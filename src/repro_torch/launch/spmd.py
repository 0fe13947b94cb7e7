"""Start an SPMD world: one process a rank, each running the same function
under its program (``parallel.collectives``).

  results = spmd.spawn(fn, Mesh(("data", "model"), (2, 2)), "cuda",
                       timeout=600, args=(...,))

Each child takes rank r of ``mesh.size``, runs with ``OMP_NUM_THREADS=1``
(set before torch loads in it), takes card ``r % device_count`` on
"cuda" (several ranks share a card when there are fewer cards than
ranks), joins the process group through a ``file://`` rendezvous in a
fresh directory (NCCL where each rank owns a card, else gloo:
``collectives.default_backend``), starts its program on `mesh`
(``launch.mesh.init_device_mesh``) and calls ``fn(*args)`` with it
active. ``spawn`` returns the ranks' return values in rank order (each
must pickle; tensors are saved by ``torch.save``).

A failure in any rank fails the call: the other ranks, which may wait in
a collective for it, are killed, and ``spawn`` raises with the failing
rank's traceback. So does a world that outlasts `timeout` seconds: every
child is killed first. ``fn`` must be importable by name (a module-level
function); the children start afresh (the "spawn" start method), not
forked, so a parent holding a CUDA context is safe.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch import mesh as mesh_lib
from repro_torch.parallel import collectives


@contextlib.contextmanager
def world(device):
    """A CLI's world: yields (the SPMD program or None, the rank's
    device), the program active while open. Under ``torchrun``
    (WORLD_SIZE > 1) this joins its process group (env:// rendezvous;
    rank r on card LOCAL_RANK), starts the program on the host mesh
    (``mesh.make_host_mesh()``) and, on a clean exit, waits for every
    rank and leaves the group (a rank that exits while still in it can
    abort in gloo's teardown, another rank's pairs closing under it). In
    a world that ``spawn`` started, the program is already active and
    the group is spawn's to end."""
    joined = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        world_size = int(os.environ["WORLD_SIZE"])
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", os.environ["RANK"])) % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group(
            collectives.default_backend(device, world_size),
            init_method="env://")
        joined = True
    prog = collectives.active()
    if prog is None and dist.is_initialized():
        prog = mesh_lib.init_device_mesh(mesh_lib.make_host_mesh(), device)
    with collectives.program(prog):
        yield prog, device
    if joined:
        dist.barrier()
        dist.destroy_process_group()


class WorldFailed(RuntimeError):
    """A rank of an SPMD world failed, or the world timed out."""


def _child(fn, rank, mesh, device, backend, rdv, out, args_file, timeout):
    torch.set_num_threads(1)
    ok = False
    try:
        args = torch.load(args_file, weights_only=False)
        device = torch.device(device)
        if device.type == "cuda":
            device = torch.device("cuda", collectives.card_of(rank, device))
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=f"file://{rdv}", world_size=mesh.size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        prog = collectives.start(mesh, device)
        with collectives.program(prog):
            result = fn(*args)
        torch.save({"ok": True, "result": result}, out)
        ok = True
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
    finally:
        if dist.is_initialized():
            with contextlib.suppress(Exception):
                if ok:
                    dist.barrier()
                dist.destroy_process_group()
    if not ok:
        os._exit(1)


@contextlib.contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spawn(fn, mesh, device="cpu", timeout: float = 600.0, args=(),
          workdir=None) -> list:
    """Run ``fn(*args)`` on every rank of `mesh` (one process a rank);
    returns their results in rank order, or raises ``WorldFailed``.
    `workdir`: where the rendezvous and result files go (a temporary
    directory under it, removed after)."""
    world = mesh.size
    backend = collectives.default_backend(device, world)
    tmp = tempfile.mkdtemp(prefix="spmd_", dir=workdir)
    rdv = os.path.join(tmp, "rendezvous")
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
    # the arguments go through a file: a large pickle in the start pipe
    # would hold each start until that child has read it, starting the
    # ranks one after another
    args_file = os.path.join(tmp, "args.pt")
    torch.save(tuple(args), args_file)
    ctx = mp.get_context("spawn")
    procs = []
    try:
        with _env(OMP_NUM_THREADS="1"):
            for r in range(world):
                p = ctx.Process(target=_child, args=(
                    fn, r, mesh, str(device), backend, rdv, outs[r],
                    args_file, timeout), daemon=True)
                p.start()
                procs.append(p)
        deadline = time.monotonic() + timeout
        failed = None
        while True:
            codes = [p.exitcode for p in procs]
            failed = next((r for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is not None or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise WorldFailed(f"the {mesh.name} world outlasted its "
                                  f"{timeout:.0f} s; every rank killed")
            time.sleep(0.05)
        if failed is not None:
            err = (torch.load(outs[failed], weights_only=False)["error"]
                   if os.path.exists(outs[failed])
                   else f"exit code {procs[failed].exitcode}")
            raise WorldFailed(f"rank {failed} of the {mesh.name} world "
                              f"failed:\n{err}")
        return [torch.load(o, weights_only=False)["result"] for o in outs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
