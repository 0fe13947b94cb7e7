"""Dry run of every (architecture x input-shape) cell: per-device bytes,
flops and collectives, with no array allocated.

Counterpart of the JAX package's ``launch/dryrun.py``, with its CLI and
its records. Each cell's step (``launch.steps``: the MPSL train step, a
prefill or a decode step) runs once as rank 0 of the cell's mesh in the
explicit SPMD program (``parallel.collectives``), traced by
``trace_program``: a fresh fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: no peers, no
transport), the program on it, every tensor a
``torch._subclasses.FakeTensorMode`` fake, the arguments rank 0's shards
of the step constructor's in_specs. The step runs the impls
``default_run`` picks (blockwise / auto attention, the plain CE, the
dense or ep dispatch), never the kernels, whose ctypes wrappers cannot
take fake tensors. The scan of SSM layers is traced in its associative
form (``models.mamba.assoc_selective_scan``, the JAX package's own): a
stepped trace of a 32k-token prefill over 64 layers is millions of
fake-tensor ops.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-4b \\
      --shape train_4k [--multi-pod | --host-mesh] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Meshes: the JAX dry run's 16 x 16 and 2 x 16 x 16 (``--multi-pod``,
``--both-meshes``), and ``--host-mesh``, the local CUDA devices x 1 (one
device where there is no card: no group, no collective). A record keeps
the JAX record's keys, each for rank 0:

  flops_per_device  ``torch.utils.flop_counter.FlopCounterMode`` over the
                    rank's trace (matmul-class ops): its own shards' work,
                    the work every model rank repeats included (the
                    dboth layout's whole heads), as the JAX per-device
                    figure counts it.
  collective_bytes_per_device  {"all-gather", "all-reduce",
                    "reduce-scatter"}: the bytes of every collective the
                    rank's step issues, summed as the JAX function sums
                    an HLO's, by result: an all-reduce's tensor, an
                    all-gather's output, a reduce-scatter's output (the
                    counter's input bytes over the axis size); {} on a
                    mesh of one device.
  collectives       ``collectives.read_counts()`` of the step, {"op/axis":
                    {"calls", "bytes"}} in the counter's convention (a
                    reduce-scatter by its input): what a rank of a real
                    world counts (``chip_smoke.py``'s mesh paths).
  memory.argument_size_in_bytes  exact: each argument leaf's
                    ``sharding.shard_shape`` under its spec, summed.
  memory.temp_size_in_bytes  the peak of live fake bytes the rank's step
                    creates (a dispatch mode tracks each storage until it
                    dies; the collectives' outputs included).
  lower_s           the traces' seconds; compile_s and bytes_per_device
                    are null (no compiler, no cost model of bytes).

A train cell of mu > 1 microbatches is traced twice, at one microbatch
(the step run with mu 1) and at two (mu 2): the per-microbatch part is
their difference, the once-a-step part (``reduce_grads``' all-reduces,
the gradient norm's) what the first holds beyond it, so the step's
flops and collectives are one + (mu - 1) x (two - one), exactly; the
temp bytes are the two-microbatch trace's peak (the gradient sum live
through the second microbatch, as through every later one).

A JAX record counts each HLO instruction once: a ``lax.scan``-ed layer
stack's collectives count once there, L times here (every layer, every
microbatch and the remat recompute run).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import obs, tree
from repro_torch.configs import SHAPES, cell_supported, get_config, list_archs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.parallel import collectives, sharding

LOG = obs.get_logger("dryrun")


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops create while the mode is on,
    live and at their peak: each storage counted once, until it dies
    (a storage's Python object lives as long as the storage does). The
    storages of `args` (updated in place, or viewed) are not counted."""

    def __init__(self, args=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._args = {id(t.untyped_storage()) for t in tree.leaves(args)
                      if isinstance(t, torch.Tensor)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._sizes or key in self._args:
                continue
            n = st.nbytes()
            self._sizes[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out

    def _free(self, key):
        self.live -= self._sizes.pop(key)


def _fake_tree(t):
    """Meta leaves as fake tensors of the same shape and dtype (call
    inside the FakeTensorMode); other leaves (ints) as they are."""
    def fake(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return torch.empty(leaf.shape, dtype=leaf.dtype)
    return tree.map_(fake, t) if t is not None else None


def _bytes_per_device(t, specs, mesh) -> int:
    """Each tensor leaf's per-device bytes under its spec, summed."""
    if t is None:
        return 0
    if isinstance(t, dict):
        return sum(_bytes_per_device(t[k], specs[k], mesh) for k in t)
    if isinstance(t, (list, tuple)):
        return sum(_bytes_per_device(a, b, mesh) for a, b in zip(t, specs))
    if not isinstance(t, torch.Tensor):
        return 0
    return (math.prod(sharding.shard_shape(t.shape, specs, mesh))
            * t.element_size())


@contextlib.contextmanager
def fake_program(mesh):
    """Rank 0's SPMD program on `mesh` over a fresh fake process group of
    ``mesh.size`` ranks (no peers: every collective returns at once),
    active while open, the group destroyed on exit; None, and no group,
    on a mesh of one device. Refuses where a process group is already
    initialized."""
    if mesh.size == 1:
        with collectives.program(None):
            yield None
        return
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "one is already initialized")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=mesh.size,
                            store=FakeStore())
    try:
        with collectives.program(mesh_lib.init_device_mesh(mesh, "cpu")) \
                as prog:
            yield prog
    finally:
        dist.destroy_process_group()


def trace_program(fn, a_args, mesh, specs):
    """(flops, live peak bytes, collectives, seconds) of rank 0 of `mesh`
    running fn(*args) in the SPMD program, on a fake process group
    (``fake_program``) and fake tensors: `a_args`, a step constructor's
    abstract whole arguments (meta leaves), made fake and cut into rank
    0's shards by `specs` (``steps.shard_inputs``: a train state's params
    made leaves that require grad); the collectives are the counter's
    records, {"op/axis": {"calls", "bytes"}}, of the call alone."""
    with fake_program(mesh), FakeTensorMode():
        args = steps.shard_inputs(tuple(_fake_tree(a) for a in a_args),
                                  specs)
        live = LiveBytes(args)
        collectives.reset_counts()
        t0 = time.perf_counter()
        with sharding.use_mesh(mesh), \
                FlopCounterMode(display=False) as fc, live:
            out = fn(*args)
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in collectives.read_counts().items()
                  if k != "program"}
        del out, args
    return fc.get_total_flops(), live.peak, counts, seconds


def collective_bytes(counts, mesh) -> Dict[str, float]:
    """The JAX record's ``collective_bytes_per_device`` of a rank's
    counter records: bytes by op, each by its result (a reduce-scatter's
    output: its input over the axis size)."""
    out: Dict[str, float] = {}
    for key, rec in counts.items():
        op, axis = key.split("/", 1)
        n = rec["bytes"]
        if op == "reduce_scatter":
            n //= collectives.axis_size(mesh, axis)
        name = op.replace("_", "-")
        out[name] = out.get(name, 0.0) + float(n)
    return out


def _extrapolate(one, two, mu):
    """one + (mu - 1) x (two - one), leaf by leaf, over {"op/axis":
    {"calls", "bytes"}} records (a key missing from one counts 0)."""
    out = {}
    for key in sorted(set(one) | set(two)):
        a = one.get(key, {"calls": 0, "bytes": 0})
        b = two.get(key, {"calls": 0, "bytes": 0})
        out[key] = {f: a[f] + (mu - 1) * (b[f] - a[f]) for f in a}
    return out


def mesh_for(multi_pod: bool = False, host_mesh: bool = False):
    if host_mesh:
        return mesh_lib.make_host_mesh()
    return mesh_lib.make_production_mesh(multi_pod=multi_pod)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             host_mesh: bool = False,
             overrides: Optional[Dict[str, Any]] = None,
             cfg=None, shape=None, verbose: bool = True) -> Dict[str, Any]:
    """The record of one cell. `cfg` / `shape` replace the published
    config and shape (a cut cell); `overrides` go to ``default_run``."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    mesh = mesh_for(multi_pod, host_mesh)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh.name}
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec["status"] = why
        if verbose:
            LOG.info(f"{arch} x {shape_name}: {why}", arch=arch,
                     shape=shape_name, status=why)
        return rec

    with sharding.use_mesh(mesh):
        run = steps.default_run(cfg, shape, mesh, **(overrides or {}))
    run = dataclasses.replace(run, ssm_impl="assoc")
    mu = run.microbatches
    if shape.kind == "train":
        _, a_state, a_batch, specs = steps.build_train(cfg, run, mesh)
        arg_bytes = (_bytes_per_device(a_state, specs[0], mesh)
                     + _bytes_per_device(a_batch, specs[1], mesh))

        def trace_mb(n):
            """The step at n microbatches, on n of the cell's microbatches
            (each client's local batch cut by mu, n of the parts)."""
            step_fn, _, _, _ = steps.build_train(
                cfg, dataclasses.replace(run, microbatches=n), mesh)
            a_mb = {k: v if k == "mask" else steps._meta(
                (v.shape[0], n * (v.shape[1] // mu)) + tuple(v.shape[2:]),
                v.dtype) for k, v in a_batch.items()}

            return trace_program(step_fn, (a_state, a_mb), mesh, specs)

        flops, temp, counts, secs = trace_mb(1)
        if mu > 1:
            flops2, temp, counts2, secs2 = trace_mb(2)
            flops += (mu - 1) * (flops2 - flops)
            counts = _extrapolate(counts, counts2, mu)
            secs += secs2
        trace_note = (f"rank 0's step at 1 and 2 of {mu} microbatches "
                      f"traced: 1 + {mu - 1} x (2 - 1)" if mu > 1
                      else "rank 0's whole step traced")
    elif shape.kind == "prefill":
        fn, args, specs = steps.build_prefill(cfg, run, mesh)
        arg_bytes = _bytes_per_device(args, specs, mesh)
        flops, temp, counts, secs = trace_program(fn, args, mesh, specs)
        trace_note = "rank 0's whole prefill traced"
    else:
        fn, args, specs, _ = steps.build_decode(cfg, run, mesh)
        arg_bytes = _bytes_per_device(args, specs, mesh)
        flops, temp, counts, secs = trace_program(fn, args, mesh, specs)
        trace_note = "rank 0's decode step traced"

    coll = collective_bytes(counts, mesh)
    rec.update({
        "status": "ok",
        "kind": shape.kind,
        "microbatches": mu,
        "n_clients": run.mpsl.n_clients,
        "flops_per_device": float(flops),
        "bytes_per_device": None,
        "collective_bytes_per_device": coll,
        "collectives": counts,
        "memory": {"generated_code_size_in_bytes": None,
                   "argument_size_in_bytes": float(arg_bytes),
                   "output_size_in_bytes": None,
                   "temp_size_in_bytes": float(temp),
                   "alias_size_in_bytes": None},
        "lower_s": round(secs, 1),
        "compile_s": None,
        "impls": {"attn": run.attn_impl, "moe": run.moe_impl,
                  "ce": run.ce_impl, "ssm": run.ssm_impl},
        "notes": {"trace": trace_note,
                  "collective_bytes_per_device": (
                      "rank 0's collectives, by result bytes; a JAX record "
                      "counts each HLO instruction once (a scanned layer "
                      "stack's collectives once, here L times)"),
                  "bytes_per_device": "no cost model of bytes accessed",
                  "temp_size_in_bytes": "peak live fake bytes of rank 0's "
                                        "step"},
    })
    if verbose:
        coll_s = {k: round(v / 1e6, 1) for k, v in coll.items()}
        LOG.info(f"{arch} x {shape_name} ({rec['mesh']}): OK  "
                 f"flops/dev={rec['flops_per_device']:.3e}  "
                 f"temp={temp / 1e9:.2f}GB args={arg_bytes / 1e9:.2f}GB  "
                 f"coll={coll_s}MB  trace={secs:.1f}s",
                 arch=arch, shape=shape_name, mesh=rec["mesh"])
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--host-mesh", action="store_true",
                   help="the local devices x 1 (the card's mesh)")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in list_archs() for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            p.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    if args.host_mesh:
        meshes = [dict(host_mesh=True)]
    elif args.both_meshes:
        meshes = [dict(multi_pod=False), dict(multi_pod=True)]
    else:
        meshes = [dict(multi_pod=args.multi_pod)]
    records = []
    failures = 0
    for arch, shape in cells:
        for kw in meshes:
            try:
                records.append(run_cell(arch, shape, **kw))
            except Exception as e:  # noqa: BLE001 — report and continue
                failures += 1
                name = mesh_for(**kw).name
                LOG.error(f"{arch} x {shape} ({name}): FAIL {e!r}",
                          arch=arch, shape=shape, error=repr(e))
                records.append({"arch": arch, "shape": shape, "mesh": name,
                                "status": f"FAIL: {e}"})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        LOG.info(f"wrote {len(records)} records -> {args.out}")
    LOG.info(f"{len(records) - failures}/{len(records)} cells ok",
             ok=len(records) - failures, total=len(records))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
