"""Dry run of every (architecture x input-shape) cell: per-device bytes
and flops, with no array allocated.

Counterpart of the JAX package's ``launch/dryrun.py``, with its CLI and
its records. Each cell's step (``launch.steps``: the MPSL train step, a
prefill or a decode step) is traced once under
``torch._subclasses.FakeTensorMode`` with the impls ``default_run``
picks (blockwise / auto attention, the plain CE, the dense or ep
dispatch), never the kernels, whose ctypes wrappers cannot take fake
tensors. The scan of SSM layers is traced in its associative form
(``models.mamba.assoc_selective_scan``, the JAX package's own): a
stepped trace of a 32k-token prefill over 64 layers is millions of
fake-tensor ops.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-4b \\
      --shape train_4k [--multi-pod | --host-mesh] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --host-mesh

Meshes: the JAX dry run's 16 x 16 and 2 x 16 x 16 (``--multi-pod``,
``--both-meshes``), and ``--host-mesh``, the local CUDA devices x 1 (one
device where there is no card). A record keeps the JAX record's keys:

  flops_per_device  ``torch.utils.flop_counter.FlopCounterMode`` over the
                    trace (matmul-class ops), over the device count. A
                    train cell with mu microbatches is traced at one
                    microbatch and its flops multiplied by mu, as the
                    JAX lax.scan is traced once: the counter counts no
                    elementwise op, so the optimizer adds none.
  memory.argument_size_in_bytes  exact: each argument leaf's
                    ``sharding.shard_shape`` under its spec, summed.
  memory.temp_size_in_bytes  the peak of live fake bytes the step
                    creates (a dispatch mode tracks each storage until it
                    dies), on a one-device host mesh only (plus one f32
                    gradient set for the accumulator when mu > 1); null
                    on the production meshes, where no partitioner says
                    how the work would split.
  collective_bytes_per_device  null: no partitioner runs until the
                    multi-GPU work of ROADMAP.md.
  lower_s           the trace's seconds; compile_s is null.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import weakref
from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import obs, tree
from repro_torch.configs import SHAPES, cell_supported, get_config, list_archs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.parallel import sharding

LOG = obs.get_logger("dryrun")

NO_PARTITIONER = ("no partitioner runs on one card: collectives come with "
                  "the multi-GPU work (ROADMAP.md)")


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


def _fake_tree(t, requires_grad=False):
    """Meta leaves as fake tensors of the same shape and dtype (call
    inside the FakeTensorMode); other leaves (ints) as they are."""
    def fake(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        x = torch.empty(leaf.shape, dtype=leaf.dtype)
        return x.requires_grad_() if requires_grad else x
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


def _execution_mesh(mesh):
    """The mesh the trace runs under: the cell's data axes and a model
    axis of 1, so ep runs each data shard's tokens over every expert.
    Its flops over the cell's device count are the JAX per-device ones
    (E / model experts a device, each of cap_e rows)."""
    sizes = tuple(1 if a == "model" else s
                  for a, s in zip(mesh.axis_names, mesh.axis_sizes))
    return mesh_lib.Mesh(mesh.axis_names, sizes)


def _trace(fn, make_args, mesh, count_temp: bool):
    """(flops, temp bytes or None, seconds) of fn(*make_args()) traced
    under FakeTensorMode on `mesh`'s execution mesh."""
    with FakeTensorMode():
        args = make_args()
        live = LiveBytes(args)
        t0 = time.perf_counter()
        with sharding.use_mesh(_execution_mesh(mesh)), \
                FlopCounterMode(display=False) as fc, live:
            out = fn(*args)
        seconds = time.perf_counter() - t0
        del out, args
    return fc.get_total_flops(), (live.peak if count_temp else None), seconds


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
    count_temp = host_mesh and mesh.size == 1
    if shape.kind == "train":
        _, a_state, a_batch, specs = steps.build_train(cfg, run, mesh)
        arg_bytes = (_bytes_per_device(a_state, specs[0], mesh)
                     + _bytes_per_device(a_batch, specs[1], mesh))
        # one microbatch: each client's local batch cut by mu
        step_fn, _, _, _ = steps.build_train(
            cfg, dataclasses.replace(run, microbatches=1), mesh)
        a_mb = {k: v if k == "mask" else steps._meta(
            (v.shape[0], v.shape[1] // mu) + tuple(v.shape[2:]), v.dtype)
            for k, v in a_batch.items()}

        def make_args():
            state = dict(a_state,
                         params=_fake_tree(a_state["params"], True),
                         frozen=_fake_tree(a_state["frozen"]),
                         opt=_fake_tree(a_state["opt"]))
            return state, _fake_tree(a_mb)
        flops, temp, secs = _trace(step_fn, make_args, mesh, count_temp)
        flops *= mu
        if temp is not None and mu > 1:
            temp += sum(4 * p.numel() for p in tree.leaves(a_state["params"]))
        trace_note = (f"one microbatch of {mu} traced, its flops x {mu}"
                      if mu > 1 else "the whole step traced")
    elif shape.kind == "prefill":
        fn, args, specs = steps.build_prefill(cfg, run, mesh)
        arg_bytes = _bytes_per_device(args, specs, mesh)
        flops, temp, secs = _trace(
            fn, lambda: tuple(_fake_tree(a) for a in args), mesh, count_temp)
        trace_note = "the whole prefill traced"
    else:
        fn, args, specs, _ = steps.build_decode(cfg, run, mesh)
        arg_bytes = _bytes_per_device(args, specs, mesh)
        flops, temp, secs = _trace(
            fn, lambda: tuple(_fake_tree(a) for a in args), mesh, count_temp)
        trace_note = "one decode step traced"

    rec.update({
        "status": "ok",
        "kind": shape.kind,
        "microbatches": mu,
        "n_clients": run.mpsl.n_clients,
        "flops_per_device": float(flops) / mesh.size,
        "bytes_per_device": None,
        "collective_bytes_per_device": None,
        "memory": {"generated_code_size_in_bytes": None,
                   "argument_size_in_bytes": float(arg_bytes),
                   "output_size_in_bytes": None,
                   "temp_size_in_bytes": (None if temp is None
                                          else float(temp)),
                   "alias_size_in_bytes": None},
        "lower_s": round(secs, 1),
        "compile_s": None,
        "impls": {"attn": run.attn_impl, "moe": run.moe_impl,
                  "ce": run.ce_impl, "ssm": run.ssm_impl},
        "notes": {"trace": trace_note,
                  "collective_bytes_per_device": NO_PARTITIONER,
                  "bytes_per_device": "no cost model of bytes accessed",
                  "temp_size_in_bytes": (
                      "peak live fake bytes of the step" if count_temp else
                      "not counted: no partitioner splits the work "
                      "across this mesh's devices")},
    })
    if verbose:
        temp_s = "-" if temp is None else f"{temp / 1e9:.2f}GB"
        LOG.info(f"{arch} x {shape_name} ({rec['mesh']}): OK  "
                 f"flops/dev={rec['flops_per_device']:.3e}  temp={temp_s} "
                 f"args={arg_bytes / 1e9:.2f}GB  trace={secs:.1f}s",
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
