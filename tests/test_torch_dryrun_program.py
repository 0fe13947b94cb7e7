"""The dry run's program trace (``launch.dryrun.trace_program``) against
the SPMD program it traces, run for real on the CPU (gloo).

The dry run runs each cell's step as rank 0 of the cell's mesh on a fake
process group (torch's ``fake_pg``: no peers) and fake tensors; the
collectives take the whole-tensor route a NCCL rank takes, and the
counter records each call as every backend does. One world of 4 ranks,
started once for the module, runs on (2, 2) a minitron-like train step
(4 heads on 2 KV heads: ``heads``; 2 microbatches, both int8 links on),
a hybrid train step whose 3 heads divide no axis (``dboth``), a prefill
and a decode (1 KV head: the sequence-sharded cache), and on (2, 1, 2) a
train step (the pod axis). Held:

  * the trace's collectives, by op and axis, calls and bytes, exactly
    rank 0's in the world, and every rank's alike;
  * the trace's flops exactly rank 0's ``FlopCounterMode`` flops;
  * ``collective_bytes_per_device`` the counts by the JAX record's
    result bytes (a reduce-scatter by its output);
  * ``run_cell`` on 16 x 16 and 2 x 16 x 16 at reduced configs whose
    head counts give ``heads``, ``mixed`` and ``dboth`` on 16: status ok,
    collectives recorded, no process group left; its train extrapolation
    from one and two microbatches exactly the trace of all four.
"""
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist

import _mesh_workers as W
from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun, spmd
from repro_torch.launch.mesh import Mesh, make_production_mesh

M22 = Mesh(("data", "model"), (2, 2))
P212 = Mesh(("pod", "data", "model"), (2, 1, 2))
LINKS = dict(compress_uplink=True, compress_downlink=True,
             trainable_blocks=1, head_adapter_rank=4)
HEADS = {"num_kv_heads": 2}
# (kind, config, tokens, global batch, default_run overrides)
CASES = {
    M22.name: [
        ("train", HEADS, 12, 8, dict(LINKS, microbatches=2)),
        ("train", {"arch": "hymba-1.5b", "num_heads": 3, "num_kv_heads": 3},
         12, 4, dict(trainable_blocks=1)),
        ("prefill", {}, 12, 4, {}),
        ("decode", {}, 16, 4, {}),
    ],
    P212.name: [("train", HEADS, 12, 8, dict(LINKS, microbatches=2))],
}
MESHES = {M22.name: M22, P212.name: P212}
PAIRS = [(m, i) for m in CASES for i in range(len(CASES[m]))]
IDS = [f"{m}-{CASES[m][i][0]}{i}" for m, i in PAIRS]
JAX_KEYS = {"all-gather", "all-reduce", "reduce-scatter"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    res = spmd.spawn(W.dry_cases, M22, "cpu", 300,
                     args=([(MESHES[m], CASES[m]) for m in CASES],),
                     workdir=tmp_path_factory.mktemp("dry"))
    return res


@pytest.fixture(scope="module")
def traces():
    out = {}
    for m, i in PAIRS:
        fn, a_args, specs = W.dry_step(*CASES[m][i], MESHES[m])
        out[(m, i)] = dryrun.trace_program(fn, a_args, MESHES[m], specs)
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_trace_counts_what_rank_0_counts(world, traces, pair):
    m, i = pair
    counts = traces[pair][2]
    assert counts and counts == world[0][m][i]["counts"]


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_every_rank_counts_alike(world, pair):
    m, i = pair
    for rank in world[1:]:
        assert rank[m][i]["counts"] == world[0][m][i]["counts"]


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_trace_flops_are_rank_0s(world, traces, pair):
    m, i = pair
    assert traces[pair][0] == world[0][m][i]["flops"] > 0
    assert traces[pair][1] > 0                     # the live peak


# ranks a counter axis spans, by mesh
AXIS_SIZES = {M22.name: {"data": 2, "model": 2, "world": 4},
              P212.name: {"pod": 2, "data": 1, "model": 2, "pod+data": 2,
                          "world": 4}}


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_collective_bytes_by_result(traces, pair):
    m, _ = pair
    counts = traces[pair][2]
    want = {}
    for key, rec in counts.items():
        op, axis = key.split("/")
        n = rec["bytes"]
        if op == "reduce_scatter":
            assert n % AXIS_SIZES[m][axis] == 0
            n //= AXIS_SIZES[m][axis]
        name = {"all_gather": "all-gather", "all_reduce": "all-reduce",
                "reduce_scatter": "reduce-scatter"}[op]
        want[name] = want.get(name, 0) + n
    got = dryrun.collective_bytes(counts, MESHES[m])
    assert set(got) <= JAX_KEYS and got == want


# reduced configs whose heads give each layout on a model axis of 16
PROD = [("heads", {"num_heads": 16, "num_kv_heads": 16, "head_dim": 8},
         "train", False),
        ("mixed", {"num_heads": 16, "num_kv_heads": 1, "head_dim": 8},
         "train", True),
        ("dboth", {"num_heads": 3, "num_kv_heads": 1}, "prefill", False),
        ("mixed", {"num_heads": 16, "num_kv_heads": 1, "head_dim": 8},
         "decode", True)]
SHAPE_NAMES = {"train": "train_4k", "prefill": "prefill_32k",
               "decode": "decode_32k"}


@pytest.mark.parametrize("layout,kw,kind,multi_pod", PROD,
                         ids=[f"{p[0]}-{p[2]}-{'2x16x16' if p[3] else '16x16'}"
                              for p in PROD])
def test_run_cell_on_the_production_meshes(layout, kw, kind, multi_pod):
    cfg = W._config(dict(kw, d_model=128))
    shape = ShapeConfig(SHAPE_NAMES[kind], 32, 64, kind)
    rec = dryrun.run_cell("minitron-4b", SHAPE_NAMES[kind],
                          multi_pod=multi_pod, cfg=cfg, shape=shape,
                          overrides=dict(compute_dtype="float32"),
                          verbose=False)
    assert rec["status"] == "ok" and not dist.is_initialized()
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    coll = rec["collective_bytes_per_device"]
    assert coll and set(coll) <= JAX_KEYS and all(v > 0 for v in
                                                  coll.values())
    assert rec["collectives"] and "program" not in rec["collectives"]
    assert any(k.endswith("/model") for k in rec["collectives"])
    if multi_pod and kind == "train":
        assert any("pod" in k for k in rec["collectives"])
    assert rec["flops_per_device"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0


def test_run_cell_extrapolates_the_microbatches_exactly():
    """A train cell of 4 microbatches: the record (traced at 1 and 2) has
    exactly the flops and collectives of the whole 4-microbatch step
    traced."""
    kw = {"num_heads": 16, "num_kv_heads": 16, "head_dim": 8,
          "d_model": 128}
    mesh = make_production_mesh()
    rec = dryrun.run_cell("minitron-4b", "train_4k", cfg=W._config(kw),
                          overrides=dict(compute_dtype="float32",
                                         microbatches=4), verbose=False,
                          shape=ShapeConfig("train_4k", 16, 128, "train"))
    fn, a_args, specs = W.dry_step("train", kw, 16, 128,
                                   dict(microbatches=4), mesh)
    flops, _, counts, _ = dryrun.trace_program(fn, a_args, mesh, specs)
    assert rec["microbatches"] == 4
    assert rec["flops_per_device"] == flops
    assert rec["collectives"] == counts


def test_run_cell_on_one_device_and_beside_a_group():
    """The host mesh of one device traces with no group and records no
    collective; a trace refuses to start beside an initialized group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    kw = {"num_kv_heads": 2}
    shape = ShapeConfig("decode_32k", 16, 4, "decode")
    rec = dryrun.run_cell("minitron-4b", "decode_32k", host_mesh=True,
                          cfg=W._config(kw), shape=shape, verbose=False)
    assert rec["collective_bytes_per_device"] == {} == rec["collectives"]
    dist.init_process_group("fake", rank=0, world_size=2, store=FakeStore())
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            dryrun.run_cell("minitron-4b", "decode_32k", cfg=W._config(kw),
                            shape=shape, verbose=False)
    finally:
        dist.destroy_process_group()
