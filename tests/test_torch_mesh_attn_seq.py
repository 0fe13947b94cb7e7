"""The query sequence sharded for the core attention
(``RunConfig.attn_seq_shard``) in the SPMD program on the CPU (gloo),
against the same program without it and against the JAX package.

With the flag each model rank runs the core self-attention over its
contiguous S/m slice of the queries, every head, against the whole K/V
(the JAX ``repro/models/attention.py:271-276`` layout), where the
queries are more than one and divide the model axis. One world of 4
ranks on the mesh (2, 2), started once for the module, runs the MPSL
loss and its gradients of each case with and without the flag (4
clients x 2 x 12 tokens, client 1 masked, links off, f32, the last block
trainable):

  * reduced minitron-4b with 4 query and 4 KV heads (``heads``), 4 and 1
    (``mixed``), 3 and 1 (``dboth``), and 3 and 1 at d_model 63, which
    divides no axis (``replicated``);
  * reduced hymba-1.5b with a sliding window of 8 on its local layer
    (``mixed``; the scan beside the attention);
  * reduced whisper-tiny (6 heads: ``heads``), the encoder's 16 frames
    and the decoder's 12 tokens both sliced, cross-attention untouched;
  * the ``heads`` case under ``seq_shard_acts`` as well (the stream cut
    between the blocks, gathered at each block's entry, then sliced for
    the core);
  * the ``heads`` case at 13 tokens, which do not divide the model axis:
    nothing changes.

Held: the loss within 1e-6 and every gradient within 1e-5 (relative L2)
of the run without the flag; both against the JAX ``make_lm_loss`` with
``attn_seq_shard=True`` (a no-op on one JAX device) at
``test_torch_mesh_step.py``'s limits; the masked client's adapter
gradient exactly 0; the collectives the flag adds, exactly as derived
from the autograd pairs (``_delta``); a prefill (reduced minitron, its
one KV head's cache on the sequence) with logits within 1e-5 and the
cache bitwise; and, in the dry run's trace of the ``dboth`` step, the
core attention's flops down by exactly (m - 1) / m.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import _mesh_workers as W
from repro.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro.core import mpsl as jmpsl
from repro_torch.core import split
from repro_torch.launch import dryrun, spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM

MESH = Mesh(("data", "model"), (2, 2))
N, BN, S = 4, 2, 12
MASK = [1.0, 0.0, 1.0, 1.0]
HEADS = {"num_kv_heads": 4}
WHISPER = {"arch": "whisper-tiny", "d_model": 48, "num_heads": 6,
           "num_kv_heads": 6, "head_dim": 8, "vocab_size": 257}
# (name, config, the attention layout on (2, 2), text tokens, RunConfig
# fields set with and without the flag)
CASES = [
    ("heads", HEADS, "heads", S, ()),
    ("mixed", {}, "mixed", S, ()),
    ("dboth", {"num_heads": 3, "num_kv_heads": 1}, "dboth", S, ()),
    ("replicated", {"num_heads": 3, "num_kv_heads": 1, "d_model": 63},
     "replicated", S, ()),
    ("hybrid-window", {"arch": "hymba-1.5b", "sliding_window": 8}, "mixed",
     S, ()),
    ("whisper", WHISPER, "heads", S, ()),
    ("heads+seq_model", HEADS, "heads", S, (("seq_shard_acts", True),)),
    ("heads-s13", HEADS, "heads", 13, ()),
]
IDS = [c[0] for c in CASES]
# the flag against the run without it: the same f32 products, the core's
# rows split between the ranks, the K/V gradients summed over them
FLAG_LOSS_TOL, FLAG_GRAD_TOL = 1e-6, 1e-5
# tests/test_torch_mesh_step.py's limits against the JAX package
LOSS_TOL, GRAD_L2_TOL = 1e-4, 1e-3
PREFILL_TOL = 1e-5


def _trees(kw):
    cfg = W._config(kw)
    run = W._port_run(cfg, N, False)
    gen = torch.Generator().manual_seed(0)
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run)
    params["client"]["adapter"]["b"].normal_(0.0, 0.05, generator=gen)
    return W.bridge.to_repro(params), W.bridge.to_repro(frozen)


def _batch(cfg, s, seed=4):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (N, BN, s)),
           "labels": rng.integers(0, cfg.vocab_size, (N, BN, s)),
           "mask": np.asarray(MASK, np.float32)}
    if cfg.family == "audio":
        out["frame_embeds"] = (0.02 * rng.standard_normal(
            (N, BN, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


def _prefill_args():
    """Reduced minitron-4b served: its one KV head divides no model axis of
    2, so its caches lie on the sequence; 4 prompts of 12 tokens."""
    params = W.bridge.to_repro(TM.init_lm(W._config({}),
                                          torch.Generator().manual_seed(5)))
    tokens = np.random.default_rng(5).integers(0, 256, (4, 12))
    return {}, params, tokens, "attn_seq_shard"


def _inputs():
    out = []
    for _, kw, _, s, base in CASES:
        params, frozen = _trees(kw)
        out.append((kw, params, frozen, _batch(W._config(kw), s), None,
                    "attn_seq_shard", base))
    return out


def _jrun(cfg):
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=False, compress_downlink=False)
    return RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                     compute_dtype="float32", attn_impl="naive",
                     ce_impl="jnp", attn_seq_shard=True)


def _jax_loss(kw, params, frozen, batch):
    kw = dict(kw)
    cfg = reduced(get_config(kw.pop("arch", "minitron-4b")), **kw)
    loss_fn = jmpsl.make_lm_loss(cfg, _jrun(cfg))
    jb = {k: jnp.asarray(v, jnp.int32) if k in ("tokens", "labels")
          else jnp.asarray(v) for k, v in batch.items()}
    (loss, met), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, frozen, jb, jax.random.PRNGKey(0))
    return {"loss": float(loss), "per_client": np.asarray(met["per_client"]),
            "grads": [np.asarray(x) for x in jax.tree_util.tree_leaves(
                W.bridge.from_repro(jax.tree_util.tree_map(np.asarray,
                                                           grads)))]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The world's results (spawned on a thread) and the JAX side's,
    computed while the world runs."""
    args = _inputs()
    port = {}

    def run_world():
        try:
            port["res"] = spmd.spawn(
                W.seq_cases, MESH, "cpu", 300,
                args=([MESH], args, [_prefill_args()]),
                workdir=tmp_path_factory.mktemp("attn_seq"))
        except BaseException as e:        # re-raised on the test's thread
            port["err"] = e

    world = threading.Thread(target=run_world)
    world.start()
    try:
        ref = [_jax_loss(a[0], a[1], a[2], a[3]) for a in args]
    finally:
        world.join()
    if "err" in port:
        raise port["err"]
    res = port["res"]
    return (args, [r[MESH.name][0] for r in res],
            [r[MESH.name][1] for r in res], ref)


def _rel_l2(got, want):
    den = float(np.linalg.norm(want)) or 1.0
    return float(np.linalg.norm(np.asarray(got) - want)) / den


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_flag_matches_the_run_without_it(results, i):
    for rank in results[1]:
        whole, seq = rank[i]["whole"], rank[i]["seq"]
        assert abs(seq["loss"] - whole["loss"]) <= \
            FLAG_LOSS_TOL * abs(whole["loss"])
        np.testing.assert_allclose(seq["per_client"], whole["per_client"],
                                   rtol=FLAG_LOSS_TOL)
        assert len(seq["grads"]) == len(whole["grads"])
        for j, (a, b) in enumerate(zip(seq["grads"], whole["grads"])):
            assert _rel_l2(a, b) <= FLAG_GRAD_TOL, f"gradient leaf {j}"


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_flag_matches_jax(results, i):
    want = results[3][i]
    for rank in results[1]:
        r = rank[i]["seq"]
        assert abs(r["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        np.testing.assert_allclose(r["per_client"], want["per_client"],
                                   rtol=LOSS_TOL)
        assert len(r["grads"]) == len(want["grads"])
        for j, (g, w) in enumerate(zip(r["grads"], want["grads"])):
            assert _rel_l2(g, w) <= GRAD_L2_TOL, f"gradient leaf {j}"


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_masked_client_gradient_is_zero(results, i):
    paths = W.tree.paths(W.bridge.from_repro(results[0][i][1]))
    adapters = [j for j, p in enumerate(paths) if "adapter" in p]
    assert adapters
    for rank in results[1]:
        for j in adapters:
            g = rank[i]["seq"]["grads"][j]
            assert not np.any(g[MASK.index(0.0)]), paths[j]
            assert np.any(g[0]), paths[j]


def _attn_layers(cfg, s):
    """[(local batch rows, queries, layers)] of the self-attentions a step
    runs: the body's, and the encoder's over its frames."""
    b = N // MESH.shape["data"] * BN
    out = [(b, s, cfg.num_layers)]
    if cfg.encoder_layers:
        out.append((b, cfg.encoder_seq, cfg.encoder_layers))
    return out


def _delta(cfg, layout, s):
    """The collectives the flag adds to a step, {"op/axis": [calls,
    bytes]}, from the autograd pairs of ``_query_slice`` and
    ``_query_joined``; f32, whole heads (q and the output H, K/V K):

      heads  forward: q, k, v and the output all-gathered (4); backward:
             dq and the output's heads gathered (2), dk, dv all-reduced (2)
      mixed  forward: q and the output (2); backward: dq, the output's
             heads (2); K/V entered by the layout's own copy_to already
      dboth, replicated  forward: the output (1); backward: dq (1), dk,
             dv all-reduced (2)

    Each block's forward runs twice (the remat recompute)."""
    m = MESH.shape["model"]
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {"all_gather/model": [0, 0], "all_reduce/model": [0, 0]}
    for b, sq, n in _attn_layers(cfg, s):
        if sq % m:
            continue
        q = o = b * sq * h * hd * 4
        kv = b * sq * k * hd * 4
        fwd = {"heads": [q, kv, kv, o], "mixed": [q, o]}.get(layout, [o])
        bwd = {"heads": [q, o], "mixed": [q, o]}.get(layout, [q])
        red = [] if layout == "mixed" else [kv, kv]
        gathers = 2 * fwd + bwd
        out["all_gather/model"][0] += n * len(gathers)
        out["all_gather/model"][1] += n * sum(gathers)
        out["all_reduce/model"][0] += n * len(red)
        out["all_reduce/model"][1] += n * sum(red)
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_collectives_the_flag_adds(results, i):
    """Exactly the derived calls and bytes over `model`; nothing else
    moves. At 13 tokens the counts are unchanged, and so is every bit."""
    _, kw, layout, s, _ = CASES[i]
    want = _delta(W._config(kw), layout, s)
    for rank in results[1]:
        whole, seq = rank[i]["whole"], rank[i]["seq"]
        for key, (calls, nbytes) in want.items():
            base = whole["counts"].get(key, {"calls": 0, "bytes": 0})
            got = seq["counts"].get(key, {"calls": 0, "bytes": 0})
            assert got["calls"] - base["calls"] == calls, key
            assert got["bytes"] - base["bytes"] == nbytes, key
        assert {k: v for k, v in seq["counts"].items() if k not in want} \
            == {k: v for k, v in whole["counts"].items() if k not in want}
        if s % MESH.shape["model"]:
            assert seq["counts"] == whole["counts"]
            assert seq["loss"] == whole["loss"]
            for a, b in zip(seq["grads"], whole["grads"]):
                np.testing.assert_array_equal(a, b)


def test_layouts_are_as_named():
    """Each case's attention weights lie in the layout its name says on
    (2, 2) (``attention.model_layout`` of rank 0's shards of the first
    block's)."""
    from repro_torch.models import attention
    from repro_torch.parallel import sharding
    for name, kw, layout, _, _ in CASES:
        params = TM.init_lm(W._config(kw), torch.Generator().manual_seed(0),
                            device="meta")
        specs = sharding.param_specs(params, MESH)
        blk, sp = params["segments"][0][0], specs["segments"][0][0]
        attn, sp = ((blk["mix"]["attn"], sp["mix"]["attn"]) if "mix" in blk
                    else (blk["attn"], sp["attn"]))
        with dryrun.fake_program(MESH):
            local = {n: sharding.shard_leaf(torch.empty(attn[n].shape),
                                            sp[n]) for n in ("wq", "wk")}
            assert attention.model_layout(local) == layout, name


def test_prefill_logits_and_cache(results):
    """``steps.build_prefill`` with the flag: the last logits within 1e-5
    of the run without it, every cache leaf bitwise (written whole from
    the same K/V before the core); the flag adds the mixed layout's two
    all-gathers a layer (no backward)."""
    layers = W._config({}).num_layers
    for rank in results[2]:
        whole, seq = rank[0]["whole"], rank[0]["seq"]
        key = "all_gather/model"
        assert seq["counts"][key] - whole["counts"].get(key, 0) == 2 * layers
        np.testing.assert_allclose(seq["logits"], whole["logits"],
                                   atol=PREFILL_TOL, rtol=PREFILL_TOL)
        assert len(seq["cache"]) == len(whole["cache"]) > 0
        for a, b in zip(seq["cache"], whole["cache"]):
            np.testing.assert_array_equal(a, b)


def test_dboth_core_flops_fall_by_the_slices():
    """The dry run's trace of rank 0's dboth step (naive attention: the
    scores and PV products, 4 B H Sq Sk hd flops a forward, twice that a
    backward, the forward run twice under remat): with the flag its flops
    fall by exactly (m - 1) / m of the core's, and nothing else moves."""
    kw = {"num_heads": 3, "num_kv_heads": 1}
    cfg = W._config(kw)
    flops = {}
    for flag in (False, True):
        fn, a_args, specs = W.dry_step(
            "train", kw, S, N, dict(trainable_blocks=1, attn_seq_shard=flag),
            MESH)
        flops[flag] = dryrun.trace_program(fn, a_args, MESH, specs)[0]
    m = MESH.shape["model"]
    b = N // MESH.shape["data"]     # this data rank's client x 2 rows
    core = 16 * b * cfg.num_heads * S * S * cfg.resolved_head_dim \
        * cfg.num_layers
    assert flops[False] - flops[True] == core * (m - 1) // m
