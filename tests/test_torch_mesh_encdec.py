"""The encoder-decoder (whisper) and VLM (qwen2-vl) stacks as SPMD programs
on the CPU (gloo), against the JAX package.

Reduced whisper-tiny (2 encoder + 2 decoder layers, 6 heads of hd 8, d
48, 16 frames, vocab 257: on (2, 2) its attention layout is "heads", on
(1, 4) "dboth" in every encoder, self and cross block, and its LM head
lies on `data` alone, the CE running whole on each model rank) and
reduced qwen2-vl-72b (2 layers, d 64, 8 / 2 heads of hd 16, M-RoPE
sections (2, 3, 3), qkv bias, vocab 256: "heads" on (2, 2), "mixed" on
(1, 4), the vocab-parallel CE; 4 patches before 12 text tokens). One
world of 4 ranks, started once for the module, runs every case on the
meshes (2, 2), (1, 4) and (4, 1):

  * the shard of every leaf on every rank against the JAX
    ``NamedSharding`` shard of the rule table's spec on 4 forced host
    devices (in a subprocess), the encoder's and the learned ``pos``
    leaves included; the gathered tree bitwise the whole one;
  * one encoder block, one decoder block (cross-attention over an
    encoder output) and one qwen2-vl block under M-RoPE positions, the
    batch on `data`: forward, x's and the encoder output's gradients and
    every param's against the JAX ``apply_block`` (its plain paths);
  * the MPSL step of each arch (4 clients x 2 x 12 tokens, 16 frames or
    4 patches a sample, client 1 masked, both links int8 on the JAX
    draws, the last block trainable): the loss, every gradient and one
    AdamW step against the JAX ``make_lm_loss`` / ``make_train_step``;
    the MPSL properties across ranks (the masked client's adapter
    gradient exactly 0; a client's gradient bitwise unchanged when
    another data rank's client changes its tokens, or its frames or
    patches);
  * serving on (1, 4) and (2, 2): prefill and 8 greedy steps against the
    JAX serving composition (``tests/test_torch_encdec.py``'s, the JAX
    ``build_prefill`` / ``build_decode`` steps) teacher-forced with the
    port's tokens; whisper always with frames, once over a
    sequence-sharded self cache (24 slots, 6 a rank on (1, 4): the last
    two ranks' shards start empty) and once over a cache whose 25 slots
    divide no model axis (whole on every rank); the cross K/V every KV
    head on every model rank, the same bits on each, against the JAX
    ``compute_cross_kv_stacked``;
  * ``steps.build_prefill``, ``build_decode`` (a seeded cache and cross
    K/V, 2 steps) and ``build_train`` on (1, 4) and (2, 2) against the
    one-process cells: the logits, every cache leaf after a gather, two
    steps' losses and grad norms.

The port runs its kernels' plain versions (the kernel route on CPU
tensors); the JAX side runs unsharded on its plain paths (naive
attention, the jnp CE).
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import _mesh_workers as W
from repro.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro.core import mpsl as jmpsl
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import schedules as jsched
from repro.parallel import sharding as jsharding
from repro_torch.core import split
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ROOT = pathlib.Path(__file__).resolve().parents[1]
WHISPER = {"arch": "whisper-tiny", "d_model": 48, "num_heads": 6,
           "num_kv_heads": 6, "head_dim": 8, "vocab_size": 257}
QWEN = {"arch": "qwen2-vl-72b", "d_model": 64, "num_heads": 8,
        "num_kv_heads": 2, "head_dim": 16, "mrope_sections": (2, 3, 3)}
ARCHS = {"whisper-tiny": WHISPER, "qwen2-vl-72b": QWEN}
MESHES = [Mesh(("data", "model"), (2, 2)), Mesh(("data", "model"), (1, 4)),
          Mesh(("data", "model"), (4, 1))]
N, BN, S, P = 4, 2, 12, 4
MASK = [1.0, 0.0, 1.0, 1.0]
LR = 1e-3
# one block: f32 sums in other orders (the model axis's partial sums
# added by the all-reduce): outputs within 1e-5, each gradient leaf 1e-4
# in relative L2
BLOCK_ATOL, BLOCK_GRAD_L2 = 1e-5, 1e-4
B = 4
# the MPSL step: tests/test_torch_mesh_step.py's limits
LOSS_TOL, GRAD_L2_TOL = 1e-4, 1e-3
# served logits (tests/test_torch_serve.py's limit)
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
STEPS = 8
# whisper's decode slots: 12 + 12 = 24 divides a model axis of 4 (the
# self cache sequence-sharded, 6 slots a rank), 12 + 13 = 25 none
SERVES = [("whisper-tiny", 12), ("whisper-tiny", 13), ("qwen2-vl-72b", 12)]
# the decode cells: a cache of 24 slots, the first 14 seeded (on (1, 4)
# whisper's last rank holds slots 18..23: none filled)
CELL_SLOTS, CELL_FILLED, CELL_STEPS = 24, 14, 2
# XLA's CPU backend without its costly LLVM passes (tests/test_torch_steps.py)
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def _jit(fn):
    return jax.jit(fn, compiler_options=FAST_XLA)


def _jcfg(kw):
    kw = dict(kw)
    return reduced(get_config(kw.pop("arch")), **kw)


def _stub(cfg, lead, seed, n=None):
    """The frame (audio: encoder_seq) or patch (vlm: P, or n) embeddings,
    0.02 x N(0, 1), f32 numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        key, n = "frame_embeds", cfg.encoder_seq
    else:
        key, n = "patch_embeds", n or P
    return {key: (0.02 * rng.standard_normal((*lead, n, cfg.d_model)))
            .astype(np.float32)}


def _nonzero(params, gen):
    """Every all-zero leaf (norm deviations, layernorm and qkv biases) and
    every norm scale moved off its init, so each gradient is held."""
    for path, leaf in zip(W.tree.paths(params), W.tree.leaves(params)):
        if "norm" in path or not leaf.any():
            leaf.add_(torch.randn(leaf.shape, generator=gen) * 0.1)
    return params


def _trees():
    return {a: W.bridge.to_repro(TM.init_lm(W._config(kw),
                                     torch.Generator().manual_seed(0)))
            for a, kw in ARCHS.items()}


def _blocks():
    """(cfg_kw, kind, params, x, positions, cot, enc_out) of a whisper
    encoder block, a decoder block and a qwen2-vl block."""
    out = []
    for arch, kind in (("whisper-tiny", "enc"), ("whisper-tiny", "dec"),
                       ("qwen2-vl-72b", "dense")):
        kw = ARCHS[arch]
        cfg = W._config(kw)
        gen = torch.Generator().manual_seed(3)
        bk = TM.BlockKind(kind, causal=kind != "enc", cross=kind == "dec")
        params = _nonzero(TM.init_block(gen, cfg, bk), gen)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
        cot = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
        enc = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model),
                                   dtype=np.float32) if kind == "dec"
               else None)
        pos = TL.build_positions(cfg, B, S, P if arch == "qwen2-vl-72b"
                                 else None).numpy()
        out.append((kw, kind, W.bridge.to_repro(params), x, pos, cot, enc))
    return out


def _mpsl_trees(kw):
    cfg = W._config(kw)
    run = W._port_run(cfg, N, True)
    gen = torch.Generator().manual_seed(0)
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run)
    params["client"]["adapter"]["b"].normal_(0.0, 0.05, generator=gen)
    return W.bridge.to_repro(params), W.bridge.to_repro(frozen)


def _batch(cfg, seed, mask=MASK):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (N, BN, S)),
            "labels": rng.integers(0, cfg.vocab_size, (N, BN, S)),
            "mask": np.asarray(mask, np.float32),
            **_stub(cfg, (N, BN), seed + 100)}


def _seq(cfg):
    return S + (P if cfg.family == "vlm" else 0)


def _draws(cfg):
    """The uniforms the JAX step draws at step 0 of a state seeded 9."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 0),
                             1)
    r_up, r_down = jax.random.split(key)
    shape = (N, BN, _seq(cfg), cfg.d_model)
    return {"uplink": np.array(jax.random.uniform(r_up, shape)),
            "downlink": np.array(jax.random.uniform(r_down, shape))}


def _prop_args(kw, params, frozen):
    """Client 3 (the last data rank's) changes its tokens, then its frames
    or patches."""
    cfg = W._config(kw)
    b1 = _batch(cfg, 12)
    b2 = {k: v.copy() for k, v in b1.items()}
    b2["tokens"][3] = (b2["tokens"][3] + 7) % cfg.vocab_size
    b3 = {k: v.copy() for k, v in b1.items()}
    key = "frame_embeds" if cfg.family == "audio" else "patch_embeds"
    b3[key][3] = -b3[key][3]
    return (kw, params, frozen, [b1, b2, b3])


def _serve_inputs(kw, seed=5):
    cfg = W._config(kw)
    params = W.bridge.to_repro(TM.init_lm(cfg,
                                          torch.Generator().manual_seed(5)))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return params, tokens, _stub(cfg, (B,), seed + 1)


def _seeded(cfg, cache_len, filled, rng):
    """A whole body cache of `cache_len` slots whose first `filled` hold
    seeded K/V (positions 0..filled-1), and (whisper) seeded cross K/V of
    every KV head."""
    cache = TM.init_body_cache(cfg, B, cache_len, torch.float32)
    for seg in cache:
        for layer in seg:
            for k in ("k", "v"):
                layer[k].copy_(torch.from_numpy(rng.standard_normal(
                    tuple(layer[k].shape)).astype(np.float32)))
            layer["pos"][:] = -1
            layer["pos"][:, :filled] = torch.arange(filled, dtype=torch.int32)
            layer["index"] = filled
    ckv = None
    if cfg.encoder_layers:
        shape = (B, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        ckv = [[{"k": torch.from_numpy(rng.standard_normal(shape)
                                       .astype(np.float32)),
                 "v": torch.from_numpy(rng.standard_normal(shape)
                                       .astype(np.float32)),
                 "pos": TL.positions_from_shape(B, cfg.encoder_seq)}
                for _ in range(seg.count)] if seg.kind.cross else None
               for seg in TM.body_segments(cfg)]
    return cache, ckv


def _decode_args(kw):
    cfg = W._config(kw)
    params, _, _ = _serve_inputs(kw, 7)
    rng = np.random.default_rng(7)
    cache, ckv = _seeded(cfg, CELL_SLOTS, CELL_FILLED, rng)
    tokens = rng.integers(0, cfg.vocab_size, (B, CELL_STEPS))
    pos = np.full((B, 3, 1) if cfg.pos_embed == "mrope" else (B, 1),
                  CELL_FILLED, np.int32)
    return (kw, params, cache, ckv, tokens, pos, CELL_STEPS)


def _prefill_args(kw):
    cfg = W._config(kw)
    params, tokens, _ = _serve_inputs(kw, 11)
    # build_prefill's VLM batch leads with the cells' 256 patches
    n = W.steps.VLM_PATCH_TOKENS if cfg.family == "vlm" else None
    return (kw, params, tokens, _stub(cfg, (B,), 12, n))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    trees = _trees()
    steps_args, props = [], []
    for kw in ARCHS.values():
        cfg = W._config(kw)
        params, frozen = _mpsl_trees(kw)
        steps_args.append((kw, params, frozen, _batch(cfg, 4), _draws(cfg),
                           LR))
        props.append([_prop_args(kw, params, frozen)])
    serves = []
    for arch, slots in SERVES:
        params, tokens, stub = _serve_inputs(ARCHS[arch])
        serves.append((ARCHS[arch], params, tokens, STEPS, slots, stub))
    prefills = [_prefill_args(kw) for kw in ARCHS.values()]
    decodes = [_decode_args(kw) for kw in ARCHS.values()]
    res = spmd.spawn(W.encdec_cases, MESHES[0], "cpu", 300, args=(
        MESHES, trees, _blocks(), steps_args, props, serves, prefills,
        decodes), workdir=tmp_path_factory.mktemp("encdec"))
    out = {m.name: [r[m.name] for r in res] for m in MESHES}
    return {"trees": trees, "steps": steps_args, "serves": serves,
            "prefills": prefills, "decodes": decodes}, out


def _rel_l2(got, want):
    den = float(np.linalg.norm(want)) or 1.0
    return float(np.linalg.norm(np.asarray(got) - want)) / den


def _flat(t):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        W.bridge.from_repro(jax.tree_util.tree_map(np.asarray, t)))]


# ---------------------------------------------------------------------------
# layouts


JAX_SHARDS = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config, reduced
from repro.models import model as JM
from repro.parallel import sharding as sh
spec = json.loads(sys.argv[1])
out = {}
for arch, kw in spec["archs"].items():
    kw = dict(kw)
    if "mrope_sections" in kw:
        kw["mrope_sections"] = tuple(kw["mrope_sections"])
    cfg = reduced(get_config(kw.pop("arch")), **kw)
    params = jax.eval_shape(lambda k: JM.init_lm(k, cfg), jax.random.PRNGKey(0))
    for d, m in spec["meshes"]:
        mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                    ("data", "model"))
        specs = sh.param_specs(params, mesh)
        leaves = jax.tree_util.tree_flatten_with_path(params)[0]
        sp = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for (path, leaf), s in zip(leaves, sp):
            idx = NamedSharding(mesh, s).devices_indices_map(leaf.shape)
            name = "/".join(sh._path_names(path))
            out[f"{arch}/{d}x{m}/{name}"] = {
                str(dev.id): [[sl.start or 0, leaf.shape[i] if sl.stop is None
                               else sl.stop] for i, sl in enumerate(ix)]
                for dev, ix in idx.items()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_shards():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    arg = json.dumps({"archs": ARCHS, "meshes": [list(m.axis_sizes)
                                                 for m in MESHES]})
    proc = subprocess.run([sys.executable, "-c", JAX_SHARDS, arg], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


def _jax_path(path):
    """(the JAX package's leaf path, the layer index or None) of a port
    path: a segment's per-layer index dropped (the JAX leaf stacks it)."""
    parts = path.split("/")
    if "segments" not in parts:
        return path, None
    j = parts.index("segments")
    return "/".join(parts[:j + 2] + parts[j + 3:]), int(parts[j + 2])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_shards_are_the_rule_tables(worlds, jax_shards, mesh, arch):
    inputs, out = worlds
    jtree = inputs["trees"][arch]
    jleaves = {"/".join(jsharding._path_names(p)): np.asarray(x)
               for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    ptree = W.bridge.from_repro(jtree)
    paths = W.tree.paths(ptree)
    whole = [W._np(x) for x in W.tree.leaves(ptree)]
    on = set()
    for rank, res in enumerate(out[mesh.name]):
        sh = res["shards"][arch]
        assert sh["equal"], "gather_tree(shard_tree(t)) != t"
        for path, local, spec in zip(paths, sh["local"], sh["specs"]):
            on |= {a for e in spec if e
                   for a in ((e,) if isinstance(e, str) else e)}
            jpath, layer = _jax_path(path)
            idx = jax_shards[f"{arch}/{mesh.name}/{jpath}"][str(rank)]
            want = jleaves[jpath][tuple(slice(a, b) for a, b in idx)]
            if layer is not None:
                want = want[layer]
            np.testing.assert_array_equal(local, want, err_msg=path)
    assert {a for a, n in mesh.shape.items() if n > 1} <= on
    assert any(p.startswith("encoder/segments") for p in paths) == \
        (arch == "whisper-tiny")


def test_layouts(worlds):
    """whisper: "heads" on (2, 2), "dboth" on (1, 4) (every attention
    weight's D on (data, model)), its learned positions' D on `model`,
    its LM head on `data` alone; qwen2-vl: "mixed" on (1, 4) (wk on D,
    its biases bk / bv replicated), its LM head vocab-parallel."""
    inputs, out = worlds

    def specs(mesh, arch):
        paths = W.tree.paths(W.bridge.from_repro(inputs["trees"][arch]))
        return dict(zip(paths, out[mesh][0]["shards"][arch]["specs"]))
    w22, w14 = specs("2x2", "whisper-tiny"), specs("1x4", "whisper-tiny")
    assert w22["segments/0/0/cross/wq"] == ("data", "model", None)
    assert w14["segments/0/0/cross/wq"] == (("data", "model"), None, None)
    assert w14["encoder/segments/0/0/attn/wo"] == (None, None,
                                                   ("data", "model"))
    assert w14["encoder/pos"] == w22["embed/pos"] == (None, "model")
    assert w22["lm_head"] == ("data", None) and w14["lm_head"] == (None,
                                                                   None)
    q14 = specs("1x4", "qwen2-vl-72b")
    assert q14["segments/0/0/attn/wq"] == (None, "model", None)
    assert q14["segments/0/0/attn/wk"] == (("data", "model"), None, None)
    assert q14["segments/0/0/attn/bk"] == (None, None)
    assert q14["lm_head"] == (None, "model")


# ---------------------------------------------------------------------------
# one block


@pytest.fixture(scope="module")
def jax_blocks():
    out = []
    for kw, kind, params, x, pos, cot, enc in _blocks():
        cfg = _jcfg(kw)
        bk = JM.BlockKind(kind, causal=kind != "enc", cross=kind == "dec")

        def f(p, x, e, cfg=cfg, bk=bk, pos=pos):
            y, _, _ = JM.apply_block(p, x, cfg, bk,
                                     positions=jnp.asarray(pos), enc_out=e,
                                     impls={"attn": "naive"})
            return y

        def fwd_bwd(p, x, e, cot, f=f):
            y, vjp = jax.vjp(f, p, x, e)
            return (y, *vjp(cot))

        e = None if enc is None else jnp.asarray(enc)
        y, gp, gx, ge = _jit(fwd_bwd)(params, jnp.asarray(x), e,
                                      jnp.asarray(cot))
        out.append({"y": np.asarray(y), "dx": np.asarray(gx),
                    "denc": None if ge is None else np.asarray(ge),
                    "grads": _flat(gp)})
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", [0, 1, 2], ids=["enc", "dec", "vlm"])
def test_block_matches_jax(worlds, jax_blocks, mesh, i):
    want = jax_blocks[i]
    for rank in worlds[1][mesh.name]:
        b = rank["blocks"][i]
        for k in ("y", "dx", "denc"):
            if want[k] is None:
                assert k not in b
                continue
            np.testing.assert_allclose(b[k], want[k], atol=BLOCK_ATOL,
                                       rtol=0, err_msg=k)
        assert len(b["grads"]) == len(want["grads"])
        for j, (g, w) in enumerate(zip(b["grads"], want["grads"])):
            assert _rel_l2(g, w) <= BLOCK_GRAD_L2, f"param grad {j}"


# ---------------------------------------------------------------------------
# the MPSL step


def _jrun(cfg):
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=True, compress_downlink=True)
    return RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                     compute_dtype="float32", attn_impl="naive",
                     ce_impl="jnp")


def _jbatch(b):
    return {k: jnp.asarray(v, jnp.int32) if k in ("tokens", "labels")
            else jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_steps(worlds):
    out = []
    for kw, params, frozen, batch, _, _ in worlds[0]["steps"]:
        cfg = _jcfg(kw)
        run = _jrun(cfg)
        loss_fn = jmpsl.make_lm_loss(cfg, run)
        rng = jax.random.fold_in(jax.random.PRNGKey(9), 0)
        step = jmpsl.make_train_step(loss_fn, run, jsched.constant(LR))

        def both(state, batch, rng, loss_fn=loss_fn, step=step):
            return (jax.value_and_grad(loss_fn, has_aux=True)(
                state["params"], state["frozen"], batch, rng),
                step(state, batch))

        ((loss, met), grads), (new, smet) = _jit(both)(
            jmpsl.init_state(params, frozen, seed=9), _jbatch(batch), rng)
        out.append({"loss": float(loss),
                    "per_client": np.asarray(met["per_client"]),
                    "grads": _flat(grads), "step_loss": float(smet["loss"]),
                    "grad_norm": float(smet["grad_norm"]),
                    "mu": _flat(new["opt"]["mu"]),
                    "nu": _flat(new["opt"]["nu"]),
                    "params": _flat(new["params"])})
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", [0, 1], ids=list(ARCHS))
def test_mpsl_step_matches_jax(worlds, jax_steps, mesh, i):
    want = jax_steps[i]
    for rank in worlds[1][mesh.name]:
        r = rank["steps"][i]
        assert abs(r["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        np.testing.assert_allclose(r["per_client"], want["per_client"],
                                   rtol=LOSS_TOL)
        assert len(r["grads"]) == len(want["grads"])
        for j, (g, w) in enumerate(zip(r["grads"], want["grads"])):
            assert _rel_l2(g, w) <= GRAD_L2_TOL, f"gradient leaf {j}"
        assert abs(r["step_loss"] - want["step_loss"]) <= \
            LOSS_TOL * abs(want["step_loss"])
        assert abs(r["grad_norm"] - want["grad_norm"]) <= \
            LOSS_TOL * want["grad_norm"]
        for k in ("mu", "nu"):
            for j, (g, w) in enumerate(zip(r[k], want[k])):
                assert _rel_l2(g, w) <= GRAD_L2_TOL, f"{k} leaf {j}"
        moved = max(float(np.abs(a - b).max())
                    for a, b in zip(r["params"], want["params"]))
        assert moved <= 2 * LR * 1.01


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", [0, 1], ids=list(ARCHS))
def test_mpsl_properties_across_ranks(worlds, mesh, i):
    """The masked client's adapter gradient is exactly 0 (every mesh);
    with a data axis above 1, client 3 (the last data rank's) changing
    its tokens, or its frames or patches, leaves every other client's
    gradient bitwise unchanged."""
    inputs, out = worlds
    params = inputs["steps"][i][1]
    paths = W.tree.paths(W.bridge.from_repro(params))
    for rank in out[mesh.name]:
        grads = dict(zip(paths, rank["steps"][i]["grads"]))
        for k in ("a", "b"):
            g = grads[f"client/adapter/{k}"]
            assert float(np.abs(g[1]).max()) == 0.0
            assert float(np.abs(g[0]).max()) > 0.0
        if "props" not in rank:
            continue
        g1, *others = rank["props"][i][0]
        for g2 in others:
            for k in ("a", "b"):
                a = g1["adapter"][f"client/adapter/{k}"]
                b = g2["adapter"][f"client/adapter/{k}"]
                assert float(np.abs(a[3] - b[3]).max()) > 0
                for c in (0, 1, 2):
                    np.testing.assert_array_equal(a[c], b[c])


# ---------------------------------------------------------------------------
# serving


def _jax_serve(cfg, params, tokens, stub, fed):
    """The composition of the JAX ``build_prefill`` / ``build_decode``
    steps (the encoder, the cross K/V, ``forward_body`` with the cache,
    ``lm_logits``; ``_build_positions`` handed the patches on axis 2, as
    training has them), naive attention, each decode step fed the port's
    token: (the logits [B, STEPS + 1, V], the cross K/V per layer)."""
    impls = {"attn": "naive"}
    b, s = tokens.shape
    h = JM.embed_tokens(params, jnp.asarray(tokens), cfg, dtype=jnp.float32)
    ckv = None
    if cfg.family == "vlm":
        pe = jnp.asarray(stub["patch_embeds"])
        h = jnp.concatenate([pe, h], axis=1)
        s = h.shape[1]
        positions = jmpsl._build_positions(cfg, {"patch_embeds": pe[:, None]},
                                           b, s)
    else:
        positions = JL.positions_from_shape(b, s)
        enc = JM.run_encoder(params, jnp.asarray(stub["frame_embeds"]), cfg,
                             impls=impls, remat=False)
        ckv = JM.compute_cross_kv_stacked(params, enc, cfg)
    cache = JM.init_body_cache(cfg, b, s + 512, jnp.float32)
    h, cache, _ = JM.forward_body(params, h, cfg, positions=positions,
                                  cache=cache, cross_kv=ckv, impls=impls,
                                  remat=False)
    out = [np.asarray(JM.lm_logits(params, h[:, -1:], cfg))[:, -1]]
    start = (int(positions[0, 0, -1]) + 1 if cfg.family == "vlm" else s)
    for i in range(STEPS):
        p = jnp.full((b, 1), start + i, jnp.int32)
        if cfg.family == "vlm":
            p = jnp.broadcast_to(p[:, None], (b, 3, 1))
        flat = p[:, 0] if p.ndim == 3 else p
        h = JM.embed_tokens(params, jnp.asarray(fed[:, i:i + 1], jnp.int32),
                            cfg, positions=flat, dtype=jnp.float32)
        h, cache, _ = JM.forward_body(params, h, cfg, positions=p,
                                      cache=cache, cross_kv=ckv, impls=impls,
                                      remat=False)
        out.append(np.asarray(JM.lm_logits(params, h, cfg))[:, -1])
    layers_ckv = None
    if ckv is not None:
        layers_ckv = [{n: np.asarray(seg[n][j]) for n in ("k", "v", "pos")}
                      for seg in ckv if seg is not None
                      for j in range(seg["k"].shape[0])]
    return np.stack(out, axis=1), layers_ckv


@pytest.fixture(scope="module")
def jax_served(worlds):
    """Each serve case through the JAX composition, fed the port's (2, 2)
    greedy tokens."""
    out = []
    for i, (kw, params, tokens, _, _, stub) in enumerate(
            worlds[0]["serves"]):
        fed = worlds[1]["2x2"][0]["serve"][i]["tokens"]
        out.append(_jax_serve(_jcfg(kw), params, tokens, stub, fed))
    return out


SERVE_MESHES = [m for m in MESHES if m.shape["model"] > 1]
SERVE_IDS = [f"{a}-{s}slots" for a, s in SERVES]


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", range(len(SERVES)), ids=SERVE_IDS)
def test_serving_matches_jax(worlds, jax_served, mesh, i):
    want, _ = jax_served[i]
    for rank in worlds[1][mesh.name]:
        got = rank["serve"][i]
        assert got["logits"].shape == want.shape
        for step in range(STEPS + 1):
            np.testing.assert_allclose(got["logits"][:, step],
                                       want[:, step], **SERVE_TOL,
                                       err_msg=f"step {step}")
        np.testing.assert_array_equal(got["tokens"], want.argmax(-1))


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", [0, 1], ids=SERVE_IDS[:2])
def test_whisper_cross_kv_on_every_model_rank(worlds, jax_served, mesh, i):
    """The cross K/V that prefill kept: every KV head on every model
    rank (the batch on `data`), the same bits on each, against the JAX
    ``compute_cross_kv_stacked``."""
    _, want = jax_served[i]
    data = mesh.shape["data"]
    for rank in worlds[1][mesh.name]:
        got = rank["serve"][i]
        assert got["cross_heads"] == [6] * len(want)
        assert all(s == ("data" if data > 1 else None, None, None, None)
                   for s in got["cross_specs"])
        assert got["cross_same_on_model_ranks"]
        for g, w in zip(got["cross"], want):
            for n in ("k", "v"):
                np.testing.assert_allclose(g[n], w[n], **SERVE_TOL)
            np.testing.assert_array_equal(g["pos"], w["pos"])


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=lambda m: m.name)
def test_whisper_self_cache_layouts(worlds, mesh):
    """(2, 2): 3 of 6 KV heads a rank. (1, 4): the 24-slot caches hold 6
    slots and every head a rank, the last two ranks' shards empty after
    the 12-token prompt (rank 3's until step 6 writes slot 18); the
    25-slot caches every slot on every rank."""
    ranks = worlds[1][mesh.name]
    if mesh.shape["model"] == 2:
        assert all(set(r["serve"][i]["kv_slots"]) == {(24 + i, 3)}
                   for r in ranks for i in (0, 1))
        return
    for r in ranks:
        assert set(r["serve"][0]["kv_slots"]) == {(6, 6)}
        assert all(s[1] == "model" for s in r["serve"][0]["kv_specs"])
        assert set(r["serve"][1]["kv_slots"]) == {(25, 6)}
    assert ranks[2]["serve"][0]["fewest_valid"][0] == 0
    assert ranks[3]["serve"][0]["fewest_valid"][:7] == [0] * 7
    assert ranks[3]["serve"][0]["fewest_valid"][7] > 0


# ---------------------------------------------------------------------------
# the cells


def _one_run(cfg, kind, seq, b, **over):
    one = Mesh(("data", "model"), (1, 1))
    return W.steps.default_run(cfg, W.ShapeConfig(kind, seq, b, kind), one,
                               attn_impl="kernel", compute_dtype="float32",
                               **over), one


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", [0, 1], ids=list(ARCHS))
def test_prefill_cell_matches_one_process(worlds, mesh, i):
    """``steps.build_prefill`` on the rule table's layout (weights' D on
    `data` as well, the batch on `data`; whisper's frames, qwen2-vl's 256
    patches): the last logits and every cache leaf, gathered, against
    the same function in one process."""
    kw, params, tokens, stub = worlds[0]["prefills"][i]
    cfg = W._config(kw)
    b, s = tokens.shape
    s += stub.get("patch_embeds", np.zeros((0, 0))).shape[1]
    run, one = _one_run(cfg, "prefill", s, b)
    fn = W.steps.build_prefill(cfg, run, one)[0]
    logits, cache = fn(W.bridge.from_repro(params),
                       {"tokens": torch.from_numpy(tokens),
                        **{k: torch.from_numpy(v) for k, v in stub.items()}})
    want = dict(zip(W.tree.paths(cache), W.tree.leaves(cache)))
    for rank in worlds[1][mesh.name]:
        got = rank["prefill"][i]
        np.testing.assert_allclose(got["logits"], W._np(logits),
                                   **SERVE_TOL)
        assert set(got["cache"]) == {p for p, x in want.items()
                                     if torch.is_tensor(x)}
        for p, x in got["cache"].items():
            np.testing.assert_allclose(x, W._np(want[p]), **SERVE_TOL,
                                       err_msg=p)


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", [0, 1], ids=list(ARCHS))
def test_decode_cell_matches_one_process(worlds, mesh, i):
    """``steps.build_decode`` (a 24-slot cache, 14 seeded; whisper's cross
    K/V seeded, every KV head; 2 steps) on its in_specs' layout (the
    serving layout, the batch on `data`, whisper's self cache
    sequence-sharded on (1, 4)): each step's logits and every cache leaf
    after them, gathered, against the same function in one process."""
    kw, params, cache, ckv, tokens, pos, n = worlds[0]["decodes"][i]
    cfg = W._config(kw)
    run, one = _one_run(cfg, "decode", CELL_SLOTS, B)
    fn = W.steps.build_decode(cfg, run, one)[0]
    cache = W.tree.map_(lambda x: x.clone() if torch.is_tensor(x) else x,
                        cache)
    p = W.bridge.from_repro(params)
    logits = []
    for s in range(n):
        out, cache = fn(p, cache, ckv, torch.from_numpy(tokens[:, s:s + 1]),
                        torch.from_numpy(pos + s))
        logits.append(W._np(out[:, -1]))
    want = dict(zip(W.tree.paths(cache), W.tree.leaves(cache)))
    for rank in worlds[1][mesh.name]:
        got = rank["decode"][i]
        np.testing.assert_allclose(got["logits"], np.stack(logits, 1),
                                   **SERVE_TOL)
        assert set(got["cache"]) == {q for q, x in want.items()
                                     if torch.is_tensor(x)}
        for q, x in got["cache"].items():
            np.testing.assert_allclose(x, W._np(want[q]), **SERVE_TOL,
                                       err_msg=q)


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", [0, 1], ids=list(ARCHS))
def test_train_cell_matches_one_process(worlds, mesh, i):
    """``steps.build_train`` (``default_run``'s RunConfig with the
    kernels, 4 clients; whisper's frames, qwen2-vl's patches) on the rule
    table's layout of its in_specs: two steps' losses and grad norms
    against the same function in one process, within 1e-4."""
    kw = worlds[0]["prefills"][i][0]
    cfg = W._config(kw)
    one = Mesh(("data", "model"), (1, 1))
    batch = W._cell_batch(kw)
    run = W._train_cell_run(cfg, one, 4, batch["tokens"].shape[-1])
    step_fn = W.steps.build_train(cfg, run, one)[0]
    params, frozen, _ = split.init_mpsl_lm(torch.Generator().manual_seed(0),
                                           cfg, run)
    state = W.mpsl.init_state(params, frozen, 0)
    want = []
    for _ in range(2):
        state, met = step_fn(state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        want.append((float(met["loss"]), float(met["grad_norm"])))
    for rank in worlds[1][mesh.name]:
        for (loss, norm), (wl, wn) in zip(rank["train_cell"][i], want):
            assert abs(loss - wl) <= LOSS_TOL * abs(wl)
            assert abs(norm - wn) <= LOSS_TOL * abs(wn)
