"""The Mamba and hybrid families as SPMD programs on the CPU (gloo), against
the JAX package.

Reduced falcon-mamba-7b (2 Mamba blocks, d_model 64, d_inner 128,
d_state 4, vocab 256: the vocab-parallel CE) and reduced hymba-1.5b (3
hybrid blocks, one global and two sliding-window; 5 query heads on 1 KV
head, so neither count divides a model axis of 2 or 4 and the rule
table takes its fallbacks: D on (data, model) for every attention weight
and the KV cache's slots on `model`; vocab 257, which divides no axis,
so the LM head lies on `data` alone and the CE runs whole on each model
rank); beside it hymba-1.5b as ``reduced`` makes it (4 query heads on 1
KV head: the query heads on `model`, wk / wv on D, the cache
sequence-sharded: ``attention.model_layout``'s "mixed") for the block,
the step and serving. One world of 4 ranks, started once for the module,
runs every case on the meshes (2, 2), (1, 4) and (4, 1):

  * the shard of every leaf on every rank against the JAX
    ``NamedSharding`` shard of the rule table's spec on 4 forced host
    devices (in a subprocess: this process's JAX has one device); Mamba's
    in_proj, which the port cuts section by section (x's and z's channel
    slice r on model rank r), against that cut; the gathered tree bitwise
    the whole one;
  * one Mamba block and one hybrid block, the batch on `data`, forward
    and every gradient against the JAX ``apply_block`` (its plain paths);
  * the MPSL step of each arch (4 clients x 2 x 12 tokens, client 1
    masked, both links int8 on the JAX draws, the last block trainable):
    the loss, every gradient and one AdamW step against the JAX
    ``make_lm_loss`` / ``make_train_step``; the MPSL properties across
    ranks (the masked client's adapter gradient exactly 0, a client's
    gradient bitwise unchanged when another data rank's client changes
    its tokens);
  * serving on (1, 4) and (2, 2): prefill and 8 greedy steps against the
    JAX serving functions teacher-forced with the port's tokens, hymba's
    caches sequence-sharded (some rank's shard holds only empty slots at
    some steps), the prompt within the window (ROADMAP.md Queue 3);
  * the merged decode attention over a sequence-sharded cache with an
    empty shard against one unsharded attention;
  * ``steps.build_prefill`` and ``build_train`` on (1, 4) and (2, 2)
    (the rule table's layout, weights' D on `data` as well) against the
    one-process cells: the last logits and every cache leaf, gathered;
    two steps' losses and grad norms.

The port runs its kernels' plain versions (the kernel route on CPU
tensors); the JAX side runs unsharded on its plain paths (naive
attention, the jnp scan and CE).
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
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.optim import schedules as jsched
from repro.parallel import sharding as jsharding
from repro_torch.core import split
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM

ROOT = pathlib.Path(__file__).resolve().parents[1]
FALCON = {"arch": "falcon-mamba-7b"}
HYMBA = {"arch": "hymba-1.5b", "num_layers": 3, "num_heads": 5,
         "num_kv_heads": 1, "vocab_size": 257}
# reduced hymba-1.5b as ``reduced`` makes it: 4 query heads on 1 KV head,
# the query heads divide the model axis and the KV head does not (the
# "mixed" layout of ``attention.model_layout``)
HYMBA_MIXED = {"arch": "hymba-1.5b", "num_layers": 3}
ARCHS = {"falcon-mamba-7b": FALCON, "hymba-1.5b": HYMBA}
MODELS = {**ARCHS, "hymba-mixed": HYMBA_MIXED}
KINDS = {"falcon-mamba-7b": "ssm", "hymba-1.5b": "hybrid",
         "hymba-mixed": "hybrid"}
MESHES = [Mesh(("data", "model"), (2, 2)), Mesh(("data", "model"), (1, 4)),
          Mesh(("data", "model"), (4, 1))]
N, BN, S = 4, 2, 12
MASK = [1.0, 0.0, 1.0, 1.0]
LR = 1e-3
# one block: f32 sums in other orders (the model axis's partial sums
# added by the all-reduce): outputs within 1e-5, each gradient leaf 1e-4
# in relative L2
BLOCK_ATOL, BLOCK_GRAD_L2 = 1e-5, 1e-4
B, BS = 4, 12
# the MPSL step: tests/test_torch_mesh_step.py's limits
LOSS_TOL, GRAD_L2_TOL = 1e-4, 1e-3
# served logits (tests/test_torch_serve.py's limit)
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_B, SERVE_S, STEPS, SLOTS = 4, 12, 8, 12
# XLA's CPU backend without its costly LLVM passes (tests/test_torch_steps.py)
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def _jit(fn):
    return jax.jit(fn, compiler_options=FAST_XLA)


def _jcfg(kw):
    kw = dict(kw)
    return reduced(get_config(kw.pop("arch")), **kw)


def _trees():
    """Each arch's whole params, as the JAX package lays them out (the
    port's init, through the bridge)."""
    return {a: W.bridge.to_repro(TM.init_lm(W._config(kw),
                                     torch.Generator().manual_seed(0)))
            for a, kw in ARCHS.items()}


def _blocks():
    """(cfg_kw, kind, params, x, pos, cot) of a Mamba and a hybrid block,
    with nonzero norm scales (and betas) so their gradients are held."""
    out = []
    for name, kw in MODELS.items():
        kind = KINDS[name]
        cfg = W._config(kw)
        gen = torch.Generator().manual_seed(3)
        params = TM.init_block(gen, cfg, TM.BlockKind(kind))
        for path, leaf in zip(W.tree.paths(params), W.tree.leaves(params)):
            if "norm" in path or "beta" in path:
                leaf.add_(torch.randn(leaf.shape, generator=gen) * 0.1)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((B, BS, cfg.d_model), dtype=np.float32)
        cot = rng.standard_normal((B, BS, cfg.d_model), dtype=np.float32)
        pos = np.broadcast_to(np.arange(BS, dtype=np.int32), (B, BS)).copy()
        out.append((kw, kind, W.bridge.to_repro(params), x, pos, cot))
    return out


def _mpsl_trees(kw):
    cfg = W._config(kw)
    run = W._port_run(cfg, N, True)
    gen = torch.Generator().manual_seed(0)
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run)
    params["client"]["adapter"]["b"].normal_(0.0, 0.05, generator=gen)
    return W.bridge.to_repro(params), W.bridge.to_repro(frozen)


def _batch(seed, vocab, mask=MASK):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (N, BN, S)),
            "labels": rng.integers(0, vocab, (N, BN, S)),
            "mask": np.asarray(mask, np.float32)}


def _draws(d_model):
    """The uniforms the JAX step draws at step 0 of a state seeded 9."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 0),
                             1)
    r_up, r_down = jax.random.split(key)
    shape = (N, BN, S, d_model)
    return {"uplink": np.array(jax.random.uniform(r_up, shape)),
            "downlink": np.array(jax.random.uniform(r_down, shape))}


def _prop_args(kw, params, frozen, vocab):
    b1 = _batch(12, vocab)
    b2 = {k: v.copy() for k, v in b1.items()}
    b2["tokens"][3] = (b2["tokens"][3] + 7) % vocab   # another data rank's
    return [(kw, params, frozen, [b1, b2])]


def _serve_inputs(kw):
    cfg = W._config(kw)
    params = W.bridge.to_repro(TM.init_lm(cfg, torch.Generator().manual_seed(5)))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               (SERVE_B, SERVE_S))
    return params, tokens


def _merge_case(window):
    """q of 5 heads over a 24-slot cache of 1 KV head: row 0 holds valid
    slots 0..13 (the last two model-4 shards hold none), row 1 every
    third slot of 0..11 (its second model-2 shard holds none)."""
    rng = np.random.default_rng(21)
    q = rng.standard_normal((2, 1, 5, 16), dtype=np.float32)
    k = rng.standard_normal((2, 24, 1, 16), dtype=np.float32)
    v = rng.standard_normal((2, 24, 1, 16), dtype=np.float32)
    k_pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    valid = np.zeros((2, 24), bool)
    valid[0, :14] = True
    valid[1, 0:12:3] = True
    q_pos = np.full((2, 1), 23, np.int32)
    return q, k, v, q_pos, k_pos, valid, window


MERGES = [_merge_case(0), _merge_case(16)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    trees = _trees()
    steps_args, props, serves = [], [], []
    for kw in MODELS.values():
        cfg = W._config(kw)
        params, frozen = _mpsl_trees(kw)
        steps_args.append((kw, params, frozen, _batch(4, cfg.vocab_size),
                           _draws(cfg.d_model), LR))
        props.append(_prop_args(kw, params, frozen, cfg.vocab_size))
        serves.append((kw, *_serve_inputs(kw), STEPS, SLOTS))
    prefills = [(kw, params, tokens) for kw, params, tokens, _, _ in serves]
    res = spmd.spawn(W.ssm_cases, MESHES[0], "cpu", 300, args=(
        MESHES, trees, _blocks(), steps_args, props, serves, MERGES,
        prefills), workdir=tmp_path_factory.mktemp("ssm"))
    out = {m.name: [r[m.name] for r in res] for m in MESHES}
    return {"trees": trees, "steps": steps_args, "serves": serves}, out


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


def _paired_cut(whole, coords, mesh):
    """in_proj [D, 2 di]: D cut over `data`, x's and z's channels each cut
    over `model` (slice r of each on model rank r)."""
    d, m = mesh.shape["data"], mesh.shape["model"]
    rows = whole.shape[0] // d
    w = whole[coords["data"] * rows:(coords["data"] + 1) * rows]
    x, z = np.split(w, 2, axis=1)
    c = x.shape[1] // m
    j = coords["model"]
    return np.concatenate([x[:, j * c:(j + 1) * c], z[:, j * c:(j + 1) * c]],
                          axis=1)


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
        coords = mesh.coords(rank)
        for path, local, full, spec in zip(paths, sh["local"], whole,
                                           sh["specs"]):
            on |= {a for e in spec if e
                   for a in ((e,) if isinstance(e, str) else e)}
            parts = path.split("/")
            if parts[0] == "segments":
                jpath, layer = "/".join(parts[:2] + parts[3:]), int(parts[2])
            else:
                jpath, layer = path, None
            if parts[-1] == "in_proj":
                np.testing.assert_array_equal(
                    local, _paired_cut(full, coords, mesh), err_msg=path)
                continue
            idx = jax_shards[f"{arch}/{mesh.name}/{jpath}"][str(rank)]
            want = jleaves[jpath][tuple(slice(a, b) for a, b in idx)]
            if layer is not None:
                want = want[layer]
            np.testing.assert_array_equal(local, want, err_msg=path)
    assert {a for a, n in mesh.shape.items() if n > 1} <= on


def test_hymba_takes_the_fallbacks(worlds):
    """On (2, 2) hymba's attention weights lie D on (data, model), its
    lm_head on `data` alone; falcon's in_proj is Paired."""
    inputs, out = worlds
    specs = dict(zip(W.tree.paths(W.bridge.from_repro(
        inputs["trees"]["hymba-1.5b"])),
        out["2x2"][0]["shards"]["hymba-1.5b"]["specs"]))
    assert specs["segments/0/0/mix/attn/wq"] == (("data", "model"), None,
                                                 None)
    assert specs["segments/0/0/mix/attn/wo"] == (None, None,
                                                 ("data", "model"))
    assert specs["lm_head"] == ("data", None)
    assert specs["embed/table"] == (None, "model")
    fspecs = out["2x2"][0]["shards"]["falcon-mamba-7b"]["specs"]
    paired = [s for s in fspecs if any(getattr(e, "sections", 1) == 2
                                       for e in s)]
    assert len(paired) == 2 and paired[0] == ("data", "model")


# ---------------------------------------------------------------------------
# one block


@pytest.fixture(scope="module")
def jax_blocks():
    out = []
    for kw, kind, params, x, pos, cot in _blocks():
        cfg = _jcfg(kw)

        def f(p, x, cfg=cfg, kind=kind, pos=pos):
            y, _, _ = JM.apply_block(p, x, cfg, JM.BlockKind(kind),
                                     positions=jnp.asarray(pos),
                                     impls={"attn": "naive", "ssm": "jnp"})
            return y

        def fwd_bwd(p, x, cot, f=f):
            y, vjp = jax.vjp(f, p, x)
            return (y, *vjp(cot))

        y, gp, gx = _jit(fwd_bwd)(params, jnp.asarray(x), jnp.asarray(cot))
        out.append({"y": np.asarray(y), "dx": np.asarray(gx),
                    "grads": _flat(gp)})
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", [0, 1, 2], ids=list(MODELS))
def test_block_matches_jax(worlds, jax_blocks, mesh, i):
    want = jax_blocks[i]
    for rank in worlds[1][mesh.name]:
        b = rank["blocks"][i]
        np.testing.assert_allclose(b["y"], want["y"], atol=BLOCK_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(b["dx"], want["dx"], atol=BLOCK_ATOL,
                                   rtol=0)
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
                     ce_impl="jnp", ssm_impl="jnp", ssm_chunk=16)


def _jbatch(b):
    return {"tokens": jnp.asarray(b["tokens"], jnp.int32),
            "labels": jnp.asarray(b["labels"], jnp.int32),
            "mask": jnp.asarray(b["mask"])}


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
@pytest.mark.parametrize("i", [0, 1, 2], ids=list(MODELS))
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
@pytest.mark.parametrize("i", [0, 1, 2], ids=list(MODELS))
def test_mpsl_properties_across_ranks(worlds, mesh, i):
    """The masked client's adapter gradient is exactly 0 (every mesh);
    with a data axis above 1, client 3 (the last data rank's) changing
    its tokens leaves every other client's gradient bitwise unchanged."""
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
        g1, g2 = rank["props"][i][0]
        for k in ("a", "b"):
            a = g1["adapter"][f"client/adapter/{k}"]
            b = g2["adapter"][f"client/adapter/{k}"]
            assert float(np.abs(a[3] - b[3]).max()) > 0
            for c in (0, 1, 2):
                np.testing.assert_array_equal(a[c], b[c])


# ---------------------------------------------------------------------------
# serving


@pytest.fixture(scope="module")
def jax_served(worlds):
    """The JAX serving functions (naive attention, the jnp scan), each
    decode step fed the port's (2, 2) greedy token."""
    out = []
    for i, (kw, params, tokens, steps_, _) in enumerate(worlds[0]["serves"]):
        cfg = _jcfg(kw)
        prefill, decode = jserve.build_serving_fns(cfg, jnp.float32)
        fed = worlds[1]["2x2"][0]["serve"][i]["tokens"]
        logits, cache = prefill(params, jnp.asarray(tokens, jnp.int32))
        ref = [np.asarray(logits[:, -1])]
        for s in range(steps_):
            pos = jnp.full((SERVE_B, 1), SERVE_S + s, jnp.int32)
            logits, cache = decode(params, cache,
                                   jnp.asarray(fed[:, s:s + 1], jnp.int32),
                                   pos)
            ref.append(np.asarray(logits[:, -1]))
        out.append(np.stack(ref, axis=1))
    return out


SERVE_MESHES = [m for m in MESHES if m.shape["model"] > 1]


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", [0, 1, 2], ids=list(MODELS))
def test_serving_matches_jax(worlds, jax_served, mesh, i):
    want = jax_served[i]
    for rank in worlds[1][mesh.name]:
        got = rank["serve"][i]
        assert got["logits"].shape == want.shape
        for step in range(STEPS + 1):
            np.testing.assert_allclose(got["logits"][:, step],
                                       want[:, step], **SERVE_TOL,
                                       err_msg=f"step {step}")
        np.testing.assert_array_equal(got["tokens"], want.argmax(-1))


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=lambda m: m.name)
def test_hymba_cache_is_sequence_sharded(worlds, mesh):
    """Every KV cache holds 1/m of the prompt + decode slots and every
    head; on (1, 4) the last rank's shards hold only empty slots until
    step 7 (slots 18..23, written from step 6 on)."""
    m = mesh.shape["model"]
    ranks = [r["serve"][1] for r in worlds[1][mesh.name]]
    for r in ranks:
        assert set(r["kv_slots"]) == {((SERVE_S + SLOTS) // m, 1)}
        assert all(s[1] == "model" for s in r["kv_specs"])
    if m == 4:
        assert ranks[3]["fewest_valid"][:7] == [0] * 7
        assert ranks[3]["fewest_valid"][7] > 0


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("case", [0, 1], ids=["causal", "window16"])
def test_merged_attention_with_an_empty_shard(worlds, mesh, case):
    q, k, v, q_pos, k_pos, valid, window = MERGES[case]
    t = torch.from_numpy
    want, _ = fa.flash_attention_plain(t(q), t(k), t(v), t(q_pos), t(k_pos),
                                       causal=True, window=window,
                                       k_valid=t(valid))
    held = [n for r in worlds[1][mesh.name]
            for n in r["merged"][case]["valid_here"]]
    assert 0 in held                 # some rank holds no key of some row
    for r in worlds[1][mesh.name]:
        np.testing.assert_allclose(r["merged"][case]["o"], want.numpy(),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=lambda m: m.name)
@pytest.mark.parametrize("i", [0, 1, 2], ids=list(MODELS))
def test_prefill_cell_matches_one_process(worlds, mesh, i):
    """``steps.build_prefill`` on the rule table's layout (weights' D on
    `data` as well, the batch on `data`): the last logits and every
    cache leaf, gathered, against the same function in one process (no
    program): K/V over every slot, the SSM states over every channel."""
    kw, params, tokens, _, _ = worlds[0]["serves"][i]
    cfg = W._config(kw)
    b, s = tokens.shape
    one = Mesh(("data", "model"), (1, 1))
    run = W.steps.default_run(cfg, W.ShapeConfig("prefill", s, b, "prefill"),
                              one, attn_impl="kernel", ssm_impl="kernel",
                              compute_dtype="float32")
    fn = W.steps.build_prefill(cfg, run, one)[0]
    logits, cache = fn(W.bridge.from_repro(params),
                       {"tokens": torch.from_numpy(tokens)})
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
@pytest.mark.parametrize("i", [0, 1, 2], ids=list(MODELS))
def test_train_cell_matches_one_process(worlds, mesh, i):
    """``steps.build_train`` (``default_run``'s RunConfig with the
    kernels, 4 clients) on the rule table's layout of its in_specs: two
    steps' losses and grad norms against the same function in one
    process, within 1e-4."""
    kw = worlds[0]["serves"][i][0]
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
