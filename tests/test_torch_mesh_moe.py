"""The MoE layouts of the production meshes as SPMD programs on the CPU
(gloo), against the JAX package.

Reduced qwen2-moe-a2.7b (2 MoE blocks, d_model 64, 4 heads on 4 KV heads,
qkv bias, vocab 256) with 5 experts top 2 (d_ff_expert 32) and a shared
expert (d_ff_shared 32): 5 divides neither model axis of 4 nor 2, so the
rule table lays each expert's F on `model` (wi / wg (None, data, model),
wo (None, model, data)), as it lays qwen2-moe's 60 experts on a model
axis of 8 or 16. Beside it the same with 8 experts, which lie on `model`
(2 or 4 a rank). One world of 4 ranks a mesh, (1, 4) and (2, 2) (there D
on `data` as well), each started once for the module:

  * the layer (``apply_moe``) under dense, ragged and ep: its output, aux
    and every gradient of sum(y * cot) + aux against the JAX
    ``apply_moe`` jitted under ``sharding.use_mesh`` on the same mesh of
    4 forced host devices (in a subprocess, as
    ``tests/test_torch_mesh_ep.py`` runs it: its ep is ``shard_map``'s
    where the experts divide the axis, ragged where they do not) and
    against the port in one process; the ragged dispatch over experts on
    `model` runs each (token, k) slot on exactly one rank;
  * the MPSL train step through ``steps.build_train`` (``default_run``'s
    RunConfig: its dense dispatch, and the kernel path's ragged one), 4
    clients x 2 x 12 tokens, client 1 masked: the loss, every client's
    loss and every gradient at the start, and two steps' losses and grad
    norms against the JAX ``make_lm_loss`` / ``make_train_step``; each
    step's collectives by op and axis exactly as derived from the code
    (``_step_collectives``);
  * serving: the serve CLI's prefill and 4 greedy decode steps (ragged)
    on the TP-only layout against the JAX serving functions,
    teacher-forced with the port's tokens, and the greedy tokens.

The port runs its kernels' plain versions (the kernel route on CPU
tensors); the JAX side its plain paths (naive attention, the jnp CE).
"""
import dataclasses
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
from repro.configs import MoEConfig as JMoEConfig
from repro.configs import MPSLConfig as JMPSLConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_config, reduced
from repro.core import mpsl as jmpsl
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import schedules as jsched
from repro_torch.configs import MoEConfig
from repro_torch.core import split
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe
from repro_torch.parallel import sharding

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2-moe-a2.7b"
VARIANTS = {
    # F on `model`: 5 experts divide no model axis of 2 or 4
    "f_on_model": dict(num_experts=5, top_k=2, d_ff_expert=32,
                       num_shared_experts=1, d_ff_shared=32),
    # experts on `model`
    "experts_on_model": dict(num_experts=8, top_k=2, d_ff_expert=32,
                             num_shared_experts=1, d_ff_shared=32),
}
IMPLS = ("dense", "ragged", "ep")
MESHES = [Mesh(("data", "model"), (1, 4)), Mesh(("data", "model"), (2, 2))]
# f32 sums of the same products in other orders (the all-reduces of the
# partial sums, XLA's): 2e-5 of the largest element, the JAX suite's
# ep-vs-dense limit
TOL = 2e-5
# the MPSL step (tests/test_torch_mesh_step.py): the loss 1e-4 relative,
# every gradient leaf 1e-3 in relative L2
LOSS_TOL, GRAD_L2_TOL = 1e-4, 1e-3
N, BN, S = 4, 2, 12
MASK = [1.0, 0.0, 1.0, 1.0]
# (variant, moe dispatch): default_run's dense, the kernel path's ragged
TRAINS = [("f_on_model", "dense"), ("f_on_model", "ragged"),
          ("experts_on_model", "ragged")]
# served logits: two frameworks sum the same f32 products in other orders
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_B, STEPS, SLOTS = 4, 4, 8

JAX_LAYER = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import MoEConfig, get_config, reduced
from repro.models import moe
from repro.parallel import sharding as sh
spec = json.loads(sys.argv[1])
out = {}
for name, kw in spec["variants"].items():
    data = dict(np.load(spec["inputs"][name]))
    cfg = reduced(get_config(spec["arch"]), moe=MoEConfig(**kw))
    x, cot = jnp.asarray(data.pop("x")), jnp.asarray(data.pop("cot"))
    p = {k: jnp.asarray(v) for k, v in data.items() if "." not in k}
    p["shared"] = {k.split(".")[1]: jnp.asarray(v) for k, v in data.items()
                   if k.startswith("shared.")}
    for d, m in spec["meshes"]:
        mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                    ("data", "model"))
        for impl in spec["impls"]:
            def loss(p, x, impl=impl):
                y, aux = moe.apply_moe(p, x, cfg, impl=impl)
                return (y * cot).sum() + aux, (y, aux)
            with sh.use_mesh(mesh):
                (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(p, x)
            key = f"{name}/{d}x{m}/{impl}"
            out[key + "/y"] = np.asarray(y)
            out[key + "/aux"] = np.asarray(aux)
            out[key + "/dx"] = np.asarray(gx)
            for i, g in enumerate(jax.tree_util.tree_leaves(gp)):
                out[f"{key}/g{i}"] = np.asarray(g)
np.savez(spec["out"], **out)
"""


def _cfg_kw(variant):
    return {"arch": ARCH, "moe": MoEConfig(**VARIANTS[variant])}


def _jcfg(variant):
    return reduced(get_config(ARCH), moe=JMoEConfig(**VARIANTS[variant]))


def _layer_inputs(variant):
    cfg = W._config(_cfg_kw(variant))
    params = W.bridge.to_repro(moe.init_moe(
        torch.Generator().manual_seed(0), cfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, cfg.d_model), dtype=np.float32)
    cot = rng.standard_normal((2, 16, cfg.d_model), dtype=np.float32)
    return params, x, cot


def _flat_npz(params, x, cot):
    out = {"x": x, "cot": cot}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}.{j}": w for j, w in v.items()})
        else:
            out[k] = v
    return out


def _batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (N, BN, S)),
            "labels": rng.integers(0, cfg.vocab_size, (N, BN, S)),
            "mask": np.asarray(MASK, np.float32)}


def _serve_inputs(variant):
    cfg = W._config(_cfg_kw(variant))
    params = W.bridge.to_repro(W.M.init_lm(cfg,
                                           torch.Generator().manual_seed(5)))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               (SERVE_B, S))
    return params, tokens


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    layers = {v: _layer_inputs(v) for v in VARIANTS}
    inputs = {}
    for v, (params, x, cot) in layers.items():
        inputs[v] = str(tmp / f"{v}.npz")
        np.savez(inputs[v], **_flat_npz(params, x, cot))
    spec = {"arch": ARCH, "variants": VARIANTS, "inputs": inputs,
            "impls": list(IMPLS), "out": str(tmp / "jax.npz"),
            "meshes": [list(m.axis_sizes) for m in MESHES]}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_LAYER,
                                 json.dumps(spec)], env=env,
                                stderr=subprocess.PIPE, text=True)
    layer_args = [(_cfg_kw(v), *layers[v], impl)
                  for v in VARIANTS for impl in IMPLS]
    train_args = [(_cfg_kw(v), impl, _batch(W._config(_cfg_kw(v))), 0)
                  for v, impl in TRAINS]
    serves = {v: _serve_inputs(v) for v in VARIANTS}
    serve_args = [(_cfg_kw(v), *serves[v], STEPS, SLOTS) for v in VARIANTS]
    out = {}
    for mesh in MESHES:
        res = spmd.spawn(W.moe_cases, mesh, "cpu", 300, args=(
            [mesh], layer_args, train_args, serve_args),
            workdir=tmp_path_factory.mktemp(mesh.name))
        out[mesh.name] = [r[mesh.name] for r in res]
    _, err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, err[-3000:]
    return ({"layers": layers, "trains": train_args, "serves": serves},
            out, dict(np.load(tmp / "jax.npz")))


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                             or 1.0)
    assert err <= TOL, f"{what}: {err:.3g} of the largest element"


def _layer_index(variant, impl):
    return list(VARIANTS).index(variant) * len(IMPLS) + IMPLS.index(impl)


# ---------------------------------------------------------------------------
# the layer


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_layer_matches_jax(worlds, mesh, variant, impl):
    _, out, jax_out = worlds
    key = f"{variant}/{mesh.name}/{impl}"
    for rank in out[mesh.name]:
        r = rank["layer"][_layer_index(variant, impl)]
        _close(r["y"], jax_out[key + "/y"], "y")
        assert abs(r["aux"] - float(jax_out[key + "/aux"])) <= \
            TOL * abs(float(jax_out[key + "/aux"]))
        _close(r["dx"], jax_out[key + "/dx"], "dx")
        for i, g in enumerate(r["grads"]):
            _close(g, jax_out[f"{key}/g{i}"], f"gradient leaf {i}")


def _one_process(variant, impl, mesh):
    """The layer in one process (ep under `mesh` as a record: every
    device's share computed and added, the same capacity)."""
    cfg = W._config(_cfg_kw(variant))
    params, x, cot = _layer_inputs(variant)
    p = W.bridge.from_repro(params)
    leaves = W.tree.leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    with sharding.use_mesh(mesh if impl == "ep" else None):
        y, aux = moe.apply_moe(p, xt, cfg, impl=impl)
    ((y * torch.from_numpy(cot)).sum() + aux).backward()
    return y.detach().numpy(), float(aux.detach()), xt.grad.numpy(), \
        [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_layer_matches_one_process(worlds, mesh, variant, impl):
    y, aux, dx, grads = _one_process(variant, impl, mesh)
    for rank in worlds[1][mesh.name]:
        r = rank["layer"][_layer_index(variant, impl)]
        _close(r["y"], y, "y")
        assert abs(r["aux"] - aux) <= TOL * abs(aux)
        _close(r["dx"], dx, "dx")
        assert len(r["grads"]) == len(grads)
        for i, (g, w) in enumerate(zip(r["grads"], grads)):
            _close(g, w, f"gradient leaf {i}")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_layer_layout_and_slots(worlds, mesh, variant):
    """The rule table's layout of each variant, and the ragged dispatch
    over experts on `model`: each (token, k) slot run by exactly one model
    rank (nothing dropped); over each expert's F every rank runs every
    slot (no share of the experts, no such record)."""
    d, m = mesh.axis_sizes
    e = VARIANTS[variant]["num_experts"]
    for rank in worlds[1][mesh.name]:
        r = rank["layer"][_layer_index(variant, "ragged")]
        wi, wo = r["specs"]["wi"], r["specs"]["wo"]
        if e % m:
            assert wi == (None, "data" if d > 1 else None, "model")
            assert wo == (None, "model", "data" if d > 1 else None)
            assert r["ran"] == []
        else:
            assert wi[0] == "model" and wo[0] == "model"
            assert len(r["ran"]) == 1
            assert r["ran"][0].shape == (2 * 16, 2)
            np.testing.assert_array_equal(r["ran"][0], 1)


# ---------------------------------------------------------------------------
# the MPSL step through steps.build_train


def _jrun(variant, impl):
    """The JAX RunConfig of the port's train cell (``default_run``'s, on
    one rank), on the JAX package's plain paths."""
    cfg = W._config(_cfg_kw(variant))
    prun = W._train_cell_run(cfg, Mesh(("data", "model"), (1, 1)), N, S,
                             moe_impl=impl)
    assert prun.microbatches == 1
    fields = {f: getattr(prun, f) for f in prun.__dataclass_fields__
              if f not in ("model", "shape", "mpsl")}
    fields.update(attn_impl="naive", ce_impl="jnp", ssm_impl="jnp")
    return JRunConfig(model=_jcfg(variant),
                      shape=JShapeConfig("train", S, 2 * N, "train"),
                      mpsl=JMPSLConfig(**dataclasses.asdict(prun.mpsl)), **fields)


def _jbatch(b):
    return {"tokens": jnp.asarray(b["tokens"], jnp.int32),
            "labels": jnp.asarray(b["labels"], jnp.int32),
            "mask": jnp.asarray(b["mask"])}


def _flat(t):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(
        W.bridge.from_repro(jax.tree_util.tree_map(np.asarray, t)))]


@pytest.fixture(scope="module")
def jax_trains(worlds):
    out = []
    for (variant, impl), (kw, _, batch, seed) in zip(TRAINS,
                                                     worlds[0]["trains"]):
        cfg = W._config(kw)
        run = _jrun(variant, impl)
        prun = W._train_cell_run(cfg, Mesh(("data", "model"), (1, 1)), N, S,
                                 moe_impl=impl)
        params, frozen, _ = split.init_mpsl_lm(
            torch.Generator().manual_seed(seed), cfg, prun)
        params, frozen = W.bridge.to_repro(params), W.bridge.to_repro(frozen)
        loss_fn = jmpsl.make_lm_loss(run.model, run)
        step = jax.jit(jmpsl.make_train_step(
            loss_fn, run, jsched.warmup_cosine(run.learning_rate, 100,
                                               10_000)))
        state = jmpsl.init_state(params, frozen, seed)
        jb = _jbatch(batch)
        (loss, met), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, frozen, jb,
                                    jax.random.PRNGKey(0))
        rec = {"loss": float(loss), "per_client": np.asarray(met["per_client"]),
               "grads": _flat(grads), "steps": []}
        for _ in range(2):
            state, smet = step(state, jb)
            rec["steps"].append((float(smet["loss"]),
                                 float(smet["grad_norm"])))
        out.append(rec)
    return out


def _rel_l2(got, want):
    den = float(np.linalg.norm(want)) or 1.0
    return float(np.linalg.norm(np.asarray(got) - want)) / den


@pytest.mark.parametrize("i", range(len(TRAINS)),
                         ids=[f"{v}-{impl}" for v, impl in TRAINS])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_train_step_matches_jax(worlds, jax_trains, mesh, i):
    want = jax_trains[i]
    for rank in worlds[1][mesh.name]:
        r = rank["train"][i]
        assert abs(r["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        np.testing.assert_allclose(r["per_client"], want["per_client"],
                                   rtol=LOSS_TOL)
        assert len(r["grads"]) == len(want["grads"])
        for j, (g, w) in enumerate(zip(r["grads"], want["grads"])):
            assert _rel_l2(g, w) <= GRAD_L2_TOL, f"gradient leaf {j}"
        for (loss, norm), (wl, wn) in zip(
                [(s["loss"], s["grad_norm"]) for s in r["steps"]],
                want["steps"]):
            assert abs(loss - wl) <= LOSS_TOL * abs(wl)
            assert abs(norm - wn) <= LOSS_TOL * abs(wn)


def _step_collectives(cfg, d, m, trainable=1):
    """The collectives of one MPSL step of an MoE LM on (data d, model m)
    (H and K divide m: heads on `model`), from the code, with block remat
    (the recompute stops at the block's last saved tensor, before its
    final reduction), L blocks of which T trainable:

      the ends: the lookup (ids gathered and rows reduce-scattered over
      `data`, columns gathered over `model`), the lm_head's D gathered and
      its gradient reduce-scattered, the vocab-parallel CE (lse gathered,
      the gold logit and dh all-reduced over `model`), the metrics (every
      client's loss gathered, the mask's sum, L_S and the participating
      count all-reduced over `data`), the global norm (world);
      a block over `model`: attention's output in the forward and the
      recompute, x's gradient entering it (3); the MoE's partial sums once
      (the routed experts' and the shared expert's joined), the gradients
      of the tokens and the combine weights entering the routed experts,
      of x entering the shared expert and of its gate (5);
      over `data`: 12 weights gathered in the forward and again in the
      recompute (wq, wk, wv, wo, the router, wi, wg, wo, the shared
      expert's three, shared_gate), the trainable ones reduce-scattered;
      the router's expert density and mean probability summed (forward
      and recompute: 4); the trainable blocks' 2 norms and 3 qkv biases
      and the final norm all-reduced by ``reduce_grads``."""
    L, T = cfg.num_layers, trainable
    rows, vp = cfg.vocab_size % d == 0, cfg.vocab_size % m == 0
    out = {"all_gather/data": rows + 2 + 24 * L,
           "reduce_scatter/data": rows + 1 + 12 * T,
           "all_reduce/data": 3 + 4 * L + 5 * T + 1,
           "all_gather/model": 1 + vp,
           "all_reduce/model": 2 * vp + 8 * L,
           "all_reduce/world": 1}
    sizes = {"data": d, "model": m}
    return {k: v for k, v in out.items()
            if k.endswith("/world") or sizes[k.split("/")[1]] > 1}


@pytest.mark.parametrize("i", range(len(TRAINS)),
                         ids=[f"{v}-{impl}" for v, impl in TRAINS])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_step_collectives(worlds, mesh, i):
    cfg = W._config(worlds[0]["trains"][i][0])
    want = _step_collectives(cfg, *mesh.axis_sizes)
    for rank in worlds[1][mesh.name]:
        for s in rank["train"][i]["steps"]:
            assert {k: v["calls"] for k, v in s["counts"].items()} == want


# ---------------------------------------------------------------------------
# serving


@pytest.fixture(scope="module")
def jax_served(worlds):
    """The JAX serving functions on each variant's params, teacher-forced
    with the (1, 4) world's greedy tokens."""
    impls = {"attn": "naive", "moe": "ragged"}
    out = {}
    for v, (params, tokens) in worlds[0]["serves"].items():
        cfg = _jcfg(v)

        def prefill(params, tokens, cfg=cfg):
            b, s = tokens.shape
            cache = JM.init_body_cache(cfg, b, s + SLOTS, jnp.float32)
            h = JM.embed_tokens(params, tokens, cfg, dtype=jnp.float32)
            h, cache, _ = JM.forward_body(
                params, h, cfg, positions=JL.positions_from_shape(b, s),
                cache=cache, impls=impls, remat=False)
            return JM.lm_logits(params, h[:, -1:], cfg), cache

        def decode(params, cache, tokens, positions, cfg=cfg):
            h = JM.embed_tokens(params, tokens, cfg, positions=positions,
                                dtype=jnp.float32)
            h, cache, _ = JM.forward_body(params, h, cfg,
                                          positions=positions, cache=cache,
                                          impls=impls, remat=False)
            return JM.lm_logits(params, h, cfg), cache

        i = list(VARIANTS).index(v)
        fed = worlds[1]["1x4"][0]["serve"][i]["tokens"]
        logits, cache = jax.jit(prefill)(params,
                                         jnp.asarray(tokens, jnp.int32))
        ref = [np.asarray(logits[:, -1])]
        step = jax.jit(decode)
        for j in range(STEPS):
            pos = jnp.full((SERVE_B, 1), S + j, jnp.int32)
            logits, cache = step(params, cache,
                                 jnp.asarray(fed[:, j:j + 1], jnp.int32), pos)
            ref.append(np.asarray(logits[:, -1]))
        out[v] = np.stack(ref, axis=1)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_serving_matches_jax(worlds, jax_served, mesh, variant):
    want = jax_served[variant]
    i = list(VARIANTS).index(variant)
    for rank in worlds[1][mesh.name]:
        out = rank["serve"][i]
        assert out["logits"].shape == want.shape
        for step in range(STEPS + 1):
            np.testing.assert_allclose(out["logits"][:, step], want[:, step],
                                       **SERVE_TOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(out["tokens"], want.argmax(-1))
