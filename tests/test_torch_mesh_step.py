"""The MPSL step and serving as SPMD programs on the CPU (gloo), against
the JAX package.

Reduced minitron-4b (2 layers, 4 heads on 2 KV heads, vocab 256), 4
clients x 2 sequences x 12 tokens, client 1 masked out, both links int8
(the port fed the JAX loss's ``jax.random.uniform`` draws, each data rank
its clients'), the last block trainable. Two worlds, started once for the
module: 2 ranks on the mesh (2, 1) (clients over `data`), 4 on (2, 2)
(and heads, d_ff and vocab over `model`):

  * the loss, every gradient (gathered) and one ``make_train_step`` (loss,
    grad norm, AdamW's moments and count, the params) against the JAX
    ``make_lm_loss`` / ``make_train_step``;
  * the MPSL properties across ranks: the masked client's adapter
    gradient is exactly zero, a client's adapter gradient does not move
    when another data rank's client changes its tokens (bitwise), and
    dropping a client renormalizes the weights;
  * at (2, 2), prefill plus 4 greedy decode steps of ``launch.serve`` on
    the TP-only serving layout (batch 4 over `data`) against the JAX
    serving functions (Pallas attention in interpret mode), teacher-forced
    with the port's tokens, and the greedy tokens (argmax over the vocab
    shards).
"""
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
from repro_torch.core import split
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh

CFG_KW = {"num_kv_heads": 2}
N, BN, S = 4, 2, 12
MASK = [1.0, 0.0, 1.0, 1.0]
LR = 1e-3
# limits: the loss 1e-4 relative, every gradient leaf and
# AdamW moment 1e-3 in relative L2 (the int8 downlink quantizes a
# cotangent that differs by float noise: a few elements round to the
# neighbouring level)
LOSS_TOL, GRAD_L2_TOL = 1e-4, 1e-3
# served logits: two frameworks sum the same f32 products in other
# orders (tests/test_torch_serve.py's limit)
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_B, SERVE_S, STEPS = 4, 12, 4
MESHES = [Mesh(("data", "model"), (2, 1)), Mesh(("data", "model"), (2, 2))]


def _jcfg():
    return reduced(get_config("minitron-4b"), **CFG_KW)


def _jrun(cfg):
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=True, compress_downlink=True)
    return RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                     compute_dtype="float32", attn_impl="pallas",
                     ce_impl="pallas")


def _trees():
    """The MPSL trees (the port's init, a nonzero adapter b so that its
    'a' gets a gradient), as the JAX package lays them out."""
    cfg = W.port_config("minitron-4b", **CFG_KW)
    run = W._port_run(cfg, N, True)
    gen = torch.Generator().manual_seed(0)
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run)
    params["client"]["adapter"]["b"].normal_(0.0, 0.05, generator=gen)
    return W.bridge.to_repro(params), W.bridge.to_repro(frozen)


def _batch(seed, mask=MASK):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (N, BN, S)),
            "labels": rng.integers(0, 256, (N, BN, S)),
            "mask": np.asarray(mask, np.float32)}


def _jbatch(b):
    return {"tokens": jnp.asarray(b["tokens"], jnp.int32),
            "labels": jnp.asarray(b["labels"], jnp.int32),
            "mask": jnp.asarray(b["mask"])}


def _draws(d_model):
    """The uniforms the JAX step draws at step 0 of a state seeded 9."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 0),
                             1)
    r_up, r_down = jax.random.split(key)
    shape = (N, BN, S, d_model)
    return {"uplink": np.array(jax.random.uniform(r_up, shape)),
            "downlink": np.array(jax.random.uniform(r_down, shape))}


def _prop_args(params, frozen):
    b1 = _batch(12)
    b2 = {k: v.copy() for k, v in b1.items()}
    b2["tokens"][3] = (b2["tokens"][3] + 7) % 256    # another data rank's
    same = _batch(14)
    for k in ("tokens", "labels"):
        same[k] = np.broadcast_to(same[k][:1], same[k].shape).copy()
    drop = dict(same, mask=np.asarray(MASK, np.float32))
    zero_b = {**params, "client": {"adapter": dict(
        params["client"]["adapter"],
        b=np.zeros_like(params["client"]["adapter"]["b"]))}}
    return [(CFG_KW, params, frozen, [b1, b2]),
            (CFG_KW, zero_b, frozen, [same, drop])]


def _serve_inputs():
    cfg = W.port_config("minitron-4b", **CFG_KW)
    params = W.bridge.to_repro(W.M.init_lm(
        cfg, torch.Generator().manual_seed(5)))
    tokens = np.random.default_rng(5).integers(0, 256, (SERVE_B, SERVE_S))
    return params, tokens


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    params, frozen = _trees()
    batch = _batch(4)
    step_args = (CFG_KW, params, frozen, batch, _draws(64), LR)
    serve_params, tokens = _serve_inputs()
    out = {}
    for mesh in MESHES:
        res = spmd.spawn(W.step_cases, mesh, "cpu", 120, args=(
            [mesh], step_args, _prop_args(params, frozen),
            (CFG_KW, serve_params, tokens, STEPS)),
            workdir=tmp_path_factory.mktemp(mesh.name))
        out[mesh.name] = [r[mesh.name] for r in res]
    return (params, frozen, batch, serve_params, tokens), out


@pytest.fixture(scope="module")
def jax_step(worlds):
    params, frozen, batch = worlds[0][:3]
    cfg = _jcfg()
    run = _jrun(cfg)
    loss_fn = jmpsl.make_lm_loss(cfg, run)
    rng = jax.random.fold_in(jax.random.PRNGKey(9), 0)
    (loss, met), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, frozen, _jbatch(batch), rng)
    state = jmpsl.init_state(params, frozen, seed=9)
    step = jmpsl.make_train_step(loss_fn, run, jsched.constant(LR))
    new, smet = jax.jit(step)(state, _jbatch(batch))
    flat = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(
        W.bridge.from_repro(jax.tree_util.tree_map(np.asarray, t)))]
    return {"loss": float(loss), "per_client": np.asarray(met["per_client"]),
            "grads": flat(grads), "step_loss": float(smet["loss"]),
            "grad_norm": float(smet["grad_norm"]),
            "params": flat(new["params"]), "mu": flat(new["opt"]["mu"]),
            "nu": flat(new["opt"]["nu"]),
            "count": int(new["opt"]["count"])}


def _rel_l2(got, want):
    den = float(np.linalg.norm(want)) or 1.0
    return float(np.linalg.norm(np.asarray(got) - want)) / den


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_loss_and_grads_match_jax(worlds, jax_step, mesh):
    for rank in worlds[1][mesh.name]:
        r = rank["step"]
        assert abs(r["loss"] - jax_step["loss"]) <= \
            LOSS_TOL * abs(jax_step["loss"])
        np.testing.assert_allclose(r["per_client"], jax_step["per_client"],
                                   rtol=LOSS_TOL)
        assert r["participating"] == sum(MASK)
        assert len(r["grads"]) == len(jax_step["grads"])
        for i, (g, w) in enumerate(zip(r["grads"], jax_step["grads"])):
            assert _rel_l2(g, w) <= GRAD_L2_TOL, f"gradient leaf {i}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_train_step_matches_jax(worlds, jax_step, mesh):
    """One AdamW update: the loss, the grad norm (over every rank's
    shards), both moments, the count; the params through the moments
    (AdamW's first step is ~lr sign(g): where g is float noise the params
    may differ by 2 lr)."""
    for rank in worlds[1][mesh.name]:
        r = rank["step"]
        assert abs(r["step_loss"] - jax_step["step_loss"]) <= \
            LOSS_TOL * abs(jax_step["step_loss"])
        assert abs(r["grad_norm"] - jax_step["grad_norm"]) <= \
            LOSS_TOL * jax_step["grad_norm"]
        assert r["count"] == jax_step["count"] == 1
        for k in ("mu", "nu"):
            for i, (g, w) in enumerate(zip(r[k], jax_step[k])):
                assert _rel_l2(g, w) <= GRAD_L2_TOL, f"{k} leaf {i}"
        moved = max(float(np.abs(a - b).max())
                    for a, b in zip(r["params"], jax_step["params"]))
        assert moved <= 2 * LR * 1.01


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_collectives_of_the_step(worlds, mesh):
    """The loss and its gradients move data only on the axes the mesh
    has, and the ranks agree on the counts."""
    counts = [r["step"]["counts"] for r in worlds[1][mesh.name]]
    ops = {k for k in counts[0] if k != "program"}
    assert {k.split("/")[1] for k in ops} <= {
        a for a, n in mesh.shape.items() if n > 1}
    assert all(c == counts[0] for c in counts[1:]) or all(
        {k: v for k, v in c.items() if k != "program"}
        == {k: v for k, v in counts[0].items() if k != "program"}
        for c in counts)
    assert counts[0]["program"]["backend"] == "gloo"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_mpsl_properties_across_ranks(worlds, mesh):
    """The masked client (both meshes); isolation and renormalization at
    (2, 2)."""
    for rank in worlds[1][mesh.name]:
        grads = dict(zip(W.tree.paths(W.bridge.from_repro(worlds[0][0])),
                         rank["step"]["grads"]))
        for k in ("a", "b"):
            g = grads[f"client/adapter/{k}"]
            assert float(np.abs(g[1]).max()) == 0.0       # masked out
            assert float(np.abs(g[0]).max()) > 0.0
        if "props" not in rank:
            continue
        iso = rank["props"][0]
        for k in ("a", "b"):
            g1 = iso[0]["adapter"][f"client/adapter/{k}"]
            g2 = iso[1]["adapter"][f"client/adapter/{k}"]
            # client 3 (the second data rank's) changed its tokens: its
            # gradient moves, the others keep every bit
            assert float(np.abs(g1[3] - g2[3]).max()) > 0
            for c in (0, 1, 2):
                np.testing.assert_array_equal(g1[c], g2[c])
        full, drop = rank["props"][1]
        assert abs(full["loss"] - drop["loss"]) < 1e-5


@pytest.fixture(scope="module")
def jax_served(worlds):
    params, tokens = worlds[0][3:]
    cfg = _jcfg()
    impls = {"attn": "pallas"}

    def prefill(params, tokens):
        b, s = tokens.shape
        cache = JM.init_body_cache(cfg, b, s + 512, jnp.float32)
        h = JM.embed_tokens(params, tokens, cfg, dtype=jnp.float32)
        h, cache, _ = JM.forward_body(
            params, h, cfg, positions=JL.positions_from_shape(b, s),
            cache=cache, impls=impls, remat=False)
        return JM.lm_logits(params, h[:, -1:], cfg), cache

    def decode(params, cache, tokens, positions):
        h = JM.embed_tokens(params, tokens, cfg, positions=positions,
                            dtype=jnp.float32)
        h, cache, _ = JM.forward_body(params, h, cfg, positions=positions,
                                      cache=cache, impls=impls, remat=False)
        return JM.lm_logits(params, h, cfg), cache

    fed = worlds[1]["2x2"][0]["serve"]["tokens"]
    logits, cache = jax.jit(prefill)(params, jnp.asarray(tokens, jnp.int32))
    ref = [np.asarray(logits[:, -1])]
    step = jax.jit(decode)
    for i in range(STEPS):
        pos = jnp.full((SERVE_B, 1), SERVE_S + i, jnp.int32)
        logits, cache = step(params, cache,
                             jnp.asarray(fed[:, i:i + 1], jnp.int32), pos)
        ref.append(np.asarray(logits[:, -1]))
    return np.stack(ref, axis=1)


def test_serving_matches_jax(worlds, jax_served):
    for rank in worlds[1]["2x2"]:
        out = rank["serve"]
        assert out["logits"].shape == (SERVE_B, STEPS + 1, 256)
        for step in range(STEPS + 1):
            np.testing.assert_allclose(out["logits"][:, step],
                                       jax_served[:, step], **SERVE_TOL,
                                       err_msg=f"step {step}")
        np.testing.assert_array_equal(out["tokens"],
                                      jax_served.argmax(-1))
