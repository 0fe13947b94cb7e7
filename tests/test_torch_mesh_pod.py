"""The `pod` axis: the MPSL step, serving and checkpoints of the SPMD
program on (pod, data, model) meshes on the CPU (gloo), against the JAX
package.

The JAX package's multi-pod mesh (2 x 16 x 16) lays the clients and the
batch on (pod, data), flattened pod-major; fsdp stays on `data` within a
pod, the weights are replicated across pods, and an fsdp leaf's gradient
crosses `pod` once a step. Reduced minitron-4b (2 layers, 4 heads on 2
KV heads, vocab 256), 4 clients x 2 sequences x 12 tokens, client 1
masked out, both links int8 (the port fed the JAX loss's
``jax.random.uniform`` draws, each client rank its clients'), the last
block trainable. One world of 4 ranks runs (2, 2, 1) (a client a rank,
fsdp over `data`) and (2, 1, 2) (two clients a pod, heads, d_ff and
vocab over `model`); one of 8 runs (2, 2, 2):

  * the loss, every gradient (gathered) and one ``make_train_step``
    (loss, grad norm, AdamW's moments and count, the params) against the
    JAX ``make_lm_loss`` / ``make_train_step``;
  * the gradients' collectives: every fsdp leaf's all-reduced over `pod`
    once (its reduce-scatter over `data` is its gather's), every other
    shared leaf's over the flattened (pod, data) axis;
  * the MPSL properties across pods: the masked client's adapter
    gradient is exactly zero, a client's adapter gradient does not move
    when a client on the other pod changes its tokens (bitwise), and
    dropping a client renormalizes the weights;
  * prefill plus 4 greedy decode steps of ``launch.serve`` on the TP-only
    serving layout (the batch over (pod, data)) against the JAX serving
    functions, teacher-forced with the port's tokens;
  * the state after the step, saved on (2, 2, 1), restored on (2, 1) (a
    world of 2) and on one process, bitwise.
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
# tests/test_torch_mesh_step.py's limits
LOSS_TOL, GRAD_L2_TOL = 1e-4, 1e-3
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_B, STEPS = 4, 4
AXES = ("pod", "data", "model")
MESHES = [Mesh(AXES, (2, 2, 1)), Mesh(AXES, (2, 1, 2))]
WIDE = Mesh(AXES, (2, 2, 2))
ALL = MESHES + [WIDE]


def _jcfg():
    return reduced(get_config("minitron-4b"), **CFG_KW)


def _jrun(cfg):
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=True, compress_downlink=True)
    return RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                     compute_dtype="float32", attn_impl="naive",
                     ce_impl="jnp")


def _trees():
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


def _draws(d_model):
    """The uniforms the JAX step draws at step 0 of a state seeded 9."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 0),
                             1)
    r_up, r_down = jax.random.split(key)
    shape = (N, BN, S, d_model)
    return {"uplink": np.array(jax.random.uniform(r_up, shape)),
            "downlink": np.array(jax.random.uniform(r_down, shape))}


def _prop_args(params, frozen):
    """Client 3 (pod 1's) changes its tokens; then every client sends the
    same tokens, once with client 1 dropped."""
    b1 = _batch(12)
    b2 = {k: v.copy() for k, v in b1.items()}
    b2["tokens"][3] = (b2["tokens"][3] + 7) % 256
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
    tokens = np.random.default_rng(5).integers(0, 256, (SERVE_B, S))
    return params, tokens


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    params, frozen = _trees()
    batch = _batch(4)
    step_args = (CFG_KW, params, frozen, batch, _draws(64), LR)
    serve_params, tokens = _serve_inputs()
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    serve_args = (CFG_KW, serve_params, tokens, STEPS)
    out = {}
    for meshes, save in ((MESHES, ckpt), ([WIDE], None)):
        res = spmd.spawn(W.pod_cases, meshes[0], "cpu", 240, args=(
            meshes, step_args, _prop_args(params, frozen), serve_args,
            save), workdir=tmp_path_factory.mktemp("pod"))
        out.update({m.name: [r[m.name] for r in res] for m in meshes})
    restored = {"2x1": spmd.spawn(
        W.restored, Mesh(("data", "model"), (2, 1)), "cpu", 120,
        args=(CFG_KW, params, frozen, ckpt),
        workdir=tmp_path_factory.mktemp("restore")),
        "1x1": [W.restored(CFG_KW, params, frozen, ckpt)]}
    return (params, frozen, batch, serve_params, tokens), out, restored


@pytest.fixture(scope="module")
def jax_step(worlds):
    params, frozen, batch = worlds[0][:3]
    cfg = _jcfg()
    run = _jrun(cfg)
    loss_fn = jmpsl.make_lm_loss(cfg, run)
    rng = jax.random.fold_in(jax.random.PRNGKey(9), 0)
    jb = {"tokens": jnp.asarray(batch["tokens"], jnp.int32),
          "labels": jnp.asarray(batch["labels"], jnp.int32),
          "mask": jnp.asarray(batch["mask"])}
    step = jmpsl.make_train_step(loss_fn, run, jsched.constant(LR))

    def both(state, batch, rng):
        return (jax.value_and_grad(loss_fn, has_aux=True)(
            state["params"], state["frozen"], batch, rng), step(state, batch))

    ((loss, met), grads), (new, smet) = jax.jit(both)(
        jmpsl.init_state(params, frozen, seed=9), jb, rng)
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


@pytest.mark.parametrize("mesh", ALL, ids=lambda m: m.name)
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


@pytest.mark.parametrize("mesh", ALL, ids=lambda m: m.name)
def test_train_step_matches_jax(worlds, jax_step, mesh):
    """One AdamW update: the loss, the grad norm (each shard counted once
    over pods, data and model), both moments, the count, the params."""
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


@pytest.mark.parametrize("mesh", ALL, ids=lambda m: m.name)
def test_gradients_cross_pod_once(worlds, mesh):
    """``reduce_grads`` after the loss's backward: each trainable leaf
    whose spec lays a dim on `data` (fsdp, reduce-scattered within its
    pod) is all-reduced over `pod` once, and nothing else moves over `pod`
    alone; the loss and the other shared leaves use the flattened (pod,
    data) axis. The ranks agree on the counts."""
    axes = [W.C.spec_axes(sp)
            for sp in worlds[1][mesh.name][0]["step"]["specs"]]
    fsdp = sum("data" in a and "pod" not in a for a in axes)
    counts = [r["step"]["counts"] for r in worlds[1][mesh.name]]
    first = {k: v for k, v in counts[0].items() if k != "program"}
    for c in counts:
        assert {k: v for k, v in c.items() if k != "program"} == first
    assert first.get("all_reduce/pod", {"calls": 0})["calls"] == fsdp
    assert (fsdp > 0) == (mesh.shape["data"] > 1)
    assert first["all_reduce/pod+data"]["calls"] > 0
    assert {k.split("/")[1] for k in first} <= {"pod", "pod+data", "data",
                                                "model", "world"}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_mpsl_properties_across_pods(worlds, mesh):
    for rank in worlds[1][mesh.name]:
        grads = dict(zip(W.tree.paths(W.bridge.from_repro(worlds[0][0])),
                         rank["step"]["grads"]))
        for k in ("a", "b"):
            g = grads[f"client/adapter/{k}"]
            assert float(np.abs(g[1]).max()) == 0.0       # masked out
            assert float(np.abs(g[0]).max()) > 0.0
        iso = rank["props"][0]
        for k in ("a", "b"):
            g1 = iso[0]["adapter"][f"client/adapter/{k}"]
            g2 = iso[1]["adapter"][f"client/adapter/{k}"]
            # client 3, on pod 1, changed its tokens: its gradient moves,
            # the others keep every bit (pod 0's clients 0 and 1 included)
            assert float(np.abs(g1[3] - g2[3]).max()) > 0
            for c in (0, 1, 2):
                np.testing.assert_array_equal(g1[c], g2[c])
        full, drop = rank["props"][1]
        assert abs(full["loss"] - drop["loss"]) < 1e-5


@pytest.fixture(scope="module")
def jax_served(worlds):
    params, tokens = worlds[0][3:]
    cfg = _jcfg()

    def prefill(params, tokens):
        b, s = tokens.shape
        cache = JM.init_body_cache(cfg, b, s + 512, jnp.float32)
        h = JM.embed_tokens(params, tokens, cfg, dtype=jnp.float32)
        h, cache, _ = JM.forward_body(
            params, h, cfg, positions=JL.positions_from_shape(b, s),
            cache=cache, impls={"attn": "naive"}, remat=False)
        return JM.lm_logits(params, h[:, -1:], cfg), cache

    def decode(params, cache, tokens, positions):
        h = JM.embed_tokens(params, tokens, cfg, positions=positions,
                            dtype=jnp.float32)
        h, cache, _ = JM.forward_body(params, h, cfg, positions=positions,
                                      cache=cache, impls={"attn": "naive"},
                                      remat=False)
        return JM.lm_logits(params, h, cfg), cache

    out = {}
    step = jax.jit(decode)
    for mesh in ALL:
        fed = worlds[1][mesh.name][0]["serve"]["tokens"]
        logits, cache = jax.jit(prefill)(params,
                                         jnp.asarray(tokens, jnp.int32))
        ref = [np.asarray(logits[:, -1])]
        for i in range(STEPS):
            pos = jnp.full((SERVE_B, 1), S + i, jnp.int32)
            logits, cache = step(params, cache,
                                 jnp.asarray(fed[:, i:i + 1], jnp.int32), pos)
            ref.append(np.asarray(logits[:, -1]))
        out[mesh.name] = np.stack(ref, axis=1)
    return out


@pytest.mark.parametrize("mesh", ALL, ids=lambda m: m.name)
def test_serving_matches_jax(worlds, jax_served, mesh):
    want = jax_served[mesh.name]
    for rank in worlds[1][mesh.name]:
        out = rank["serve"]
        assert out["logits"].shape == (SERVE_B, STEPS + 1, 256)
        for step in range(STEPS + 1):
            np.testing.assert_allclose(out["logits"][:, step], want[:, step],
                                       **SERVE_TOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(out["tokens"], want.argmax(-1))
        # nothing moves over the client axis: it only splits the requests
        assert {k.split("/")[1] for k in out["counts"]
                if k != "program"} <= {"model"}


@pytest.mark.parametrize("where", ["2x1", "1x1"])
def test_checkpoint_restores_across_world_sizes(worlds, where):
    """The state after the step on (2, 2, 1), restored on (2, 1) and on
    one process: every leaf bitwise the saved one, on every rank."""
    saved = worlds[1]["2x2x1"][0]["step"]["saved"]
    assert len(saved) > 0
    for got in worlds[2][where]:
        assert set(got) == set(saved)
        for k in saved:
            np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
