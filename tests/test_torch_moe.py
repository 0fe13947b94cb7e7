"""The port's MoE family against the JAX package on the CPU.

Reduced qwen2-moe-a2.7b (2 MoE blocks, d_model 64, 4 experts top 2 plus
a shared expert, qkv bias) and reduced qwen3-moe-235b-a22b (4 experts top
2, no shared expert, qk-norm, 4 heads on 1 KV head), on params the JAX
package builds and the bridge carries over, and numpy inputs from a seed:
the routing, the MoE layer (dense and ragged, f32 and bf16) and its
gradients, the whole forward and cached decode, and the MPSL loss with
the router's aux loss and every gradient, with compression off and on
and with remat. Every comparison first asserts that both sides routed
every token to the same experts, so a flip shows as a flip. Then the MPSL
properties on an MoE arch, the routing tape, the bridge and the CLIs."""
import dataclasses
import json
import threading

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro.core import mpsl as jmpsl
from repro.core import split as jsplit
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch import bridge, tree
from repro_torch.configs import MPSLConfig as TMPSLConfig
from repro_torch.configs import RunConfig as TRunConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.core import mpsl, split
from repro_torch.launch import serve, train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

MOE_ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# one MoE layer: f32 sums in other orders (1e-5); bf16 activations round
# to bf16, one ulp is 2^-8 (2e-2); each relative to the largest element
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# through a whole model (two blocks and the final norm, and serving)
MODEL_TOL = 1e-4
# tests/test_smoke_archs.py::test_decode_matches_full_forward
DECODE_VS_FULL = 5e-5
# the MPSL step (tests/test_torch_mpsl.py)
N, BN, S = 3, 2, 12
LOSS_TOL, GRAD_TOL, ADAPTER_L2_TOL = 1e-5, 1e-4, 1e-3


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, **moe):
    """(JAX, port) reduced configs, the MoE fields overridden by `moe`."""
    out = []
    for cfg in (reduced(get_config(arch)), treduced(tget_config(arch))):
        out.append(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg)
    return out


def _assert_close(got, want, tol, name=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) + 1e-12
    assert float(np.abs(got - want).max()) <= tol * scale, name


def _jax_routes(monkeypatch):
    """Record every JAX ``_routing`` call's idx, in call order, also from
    inside a scan (a host callback; the JAX package is left as it is)."""
    rec = []
    orig = JMOE._routing

    def routing(params, x, cfg):
        w, idx, aux = orig(params, x, cfg)
        jax.debug.callback(lambda i: rec.append(np.asarray(i)), idx,
                           ordered=True)
        return w, idx, aux

    monkeypatch.setattr(JMOE, "_routing", routing)
    return rec


def _assert_same_routes(tape, jax_idx):
    """The port's routing (a tape's idx) equals the JAX package's."""
    assert len(tape.idx) == len(jax_idx) > 0
    for i, (a, b) in enumerate(zip(tape.idx, jax_idx)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"call {i}")


# ---------------------------------------------------------------------------
# one MoE layer


def _layer(arch, seed, **moe):
    jcfg, tcfg = _cfgs(arch, **moe)
    jp = _np_tree(JMOE.init_moe(jax.random.PRNGKey(seed), jcfg))
    x = np.random.default_rng(seed).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, bridge.from_repro(jp), x


@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_matches_jax(seed, top_k):
    jcfg, tcfg, jp, tp, x = _layer("qwen2-moe-a2.7b", seed, num_experts=8,
                                   top_k=top_k, d_ff_expert=16)
    xt = x.reshape(-1, jcfg.d_model)
    jw, jidx, jaux = JMOE._routing(jp, jnp.asarray(xt), jcfg)
    tw, tidx, taux = TMOE._routing(tp, _t(xt), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _assert_close(tw, jw, TOL["float32"])
    assert abs(float(taux) - float(jaux)) <= TOL["float32"] * abs(float(jaux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "ragged"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_and_grads_match_jax(arch, impl, dtype):
    """y, aux and the gradients of sum(y * c) + aux with respect to x and
    every leaf (router, wi, wg, wo, the shared expert and its gate)."""
    jcfg, tcfg, jp, tp, x = _layer(arch, 3)
    jdt, tdt = DTYPES[dtype]
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        y, aux = JMOE.apply_moe(p, xx.astype(jdt), jcfg, impl=impl)
        return jnp.sum(y.astype(jnp.float32) * cot) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    leaves = tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    xs = xt.to(tdt)
    _, tidx, _ = TMOE._routing(tp, xs.reshape(-1, tcfg.d_model), tcfg)
    _, jidx, _ = JMOE._routing(jp, jnp.asarray(x).astype(jdt).reshape(
        -1, jcfg.d_model), jcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    y, aux = TMOE.apply_moe(tp, xs, tcfg, impl=impl)
    assert y.dtype == tdt
    loss = (y.float() * _t(cot)).sum() + aux
    grads = torch.autograd.grad(loss, [xt] + leaves)
    tol = TOL[dtype]
    _assert_close(y, jy.astype(jnp.float32), tol, "y")
    assert abs(float(aux.detach()) - float(jaux)) <= \
        TOL["float32"] * float(jaux)
    _assert_close(grads[0], jgx, tol, "x")
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgp)[0]]
    assert len(names) == len(leaves)
    if arch == "qwen2-moe-a2.7b":
        assert {"['shared']['wg']", "['shared_gate']"} <= set(names)
    for name, g, w in zip(names, grads[1:], jax.tree_util.tree_leaves(jgp)):
        _assert_close(g, w, tol, name)


@pytest.mark.parametrize("seed,top_k", [(0, 1), (1, 2), (2, 4), (3, 1),
                                        (4, 2), (5, 4)])
def test_ragged_equals_dense(seed, top_k):
    """tests/test_model_components.py::test_moe_dense_equals_ragged, in the
    port, on the port's own init."""
    _, cfg = _cfgs("qwen2-moe-a2.7b", num_experts=8, top_k=top_k,
                   d_ff_expert=16, num_shared_experts=1, d_ff_shared=16)
    g = torch.Generator().manual_seed(seed)
    p = TMOE.init_moe(g, cfg)
    x = torch.randn((2, 6, cfg.d_model), generator=g)
    y1, aux1 = TMOE.apply_moe(p, x, cfg, impl="dense")
    y2, aux2 = TMOE.apply_moe(p, x, cfg, impl="ragged")
    torch.testing.assert_close(y1, y2, atol=2e-5, rtol=2e-5)
    assert abs(float(aux1 - aux2)) < 1e-7


def test_router_aux_penalizes_imbalance():
    """tests/test_model_components.py::
    test_moe_router_aux_penalizes_imbalance, in the port."""
    _, cfg = _cfgs("qwen2-moe-a2.7b", num_experts=4, top_k=1, d_ff_expert=8,
                   num_shared_experts=0, d_ff_shared=0, router_aux_coef=1.0)
    g = torch.Generator().manual_seed(0)
    p = TMOE.init_moe(g, cfg)
    x = torch.randn((1, 64, cfg.d_model), generator=g)
    router = torch.zeros_like(p["router"])
    router[:, 0] = 10.0                   # total collapse onto expert 0
    _, aux_bal = TMOE.apply_moe(p, x, cfg)
    _, aux_col = TMOE.apply_moe(dict(p, router=router), x, cfg)
    assert float(aux_col) > float(aux_bal)


# ---------------------------------------------------------------------------
# the whole model


def _model(arch, seed=1):
    jcfg, tcfg = _cfgs(arch)
    jtree = _np_tree(JM.init_lm(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jtree, bridge.from_repro(jtree)


@pytest.mark.parametrize("impl", ["dense", "ragged"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match_jax(arch, impl, monkeypatch):
    jcfg, tcfg, jtree, params = _model(arch)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 12))
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    routes = _jax_routes(monkeypatch)
    jh = JM.embed_tokens(jtree, jnp.asarray(tokens), jcfg, dtype=jnp.float32)
    want, _, jaux = JM.forward_body(
        jtree, jh, jcfg, positions=jnp.asarray(pos),
        impls={"attn": "pallas", "moe": impl}, remat=False)
    jax.effects_barrier()
    th = TM.embed_tokens(params, _t(tokens), tcfg, dtype=torch.float32)
    with TMOE.routing_tape() as tape:
        got, _, aux = TM.forward_body(params, th, tcfg, positions=_t(pos),
                                      impls={"attn": "kernel", "moe": impl})
    _assert_same_routes(tape, routes)
    assert len(tape.idx) == tcfg.num_layers
    _assert_close(got, want, MODEL_TOL)
    _assert_close(TM.lm_logits(params, got, tcfg),
                  JM.lm_logits(jtree, want, jcfg), MODEL_TOL)
    assert abs(float(aux) - float(jaux)) <= MODEL_TOL * float(jaux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cached_decode_matches_full_forward(arch):
    """Greedy decode through the KV cache (prefill, then one token a step)
    gives the logits of the full forward over the same tokens."""
    _, cfg, _, params = _model(arch)
    b, s, steps = 2, 8, 4
    tokens = torch.randint(0, cfg.vocab_size, (b, s + steps),
                           generator=torch.Generator().manual_seed(2))
    prefill, decode = serve.build_serving_fns(cfg, device="cpu")
    out = serve.generate(prefill, decode, params, tokens[:, :s], steps,
                         forced_tokens=tokens[:, s:])
    h = TM.embed_tokens(params, tokens, cfg, dtype=torch.float32)
    with torch.no_grad():
        h, _, _ = TM.forward_body(params, h, cfg,
                                  positions=TL.positions_from_shape(b, s + steps))
        full = TM.lm_logits(params, h, cfg)[:, s - 1:]
    torch.testing.assert_close(out["logits"], full, atol=DECODE_VS_FULL,
                               rtol=DECODE_VS_FULL)


# ---------------------------------------------------------------------------
# the MPSL loss


def _jax_run(compress, remat="block", coef=None):
    cfg = reduced(get_config("qwen2-moe-a2.7b"))
    if coef is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router_aux_coef=coef))
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=compress, compress_downlink=compress)
    return cfg, RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                          compute_dtype="float32", attn_impl="pallas",
                          ce_impl="pallas", moe_impl="ragged", remat=remat)


def _port_run(compress, remat="block", coef=None):
    cfg = treduced(tget_config("qwen2-moe-a2.7b"))
    if coef is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router_aux_coef=coef))
    mp = TMPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                     compress_uplink=compress, compress_downlink=compress)
    return cfg, TRunConfig(model=cfg, shape=None, mpsl=mp,
                           compute_dtype="float32", attn_impl="kernel",
                           ce_impl="kernel", moe_impl="ragged", remat=remat)


def _np_batch(cfg, seed, mask=None, bn=BN):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (N, bn, S)),
            "labels": rng.integers(0, cfg.vocab_size, (N, bn, S)),
            "mask": (np.ones(N, np.float32) if mask is None
                     else np.asarray(mask, np.float32))}


def _jax_batch(b):
    return {"tokens": jnp.asarray(b["tokens"], jnp.int32),
            "labels": jnp.asarray(b["labels"], jnp.int32),
            "mask": jnp.asarray(b["mask"])}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_trees():
    cfg, run = _jax_run(False)
    params, frozen, _ = jsplit.init_mpsl_lm(jax.random.PRNGKey(0), cfg, run)
    # a nonzero adapter b, so the adapter's 'a' gets a gradient too
    params["client"]["adapter"]["b"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(1), params["client"]["adapter"]["b"].shape)
    return _np_tree(params), _np_tree(frozen)


def _port_grads(loss_fn, trees, batch, rng):
    """(loss, metrics, gradients as a tree shaped as the params)."""
    params, frozen = (bridge.from_repro(t) for t in trees)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, frozen, batch, rng)
    grads = iter(torch.autograd.grad(loss, tree.leaves(params)))
    return loss.detach(), metrics, tree.map_(lambda _: next(grads), params)


def _assert_trees_close(got, want, l2_paths=()):
    """Each leaf within GRAD_TOL of its largest element; leaves whose path
    names one of `l2_paths` within ADAPTER_L2_TOL in relative L2 norm."""
    got = bridge.to_repro(got)
    gl = jax.tree_util.tree_leaves(got)
    wl = jax.tree_util.tree_flatten_with_path(_np_tree(want))[0]
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(_np_tree(want))
    for g, (path, w) in zip(gl, wl):
        name = jax.tree_util.keystr(path)
        if any(p in name for p in l2_paths):
            err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            assert err <= ADAPTER_L2_TOL, (name, err)
        else:
            _assert_close(g, w, GRAD_TOL, name)


def _draws(key, d_model):
    """The uniforms the JAX loss draws for its two links from `key`."""
    r_up, r_down = jax.random.split(jax.random.fold_in(key, 1))
    shape = (N, BN, S, d_model)
    return {"uplink": _t(jax.random.uniform(r_up, shape)),
            "downlink": _t(jax.random.uniform(r_down, shape))}


@pytest.mark.parametrize("compress,remat", [(False, "block"), (True, "block"),
                                            (False, "none")])
def test_mpsl_loss_aux_and_grads_match_jax(jax_trees, compress, remat,
                                           monkeypatch):
    jcfg, jrun = _jax_run(compress, remat)
    tcfg, trun = _port_run(compress, remat)
    b = _np_batch(jcfg, seed=3)
    key = jax.random.PRNGKey(5)
    jloss_fn = jmpsl.make_lm_loss(jcfg, jrun)
    loss_fn = mpsl.make_lm_loss(tcfg, trun)
    rng = _draws(key, tcfg.d_model) if compress else 0
    # the same routing, from one forward each
    routes = _jax_routes(monkeypatch)
    jloss_fn(*jax_trees, _jax_batch(b), key)
    jax.effects_barrier()
    monkeypatch.undo()
    with TMOE.routing_tape() as tape, torch.no_grad():
        loss_fn(*(bridge.from_repro(t) for t in jax_trees), _torch_batch(b),
                rng)
    _assert_same_routes(tape, routes)

    (jl, jmet), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        *jax_trees, _jax_batch(b), key)
    loss, met, grads = _port_grads(loss_fn, jax_trees, _torch_batch(b), rng)
    assert float(jmet["aux"]) > 0
    assert abs(float(met["aux"]) - float(jmet["aux"])) <= \
        LOSS_TOL * float(jmet["aux"])
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert float(met["loss"]) == float(loss)
    np.testing.assert_allclose(met["per_client"].numpy(),
                               np.asarray(jmet["per_client"]), rtol=LOSS_TOL)
    _assert_trees_close(grads, jg,
                        l2_paths=("'adapter'",) if compress else ())


def test_aux_gives_a_dropped_client_the_jax_gradient(jax_trees):
    """The aux loss is taken over every client's tokens and added after the
    client weights: a client with mask 0 gets a nonzero adapter gradient,
    the JAX package's."""
    jcfg, jrun = _jax_run(False)
    tcfg, trun = _port_run(False)
    b = _np_batch(jcfg, seed=6, mask=[1, 0, 1])
    jg = jax.grad(lambda p: jmpsl.make_lm_loss(jcfg, jrun)(
        p, jax_trees[1], _jax_batch(b), jax.random.PRNGKey(0))[0])(
            jax_trees[0])
    _, _, g = _port_grads(mpsl.make_lm_loss(tcfg, trun), jax_trees,
                          _torch_batch(b), 0)
    for k in ("a", "b"):
        got = g["client"]["adapter"][k]
        assert float(got[1].abs().max()) > 0.0
        _assert_close(got, jg["client"]["adapter"][k], GRAD_TOL, k)


# ---------------------------------------------------------------------------
# the MPSL properties (tests/test_mpsl_equivalence.py) on an MoE arch


@pytest.fixture(scope="module")
def no_aux():
    """Reduced qwen2-moe-a2.7b with router_aux_coef 0: the loss couples no
    clients, so the MPSL properties hold as on a dense arch."""
    cfg, run = _port_run(False, coef=0.0)
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), cfg, run)
    params["client"]["adapter"]["b"] = 0.05 * torch.randn(
        params["client"]["adapter"]["b"].shape,
        generator=torch.Generator().manual_seed(1))
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return cfg, params, frozen, mpsl.make_lm_loss(cfg, run)


def _adapter_grads(loss_fn, params, frozen, b):
    _, _, g = mpsl.value_and_grad(loss_fn, params, frozen, _torch_batch(b), 0)
    return dict(zip(("a", "b"), g[:2]))     # client.adapter.{a, b} lead


@pytest.mark.parametrize("mask", [[1, 1, 1], [1, 0, 1]])
def test_no_aux_aggregated_equals_per_client(no_aux, mask):
    cfg, params, frozen, loss_fn = no_aux
    batch = _torch_batch(_np_batch(cfg, seed=11, mask=mask))
    _, met, g_agg = mpsl.value_and_grad(loss_fn, params, frozen, batch, 0)
    assert float(met["aux"]) == 0.0
    g_pc, _, _ = mpsl._per_client_grads(loss_fn, params, frozen, batch, 0)
    for a, b in zip(g_agg, g_pc):
        scale = float(a.abs().max()) + 1e-8
        assert float((a - b).abs().max()) / scale < 1e-4


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_no_aux_client_isolation_is_bitwise(no_aux, impl):
    cfg, params, frozen, _ = no_aux
    _, run = _port_run(False, coef=0.0)
    loss_fn = mpsl.make_lm_loss(cfg, run, impls={"moe": impl})
    b1 = _np_batch(cfg, seed=12)
    b2 = {k: v.copy() for k, v in b1.items()}
    b2["tokens"][1] = (b2["tokens"][1] + 7) % cfg.vocab_size
    g1, g2 = (_adapter_grads(loss_fn, params, frozen, b)["b"]
              for b in (b1, b2))
    assert float((g1[1] - g2[1]).abs().max()) > 0
    assert torch.equal(g1[0], g2[0])
    assert torch.equal(g1[2], g2[2])


def test_no_aux_dropped_client_gets_zero_grad(no_aux):
    cfg, params, frozen, loss_fn = no_aux
    g = _adapter_grads(loss_fn, params, frozen,
                       _np_batch(cfg, seed=13, mask=[1, 0, 1]))
    for k in ("a", "b"):
        assert float(g[k][1].abs().max()) == 0.0
        assert float(g[k][0].abs().max()) > 0.0


def test_aux_couples_clients():
    """With the default coefficient, one client's tokens move another's
    adapter gradient (through the expert density and the mean router
    probabilities), as in the JAX package."""
    cfg, run = _port_run(False)
    assert cfg.moe.router_aux_coef > 0
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), cfg, run)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss_fn = mpsl.make_lm_loss(cfg, run)
    b1 = _np_batch(cfg, seed=12)
    b2 = {k: v.copy() for k, v in b1.items()}
    b2["tokens"][1] = (b2["tokens"][1] + 7) % cfg.vocab_size
    g1, g2 = (_adapter_grads(loss_fn, params, frozen, b)["b"]
              for b in (b1, b2))
    assert float((g1[0] - g2[0]).abs().max()) > 0


@pytest.mark.parametrize("mu", [2])
def test_microbatching_averages_loss_and_aux(jax_trees, mu):
    tcfg, trun = _port_run(False)
    loss_fn = mpsl.make_lm_loss(tcfg, trun)
    params, frozen = (bridge.from_repro(t) for t in jax_trees)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    batch = _torch_batch(_np_batch(tcfg, seed=15, bn=4))
    mbs = mpsl._split_microbatches(batch, mu)
    auxes = [float(loss_fn(params, frozen, mb, 0)[1]["aux"]) for mb in mbs]
    lm, met, _ = mpsl._grad_agg(loss_fn, params, frozen, batch, 0, mu)
    assert float(met["aux"]) == pytest.approx(np.mean(auxes), rel=1e-6)
    assert float(met["loss"]) == pytest.approx(float(lm), rel=1e-6)


# ---------------------------------------------------------------------------
# the routing tape


def test_routing_tape_replay_is_bitwise_and_counts_a_flip():
    """Replaying a path's own routing changes no bit and counts no flip;
    replaying a tape with one token sent elsewhere counts that token."""
    _, cfg, _, params = _model("qwen2-moe-a2.7b")
    tokens = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 12)))
    pos = TL.positions_from_shape(2, 12)

    def run():
        h = TM.embed_tokens(params, tokens, cfg, dtype=torch.float32)
        with torch.no_grad():
            return TM.forward_body(params, h, cfg, positions=pos)

    want, _, want_aux = run()
    with TMOE.routing_tape() as rec:
        got, _, aux = run()
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    with TMOE.routing_tape(rec.idx) as rep:
        got, _, aux = run()
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    assert int(rep.flips) == 0
    assert rep.decisions == 2 * 12 * cfg.num_layers

    forced = [i.clone() for i in rec.idx]
    e = cfg.moe.num_experts
    chosen = set(forced[1][5].tolist())
    forced[1][5, 0] = next(x for x in range(e) if x not in chosen)
    with TMOE.routing_tape(forced) as rep:
        got, _, _ = run()
    assert int(rep.flips) == 1
    assert not torch.equal(got, want)
    with pytest.raises(RuntimeError, match="holds"):
        with TMOE.routing_tape(rec.idx[:1]):
            run()


def test_routing_tape_sees_calls_from_another_thread():
    """On CUDA the autograd engine recomputes a checkpointed block on a
    thread of its own: a tape opened on the caller's thread records, and
    replays, the routing calls made there too."""
    _, cfg, _, params = _model("qwen2-moe-a2.7b")
    p = params["segments"][0][0]["moe"]
    x = torch.randn((6, cfg.d_model), generator=torch.Generator().manual_seed(3))

    def on_another_thread():
        out = []
        t = threading.Thread(target=lambda: out.append(
            TMOE._routing(p, x, cfg)[1]))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        return out[0]

    with TMOE.routing_tape() as rec:
        idx = on_another_thread()
    assert len(rec.idx) == 1 and torch.equal(rec.idx[0], idx)
    forced = [idx.clone()]
    forced[0][2] = forced[0][2].flip(0)          # the same set: no flip
    chosen = set(idx[4].tolist())
    forced[0][4, 0] = next(e for e in range(cfg.moe.num_experts)
                           if e not in chosen)
    with TMOE.routing_tape(forced) as rep:
        got = on_another_thread()
    assert torch.equal(got, forced[0])
    assert rep.calls == 1 and int(rep.flips) == 1


# ---------------------------------------------------------------------------
# the bridge and the entry points


def test_bridge_round_trips_moe_trees(jax_trees):
    _, _, jtree, params = _model("qwen3-moe-235b-a22b")
    layer = params["segments"][0][0]["moe"]
    assert layer["wi"].shape == (4, 64, 32)          # one [E, ...] tensor
    for t in (jtree, *jax_trees):
        back = bridge.to_repro(bridge.from_repro(t))
        for x, y in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(t)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert bridge.from_repro(jax_trees[1])["segments"][0][0]["moe"][
        "shared"]["wg"].dtype == torch.bfloat16


def test_serve_and_train_clis_run_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--arch", "qwen2-moe-a2.7b",
                       "--prompt-len", "12", "--decode-steps", "3"]) == 0
    capsys.readouterr()
    assert train.main(["--device", "cpu", "--arch", "qwen2-moe-a2.7b",
                       "--steps", "3", "--seq", "12", "--compress",
                       "--trainable-blocks", "1"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(summary["losses"]) == 3 and all(np.isfinite(summary["losses"]))
