"""The port's blockwise / auto attention, the one-card ep MoE dispatch,
``optim.accumulate_grads`` and the impl fields of RunConfig, against the
JAX package on the CPU.

Inputs are drawn with numpy from a seed and reach both packages as the
same f32 values. blockwise is held to the port's naive attention and to
the JAX ``_blockwise_attention`` (forward and the gradients of q, k, v),
the ep dispatch to the JAX ``_apply_ep`` under a (1, 1) mesh, with and
without capacity overflow."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import optim as joptim
from repro.configs import get_config, reduced
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.parallel import sharding as jsharding
from repro_torch import bridge
from repro_torch.configs import MPSLConfig, RunConfig, SHAPES, port_impls
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.core import mpsl, split
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention, moe
from repro_torch.optim import accumulate_grads
from repro_torch.parallel import sharding

# f32 sums of the same products in other orders (blocks of 8 keys against
# the whole row, JAX's XLA against torch's kernels)
ATTN_TOL = 1e-5
EP_TOL = 1e-5
ACCUM_TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# blockwise attention


# (name, b, sq, sk, h, kh, hd, causal, window, with k_valid, q offset)
ATTN_CASES = [
    ("causal", 2, 20, 20, 4, 2, 8, True, 0, False, 0),
    ("window", 2, 29, 29, 4, 1, 8, True, 6, False, 0),
    ("k_valid_ragged", 2, 11, 37, 6, 3, 8, True, 0, True, 26),
    ("cross_noncausal", 3, 7, 21, 4, 4, 16, False, 0, False, 0),
]


def _attn_inputs(b, sq, sk, h, kh, hd, causal, with_valid, q_off, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, sk, kh, hd), dtype=np.float32)
    v = rng.standard_normal((b, sk, kh, hd), dtype=np.float32)
    q_pos = np.broadcast_to(np.arange(q_off, q_off + sq, dtype=np.int32),
                            (b, sq)).copy()
    k_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    valid = None
    if with_valid:
        valid = rng.random((b, sk)) < 0.7
        valid[:, 0] = True          # every query row keeps a key
    do = rng.standard_normal((b, sq, h, hd), dtype=np.float32)
    return q, k, v, q_pos, k_pos, valid, do


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_blockwise_matches_naive_and_jax(case):
    _, b, sq, sk, h, kh, hd, causal, window, with_valid, q_off = case
    q, k, v, qp, kp, valid, do = _attn_inputs(b, sq, sk, h, kh, hd, causal,
                                              with_valid, q_off)
    block = 8                       # Sk is not a multiple of it

    def jfn(q_, k_, v_):
        return jattn._blockwise_attention(
            q_, k_, v_, jnp.asarray(qp), jnp.asarray(kp), causal, window,
            None if valid is None else jnp.asarray(valid), block=block)

    @jax.jit
    def forward_and_vjp(q_, k_, v_, do_):
        o, vjp = jax.vjp(jfn, q_, k_, v_)
        return o, vjp(do_)
    jo, jg = forward_and_vjp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(do))

    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    tvalid = None if valid is None else _t(valid)
    out = attention._blockwise_attention(tq, tk, tv, _t(qp), _t(kp), causal,
                                         window, tvalid, block=block)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    bias = attention._mask_bias(_t(qp), _t(kp), causal, window, tvalid)
    naive = attention._naive_attention(tq, tk, tv, bias)
    ngrads = torch.autograd.grad(naive, (tq, tk, tv), _t(do))

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(out.detach().numpy(), naive.detach().numpy(),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    for g, j, n in zip(grads, jg, ngrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
        np.testing.assert_allclose(g.numpy(), n.numpy(), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


def test_blockwise_backward_recomputes_each_block():
    """The backward keeps each block step's inputs, not its [Sq, block]
    scores: the saved tensors of a 3-block call hold no scores [B, Sq,
    K, G, block] and no bias [B, Sq, block]."""
    q, k, v, qp, kp, _, _ = _attn_inputs(1, 16, 24, 2, 1, 4, True, False, 0)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        attention._blockwise_attention(tq, tk, tv, _t(qp), _t(kp), True, 0,
                                       None, block=8)
    assert shapes
    assert not {(1, 16, 1, 2, 8), (1, 16, 8)} & set(shapes), shapes


def _jax_choice(impl, sq, sk, monkeypatch):
    calls = []
    for name in ("_naive_attention", "_blockwise_attention"):
        fn = getattr(jattn, name)
        monkeypatch.setattr(
            jattn, name, lambda *a, _fn=fn, _n=name, **k: (
                calls.append(_n), _fn(*a, **k))[1])
    cfg = reduced(get_config("minitron-4b"), pos_embed="none")
    params = jattn.init_attention(jax.random.PRNGKey(0), cfg)
    x = jnp.ones((1, sq, cfg.d_model), jnp.float32)
    kv = jnp.ones((1, sk, cfg.d_model), jnp.float32)
    # traced, not run: the choice is made while tracing
    jax.eval_shape(lambda p, x_, kv_: jattn.apply_attention(
        p, x_, cfg, positions=jnp.zeros((1, sq), jnp.int32), causal=False,
        impl=impl, kv_x=kv_, use_rope=False), params, x, kv)
    return {"_naive_attention": "naive",
            "_blockwise_attention": "blockwise"}[calls[-1]]


@pytest.mark.parametrize("impl", ["auto", "blockwise", "naive"])
def test_auto_and_decode_choice_match_jax(impl, monkeypatch):
    for sq, sk in ((1, 2049), (3, 2048), (3, 2049), (1, 16)):
        want = _jax_choice(impl, sq, sk, monkeypatch)
        assert attention.resolve_impl(impl, sq, sk) == want, (impl, sq, sk)


# ---------------------------------------------------------------------------
# the ep dispatch


def _jax_ep(params, x, cfg, w, idx, capacity):
    """The JAX ``_apply_ep`` under a (1, 1) mesh, jitted (eager shard_map
    dispatches op by op)."""
    with jsharding.use_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        return np.asarray(jax.jit(lambda p, a, b, c: jmoe._apply_ep(
            p, a, cfg, b, c, capacity_factor=capacity))(
                params, jnp.asarray(x), w, idx))


def _moe_setup(t=24, seed=0):
    jcfg = reduced(get_config("qwen3-moe-235b-a22b"))
    tcfg = treduced(tget_config("qwen3-moe-235b-a22b"))
    params = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, jcfg.d_model), dtype=np.float32)
    jw, jidx, _ = jmoe._routing(params, jnp.asarray(x), jcfg)
    tparams = bridge.from_repro(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, tparams, x, jw, jidx


@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_ep_matches_jax_on_a_one_card_mesh(capacity):
    jcfg, tcfg, params, tparams, x, jw, jidx = _moe_setup()
    want = _jax_ep(params, x, jcfg, jw, jidx, capacity)
    with sharding.use_mesh(mesh_lib.Mesh(("data", "model"), (1, 1))):
        got = moe._apply_ep(tparams, _t(x), tcfg, _t(jw),
                            _t(jidx).long(), capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EP_TOL,
                               rtol=EP_TOL)
    drops = int(moe.ep_drop_mask(_t(jidx).long(), tcfg.moe.num_experts,
                                 capacity).sum())
    if capacity == 0.5:
        assert drops > 0
        # a token none of whose slots dropped gets the full mixture
        keep = ~moe.ep_drop_mask(_t(jidx).long(), tcfg.moe.num_experts,
                                 capacity).any(-1)
        full = _jax_ep(params, x, jcfg, jw, jidx, 8.0)
        np.testing.assert_allclose(got.numpy()[keep.numpy()],
                                   full[keep.numpy()], atol=EP_TOL,
                                   rtol=EP_TOL)
    else:
        assert drops == 0


def test_ep_equals_ragged_where_nothing_drops():
    _, tcfg, _, tparams, x, jw, jidx = _moe_setup(seed=1)
    w, idx = _t(jw), _t(jidx).long()
    assert not moe.ep_drop_mask(idx, tcfg.moe.num_experts, 2.0).any()
    with sharding.use_mesh(mesh_lib.Mesh(("data", "model"), (1, 1))):
        got = moe._apply_ep(tparams, _t(x), tcfg, w, idx, 2.0)
    want = moe._apply_ragged(tparams, _t(x), tcfg, w, idx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=EP_TOL,
                               rtol=EP_TOL)


def test_ep_without_a_mesh_is_ragged_and_a_model_axis_of_two_raises():
    """With no mesh ep is ragged. A model axis of two no longer raises:
    the mesh record's two devices each run the JAX ``local`` on their
    experts and the partials add, which is the JAX shard_map ep on that
    mesh (emulated here by the JAX one-device dispatch: the same capacity
    from the global E, so the same drops; the SPMD program's ranks are
    held to the JAX shard_map itself in tests/test_torch_mesh_ep.py)."""
    jcfg, tcfg, params, tparams, x, jw, jidx = _moe_setup(seed=2)
    w, idx = _t(jw), _t(jidx).long()
    assert sharding.current_mesh() is None
    got = moe._apply_ep(tparams, _t(x), tcfg, w, idx, 0.5)
    want = moe._apply_ragged(tparams, _t(x), tcfg, w, idx)
    assert torch.equal(got, want)
    with sharding.use_mesh(mesh_lib.Mesh(("data", "model"), (1, 2))):
        got = moe._apply_ep(tparams, _t(x), tcfg, w, idx, 0.5)
    np.testing.assert_allclose(got.numpy(),
                               _jax_ep(params, x, jcfg, jw, jidx, 0.5),
                               atol=EP_TOL, rtol=EP_TOL)


def test_ep_splits_tokens_over_data_shards_as_jax():
    """A host mesh of 2 data shards x 1: each shard's tokens dispatched
    with their own capacity, as the JAX shard_map does (emulated here by
    running the JAX one-device dispatch on each half)."""
    jcfg, tcfg, params, tparams, x, jw, jidx = _moe_setup(t=32, seed=3)
    halves = [_jax_ep(params, x[sl], jcfg, jw[sl], jidx[sl], 0.5)
              for sl in (slice(0, 16), slice(16, 32))]
    with sharding.use_mesh(mesh_lib.Mesh(("data", "model"), (2, 1))):
        got = moe._apply_ep(tparams, _t(x), tcfg, _t(jw), _t(jidx).long(),
                            0.5)
    np.testing.assert_allclose(got.numpy(), np.concatenate(halves),
                               atol=EP_TOL, rtol=EP_TOL)


# ---------------------------------------------------------------------------
# accumulate_grads


@pytest.mark.parametrize("mu", [1, 2, 4])
def test_accumulate_grads_matches_jax(mu):
    rng = np.random.default_rng(mu)
    w = rng.standard_normal((6, 3), dtype=np.float32)
    b = rng.standard_normal((3,), dtype=np.float32)
    x = rng.standard_normal((8, 6), dtype=np.float32)
    y = rng.standard_normal((8, 3), dtype=np.float32)

    def jgrad_fn(p, batch):
        def loss(p):
            pred = batch["x"] @ p["w"] + p["b"]
            return jnp.mean((pred - batch["y"]) ** 2), None
        return jax.value_and_grad(loss, has_aux=True)(p)

    def tgrad_fn(p, batch):
        leaves = [p["b"].requires_grad_(), p["w"].requires_grad_()]
        pred = batch["x"] @ p["w"] + p["b"]
        loss = ((pred - batch["y"]) ** 2).mean()
        gb, gw = torch.autograd.grad(loss, leaves)
        return (loss.detach(), None), {"b": gb, "w": gw}

    (jl, _), jg = joptim.accumulate_grads(
        jgrad_fn, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, mu)
    (tl, aux), tg = accumulate_grads(
        tgrad_fn, {"w": _t(w), "b": _t(b)}, {"x": _t(x), "y": _t(y)}, mu)
    assert aux is None
    np.testing.assert_allclose(float(tl), float(jl), rtol=ACCUM_TOL)
    for k in ("w", "b"):
        assert tg[k].dtype == torch.float32
        np.testing.assert_allclose(tg[k].detach().numpy(), np.asarray(jg[k]),
                                   atol=ACCUM_TOL, rtol=ACCUM_TOL)


# ---------------------------------------------------------------------------
# the repair: RunConfig's impl fields reach the step


def test_port_impls_translates_the_jax_names():
    assert port_impls({"attn": "pallas", "ce": "pallas", "ssm": "pallas",
                       "moe": "ep"}) == {"attn": "kernel", "ce": "kernel",
                                         "ssm": "kernel", "moe": "ep"}
    assert port_impls({"attn": "auto", "ce": "jnp", "ssm": "jnp",
                       "moe": "dense", "attn_block": 1024}) == {
        "attn": "auto", "ce": "plain", "ssm": "plain", "moe": "dense",
        "attn_block": 1024}


@pytest.mark.parametrize("attn_impl,ce_impl,want_attn,want_ce", [
    ("naive", "jnp", 0, 0), ("pallas", "pallas", 2, 1),
    ("auto", "pallas", 0, 1)])
def test_run_impl_fields_reach_the_loss(monkeypatch, attn_impl, ce_impl,
                                        want_attn, want_ce):
    """On the parent, make_lm_loss ignored RunConfig's impl fields and
    always called the kernel wrappers: RunConfig(attn_impl="naive")
    still reached kops.flash_attention. Now the fields decide, and
    impls= still overrides them."""
    calls = {"attn": 0, "ce": 0}
    fa, ce = kops.flash_attention, kops.softmax_xent_tokens

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(kops, "flash_attention", count("attn", fa))
    monkeypatch.setattr(kops, "softmax_xent_tokens", count("ce", ce))
    cfg = treduced(tget_config("minitron-4b"))
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                    mpsl=MPSLConfig(n_clients=2, trainable_blocks=1),
                    compute_dtype="float32", attn_impl=attn_impl,
                    ce_impl=ce_impl, remat="none")
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), cfg, run)
    rng = np.random.default_rng(0)
    batch = {"tokens": _t(rng.integers(0, cfg.vocab_size, (2, 2, 12))),
             "labels": _t(rng.integers(0, cfg.vocab_size, (2, 2, 12))),
             "mask": torch.ones(2)}
    mpsl.make_lm_loss(cfg, run)(params, frozen, batch, 0)
    assert calls == {"attn": want_attn, "ce": want_ce}
    calls.update(attn=0, ce=0)
    mpsl.make_lm_loss(cfg, run, impls=mpsl.KERNEL_IMPLS)(params, frozen,
                                                        batch, 0)
    assert calls == {"attn": 2, "ce": 1}
