"""The port's SSM family against the JAX package on the CPU.

Reduced falcon-mamba-7b (2 Mamba blocks, d_model 64, d_inner 128,
d_state 4) and reduced hymba-1.5b (2 hybrid blocks: one global, one
sliding-window; 4 heads, 1 KV head), on the same params (built by the JAX
package, carried over by the bridge) and the same numpy inputs: the Mamba
and hybrid blocks with and without a cache, the whole body, serving
(logits, greedy tokens, caches), and one MPSL step's loss and every
gradient with compression off and on. The port's "kernel" path (the
kernels' plain versions, on the CPU) is held to the JAX package's
"pallas" path (its Pallas kernels in interpret mode), the port's "plain"
path to its "jnp" path. Then the bridge, the segment split of hymba's
five segments, and the port's decode-vs-full-forward property, including
a prompt longer than a window cache."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro.core import mpsl as jmpsl
from repro.core import split as jsplit
from repro.models import hybrid as JH
from repro.models import layers as JL
from repro.models import mamba as JMB
from repro.models import model as JM
from repro_torch import bridge, tree
from repro_torch.configs import MPSLConfig as TMPSLConfig
from repro_torch.configs import RunConfig as TRunConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.core import mpsl, split
from repro_torch.launch import serve
from repro_torch.models import hybrid as TH
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM

SSM_ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
# (port impls, JAX impls) of the two paths
PATHS = {"kernel": ({"attn": "kernel", "ssm": "kernel"},
                    {"attn": "pallas", "ssm": "pallas"}),
         "plain": ({"attn": "naive", "ssm": "plain"},
                   {"attn": "naive", "ssm": "jnp"})}
# one block: f32 sums in other orders (tests/test_torch_model.py F32)
BLOCK = dict(atol=2e-5, rtol=2e-5)
# two blocks and the final norm (test_torch_model.py BODY), and serving
# (test_torch_serve.py TOL)
BODY = dict(atol=5e-5, rtol=5e-5)
SERVE = dict(atol=1e-4, rtol=1e-4)
# tests/test_smoke_archs.py::test_decode_matches_full_forward
DECODE_VS_FULL = 5e-5
# the MPSL step (tests/test_torch_mpsl.py)
N, BN, S = 3, 2, 12
LOSS_TOL, GRAD_TOL, ADAPTER_L2_TOL = 1e-5, 1e-4, 1e-3


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _cfgs(arch, **kw):
    return reduced(get_config(arch), **kw), treduced(tget_config(arch), **kw)


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _pos(b, s, offset=0):
    return np.broadcast_to(np.arange(offset, offset + s, dtype=np.int32),
                           (b, s)).copy()


# ---------------------------------------------------------------------------
# the Mamba block


@pytest.fixture(scope="module")
def mamba_params():
    jcfg, tcfg = _cfgs("falcon-mamba-7b")
    jp = _np_tree(JMB.init_mamba(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jp, bridge.from_repro(jp)


@pytest.mark.parametrize("path", ["kernel", "plain"])
def test_apply_mamba_without_cache(mamba_params, path):
    jcfg, tcfg, jp, tp = mamba_params
    x = _x(0, 2, 24, jcfg.d_model)
    jimpl, timpl = PATHS[path][1]["ssm"], PATHS[path][0]["ssm"]
    want, _ = JMB.apply_mamba(jp, jnp.asarray(x), jcfg, impl=jimpl, chunk=8)
    got, cache = TMB.apply_mamba(tp, _t(x), tcfg, impl=timpl, chunk=8)
    assert cache is None
    _close(got, want, BLOCK)


@pytest.mark.parametrize("path", ["kernel", "plain"])
def test_apply_mamba_prefill_then_decode_with_cache(mamba_params, path):
    """Prefill seeds the scan with the cached state; decode runs the
    recurrence step. Outputs and both cache leaves, after each call."""
    jcfg, tcfg, jp, tp = mamba_params
    b, s = 2, 12
    x = _x(1, b, s + 2, jcfg.d_model)
    jimpl, timpl = PATHS[path][1]["ssm"], PATHS[path][0]["ssm"]
    jc = JMB.init_mamba_cache(jcfg, b, dtype=jnp.float32)
    tc = TMB.init_mamba_cache(tcfg, b, torch.float32)
    h_buf = tc["h"]
    for lo, hi in ((0, s), (s, s + 1), (s + 1, s + 2)):
        want, jc = JMB.apply_mamba(jp, jnp.asarray(x[:, lo:hi]), jcfg,
                                   cache=jc, impl=jimpl, chunk=4)
        got, tc = TMB.apply_mamba(tp, _t(x[:, lo:hi]), tcfg, cache=tc,
                                  impl=timpl, chunk=4)
        _close(got, want, BLOCK)
        _close(tc["h"], jc["h"], BLOCK)
        _close(tc["conv"], jc["conv"], BLOCK)
    assert tc["h"] is h_buf and tc["h"].dtype == torch.float32   # in place


def test_causal_conv_and_step_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    _close(TMB._causal_depthwise_conv(_t(x), _t(w), _t(bias)),
           JMB._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(bias)), BLOCK)
    xs, dts = x[:, 0], np.abs(x[:, 1]) * 0.1
    bc = rng.standard_normal((2, 4)).astype(np.float32)
    al = np.log(np.arange(1, 5, dtype=np.float32))[None].repeat(16, 0)
    h = rng.standard_normal((2, 16, 4)).astype(np.float32)
    got = TMB.selective_scan_step(_t(xs), _t(dts), _t(bc), _t(bc[::-1]),
                                  _t(al), _t(h))
    want = JMB.selective_scan_step(*map(jnp.asarray, (xs, dts, bc, bc[::-1],
                                                      al, h)))
    for g, w_ in zip(got, want):
        _close(g, w_, BLOCK)


# ---------------------------------------------------------------------------
# the hybrid block


@pytest.mark.parametrize("is_global", [True, False])
@pytest.mark.parametrize("path", ["kernel", "plain"])
def test_apply_hybrid(path, is_global):
    """The sliding window (8) is shorter than the sequence (12)."""
    jcfg, tcfg = _cfgs("hymba-1.5b", sliding_window=8)
    jp = _np_tree(JH.init_hybrid(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(3)
    for k in ("attn_norm", "ssm_norm"):   # a non-trivial norm and beta
        jp[k]["scale"] = rng.standard_normal(jcfg.d_model).astype(
            np.float32) * 0.1
    jp["beta_ssm"] = np.float32(0.7)
    tp = bridge.from_repro(jp)
    x = _x(4, 2, 12, jcfg.d_model)
    pos = _pos(2, 12)
    ti, ji = PATHS[path]
    want, _ = JH.apply_hybrid(jp, jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos), is_global=is_global,
                              impl=ji["attn"], ssm_impl=ji["ssm"])
    got, cache = TH.apply_hybrid(tp, _t(x), tcfg, positions=_t(pos),
                                 is_global=is_global, impl=ti["attn"],
                                 ssm_impl=ti["ssm"])
    assert cache is None
    _close(got, want, BLOCK)


# ---------------------------------------------------------------------------
# the whole body


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("path", ["kernel", "plain"])
def test_forward_body_hidden_states(arch, path):
    kw = {"sliding_window": 8} if arch == "hymba-1.5b" else {}
    jcfg, tcfg = _cfgs(arch, **kw)
    params = _np_tree(JM.init_lm(jax.random.PRNGKey(1), jcfg))
    tparams = bridge.from_repro(params)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 12))
    pos = _pos(2, 12)
    ti, ji = PATHS[path]
    jh = JM.embed_tokens(params, jnp.asarray(tokens), jcfg, dtype=jnp.float32)
    want, _, _ = JM.forward_body(params, jh, jcfg, positions=jnp.asarray(pos),
                                 impls=ji, remat=False)
    th = TM.embed_tokens(tparams, _t(tokens), tcfg, dtype=torch.float32)
    got, cache, aux = TM.forward_body(tparams, th, tcfg, positions=_t(pos),
                                      impls=ti)
    assert cache is None and aux == 0.0
    _close(got, want, BODY)
    _close(TM.lm_logits(tparams, got, tcfg),
           JM.lm_logits(params, want, jcfg), BODY)


# ---------------------------------------------------------------------------
# serving against the JAX package


def _jax_serving_fns(cfg):
    """repro.launch.serve.build_serving_fns with the Pallas kernels."""
    impls = {"attn": "pallas", "ssm": "pallas"}

    def prefill(params, tokens):
        b, s = tokens.shape
        cache = JM.init_body_cache(cfg, b, s + 512, jnp.float32)
        h = JM.embed_tokens(params, tokens, cfg, dtype=jnp.float32)
        h, cache, _ = JM.forward_body(params, h, cfg,
                                      positions=JL.positions_from_shape(b, s),
                                      cache=cache, impls=impls, remat=False)
        return JM.lm_logits(params, h[:, -1:], cfg), cache

    def decode(params, cache, tokens, positions):
        h = JM.embed_tokens(params, tokens, cfg, positions=positions,
                            dtype=jnp.float32)
        h, cache, _ = JM.forward_body(params, h, cfg, positions=positions,
                                      cache=cache, impls=impls, remat=False)
        return JM.lm_logits(params, h, cfg), cache

    return jax.jit(prefill), jax.jit(decode)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_matches_jax(arch):
    """Prefill and 3 decode steps, teacher-forced with the port's greedy
    tokens: logits, greedy tokens, and every cache leaf after the last
    step (stacked into the JAX layout)."""
    jcfg, tcfg = _cfgs(arch)
    params = _np_tree(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    b, s, steps = 2, 12, 3
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (b, s))
    prefill, decode = serve.build_serving_fns(tcfg, device="cpu")
    tparams = bridge.from_repro(params)
    logits, tcache = prefill(tparams, _t(tokens))
    got = [logits[:, -1]]
    for i in range(steps):
        tok = got[-1].argmax(-1)[:, None]
        pos = torch.full((b, 1), s + i, dtype=torch.int32)
        logits, tcache = decode(tparams, tcache, tok, pos)
        got.append(logits[:, -1])
    got = torch.stack(got, dim=1)

    j_prefill, j_decode = _jax_serving_fns(jcfg)
    logits, jcache = j_prefill(params, jnp.asarray(tokens, jnp.int32))
    want = [np.asarray(logits[:, -1])]
    fed = got.argmax(-1).numpy()
    for i in range(steps):
        logits, jcache = j_decode(params, jcache,
                                  jnp.asarray(fed[:, i:i + 1], jnp.int32),
                                  jnp.full((b, 1), s + i, jnp.int32))
        want.append(np.asarray(logits[:, -1]))
    want = np.stack(want, axis=1)
    _close(got, want, SERVE)
    np.testing.assert_array_equal(fed, want.argmax(-1))
    gl, gdef = jax.tree_util.tree_flatten(bridge.cache_to_repro(tcache))
    wl, wdef = jax.tree_util.tree_flatten(_np_tree(jcache))
    assert gdef == wdef
    for g, w in zip(gl, wl):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **SERVE)


@pytest.mark.parametrize("arch,window", [("falcon-mamba-7b", 0),
                                         ("hymba-1.5b", 64),
                                         ("hymba-1.5b", 8)])
def test_decode_matches_full_forward(arch, window):
    """The port's cached path: prefill of 12 then 4 decode steps against
    the full forward of all 16 tokens (no cache), < 5e-5. With a window of
    8 the prompt overfills the local layer's ring cache (12 % 8 = 4), and
    every decode step must still see exactly its window."""
    tcfg = treduced(tget_config(arch),
                    **({"sliding_window": window} if window else {}))
    params = TM.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    b, s, steps = 2, 12, 4
    tokens = torch.randint(0, tcfg.vocab_size, (b, s + steps),
                           generator=torch.Generator().manual_seed(1))
    impls = {"attn": "kernel", "ssm": "kernel"}
    pos = TL.positions_from_shape(b, s + steps)
    h = TM.embed_tokens(params, tokens, tcfg, dtype=torch.float32)
    full, _, _ = TM.forward_body(params, h, tcfg, positions=pos, impls=impls)
    cache = TM.init_body_cache(tcfg, b, s + steps, torch.float32)
    outs = []
    for lo, hi in [(0, s)] + [(t, t + 1) for t in range(s, s + steps)]:
        ht = TM.embed_tokens(params, tokens[:, lo:hi], tcfg,
                             dtype=torch.float32)
        o, cache, _ = TM.forward_body(params, ht, tcfg,
                                      positions=pos[:, lo:hi], cache=cache,
                                      impls=impls)
        outs.append(o)
    inc = torch.cat(outs, dim=1)
    assert float((full - inc).abs().max()) < DECODE_VS_FULL


# ---------------------------------------------------------------------------
# one MPSL step against the JAX package


def _runs(arch, compress):
    jcfg, tcfg = _cfgs(arch)
    mp = dict(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
              compress_uplink=compress, compress_downlink=compress)
    jrun = RunConfig(model=jcfg, shape=SHAPES["train_4k"],
                     mpsl=MPSLConfig(**mp), compute_dtype="float32",
                     attn_impl="pallas", ce_impl="pallas", ssm_impl="pallas")
    trun = TRunConfig(model=tcfg, shape=None, mpsl=TMPSLConfig(**mp),
                      compute_dtype="float32", attn_impl="kernel",
                      ce_impl="kernel", ssm_impl="kernel")
    return jcfg, jrun, tcfg, trun


@pytest.fixture(scope="module", params=SSM_ARCHS)
def mpsl_trees(request):
    jcfg, jrun, _, _ = _runs(request.param, False)
    params, frozen, _ = jsplit.init_mpsl_lm(jax.random.PRNGKey(0), jcfg, jrun)
    # a nonzero adapter b, so the adapter's 'a' gets a gradient too
    params["client"]["adapter"]["b"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(1), params["client"]["adapter"]["b"].shape)
    return request.param, _np_tree(params), _np_tree(frozen)


def _assert_trees_close(got, want, l2_paths=()):
    gl, gdef = jax.tree_util.tree_flatten(bridge.to_repro(got))
    wl, _ = jax.tree_util.tree_flatten_with_path(_np_tree(want))
    assert gdef == jax.tree_util.tree_structure(_np_tree(want))
    for g, (path, w) in zip(gl, wl):
        name = jax.tree_util.keystr(path)
        if any(p in name for p in l2_paths):
            err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            assert err <= ADAPTER_L2_TOL, (name, err)
        else:
            scale = float(np.abs(w).max()) + 1e-12
            assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, name


@pytest.mark.parametrize("compress", [False, True])
def test_mpsl_loss_and_grads_match_jax(mpsl_trees, compress):
    arch, params, frozen = mpsl_trees
    jcfg, jrun, tcfg, trun = _runs(arch, compress)
    rng = np.random.default_rng(7)
    b = {"tokens": rng.integers(0, jcfg.vocab_size, (N, BN, S)),
         "labels": rng.integers(0, jcfg.vocab_size, (N, BN, S)),
         "mask": np.ones(N, np.float32)}
    key = jax.random.PRNGKey(5)
    (jl, jmet), jg = jax.value_and_grad(jmpsl.make_lm_loss(jcfg, jrun),
                                        has_aux=True)(
        params, frozen, {"tokens": jnp.asarray(b["tokens"], jnp.int32),
                         "labels": jnp.asarray(b["labels"], jnp.int32),
                         "mask": jnp.asarray(b["mask"])}, key)
    draws = 0
    if compress:        # the draws the JAX loss makes from `key`
        r_up, r_down = jax.random.split(jax.random.fold_in(key, 1))
        shape = (N, BN, S, tcfg.d_model)
        draws = {"uplink": _t(jax.random.uniform(r_up, shape)),
                 "downlink": _t(jax.random.uniform(r_down, shape))}
    tparams, tfrozen = bridge.from_repro(params), bridge.from_repro(frozen)
    leaves = tree.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = mpsl.make_lm_loss(tcfg, trun)(
        tparams, tfrozen, {k: torch.from_numpy(v) for k, v in b.items()},
        draws)
    grads = iter(torch.autograd.grad(loss, leaves))
    grads = tree.map_(lambda _: next(grads), tparams)
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL * abs(float(jl))
    np.testing.assert_allclose(met["per_client"].detach().numpy(),
                               np.asarray(jmet["per_client"]), rtol=LOSS_TOL)
    _assert_trees_close(grads, jg,
                        l2_paths=("'adapter'",) if compress else ())


# ---------------------------------------------------------------------------
# the bridge, the port's init and the segment split


def _bitwise(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_bitwise(arch, dtype):
    jcfg, _ = _cfgs(arch)
    params = JM.init_lm(jax.random.PRNGKey(0), jcfg)
    if dtype == "bfloat16":
        params = JL.cast_tree(params, jnp.bfloat16)
    t = _np_tree(params)
    port = bridge.from_repro(t)
    first = port["segments"][0][0]
    if arch == "hymba-1.5b":
        assert first["mix"]["beta_attn"].shape == ()          # 0-d a layer
        assert t["segments"][0]["mix"]["beta_attn"].shape == (1,)
    else:
        assert first["ssm"]["A_log"].dtype == getattr(torch, dtype)
    _bitwise(bridge.to_repro(port), t)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_port_init_matches_tree_layout(arch):
    jcfg, tcfg = _cfgs(arch)
    want = _np_tree(JM.init_lm(jax.random.PRNGKey(0), jcfg))
    got = bridge.to_repro(TM.init_lm(tcfg, torch.Generator().manual_seed(0),
                                     "cpu"))
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    assert [(x.shape, x.dtype) for x in gl] == [(x.shape, x.dtype)
                                                for x in wl]
    # the S4D-real A and the dt bias's range, as the JAX init draws them
    mb = got["segments"][0]["ssm" if arch == "falcon-mamba-7b" else "mix"]
    mb = mb if arch == "falcon-mamba-7b" else mb["ssm"]
    np.testing.assert_allclose(np.exp(mb["A_log"][0, 0]),
                               np.arange(1, tcfg.ssm.d_state + 1), rtol=1e-6)
    dt = np.log1p(np.exp(mb["dt_bias"]))
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)


@pytest.mark.parametrize("boundary", range(0, 33, 4))
def test_split_segments_cuts_hymbas_five_segments(boundary):
    """hymba-1.5b's 32 layers make 5 segments (global 0, local 1-14,
    global 15, local 16-30, global 31); the port cuts them at any layer
    boundary as the JAX package does."""
    jsegs = JM.body_segments(get_config("hymba-1.5b"))
    tsegs = TM.body_segments(tget_config("hymba-1.5b"))
    assert [(s.count, s.kind.is_global) for s in tsegs] == \
        [(1, True), (14, False), (1, True), (15, False), (1, True)]
    jf, jt = jsplit.split_segments(jsegs, boundary)
    tf, tt = split.split_segments(tsegs, boundary)
    for got, want in ((tf, jf), (tt, jt)):
        assert [(s.count, s.kind.family, s.kind.is_global) for s in got] == \
            [(s.count, s.kind.family, s.kind.is_global) for s in want]
    assert sum(s.count for s in tf) == boundary
