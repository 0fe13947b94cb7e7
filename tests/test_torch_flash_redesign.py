"""The flash-attention kernels' redesign for Hopper, on the CPU.

The split-KV route of the forward: chunk partials made by the plain
version and merged by ``merge_partials`` (the combine kernel's plain
version) against the JAX Pallas kernel in interpret mode, with empty
chunks, a ring of out-of-order positions under a window, and rows with no
key; the chunk planner's cover of the keys. The tensor-core route's
rounding points (a test-local model of where the bf16 kernels round)
against the JAX kernel and its VJP. The CE autograd Function's dtype
routing (the mixed pair reaches the kernels as it comes). And the bf16 compute paths that drive the new kernels, serving
and the MPSL loss of reduced minitron-4b, against the JAX package at
``compute_dtype="bfloat16"``. Inputs come from numpy with a seed."""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro.core import mpsl as jmpsl
from repro.core import split as jsplit
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge, tree
from repro_torch.configs import MPSLConfig as TMPSLConfig
from repro_torch.configs import RunConfig as TRunConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.core import mpsl
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import softmax_xent as sx
from repro_torch.launch import serve

# tests/test_kernels.py's kernel tolerances
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# the split-KV route: partials, merge, planner


def _decode_case(case, seed=0):
    """Numpy inputs (q, k, v f32; q_pos, k_pos, k_valid; causal, window)."""
    rng = np.random.default_rng(seed)
    if case == "half_empty":
        # a 48-slot cache with 24 filled, one query at the last position
        b, sq, sk, h, kh, hd, window = 2, 1, 48, 6, 2, 16, 0
        kp = np.full((b, sk), -1, np.int32)
        kp[:, :24] = np.arange(24)
        kv = kp >= 0
        qp = np.full((b, sq), 23, np.int32)
    elif case == "ring_window":
        # a 32-slot ring holding positions 9..40 out of slot order (slot
        # p % 32), window 24 from query 40, G = 5
        b, sq, sk, h, kh, hd, window = 2, 1, 32, 10, 2, 16, 24
        pos = np.arange(9, 41, dtype=np.int32)
        kp = np.empty((b, sk), np.int32)
        kp[:, pos % sk] = pos
        kv = np.ones((b, sk), bool)
        qp = np.full((b, sq), 40, np.int32)
    else:   # no_key_row: batch row 1 has no valid key; two queries a row
        b, sq, sk, h, kh, hd, window = 2, 2, 40, 6, 3, 16, 0
        kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
        kv = rng.random((b, sk)) < 0.6
        kv[0, 0] = True
        kv[1] = False
        qp = np.full((b, sq), [38, 39], np.int32)
    q = rng.standard_normal((b, sq, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, sk, kh, hd), dtype=np.float32)
    v = rng.standard_normal((b, sk, kh, hd), dtype=np.float32)
    return q, k, v, qp, kp, kv, True, window


def _split_plain(q, k, v, qp, kp, kv, causal, window, chunk):
    """The split kernel's partials by the plain version, chunk by chunk:
    (o_parts [n,B,Sq,H,hd] f32, lse_parts [n,B,H,Sq], -inf where no key of
    the chunk passes the mask)."""
    h = q.shape[2]
    o_parts, lse_parts = [], []
    for lo in range(0, k.shape[1], chunk):
        sl = slice(lo, lo + chunk)
        o, lse = fa.flash_attention_plain(q, k[:, sl], v[:, sl], qp, kp[:, sl],
                                          causal=causal, window=window,
                                          k_valid=kv[:, sl])
        seen = fa.pair_mask(qp, kp[:, sl], kv[:, sl], causal,
                            window).any(-1)                   # [B, Sq]
        seen = seen[:, None, :].expand(-1, h, -1)
        o_parts.append(o.float())
        lse_parts.append(torch.where(seen, lse, -torch.inf))
    return torch.stack(o_parts), torch.stack(lse_parts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_chunks", [1, 3, 8])
@pytest.mark.parametrize("case", ["half_empty", "ring_window", "no_key_row"])
def test_merged_partials_match_jax(case, n_chunks, dtype):
    q, k, v, qp, kp, kv, causal, window = _decode_case(case)
    jt, tt = JNP[dtype], TORCH[dtype]
    o_ref, lse_ref = jax_fwd(
        jnp.asarray(q, jt), jnp.asarray(k, jt), jnp.asarray(v, jt),
        jnp.asarray(qp), jnp.asarray(kp), causal=causal, window=window,
        k_valid=jnp.asarray(kv), block_q=8, block_k=16, return_lse=True,
        interpret=True)
    o_ref, lse_ref = np.asarray(o_ref.astype(jnp.float32)), np.asarray(lse_ref)

    tq, tk, tv = (torch.from_numpy(x).to(tt) for x in (q, k, v))
    tqp, tkp, tkv = (torch.from_numpy(x) for x in (qp, kp, kv))
    chunk = -(-k.shape[1] // n_chunks)
    o_parts, lse_parts = _split_plain(tq, tk, tv, tqp, tkp, tkv, causal,
                                      window, chunk)
    if case == "half_empty" and n_chunks == 8:
        assert torch.isneginf(lse_parts[4:]).all()   # whole chunks empty
    o, lse = fa.merge_partials(o_parts, lse_parts, tt)
    assert o.dtype == tt and o.shape == tq.shape and lse.shape == lse_ref.shape
    np.testing.assert_allclose(o.float().numpy(), o_ref, atol=TOL[dtype],
                               rtol=TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=TOL[dtype],
                               rtol=TOL[dtype])
    if case == "no_key_row":     # o = 0 and lse = 0 where no key is valid
        for out, l in ((o.float().numpy(), lse.numpy()), (o_ref, lse_ref)):
            assert not out[1].any() and not l[1].any()
            assert l[0].all()


def test_merge_gives_an_empty_chunk_weight_zero():
    """An empty chunk marked -inf leaves the merge unchanged; read as a
    partial with lse 0 (the TPU's convention for a row with no key), it
    would pull the result towards its o = 0."""
    q, k, v, qp, kp, kv, causal, window = _decode_case("half_empty")
    args = [torch.from_numpy(x) for x in (q, k, v, qp, kp, kv)]
    o_parts, lse_parts = _split_plain(*args, causal, window, 6)
    want, want_lse = fa.merge_partials(o_parts[:4], lse_parts[:4],
                                       torch.float32)
    got, got_lse = fa.merge_partials(o_parts, lse_parts, torch.float32)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-6, rtol=1e-6)
    wrong, _ = fa.merge_partials(o_parts, lse_parts.nan_to_num(neginf=0.0),
                                 torch.float32)
    assert (wrong - want).abs().max() > 1e-3


PLANS = list(itertools.product((1, 2, 4, 7, 64), (1, 5, 8), (1, 63, 64, 513,
                                                              1024, 4097),
                               (1, 16, 132)))


@pytest.mark.parametrize("b,kh,sk,sms", PLANS[::9])
def test_split_plan_covers_the_keys_once(b, kh, sk, sms):
    n, chunk = fa.split_plan(b, kh, sk, sms)
    assert chunk % fa.SPLIT_TILE == 0 and chunk > 0
    covered = np.zeros(sk, int)
    for c in range(n):
        covered[c * chunk:min(sk, (c + 1) * chunk)] += 1
    assert (covered == 1).all()
    assert (n - 1) * chunk < sk <= n * chunk     # no empty trailing chunk


@pytest.mark.parametrize("b,kh,sk,want", [(4, 8, 1024, (16, 64)),
                                          (4, 5, 1024, (16, 64)),
                                          (64, 8, 4096, (2, 2048))])
def test_split_plan_fills_the_card_at_the_decode_shapes(b, kh, sk, want):
    """minitron-4b's decode (8 kv heads, a 1024-slot cache) and hymba-1.5b's
    (5 kv heads, its 1024-slot ring) on 132 SMs: at least two blocks an SM,
    one tile a chunk; a large batch: long chunks, about four blocks an SM."""
    n, chunk = fa.split_plan(b, kh, sk, 132)
    assert (n, chunk) == want
    assert b * kh * n >= 2 * 132


def test_decode_takes_the_split_route_and_prefill_does_not():
    assert fa.uses_split(1, 24, 8) and fa.uses_split(1, 25, 5)
    assert fa.uses_split(2, 12, 4)                 # 6 rows a kv head
    assert not fa.uses_split(512, 24, 8)
    assert not fa.uses_split(1, 64, 2)             # G = 32 > 16 rows


# ---------------------------------------------------------------------------
# the tensor-core route's rounding points


def _tc_model(q, k, v, qp, kp, kv, causal, window, do=None):
    """Where the bf16 kernels round, materialized: s = (q . k) * scale in
    f32 from bf16 operands; p rounded to bf16 before PV; in the backward p
    and ds rounded to bf16 before their products. Returns (o, lse) or
    (dq, dk, dv), in bf16 / f32."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    rb = lambda t: t.to(torch.bfloat16).float()          # noqa: E731
    qf = q.float().reshape(b, sq, kh, g, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    ok = fa.pair_mask(qp, kp, kv, causal, window)[:, None, None]
    m = torch.where(ok, s, -torch.inf).amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(-1)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-30)), 0.0)
    if do is None:
        o = torch.einsum("bkgqs,bskd->bqkgd", rb(p), vf)
        o = o / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
        return (o.reshape(b, sq, h, hd).to(torch.bfloat16),
                lse.reshape(b, h, sq))
    o, _ = _tc_model(q, k, v, qp, kp, kv, causal, window)
    dof = do.float().reshape(b, sq, kh, g, hd)
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = rb(p * (dp - delta.reshape(b, kh, g, sq)[..., None]))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", rb(p), dof)
    return (dq.reshape(b, sq, h, hd).to(torch.bfloat16),
            dk.to(torch.bfloat16), dv.to(torch.bfloat16))


# name: (b, sq, sk, h, kh, hd, window, hole in k_valid)
TC_CASES = {"causal_gqa": (2, 24, 24, 4, 2, 16, 0, False),
            "window_g5": (1, 24, 24, 10, 2, 16, 7, False),
            "k_valid": (2, 16, 40, 6, 3, 32, 0, True)}


def _tc_inputs(case, seed=0):
    b, sq, sk, h, kh, hd, window, hole = TC_CASES[case]
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal(s, dtype=np.float32)
         for s in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd),
                   (b, sq, h, hd))]
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    qp = kp[:, sk - sq:].copy()
    kv = rng.random((b, sk)) < 0.7 if hole else np.ones((b, sk), bool)
    kv[:, 0] = True
    return (*x, qp, kp, kv, window)


@pytest.mark.parametrize("case", list(TC_CASES))
def test_tensor_core_rounding_points_stay_within_bf16_tolerance(case):
    q, k, v, do, qp, kp, kv, window = _tc_inputs(case)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jpos = dict(causal=True, window=window, k_valid=jnp.asarray(kv))

    def f(q, k, v):
        return jops.flash_attention(q, k, v, jnp.asarray(qp), jnp.asarray(kp),
                                    block_q=8, block_k=16, **jpos)

    o_j, lse_j = jax_fwd(jq, jk, jv, jnp.asarray(qp), jnp.asarray(kp),
                         block_q=8, block_k=16, return_lse=True,
                         interpret=True, **jpos)
    _, vjp = jax.vjp(f, jq, jk, jv)
    grads_j = vjp(jdo)

    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    pos = (torch.from_numpy(qp), torch.from_numpy(kp), torch.from_numpy(kv),
           True, window)
    o, lse = _tc_model(tq, tk, tv, *pos)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_j.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=tol,
                               rtol=tol)
    for name, got, want in zip(("dq", "dk", "dv"),
                               _tc_model(tq, tk, tv, *pos, do=tdo), grads_j):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# the CE Function at mixed dtypes (a bf16 hidden state, an f32 head)


def test_ce_function_hands_the_kernel_the_mixed_pair(monkeypatch):
    """At bf16 compute the trainable head stays f32: the Function hands the
    CUDA kernels the pair as it comes (bf16 h, f32 w; the kernels form
    every product from bf16 pieces with f32 sums, as the TPU kernel upcasts
    both tiles) and returns dh in h's dtype, dw in w's. The kernel wrappers
    are stood in for by their plain versions, which record the dtypes they
    are handed."""
    seen = []

    def fwd(h, w, labels):
        seen.append(("fwd", h.dtype, w.dtype))
        return sx.softmax_xent_fwd_plain(h, w, labels)

    def bwd(h, w, labels, lse, g):
        seen.append(("bwd", h.dtype, w.dtype))
        return sx.softmax_xent_bwd_plain(h, w, labels, lse, g)

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(sx, "softmax_xent_fwd", fwd)
    monkeypatch.setattr(sx, "softmax_xent_bwd", bwd)
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((12, 16), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 40), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 40, 12).astype(np.int32))
    hb = h.to(torch.bfloat16).requires_grad_()
    wf = w.clone().requires_grad_()
    loss = ops.softmax_xent_tokens(hb, wf, labels)
    loss.sum().backward()
    assert seen == [("fwd", torch.bfloat16, torch.float32),
                    ("bwd", torch.bfloat16, torch.float32)]
    assert hb.grad.dtype == torch.bfloat16 and wf.grad.dtype == torch.float32
    # the same function as in f32 on the upcast h
    hf = hb.detach().float().requires_grad_()
    wf2 = w.clone().requires_grad_()
    want = sx.softmax_xent_fwd_plain(hf, wf2, labels)[0]
    want.sum().backward()
    torch.testing.assert_close(loss, want)
    torch.testing.assert_close(wf.grad, wf2.grad)
    torch.testing.assert_close(hb.grad, hf.grad.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the bf16 compute paths against the JAX package

B, S, STEPS = 2, 12, 3
# bf16's ulp is 2^-8: the frameworks round each layer's bf16 activations
# after sums taken in other orders
SERVE_TOL_BF16 = 2e-2
TRAIN_LOSS_TOL_BF16 = 1e-2
TRAIN_GRAD_TOL_BF16 = 5e-2


def test_bf16_serving_matches_jax():
    """Reduced minitron-4b served at bf16 compute: prefill and every decode
    step's logits within 2e-2 of the largest |logit| of JAX's (Pallas
    attention, interpret mode, teacher-forced with the port's tokens)."""
    cfg = reduced(get_config("minitron-4b"))
    params = jax.tree_util.tree_map(np.asarray,
                                    JM.init_lm(jax.random.PRNGKey(0), cfg))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    prefill, decode = serve.build_serving_fns(cfg, torch.bfloat16, "cpu")
    out = serve.generate(prefill, decode, bridge.from_repro(params),
                         torch.from_numpy(tokens), STEPS)

    impls = {"attn": "pallas"}
    cdt = jnp.bfloat16

    @jax.jit
    def j_prefill(params, tokens):
        cache = JM.init_body_cache(cfg, B, S + 512, cdt)
        h = JM.embed_tokens(params, tokens, cfg, dtype=cdt)
        h, cache, _ = JM.forward_body(params, h, cfg,
                                      positions=JL.positions_from_shape(B, S),
                                      cache=cache, impls=impls, remat=False)
        return JM.lm_logits(params, h[:, -1:], cfg), cache

    @jax.jit
    def j_decode(params, cache, tok, pos):
        h = JM.embed_tokens(params, tok, cfg, positions=pos, dtype=cdt)
        h, cache, _ = JM.forward_body(params, h, cfg, positions=pos,
                                      cache=cache, impls=impls, remat=False)
        return JM.lm_logits(params, h, cfg), cache

    logits, cache = j_prefill(params, jnp.asarray(tokens, jnp.int32))
    ref = [np.asarray(logits[:, -1].astype(jnp.float32))]
    fed = out["tokens"].numpy()
    for i in range(STEPS):
        logits, cache = j_decode(params, cache,
                                 jnp.asarray(fed[:, i:i + 1], jnp.int32),
                                 jnp.full((B, 1), S + i, jnp.int32))
        ref.append(np.asarray(logits[:, -1].astype(jnp.float32)))
    ref = np.stack(ref, axis=1)
    got = out["logits"].float().numpy()
    assert out["logits"].dtype == torch.bfloat16 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= SERVE_TOL_BF16 * np.abs(ref).max()


def test_bf16_mpsl_loss_and_grads_match_jax():
    """Reduced minitron-4b's MPSL loss at compute_dtype="bfloat16" (frozen
    tree bf16, trainable params f32 cast at use; links uncompressed), the
    port's kernel entry points against JAX's Pallas kernels: the loss
    within 1e-2 relative, every gradient leaf within 5e-2 relative L2."""
    n = 3
    cfg = reduced(get_config("minitron-4b"))
    jrun = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                     mpsl=MPSLConfig(n_clients=n, trainable_blocks=1,
                                     head_adapter_rank=4),
                     compute_dtype="bfloat16", attn_impl="pallas",
                     ce_impl="pallas")
    params, frozen, _ = jsplit.init_mpsl_lm(jax.random.PRNGKey(0), cfg, jrun)
    params["client"]["adapter"]["b"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(1), params["client"]["adapter"]["b"].shape)
    params, frozen = (jax.tree_util.tree_map(np.asarray, t)
                      for t in (params, frozen))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (n, B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (n, B, S)),
             "mask": np.ones(n, np.float32)}
    jb = {k: jnp.asarray(v, jnp.float32 if k == "mask" else jnp.int32)
          for k, v in batch.items()}
    (jl, _), jg = jax.value_and_grad(jmpsl.make_lm_loss(cfg, jrun),
                                     has_aux=True)(params, frozen, jb,
                                                   jax.random.PRNGKey(5))

    tcfg = treduced(tget_config("minitron-4b"))
    trun = TRunConfig(model=tcfg, shape=None,
                      mpsl=TMPSLConfig(n_clients=n, trainable_blocks=1,
                                       head_adapter_rank=4),
                      compute_dtype="bfloat16", attn_impl="kernel",
                      ce_impl="kernel")
    tparams, tfrozen = bridge.from_repro(params), bridge.from_repro(frozen)
    leaves = tree.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = mpsl.make_lm_loss(tcfg, trun)(
        tparams, tfrozen, {k: torch.from_numpy(v) for k, v in batch.items()},
        0)
    grads = iter(torch.autograd.grad(loss, leaves))
    grads = bridge.to_repro(tree.map_(lambda _: next(grads), tparams))
    assert abs(float(loss.detach()) - float(jl)) <= \
        TRAIN_LOSS_TOL_BF16 * abs(float(jl))
    got, gdef = jax.tree_util.tree_flatten(grads)
    want, wdef = jax.tree_util.tree_flatten_with_path(jg)
    assert gdef == jax.tree_util.tree_structure(jg)
    for g, (path, w) in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
        assert err <= TRAIN_GRAD_TOL_BF16, (jax.tree_util.keystr(path), err)
