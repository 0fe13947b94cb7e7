"""The flash kernels' f32 route, on the CPU.

On the card the f32 flash kernels run every product on the tensor cores
from bf16 pieces of the f32 operands (x = hi + lo, three bf16 products,
lo.lo dropped). Their plain PyTorch models (``flash_attention_fwd_pieces``,
``flash_attention_bwd_pieces``) are held here to the JAX Pallas kernels in
interpret mode (the backward through ``jax.vjp`` of
``repro.kernels.ops.flash_attention``) over the masks and head groupings
the train paths give them, and the products to their stated error bound
against f64 at hd 128. Inputs come from numpy with a seed."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import pieces

# chip_smoke.py holds the kernels to their plain versions at 1e-4 of each
# output's largest element in f32: the pieces may spend half of it
CARD_TOL_F32 = 1e-4
TOL = CARD_TOL_F32 / 2

# name: (b, sq, sk, h, kh, hd, causal, window, layout); G = h / kh
CASES = {
    "causal_g1": (2, 24, 24, 2, 2, 32, True, 0, "square"),
    "window_g3": (1, 32, 32, 6, 2, 16, True, 7, "square"),
    "k_valid_g8": (1, 16, 40, 8, 1, 16, True, 0, "suffix_valid"),
    "ragged_hd64": (2, 12, 37, 2, 2, 64, True, 0, "suffix"),
    "noncausal": (2, 20, 33, 3, 3, 64, False, 0, "full"),
    "hd128": (1, 64, 64, 2, 1, 128, True, 0, "square"),
}
SLOW_CASES = {
    "train_like": (2, 128, 128, 6, 2, 128, True, 0, "square"),
    "noncausal_long": (1, 96, 160, 4, 4, 64, False, 0, "full"),
}
ALL_CASES = {**CASES, **SLOW_CASES}
PARAMS = [*CASES, *(pytest.param(c, marks=pytest.mark.slow)
                    for c in SLOW_CASES)]


def _make(case, seed=0):
    """Numpy inputs of a case: q, k, v, dO (f32), q_pos, k_pos, k_valid,
    causal, window. No row is fully masked."""
    b, sq, sk, h, kh, hd, causal, window, layout = ALL_CASES[case]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, h, hd), dtype=np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, kh, hd), dtype=np.float32)
            for _ in range(2))
    k_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    k_valid = np.ones((b, sk), bool)
    if layout in ("square", "full"):
        q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq)).copy()
    else:
        q_pos = k_pos[:, sk - sq:].copy()
        if layout == "suffix_valid":
            k_valid = rng.random((b, sk)) < 0.7
            k_valid[:, 0] = True          # every row keeps one valid key
    return q, k, v, do, q_pos, k_pos, k_valid, causal, window


def _blocks(sq, sk):
    return (8 if sq <= 32 else 32), (16 if sk <= 64 else 64)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _within(name, got, want, tol):
    """|got - want| <= tol * max |want|."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    err = np.abs(got - want).max()
    limit = tol * max(np.abs(want).max(), 1e-30)
    assert err <= limit, f"{name}: {err} > {limit}"


@pytest.mark.parametrize("case", PARAMS)
def test_pieces_forward_matches_jax_kernel(case):
    q, k, v, _, qp, kp, kv, causal, window = _make(case)
    bq, bk = _blocks(q.shape[1], k.shape[1])
    o_j, lse_j = jax_fwd(*(jnp.asarray(x) for x in (q, k, v, qp, kp)),
                         causal=causal, window=window,
                         k_valid=jnp.asarray(kv), block_q=bq, block_k=bk,
                         return_lse=True, interpret=True)
    tq, tk, tv, tqp, tkp, tkv = _torch(q, k, v, qp, kp, kv)
    o, lse = fa.flash_attention_fwd_pieces(tq, tk, tv, tqp, tkp,
                                           causal=causal, window=window,
                                           k_valid=tkv)
    assert o.dtype == torch.float32 and o.shape == tq.shape
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    _within("o", o, np.asarray(o_j), TOL)
    _within("lse", lse, np.asarray(lse_j), TOL)


@pytest.mark.parametrize("case", PARAMS)
def test_pieces_backward_matches_jax_vjp(case):
    q, k, v, do, qp, kp, kv, causal, window = _make(case, seed=1)
    bq, bk = _blocks(q.shape[1], k.shape[1])

    def f(q, k, v):
        return jops.flash_attention(q, k, v, jnp.asarray(qp), jnp.asarray(kp),
                                    causal=causal, window=window,
                                    k_valid=jnp.asarray(kv), block_q=bq,
                                    block_k=bk)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo, tqp, tkp, tkv = _torch(q, k, v, do, qp, kp, kv)
    o, lse = fa.flash_attention_fwd_pieces(tq, tk, tv, tqp, tkp,
                                           causal=causal, window=window,
                                           k_valid=tkv)
    got = fa.flash_attention_bwd_pieces(tq, tk, tv, tqp, tkp, tkv, o, lse,
                                        tdo, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        _within(name, g, w, TOL)


def test_pieces_models_match_the_plain_versions():
    """The pieces change the products' rounding only: at a G 3 window
    case, the route's models sit within the same half limit of the plain
    versions (the oracle the card holds the kernels to)."""
    q, k, v, do, qp, kp, kv, causal, window = _make("window_g3", seed=2)
    tq, tk, tv, tdo, tqp, tkp, tkv = _torch(q, k, v, do, qp, kp, kv)
    kw = dict(causal=causal, window=window)
    want = fa.flash_attention_plain(tq, tk, tv, tqp, tkp, k_valid=tkv, **kw)
    got = fa.flash_attention_fwd_pieces(tq, tk, tv, tqp, tkp, k_valid=tkv,
                                        **kw)
    for name, g, w in zip(("o", "lse"), got, want):
        _within(name, g, w.numpy(), TOL)
    args = (tq, tk, tv, tqp, tkp, tkv, *want, tdo)
    for name, g, w in zip(("dq", "dk", "dv"),
                          fa.flash_attention_bwd_pieces(*args, **kw),
                          fa.flash_attention_bwd_plain(*args, **kw)):
        _within(name, g, w.numpy(), TOL)


def _hi_einsum(eq, a, b):
    """The same product from the hi pieces alone (one bf16 product)."""
    return torch.einsum(eq, *(pieces.split_bf16(x)[0].float()
                              for x in (a, b)))


def _bound(eq, a, b, n):
    """The pieces' stated error of einsum(eq, a, b): PRODUCT_ERROR of
    sum |a_i| |b_i|, plus f32's own rounding of the 3n-term sum."""
    return ((pieces.PRODUCT_ERROR + 3 * n * 2.0 ** -24)
            * torch.einsum(eq, a.abs().double(), b.abs().double()))


def test_pieces_error_within_the_stated_bound_at_large_scores():
    """hd 128, scores up to |s| ~ 30, against f64: the score and PV
    products from pieces stay within their stated bound element by
    element, where the hi pieces alone miss it; so do o and lse, whose
    bound follows from the products' (a score error e moves each softmax
    weight by a factor within exp(+-2e))."""
    rng = np.random.default_rng(3)
    b, s, h, hd = 1, 64, 4, 128
    q = torch.from_numpy(rng.standard_normal((b, s, h, hd),
                                             dtype=np.float32) * 8)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, 1, hd),
                                                 dtype=np.float32))
            for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32)[None]
    kv = torch.ones((b, s), dtype=torch.bool)
    qg = (q * hd ** -0.5).reshape(b, s, 1, h, hd)
    qk = "bqkgd,bskd->bkgqs"
    s64 = torch.einsum(qk, qg.double(), k.double())
    assert 25 < s64.abs().max() < 40
    ok = fa.pair_mask(pos, pos, kv, True, 0)[:, None, None]
    bound_s = _bound(qk, qg, k, hd)
    err_s = (fa._pieces_einsum(qk, qg, k).double() - s64).abs()
    assert (err_s <= bound_s).all()
    assert ((_hi_einsum(qk, qg, k).double() - s64).abs() > bound_s).any()

    p64 = torch.softmax(s64.masked_fill(~ok, -torch.inf), dim=-1)
    pv = "bkgqs,bskd->bkgqd"
    o64 = torch.einsum(pv, p64, v.double())
    p32 = p64.float()
    bound_pv = _bound(pv, p32, v, s) + 2.0 ** -24 * torch.einsum(
        pv, p64, v.double().abs())          # p's own rounding to f32
    err_pv = (fa._pieces_einsum(pv, p32, v).double() - o64).abs()
    assert (err_pv <= bound_pv).all()
    assert ((_hi_einsum(pv, p32, v).double() - o64).abs() > bound_pv).any()

    o, lse = fa.flash_attention_fwd_pieces(q, k, v, pos, pos, causal=True,
                                           k_valid=kv)
    lse64 = torch.logsumexp(s64.masked_fill(~ok, -torch.inf), dim=-1)
    e = torch.where(ok, bound_s, 0.0).amax(-1)            # [b, 1, h, s]
    f32 = 8 * 2.0 ** -24                  # exp, log and the final divide
    assert ((lse.double() - lse64.reshape(b, h, s)).abs()
            <= (e + f32 * lse64.abs()).reshape(b, h, s)).all()
    o_err = (o.double().reshape(b, s, 1, h, hd).permute(0, 2, 3, 1, 4)
             - o64).abs()
    o_bound = ((torch.exp(2 * e) - 1 + f32)[..., None] * v.abs().max()
               + bound_pv)
    assert (o_err <= o_bound).all()


def test_fully_masked_rows_give_zero():
    """A batch row with no valid key and queries before every key: o = 0
    and lse = 0 in both models, as in the JAX kernel."""
    q, k, v, do, qp, kp, kv, causal, window = _make("k_valid_g8")
    q, k, v, do = (np.concatenate([x, x]) for x in (q, k, v, do))
    qp, kp, kv = (np.concatenate([x, x]) for x in (qp, kp, kv))
    kv[1] = False
    qp[0, :4] = -1
    o_j, lse_j = jax_fwd(*(jnp.asarray(x) for x in (q, k, v, qp, kp)),
                         causal=causal, window=window,
                         k_valid=jnp.asarray(kv), block_q=8, block_k=16,
                         return_lse=True, interpret=True)
    tq, tk, tv, tdo, tqp, tkp, tkv = _torch(q, k, v, do, qp, kp, kv)
    o, lse = fa.flash_attention_fwd_pieces(tq, tk, tv, tqp, tkp,
                                           causal=causal, window=window,
                                           k_valid=tkv)
    for out, l in ((o.numpy(), lse.numpy()),
                   (np.asarray(o_j), np.asarray(lse_j))):
        assert not out[1].any() and not l[1].any()
        assert not out[0, :4].any() and not l[0, :, :4].any()
        assert l[0, :, 4:].all()
    _within("o", o, np.asarray(o_j), TOL)
    _within("lse", lse, np.asarray(lse_j), TOL)
    dq, dk, dv = fa.flash_attention_bwd_pieces(tq, tk, tv, tqp, tkp, tkv, o,
                                               lse, tdo, causal=causal,
                                               window=window)
    assert not dq[1].any() and not dk[1].any() and not dv[1].any()
    assert not dq[0, :4].any()


@pytest.mark.parametrize("dtype,want", [(torch.float32, (6, 15)),
                                        (torch.bfloat16, (2, 5))])
def test_route_products(dtype, want):
    """bf16 products a tiled call runs: the forward's s and o, the
    backward's s, dp, dq, dk and dv, each three from pieces in f32."""
    assert fa.route_products(dtype) == want
