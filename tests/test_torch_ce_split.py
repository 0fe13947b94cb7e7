"""The CE kernels' split-bf16 route, on the CPU.

The CUDA kernels run every product of the LM-head cross-entropy on the
tensor cores from bf16 pieces of the f32 operands (x = hi + lo). Their
plain PyTorch model (``softmax_xent_fwd_pieces``, ``softmax_xent_bwd_pieces``)
is held here to the JAX Pallas kernel in interpret mode for each dtype
pair the train paths give it, and to the f64 product at d_model 3072; the
split itself to its error bound and to PyTorch's bf16 rounding. Inputs
come from numpy with a seed."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
from jax import vjp

from repro.kernels import ops as jops
from repro_torch.kernels import softmax_xent as sx

# (t, d, v, block_t, block_v) of the JAX kernel, as in
# tests/test_torch_train_kernels.py: aligned, T < block and V < block, and
# ragged T and V over several tiles
CE_CASES = [(64, 32, 128, 32, 64), (7, 16, 50, 32, 64), (45, 24, 300, 16, 128)]
PAIRS = {"f32/f32": (torch.float32, torch.float32),
         "bf16/f32": (torch.bfloat16, torch.float32),
         "bf16/bf16": (torch.bfloat16, torch.bfloat16)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# chip_smoke.py holds the kernels to the plain versions at 1e-4 of each
# output's largest element in f32: the split may spend half of it
CARD_TOL_F32 = 1e-4


def test_split_reconstructs_within_its_bound():
    """hi = bf16(x) errs by at most 2^-8 |x| (bf16 keeps 8 significant
    bits), and lo = bf16(x - hi) by 2^-8 of that: |x - hi - lo| <=
    2^-16 |x| over f32's normal range."""
    rng = np.random.default_rng(0)
    mag = 10.0 ** rng.uniform(-30, 30, 20000)
    x = torch.from_numpy((mag * rng.choice([-1, 1], mag.size))
                         .astype(np.float32))
    hi, lo = sx.split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -16 * x.double().abs()).all()
    # the lo piece is needed: hi alone misses that bound
    assert ((x.double() - hi.double()).abs()
            > 2.0 ** -16 * x.double().abs()).any()


def test_split_hi_is_the_bf16_cast_and_bf16_passes_through():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)) * 37
    hi, lo = sx.split_bf16(x)
    cast = x.to(torch.bfloat16)
    assert torch.equal(hi.view(torch.int16), cast.view(torch.int16))
    assert torch.equal(lo.view(torch.int16),
                       (x - cast.float()).to(torch.bfloat16).view(torch.int16))
    xb = x.to(torch.bfloat16)
    hb, lb = sx.split_bf16(xb)
    assert hb is xb and lb is None


@pytest.mark.parametrize("pair,want", [("f32/f32", (3, 9)),
                                       ("bf16/f32", (2, 7)),
                                       ("bf16/bf16", (1, 5))])
def test_products_per_route(pair, want):
    """bf16 products a call runs: forward h.w; backward h.w again, ds.w^T
    and h^T.ds, ds always in two pieces."""
    assert sx.products(*PAIRS[pair]) == want


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("t,d,v,bt,bv", CE_CASES)
def test_pieces_models_match_jax_kernel(t, d, v, bt, bv, pair):
    h_dtype, w_dtype = PAIRS[pair]
    rng = np.random.default_rng(t + d)
    h = rng.standard_normal((t, d), dtype=np.float32) * 0.5
    w = rng.standard_normal((d, v), dtype=np.float32) * 0.1
    labels = rng.integers(0, v, t).astype(np.int32)
    g = rng.standard_normal(t, dtype=np.float32)
    th = torch.from_numpy(h).to(h_dtype)
    tw = torch.from_numpy(w).to(w_dtype)
    tl = torch.from_numpy(labels)
    # the same (rounded) inputs to JAX
    jh = jnp.asarray(th.float().numpy()).astype(JNP[h_dtype])
    jw = jnp.asarray(tw.float().numpy()).astype(JNP[w_dtype])

    def f(h, w):
        return jops.softmax_xent_tokens(h, w, jnp.asarray(labels),
                                        block_t=bt, block_v=bv)

    loss_j, pull = vjp(f, jh, jw)
    dh_j, dw_j = pull(jnp.asarray(g))

    loss, lse = sx.softmax_xent_fwd_pieces(th, tw, tl)
    dh, dw = sx.softmax_xent_bwd_pieces(th, tw, tl, lse, torch.from_numpy(g))
    assert (dh.dtype, dw.dtype) == (h_dtype, w_dtype)
    # tests/test_kernel_grads.py: loss 1e-5, gradients 2e-4
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), atol=1e-5,
                               rtol=1e-5)
    for name, got, ref, dt in (("dh", dh, dh_j, h_dtype),
                               ("dw", dw, dw_j, w_dtype)):
        # a bf16 output: both round an f32 sum (the two agree to ~1e-6) to
        # bf16, and a sum near a rounding boundary may go either way: one
        # bf16 ulp, at most 2^-7 of the value
        rtol = 2.0 ** -7 if dt == torch.bfloat16 else 2e-4
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
            atol=2e-4, rtol=rtol, err_msg=name)


def test_split_error_at_d3072_within_half_the_card_tolerance():
    """f32 h and w at minitron's d_model: the pieces model against the f64
    product, each output within half of chip_smoke.py's f32 tolerance of
    its largest element (at T 256 and V 4096 the same model errs by loss
    1.5e-6, dh 1.1e-5, dw 1.0e-5)."""
    t, d, v = 48, 3072, 512
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((t, d), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((d, v)) * d ** -0.5)
                         .astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, v, t).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal(t).astype(np.float32)) / t

    logits = h.double() @ w.double()
    lse_r = torch.logsumexp(logits, -1)
    loss_r = lse_r - logits.gather(1, lab.long()[:, None])[:, 0]
    p = torch.exp(logits - lse_r[:, None])
    p[torch.arange(t), lab.long()] -= 1
    ds = p * g.double()[:, None]
    dh_r, dw_r = ds @ w.double().T, h.double().T @ ds

    loss, lse = sx.softmax_xent_fwd_pieces(h, w, lab)
    dh, dw = sx.softmax_xent_bwd_pieces(h, w, lab, lse, g)
    for name, got, ref in (("loss", loss, loss_r), ("lse", lse, lse_r),
                           ("dh", dh, dh_r), ("dw", dw, dw_r)):
        err = (got.double() - ref).abs().max() / ref.abs().max()
        assert err <= CARD_TOL_F32 / 2, (name, err.item())


def test_pieces_scratch_pads_unaligned_rows():
    """The split pass's scratch: two pieces of an f32 operand, none for a
    bf16 one with 16-byte rows (read in place), one padded copy for a bf16
    one without (hymba's V 32001; the ragged D 200 is aligned)."""
    h = torch.zeros(5, 200)
    w = torch.zeros(200, 32001)
    hp, wp, dp, vp = sx._pieces_scratch(h, w)
    assert (dp, vp) == (200, 32008)
    assert hp.shape == (2, 5, 200) and wp.shape == (2, 200, 32008)
    hp, wp, _, _ = sx._pieces_scratch(h.bfloat16(), w.bfloat16())
    assert hp is None and wp.shape == (1, 200, 32008)
    hp, wp, dp, vp = sx._pieces_scratch(
        torch.zeros(5, 36, dtype=torch.bfloat16),
        torch.zeros(36, 64, dtype=torch.bfloat16))
    assert (dp, vp) == (40, 64) and hp.shape == (1, 5, 40) and wp is None
