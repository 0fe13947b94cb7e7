"""The training slice's kernels against the JAX package, on the CPU.

Each kernel's plain version (which the CUDA kernel is held to on the card)
and its ``torch.autograd.Function`` in ``repro_torch.kernels.ops`` against
the JAX kernel through ``repro.kernels.ops`` in interpret mode: the
flash-attention backward against ``jax.vjp`` of ``ops.flash_attention``,
the fused cross-entropy forward and backward against
``ops.softmax_xent_tokens``, and quant8 against ``quant_dequant_fwd`` and
``compression._quant_dequant_jnp`` fed ``jax.random.uniform``'s draws.
Inputs come from numpy with a seed."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quant8 import quant_dequant_fwd as jax_qd
from repro_torch.core import compression
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import quant8 as q8
from repro_torch.kernels import ref as tref
from repro_torch.kernels import softmax_xent as sx

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/test_kernel_grads.py's gradient tolerance in f32; in bf16 the
# outputs round to bf16 (one ulp is 2^-8 relative)
GRAD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


# ---------------------------------------------------------------------------
# flash attention backward

# name: (b, s_q, s_k, h, kh, hd, window, k_valid hole)
FA_CASES = {
    "causal_gqa": (2, 24, 24, 4, 2, 16, 0, False),
    "window": (2, 24, 24, 4, 1, 16, 5, False),
    "k_valid": (2, 16, 24, 4, 2, 16, 0, True),
    "ragged_mha": (1, 20, 37, 3, 3, 16, 0, False),
}


def _fa_inputs(case, seed=0):
    b, sq, sk, h, kh, hd, window, hole = FA_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, sk, kh, hd), dtype=np.float32)
    v = rng.standard_normal((b, sk, kh, hd), dtype=np.float32)
    do = rng.standard_normal((b, sq, h, hd), dtype=np.float32)
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    qp = kp[:, sk - sq:].copy()
    kv = np.ones((b, sk), bool)
    if hole:
        kv = rng.random((b, sk)) < 0.7
        kv[:, 0] = True                 # every query keeps one valid key
    return q, k, v, do, qp, kp, kv, window


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_backward_matches_jax_vjp(case, dtype):
    q, k, v, do, qp, kp, kv, window = _fa_inputs(case)
    jt = JNP[dtype]

    def f(q, k, v):
        return jops.flash_attention(q, k, v, jnp.asarray(qp), jnp.asarray(kp),
                                    causal=True, window=window,
                                    k_valid=jnp.asarray(kv), block_q=8,
                                    block_k=16)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, jt) for x in (q, k, v)))
    want = [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do, jt))]

    tt = TORCH[dtype]
    tq, tk, tv = (torch.from_numpy(x).to(tt).requires_grad_()
                  for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, torch.from_numpy(qp),
                              torch.from_numpy(kp), causal=True,
                              window=window, k_valid=torch.from_numpy(kv))
    out.backward(torch.from_numpy(do).to(tt))
    for name, got, ref in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        assert got.grad.dtype == tt
        np.testing.assert_allclose(got.grad.float().numpy(), ref,
                                   atol=GRAD_TOL[dtype], rtol=GRAD_TOL[dtype],
                                   err_msg=name)


def test_flash_backward_plain_matches_autograd_of_oracle():
    """The backward's plain version against torch autograd through the
    materialized-scores oracle, with the forward's own o and lse."""
    q, k, v, do, qp, kp, kv, window = _fa_inputs("k_valid", seed=1)
    tq, tk, tv = (torch.from_numpy(x).double().requires_grad_()
                  for x in (q, k, v))
    args = (torch.from_numpy(qp), torch.from_numpy(kp))
    ref = tref.flash_attention_ref(tq, tk, tv, *args, causal=True,
                                   window=window,
                                   k_valid=torch.from_numpy(kv))
    ref.backward(torch.from_numpy(do).double())
    f32 = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = fa.flash_attention_plain(*f32, *args, causal=True,
                                      window=window,
                                      k_valid=torch.from_numpy(kv))
    got = fa.flash_attention_bwd_plain(*f32, *args, torch.from_numpy(kv), o,
                                       lse, torch.from_numpy(do),
                                       causal=True, window=window)
    for g, t in zip(got, (tq, tk, tv)):
        torch.testing.assert_close(g, t.grad.float(), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# fused softmax cross-entropy

# (t, d, v, block_t, block_v) of the JAX kernel: aligned, T < block and V
# < block, and ragged T and V over several tiles
CE_CASES = [(64, 32, 128, 32, 64), (7, 16, 50, 32, 64), (45, 24, 300, 16, 128)]


@pytest.mark.parametrize("t,d,v,bt,bv", CE_CASES)
def test_softmax_xent_matches_jax_kernel(t, d, v, bt, bv):
    rng = np.random.default_rng(t)
    h = rng.standard_normal((t, d), dtype=np.float32) * 0.5
    w = rng.standard_normal((d, v), dtype=np.float32) * 0.1
    labels = rng.integers(0, v, t).astype(np.int32)
    g = rng.standard_normal(t, dtype=np.float32)

    def f(h, w):
        return jops.softmax_xent_tokens(h, w, jnp.asarray(labels),
                                        block_t=bt, block_v=bv)

    loss_j, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(w))
    dh_j, dw_j = vjp(jnp.asarray(g))
    _, lse_j = jref.softmax_xent_ref(jnp.asarray(h), jnp.asarray(w),
                                     jnp.asarray(labels))

    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = torch.from_numpy(labels)
    loss = ops.softmax_xent_tokens(th, tw, tl)
    loss.backward(torch.from_numpy(g))
    _, lse = sx.softmax_xent_fwd_plain(th.detach(), tw.detach(), tl)
    # tests/test_kernel_grads.py: loss 1e-5, gradients 2e-4
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_j),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-5)
    for name, got, ref in (("dh", th.grad, dh_j), ("dw", tw.grad, dw_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                                   rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_keeps_dtypes(dtype):
    rng = np.random.default_rng(5)
    tt = TORCH[dtype]
    h = torch.from_numpy(rng.standard_normal((9, 8), dtype=np.float32)).to(tt)
    w = torch.from_numpy(rng.standard_normal((8, 30), dtype=np.float32)).to(tt)
    lab = torch.from_numpy(rng.integers(0, 30, 9).astype(np.int32))
    loss, lse = sx.softmax_xent_fwd_plain(h, w, lab)
    dh, dw = sx.softmax_xent_bwd_plain(h, w, lab, lse, torch.ones(9))
    assert loss.dtype == lse.dtype == torch.float32
    assert dh.dtype == dw.dtype == tt


def test_softmax_xent_ref_matches_jax_ref():
    rng = np.random.default_rng(6)
    h = rng.standard_normal((13, 16), dtype=np.float32)
    w = rng.standard_normal((16, 77), dtype=np.float32) * 0.3
    lab = rng.integers(0, 77, 13).astype(np.int32)
    want = jref.softmax_xent_ref(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(lab))
    got = tref.softmax_xent_ref(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(lab))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# quant8


def _qd_input(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return x * np.linspace(0.1, 3.0, shape[-1], dtype=np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant8_stochastic_bitwise_equal_to_jax(dtype):
    """Fed jax.random.uniform's draws, the plain version gives the JAX
    kernel's and the unfused JAX lowering's bits (the latter under jit,
    as the train step runs it: eager, it divides by qmax where jit
    multiplies by its reciprocal, one ulp apart in some rows' scales)."""
    x = _qd_input((2, 3, 5, 48), dtype)
    key = jax.random.PRNGKey(7)
    jx = jnp.asarray(x, JNP[dtype])
    u = np.array(jax.random.uniform(key, x.shape, jnp.float32))
    want_kernel = jax_qd(jx, key=key, interpret=True)
    want_jnp = jax.jit(jcomp._quant_dequant_jnp)(jx, key)
    got = q8.quant_dequant_plain(torch.from_numpy(x).to(TORCH[dtype]),
                                 torch.from_numpy(u))
    for want in (want_kernel, want_jnp):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant8_nearest_bitwise_equal_to_jax(dtype):
    x = _qd_input((30, 64), dtype, seed=1)
    jx = jnp.asarray(x, JNP[dtype])
    tx = torch.from_numpy(x).to(TORCH[dtype])
    got = q8.quant_dequant_plain(tx)
    for want in (jax_qd(jx, interpret=True),
                 jax.jit(jref.quant_dequant_ref)(jx),
                 jax.jit(jcomp._quant_dequant_jnp)(jx, None)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    assert torch.equal(got, tref.quant_dequant_ref(tx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant8_wide_rows_bitwise_equal_to_jax(dtype):
    """Rows wider than the CUDA kernel holds in registers (4096), at
    nemotron-4-15b's width: the plain version gives the JAX kernel's bits,
    with its uniforms and rounding to nearest."""
    x = _qd_input((3, 6144), dtype, seed=3)
    key = jax.random.PRNGKey(11)
    jx = jnp.asarray(x, JNP[dtype])
    tx = torch.from_numpy(x).to(TORCH[dtype])
    u = np.array(jax.random.uniform(key, x.shape, jnp.float32))
    for got, want in ((q8.quant_dequant_plain(tx, torch.from_numpy(u)),
                       jax_qd(jx, key=key, interpret=True)),
                      (q8.quant_dequant_plain(tx),
                       jax_qd(jx, interpret=True))):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_quant8_generator_rounds_within_one_level():
    """With a generator the plain version draws its own uniforms: every
    value lands on one of the two int8 levels around x."""
    x = torch.from_numpy(_qd_input((16, 32), "float32", seed=2))
    y = q8.quant_dequant_plain(x, torch.Generator().manual_seed(0))
    scale = x.abs().amax(dim=-1, keepdim=True) / 127
    assert ((y - x).abs() <= scale * (1 + 1e-6)).all()


def test_link_compression_matches_jax_custom_vjps():
    """compress_activations: quantized value, identity cotangent;
    compress_gradients: identity value, quantized cotangent — bitwise
    against the JAX package fed the same uniforms."""
    x = _qd_input((2, 2, 6, 32), "float32", seed=3)
    g = _qd_input((2, 2, 6, 32), "float32", seed=4)
    key = jax.random.PRNGKey(11)
    u = torch.from_numpy(np.array(jax.random.uniform(key, x.shape)))
    for jfn, tfn in ((jcomp.compress_activations,
                      compression.compress_activations),
                     (jcomp.compress_gradients,
                      compression.compress_gradients)):
        y_j, vjp = jax.vjp(lambda a: jfn(a, key), jnp.asarray(x))
        (dx_j,) = vjp(jnp.asarray(g))
        tx = torch.from_numpy(x).requires_grad_()
        y = tfn(tx, u)
        y.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
        np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(dx_j))


def test_compressed_bytes_matches_jax():
    for shape in [(2, 12, 64), (4, 2, 512, 3072)]:
        assert compression.compressed_bytes(shape) == \
            jcomp.compressed_bytes(shape)


# ---------------------------------------------------------------------------
# routing by device


def test_cpu_tensors_take_the_plain_versions():
    counters = (fa.flash_attention_bwd, sx.softmax_xent_fwd,
                sx.softmax_xent_bwd, q8.quant_dequant)
    before = [c.launches for c in counters]
    h = torch.randn(5, 8, requires_grad=True)
    w = torch.randn(8, 11, requires_grad=True)
    ops.softmax_xent_tokens(h, w, torch.randint(0, 11, (5,))).sum().backward()
    x = torch.randn(3, 8, requires_grad=True)
    ops.quant_dequant(x, torch.rand(3, 8)).sum().backward()
    q, k, v, do, qp, kp, kv, _ = _fa_inputs("causal_gqa")
    tq = torch.from_numpy(q).requires_grad_()
    ops.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(qp), torch.from_numpy(kp)).sum() \
        .backward()
    assert [c.launches for c in counters] == before
    assert torch.equal(x.grad, torch.ones(3, 8))      # straight-through


def test_kernel_wrappers_refuse_cpu_tensors():
    h, w = torch.randn(4, 8), torch.randn(8, 16)
    lab = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sx.softmax_xent_fwd(h, w, lab)
    with pytest.raises(ValueError, match="CUDA"):
        sx.softmax_xent_bwd(h, w, lab, torch.zeros(4), torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        q8.quant_dequant(h)
    q, k, v, do, qp, kp, kv, _ = _fa_inputs("causal_gqa")
    t = [torch.from_numpy(a) for a in (q, k, v, qp, kp, kv)]
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(*t, torch.from_numpy(q),
                               torch.zeros(2, 4, 24), torch.from_numpy(do))


# ---------------------------------------------------------------------------
# the losses around the kernel


def test_chunked_ce_impls_match_jax_oracle():
    """chunked_softmax_xent: the plain chunked path and the kernel path
    (its plain version here) against the JAX package's checkpointed jnp
    oracle, value and gradient, with a validity mask."""
    from repro.core import losses as jlosses
    from repro_torch.core import losses

    rng = np.random.default_rng(31)
    t, d, v = 90, 32, 250
    h = rng.standard_normal((t, d), dtype=np.float32) * 0.5
    w = rng.standard_normal((d, v), dtype=np.float32) * 0.1
    labels = rng.integers(0, v, t)
    valid = np.arange(t) % 5 != 0

    def jmean(h, w):
        return jlosses.chunked_softmax_xent(
            h, w, jnp.asarray(labels), valid=jnp.asarray(valid),
            chunk=32).mean()

    l_j, g_j = jax.value_and_grad(jmean, argnums=(0, 1))(jnp.asarray(h),
                                                          jnp.asarray(w))
    for impl in ("plain", "kernel"):
        th = torch.from_numpy(h).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        loss = losses.chunked_softmax_xent(
            th, tw, torch.from_numpy(labels), valid=torch.from_numpy(valid),
            chunk=32, impl=impl).mean()
        loss.backward()
        assert abs(float(loss.detach()) - float(l_j)) < 1e-6, impl
        for name, a, r in (("dh", th.grad, g_j[0]), ("dw", tw.grad, g_j[1])):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                       rtol=1e-5, err_msg=f"{impl} {name}")


def test_classification_ce_matches_jax():
    from repro.core import losses as jlosses
    from repro_torch.core import losses

    rng = np.random.default_rng(32)
    logits = rng.standard_normal((3, 5, 10), dtype=np.float32)
    labels = rng.integers(0, 10, (3, 5))
    want = jlosses.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    got = losses.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
