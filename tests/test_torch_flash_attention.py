"""The port's flash-attention forward (its plain version, which the CUDA
kernel is held to on the card) against the JAX package's Pallas kernel,
run in interpret mode on the CPU, and the port's oracle against the JAX
oracle. Inputs come from numpy with a seed and reach both frameworks as
the same values."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# tests/test_kernels.py's kernel tolerances
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# name: (b, sq, sk, h, kh, hd, causal, window, layout)
CASES = {
    "gqa_causal": (2, 24, 24, 4, 2, 16, True, 0, "square"),
    "mha_full": (1, 16, 24, 4, 4, 16, False, 0, "square"),
    "window": (2, 24, 24, 4, 1, 16, True, 5, "square"),
    "k_valid": (2, 16, 32, 4, 2, 16, True, 0, "suffix_valid"),
    "ragged": (2, 20, 37, 6, 3, 16, True, 0, "suffix"),
    "decode": (2, 1, 40, 4, 1, 16, True, 0, "decode"),
}


def _make(case, dtype, seed=0):
    """Numpy inputs of a case: q, k, v (f32, cast per dtype later),
    q_pos, k_pos, k_valid. No row is fully masked."""
    b, sq, sk, h, kh, hd, causal, window, layout = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, sk, kh, hd), dtype=np.float32)
    v = rng.standard_normal((b, sk, kh, hd), dtype=np.float32)
    k_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    k_valid = np.ones((b, sk), bool)
    if layout == "square":
        q_pos = k_pos[:, :sq].copy()
    elif layout in ("suffix", "suffix_valid"):
        q_pos = k_pos[:, sk - sq:].copy()
        if layout == "suffix_valid":
            k_valid = rng.random((b, sk)) < 0.7
            k_valid[:, 0] = True          # every row keeps one valid key
    else:                                 # decode: 13 filled cache slots
        filled = 13
        k_pos[:, filled:] = -1
        k_valid = k_pos >= 0
        q_pos = np.full((b, 1), filled - 1, np.int32)
    return q, k, v, q_pos, k_pos, k_valid, causal, window


def _jax(q, k, v, qp, kp, kv, causal, window, dtype, block=(8, 16)):
    o, lse = jax_fwd(jnp.asarray(q, JNP[dtype]), jnp.asarray(k, JNP[dtype]),
                     jnp.asarray(v, JNP[dtype]), jnp.asarray(qp),
                     jnp.asarray(kp), causal=causal, window=window,
                     k_valid=jnp.asarray(kv), block_q=block[0],
                     block_k=block[1], return_lse=True, interpret=True)
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


def _torch(q, k, v, qp, kp, kv, dtype):
    t = TORCH[dtype]
    return (torch.from_numpy(q).to(t), torch.from_numpy(k).to(t),
            torch.from_numpy(v).to(t), torch.from_numpy(qp),
            torch.from_numpy(kp), torch.from_numpy(kv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_kernel(case, dtype):
    q, k, v, qp, kp, kv, causal, window = _make(case, dtype)
    o_ref, lse_ref = _jax(q, k, v, qp, kp, kv, causal, window, dtype)
    tq, tk, tv, tqp, tkp, tkv = _torch(q, k, v, qp, kp, kv, dtype)
    o, lse = fa.flash_attention_plain(tq, tk, tv, tqp, tkp, causal=causal,
                                      window=window, k_valid=tkv)
    assert o.dtype == TORCH[dtype] and o.shape == tq.shape
    assert lse.dtype == torch.float32 and lse.shape == (q.shape[0],
                                                        q.shape[2],
                                                        q.shape[1])
    np.testing.assert_allclose(o.float().numpy(), o_ref, atol=TOL[dtype],
                               rtol=TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_fully_masked_rows_give_zero():
    """Rows with no valid key: o = 0 and lse = 0, in the JAX kernel and the
    port alike (the oracles give a uniform average there instead)."""
    q, k, v, qp, kp, kv, causal, window = _make("k_valid", "float32")
    kv[1] = False                         # batch row 1: no valid key at all
    qp[0, :4] = -1                        # 4 queries before every key
    o_ref, lse_ref = _jax(q, k, v, qp, kp, kv, causal, window, "float32")
    tq, tk, tv, tqp, tkp, tkv = _torch(q, k, v, qp, kp, kv, "float32")
    o, lse = fa.flash_attention_plain(tq, tk, tv, tqp, tkp, causal=causal,
                                      window=window, k_valid=tkv)
    for out, l in ((o.numpy(), lse.numpy()), (o_ref, lse_ref)):
        assert not out[1].any() and not l[1].any()
        assert not out[0, :4].any() and not l[0, :, :4].any()
        assert l[0, :, 4:].all()
    np.testing.assert_allclose(o.numpy(), o_ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["gqa_causal", "window", "ragged",
                                  "k_valid"])
def test_ref_matches_jax_ref(case, dtype):
    q, k, v, qp, kp, kv, causal, window = _make(case, dtype)
    ref = jax_ref(jnp.asarray(q, JNP[dtype]), jnp.asarray(k, JNP[dtype]),
                  jnp.asarray(v, JNP[dtype]), jnp.asarray(qp),
                  jnp.asarray(kp), causal=causal, window=window,
                  k_valid=jnp.asarray(kv))
    tq, tk, tv, tqp, tkp, tkv = _torch(q, k, v, qp, kp, kv, dtype)
    out = tref.flash_attention_ref(tq, tk, tv, tqp, tkp, causal=causal,
                                   window=window, k_valid=tkv)
    assert out.dtype == TORCH[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_plain_matches_ref_where_rows_have_keys():
    q, k, v, qp, kp, kv, causal, window = _make("ragged", "float32")
    args = _torch(q, k, v, qp, kp, kv, "float32")
    o, _ = fa.flash_attention_plain(*args[:5], causal=causal, window=window,
                                    k_valid=args[5])
    ref = tref.flash_attention_ref(*args[:5], causal=causal, window=window,
                                   k_valid=args[5])
    torch.testing.assert_close(o, ref, atol=2e-5, rtol=2e-5)


def test_ops_routes_cpu_tensors_to_the_plain_version():
    q, k, v, qp, kp, kv, causal, window = _make("gqa_causal", "float32")
    tq, tk, tv, tqp, tkp, _ = _torch(q, k, v, qp, kp, kv, "float32")
    launches = fa.flash_attention_fwd.launches
    got = ops.flash_attention(tq, tk, tv, tqp, tkp, causal=True)
    want, _ = fa.flash_attention_plain(
        tq, tk, tv, tqp, tkp, causal=True,
        k_valid=torch.ones(tkp.shape, dtype=torch.bool))
    assert torch.equal(got, want)
    assert fa.flash_attention_fwd.launches == launches   # no kernel launch


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, qp, kp, kv, causal, window = _make("decode", "float32")
    args = _torch(q, k, v, qp, kp, kv, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(*args[:5], k_valid=args[5])
