"""The port's selective scan against the JAX package on the CPU.

The plain versions of the CUDA kernels (``repro_torch.kernels.
selective_scan``) against the JAX package's Pallas kernels in interpret
mode: the forward's y, h_final and chunk checkpoints, the backward's
every output; a ragged last chunk (which the Pallas kernel cannot take)
against the JAX oracle and its VJP; and ``kernels.ops.selective_scan``
under autograd, with the fused and the recompute backward, against
``jax.vjp`` of the JAX package's ``ops.selective_scan``. Inputs come from
numpy with a seed."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import selective_scan as jss
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as tss

# tests/test_kernels.py SS_TOL (forward) and tests/test_kernel_grads.py
# SS_ATOL (the adjoint), with the bf16 adjoint's 7e-2: one recurrence in
# f32 in both, sums in other orders
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-4, "bfloat16": 7e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, s, di, ds, dtype="float32"):
    """x, dt, B, C, A_log, h0, gy, gh as numpy f32, the first four rounded
    to `dtype` (so both frameworks see the same values)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, di)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)))) * 0.1
    bi = rng.standard_normal((b, s, ds))
    ci = rng.standard_normal((b, s, ds))
    al = np.log(np.abs(rng.standard_normal((di, ds))) + 0.5)
    h0 = rng.standard_normal((b, di, ds)) * 0.3
    gy = rng.standard_normal((b, s, di))
    gh = rng.standard_normal((b, di, ds))
    out = [a.astype(np.float32) for a in (x, dt, bi, ci, al, h0, gy, gh)]
    if dtype == "bfloat16":
        for i in (0, 1, 2, 3, 6):
            out[i] = np.asarray(jnp.asarray(out[i], jnp.bfloat16), np.float32)
    return out


def _jax(arrays, dtype):
    x, dt, bi, ci, al = arrays[:5]
    dt_ = getattr(jnp, dtype)
    return [jnp.asarray(a, dt_) for a in (x, dt, bi, ci)] + [jnp.asarray(al)]


def _port(arrays, dtype):
    x, dt, bi, ci, al = arrays[:5]
    return [torch.from_numpy(a).to(TDT[dtype]) for a in (x, dt, bi, ci)] + \
        [torch.from_numpy(al)]


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels


@pytest.mark.parametrize("b,s,di,ds,chunk,bd,with_h0,dtype", [
    (1, 32, 16, 4, 8, 16, False, "float32"),
    (2, 24, 16, 4, 8, 8, True, "float32"),
    (2, 16, 16, 8, 16, 16, True, "float32"),
    (2, 24, 16, 4, 8, 16, True, "bfloat16"),
])
def test_plain_forward_matches_pallas(b, s, di, ds, chunk, bd, with_h0,
                                      dtype):
    arrays = _inputs(0, b, s, di, ds, dtype)
    h0 = arrays[5] if with_h0 else None
    y, hf, hc = jss.selective_scan_fwd(
        *_jax(arrays, dtype), None if h0 is None else jnp.asarray(h0),
        chunk=chunk, block_d=bd, interpret=True, return_ckpt=True)
    ty, thf, thc = tss.selective_scan_fwd_plain(
        *_port(arrays, dtype), None if h0 is None else torch.from_numpy(h0),
        chunk=chunk)
    assert ty.dtype == TDT[dtype] and thf.dtype == thc.dtype == torch.float32
    assert thc.shape == (b, s // chunk, di, ds)
    tol = FWD_TOL[dtype]
    _close(ty, y.astype(jnp.float32), tol, "y")
    _close(thf, hf, tol, "h_final")
    _close(thc, hc, tol, "h_ckpt")


@pytest.mark.parametrize("b,s,di,ds,chunk,bd,dtype", [
    (1, 32, 16, 4, 8, 16, "float32"),
    (2, 24, 16, 8, 8, 8, "float32"),
    (2, 16, 16, 4, 8, 8, "bfloat16"),
])
def test_plain_backward_matches_pallas(b, s, di, ds, chunk, bd, dtype):
    arrays = _inputs(1, b, s, di, ds, dtype)
    h0, gy, gh = arrays[5:]
    jin = _jax(arrays, dtype)
    _, _, hc = jss.selective_scan_fwd(*jin, jnp.asarray(h0), chunk=chunk,
                                      block_d=bd, interpret=True,
                                      return_ckpt=True)
    want = jss.selective_scan_bwd(
        *jin, hc, jnp.asarray(gy, getattr(jnp, dtype)), jnp.asarray(gh),
        chunk=chunk, block_d=bd, interpret=True)
    tin = _port(arrays, dtype)
    _, _, thc = tss.selective_scan_fwd_plain(*tin, torch.from_numpy(h0),
                                             chunk=chunk)
    got = tss.selective_scan_bwd_plain(
        *tin, thc, torch.from_numpy(gy).to(TDT[dtype]),
        torch.from_numpy(gh), chunk=chunk)
    assert got[0].dtype == got[1].dtype == TDT[dtype]
    assert all(g.dtype == torch.float32 for g in got[2:])
    for name, g, w in zip("dx ddt db dc dA_log dh0".split(), got, want):
        _close(g, np.asarray(w, np.float32), BWD_TOL[dtype], name)


# ---------------------------------------------------------------------------
# a ragged last chunk (S % chunk != 0): against the oracle


def test_ragged_sequence_against_the_oracle():
    b, s, di, ds, chunk = 2, 30, 12, 4, 8
    arrays = _inputs(2, b, s, di, ds)
    x, dt, bi, ci, al, h0, gy, gh = arrays

    def ref(x, dt, bi, ci, al, h0):
        return jref.selective_scan_ref(x, dt, bi, ci, al, h0)

    (y, hf), vjp = jax.vjp(ref, *map(jnp.asarray, (x, dt, bi, ci, al, h0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    tin = [torch.from_numpy(a) for a in (x, dt, bi, ci, al)]
    ty, thf, thc = tss.selective_scan_fwd_plain(*tin, torch.from_numpy(h0),
                                                chunk=chunk)
    assert thc.shape == (b, 4, di, ds)
    _close(ty, y, FWD_TOL["float32"], "y")
    _close(thf, hf, FWD_TOL["float32"], "h_final")
    ry, rhf = tref.selective_scan_ref(*tin, torch.from_numpy(h0))
    _close(ry, y, FWD_TOL["float32"], "port oracle y")
    _close(rhf, hf, FWD_TOL["float32"], "port oracle h_final")
    got = tss.selective_scan_bwd_plain(*tin, thc, torch.from_numpy(gy),
                                       torch.from_numpy(gh), chunk=chunk)
    # dA_log of the oracle's VJP is the sum over the batch, as the port's
    for name, g, w in zip("dx ddt db dc dA_log dh0".split(), got, want):
        _close(g, w, BWD_TOL["float32"], name)


# ---------------------------------------------------------------------------
# ops.selective_scan under autograd against jax.vjp of the JAX ops


@pytest.mark.parametrize("bwd", ["fused", "recompute"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ops_autograd_matches_jax_vjp(bwd, with_h0):
    b, s, di, ds, chunk = 2, 16, 16, 4, 8
    arrays = _inputs(3, b, s, di, ds)
    x, dt, bi, ci, al, h0, gy, gh = arrays
    jin = list(map(jnp.asarray, (x, dt, bi, ci, al)))
    if with_h0:
        def f(x, dt, bi, ci, al, h0):
            return jops.selective_scan(x, dt, bi, ci, al, h0, chunk, 16, bwd)
        jin.append(jnp.asarray(h0))
    else:
        def f(x, dt, bi, ci, al):
            return jops.selective_scan(x, dt, bi, ci, al, None, chunk, 16,
                                       bwd)
    (y, hf), vjp = jax.vjp(f, *jin)
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))

    tin = [torch.from_numpy(a).requires_grad_()
           for a in (x, dt, bi, ci, al) + ((h0,) if with_h0 else ())]
    ty, thf = tops.selective_scan(*tin[:5], tin[5] if with_h0 else None,
                                  chunk=chunk, bwd=bwd)
    _close(ty, y, FWD_TOL["float32"], "y")
    _close(thf, hf, FWD_TOL["float32"], "h_final")
    got = torch.autograd.grad((ty, thf), tin,
                              (torch.from_numpy(gy), torch.from_numpy(gh)))
    for name, g, w in zip("dx ddt db dc dA_log dh0".split(), got, want):
        _close(g, w, BWD_TOL["float32"], name)


def test_ops_upcasts_a_bf16_a_log_and_returns_its_gradient_in_bf16():
    """A frozen (bf16) A_log enters the scan in f32, as the TPU kernel
    reads it; autograd casts its gradient back to bf16."""
    arrays = _inputs(4, 1, 8, 8, 4)
    x, dt, bi, ci, al = (torch.from_numpy(a) for a in arrays[:5])
    al16 = al.to(torch.bfloat16).requires_grad_()
    y, _ = tops.selective_scan(x, dt, bi, ci, al16, chunk=4)
    want, _ = tref.selective_scan_ref(x, dt, bi, ci, al16.detach().float())
    _close(y, want.numpy(), FWD_TOL["float32"])
    (g,) = torch.autograd.grad(y.sum(), al16)
    assert g.dtype == torch.bfloat16


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; a CPU tensor reaches the
    plain version through ops, never the kernel wrapper."""
    arrays = _inputs(5, 1, 8, 8, 4)
    tin = [torch.from_numpy(a) for a in arrays[:5]]
    with pytest.raises(ValueError, match="CUDA"):
        tss.selective_scan_fwd(*tin, chunk=4)
    with pytest.raises(ValueError, match="CUDA"):
        tss.selective_scan_bwd(*tin, torch.zeros(1, 2, 8, 4),
                               torch.zeros(1, 8, 8), torch.zeros(1, 8, 4),
                               chunk=4)
    assert tss.selective_scan_fwd.launches == 0
    assert tss.selective_scan_bwd.launches == 0
