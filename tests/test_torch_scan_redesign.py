"""CPU models of the selective-scan kernels' order of work, against the
JAX package.

``csrc/selective_scan_fwd.cu`` splits a small grid's sequence into
segments of whole chunks: each segment but the last runs from a zero
state (its local end state and its dt sum), a combine walks the segments
in order (entry = exp(A sum dt) * entry + local), and a sweep from the
true entries writes y, the chunk checkpoints and h_final.
``csrc/selective_scan_bwd.cu`` takes each chunk in pieces (a later piece's
entry walked from the chunk's checkpoint), keeps the state entering each
sub-chunk of a piece, recomputes a sub-chunk's states and decays and runs
the adjoint back through them, its db/dc sums per block of channels. The
models below are plain PyTorch functions that do the same work in the
same order (decays as exp2(dt A log2 e), as the kernels take them); each
is held against the JAX package's Pallas kernels in interpret mode and
against ``repro.kernels.ref.selective_scan_ref`` (its VJP for the
backward). Inputs come from numpy with a seed."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro.kernels import selective_scan as jss
from repro_torch.kernels import selective_scan as tss

# f32: one recurrence in f32 on both sides, sums in other orders; bf16
# inputs: y and the input gradients round to bf16 (one ulp is 2^-8)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _inputs(seed, b, s, di, ds, dtype="float32"):
    """x, dt, B, C, A_log, h0, gy, gh as numpy f32; x, dt, B, C and gy
    rounded to `dtype`, so both frameworks see the same values."""
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


def _port(arrays, dtype):
    """x, dt, B, C (in `dtype`), A_log, h0, gy (in `dtype`), gh."""
    x, dt, bi, ci, al, h0, gy, gh = arrays
    cast = [torch.from_numpy(a).to(TDT[dtype]) for a in (x, dt, bi, ci)]
    return (*cast, torch.from_numpy(al), torch.from_numpy(h0),
            torch.from_numpy(gy).to(TDT[dtype]), torch.from_numpy(gh))


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# the models


def _step(h, a2, x, dt, b, t):
    """(a_t, h_t) from h_{t-1}, all f32; a2 = A log2(e) [di, ds]."""
    a = torch.exp2(dt[:, t, :, None] * a2)
    return a, a * h + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]


def fwd_segments_model(x, dt, b, c, a_log, h0, *, chunk, seg_chunks):
    """The forward kernel's work: (y, h_final, h_ckpt) by segments of
    `seg_chunks` chunks (one sweep when that covers the sequence)."""
    bsz, s, di = x.shape
    ds = b.shape[-1]
    in_dtype = x.dtype
    x, dt, b, c = (t.float() for t in (x, dt, b, c))
    a2 = -torch.exp(a_log.float()) * LOG2E
    nc = -(-s // chunk)
    seg_chunks = min(seg_chunks, nc)
    nseg = -(-nc // seg_chunks)
    span = seg_chunks * chunk
    zeros = torch.zeros((bsz, di, ds))
    h_ckpt = torch.zeros((bsz, nc, di, ds))
    seg_dt = torch.zeros((bsz, nseg, di))
    # 1. every segment but the last from a zero state
    for k in range(nseg - 1):
        h = zeros
        for t in range(k * span, (k + 1) * span):
            h = _step(h, a2, x, dt, b, t)[1]
            seg_dt[:, k] += dt[:, t]
        h_ckpt[:, (k + 1) * seg_chunks] = h
    # 2. the true entries, segments in order
    h = zeros if h0 is None else h0.float()
    for k in range(nseg - 1):
        h = torch.exp2(a2 * seg_dt[:, k, :, None]) * h \
            + h_ckpt[:, (k + 1) * seg_chunks]
        h_ckpt[:, (k + 1) * seg_chunks] = h
    # 3. every segment from its entry
    y = torch.zeros((bsz, s, di))
    for k in range(nseg):
        h = (h_ckpt[:, k * seg_chunks].clone() if k else
             zeros if h0 is None else h0.float())
        for t in range(k * span, min(s, (k + 1) * span)):
            if t % chunk == 0:
                h_ckpt[:, t // chunk] = h
            h = _step(h, a2, x, dt, b, t)[1]
            y[:, t] = (h * c[:, t, None, :]).sum(-1)
    return y.to(in_dtype), h, h_ckpt


def bwd_pieces_model(x, dt, b, c, a_log, h_ckpt, gy, gh, *, chunk,
                     piece, sub, channels):
    """The backward kernel's work: (dx, ddt, db, dc, dA_log, dh0), chunks
    in reverse, each in pieces of `piece` steps in reverse (a later
    piece's entry walked from the chunk's checkpoint), sub-chunk entries of
    a piece kept, each sub-chunk of `sub` steps recomputed and run back
    through; db and dc summed per block of `channels` channels, then over
    the blocks."""
    bsz, s, di = x.shape
    ds = b.shape[-1]
    in_dtype = x.dtype
    x, dt, b, c, gy = (t.float() for t in (x, dt, b, c, gy))
    a2 = -torch.exp(a_log.float()) * LOG2E
    nd = -(-di // channels)
    dx = torch.zeros((bsz, s, di))
    ddt = torch.zeros((bsz, s, di))
    db_part = torch.zeros((bsz, nd, s, ds))
    dc_part = torch.zeros((bsz, nd, s, ds))
    dadt_dt = torch.zeros((bsz, di, ds))
    g = gh.float()

    def block_sums(v):                  # [B, di, ds] -> [B, nd, ds]
        pad = torch.zeros((bsz, nd * channels - di, ds))
        return torch.cat([v, pad], 1).reshape(bsz, nd, channels, ds).sum(2)

    for ci in reversed(range(-(-s // chunk))):
        t0c = ci * chunk
        lc = min(chunk, s - t0c)
        for p in reversed(range(-(-lc // piece))):
            tp, lp = t0c + p * piece, min(piece, lc - p * piece)
            h = h_ckpt[:, ci]
            for t in range(t0c, tp):
                h = _step(h, a2, x, dt, b, t)[1]
            nsub = -(-lp // sub)
            ent = []
            for j in range(nsub):
                ent.append(h)
                if j == nsub - 1:
                    break
                for t in range(tp + j * sub, tp + (j + 1) * sub):
                    h = _step(h, a2, x, dt, b, t)[1]
            for j in reversed(range(nsub)):
                ts, n = tp + j * sub, min(sub, lp - j * sub)
                hs, decays = [ent[j]], []
                for t in range(ts, ts + n):
                    a, h = _step(hs[-1], a2, x, dt, b, t)
                    hs.append(h)
                    decays.append(a)
                for i in reversed(range(n)):
                    t = ts + i
                    lam = g + gy[:, t, :, None] * c[:, t, None, :]
                    sb = (lam * b[:, t, None, :]).sum(-1)
                    dadt = lam * hs[i] * decays[i]
                    dx[:, t] = dt[:, t] * sb
                    ddt[:, t] = x[:, t] * sb + (dadt * a2).sum(-1) * LN2
                    dadt_dt += dadt * dt[:, t, :, None]
                    g = decays[i] * lam
                    db_part[:, :, t] = block_sums(
                        (dt[:, t] * x[:, t])[..., None] * lam)
                    dc_part[:, :, t] = block_sums(gy[:, t, :, None] * hs[i + 1])
    da = (dadt_dt * (a2 * LN2)).sum(0)
    return (dx.to(in_dtype), ddt.to(in_dtype), db_part.sum(1),
            dc_part.sum(1), da, g)


def _jax_in(arrays, dtype):
    x, dt, bi, ci, al = arrays[:5]
    jd = getattr(jnp, dtype)
    return [jnp.asarray(a, jd) for a in (x, dt, bi, ci)] + [jnp.asarray(al)]


# ---------------------------------------------------------------------------
# the forward's segment split


@pytest.mark.parametrize("b,s,di,ds,chunk,seg_chunks,with_h0,dtype", [
    (2, 48, 16, 16, 8, 2, True, "float32"),
    (1, 32, 32, 4, 8, 1, False, "float32"),
    (2, 32, 16, 4, 8, 3, True, "bfloat16"),
])
def test_forward_segments_match_pallas(b, s, di, ds, chunk, seg_chunks,
                                       with_h0, dtype):
    arrays = _inputs(0, b, s, di, ds, dtype)
    h0 = arrays[5] if with_h0 else None
    y, hf, hc = jss.selective_scan_fwd(
        *_jax_in(arrays, dtype), None if h0 is None else jnp.asarray(h0),
        chunk=chunk, block_d=16, interpret=True, return_ckpt=True)
    x, dt, bi, ci, al = _port(arrays, dtype)[:5]
    ty, thf, thc = fwd_segments_model(
        x, dt, bi, ci, al, None if h0 is None else torch.from_numpy(h0),
        chunk=chunk, seg_chunks=seg_chunks)
    tol = TOL[dtype]
    _close(ty, y.astype(jnp.float32), tol, "y")
    _close(thf, hf, tol, "h_final")
    _close(thc, hc, tol, "h_ckpt")


@pytest.mark.parametrize("s,di,ds,chunk,seg_chunks,with_h0", [
    (61, 40, 16, 8, 2, True),         # ragged S, a ragged last segment
    (37, 24, 4, 5, 3, False),         # a chunk no multiple of 8
])
def test_forward_segments_ragged_against_the_oracle(s, di, ds, chunk,
                                                    seg_chunks, with_h0):
    arrays = _inputs(1, 2, s, di, ds)
    x, dt, bi, ci, al, h0 = arrays[:6]
    jh0 = jnp.asarray(h0) if with_h0 else None
    y, hf = jref.selective_scan_ref(*map(jnp.asarray, (x, dt, bi, ci, al)),
                                    jh0)
    ty, thf, _ = fwd_segments_model(
        *(torch.from_numpy(a) for a in (x, dt, bi, ci, al)),
        torch.from_numpy(h0) if with_h0 else None, chunk=chunk,
        seg_chunks=seg_chunks)
    _close(ty, y, TOL["float32"], "y")
    _close(thf, hf, TOL["float32"], "h_final")


@pytest.mark.parametrize("seg_chunks", [1, 2, 3, 5])
def test_segment_split_checkpoints_equal_the_sequential_ones(seg_chunks):
    """h_ckpt from the split equals the plain version's sequential one to
    f32 noise: each entry differs only by the decay taken as exp(A sum dt)
    and by the sum's order."""
    arrays = _inputs(2, 2, 64, 48, 16)
    x, dt, bi, ci, al, h0 = (torch.from_numpy(a) for a in arrays[:6])
    _, want_hf, want = tss.selective_scan_fwd_plain(x, dt, bi, ci, al, h0,
                                                    chunk=8)
    _, hf, got = fwd_segments_model(x, dt, bi, ci, al, h0, chunk=8,
                                    seg_chunks=seg_chunks)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-6 * scale
    assert (hf - want_hf).abs().max().item() <= 1e-6 * scale


def test_forward_segment_plan():
    """The wrapper's plan: one sweep where batch x channels fill the card
    (falcon-mamba train: 8 x 8192), whole-chunk segments where they do not
    (hymba prefill: 4 x 3200, 24 chunks of 64), never more segments than
    chunks; the train path's checkpoints a backward piece apart."""
    assert tss.kernel_chunk(256) == tss.PIECE == 64
    assert tss.kernel_chunk(16) == 16
    assert tss.fwd_seg_chunks(8, 8192, 8) == 8
    m = tss.fwd_seg_chunks(4, 3200, 24)
    assert 1 <= m < 24
    assert -(-24 // m) * 4 * 3200 >= 132 * tss.SPLIT_TARGET_PER_SM * 0.5
    assert tss.fwd_seg_chunks(1, 16, 3) == 1        # tiny: one a segment
    assert tss.fwd_seg_chunks(1, 16, 1) == 1


# ---------------------------------------------------------------------------
# the backward's pieces


@pytest.mark.parametrize("b,s,di,ds,chunk,piece,sub,channels,dtype", [
    (2, 32, 16, 16, 16, 16, 4, 8, "float32"),
    (1, 48, 32, 4, 16, 8, 4, 16, "float32"),
    (2, 32, 16, 4, 8, 8, 8, 16, "bfloat16"),
])
def test_backward_pieces_match_pallas(b, s, di, ds, chunk, piece, sub,
                                      channels, dtype):
    arrays = _inputs(3, b, s, di, ds, dtype)
    h0, gy, gh = arrays[5:]
    jin = _jax_in(arrays, dtype)
    _, _, hc = jss.selective_scan_fwd(*jin, jnp.asarray(h0), chunk=chunk,
                                      block_d=16, interpret=True,
                                      return_ckpt=True)
    want = jss.selective_scan_bwd(
        *jin, hc, jnp.asarray(gy, getattr(jnp, dtype)), jnp.asarray(gh),
        chunk=chunk, block_d=16, interpret=True)
    x, dt, bi, ci, al, th0, tgy, tgh = _port(arrays, dtype)
    _, _, thc = fwd_segments_model(x, dt, bi, ci, al, th0, chunk=chunk,
                                   seg_chunks=2)
    got = bwd_pieces_model(x, dt, bi, ci, al, thc, tgy, tgh, chunk=chunk,
                           piece=piece, sub=sub, channels=channels)
    assert got[0].dtype == got[1].dtype == TDT[dtype]
    for name, g, w in zip("dx ddt db dc dA_log dh0".split(), got, want):
        _close(g, np.asarray(w, np.float32), TOL[dtype], name)


@pytest.mark.parametrize("s,di,ds,chunk,piece,sub,channels", [
    (45, 40, 16, 32, 8, 4, 16),   # ragged S and d; chunk of 4 pieces
    (30, 24, 8, 7, 4, 2, 16),     # a chunk no multiple of a piece
])
def test_backward_pieces_ragged_against_the_oracle(s, di, ds, chunk, piece,
                                                   sub, channels):
    x, dt, bi, ci, al, h0, gy, gh = _inputs(4, 2, s, di, ds)
    (y, hf), vjp = jax.vjp(jref.selective_scan_ref,
                           *map(jnp.asarray, (x, dt, bi, ci, al, h0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    tin = [torch.from_numpy(a) for a in (x, dt, bi, ci, al)]
    _, _, thc = fwd_segments_model(*tin, torch.from_numpy(h0), chunk=chunk,
                                   seg_chunks=1)
    got = bwd_pieces_model(*tin, thc, torch.from_numpy(gy),
                           torch.from_numpy(gh), chunk=chunk, piece=piece,
                           sub=sub, channels=channels)
    # the oracle's dA_log is summed over the batch, as the model's
    for name, g, w in zip("dx ddt db dc dA_log dh0".split(), got, want):
        _close(g, w, TOL["float32"], name)


def test_backward_pieces_at_the_train_path_chunk_equal_the_plain_version():
    """At the kernel path's checkpoint interval (kernel_chunk of the
    default 256: one piece a chunk) and the kernel's own sizes, the model
    agrees with the port's plain backward, which recomputes each chunk
    whole."""
    x, dt, bi, ci, al, h0, gy, gh = (torch.from_numpy(a) for a in
                                     _inputs(5, 1, 80, 24, 16))
    chunk = tss.kernel_chunk(256)
    _, _, hc = tss.selective_scan_fwd_plain(x, dt, bi, ci, al, h0,
                                            chunk=chunk)
    want = tss.selective_scan_bwd_plain(x, dt, bi, ci, al, hc, gy, gh,
                                        chunk=chunk)
    got = bwd_pieces_model(x, dt, bi, ci, al, hc, gy, gh, chunk=chunk,
                           piece=tss.PIECE, sub=tss.BWD_SUB,
                           channels=tss.BWD_CHANNELS)
    for name, g, w in zip("dx ddt db dc dA_log dh0".split(), got, want):
        assert math.isfinite(g.abs().max().item())
        _close(g, w.numpy(), TOL["float32"], name)
