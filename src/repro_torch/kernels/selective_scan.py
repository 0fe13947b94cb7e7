"""The Mamba-1 selective scan, forward and backward: the CUDA kernels'
wrappers and their plain versions.

Replaces the TPU kernels ``repro/kernels/selective_scan.py:
selective_scan_fwd`` (Pallas body ``_kernel``) and ``selective_scan_bwd``
(``_bwd_kernel``) with the hand-written Hopper kernels
``csrc/selective_scan_fwd.cu`` and ``csrc/selective_scan_bwd.cu``; each
source says what bounds it on an H100 and what its design does about
that.

Both versions compute the same function, in f32 whatever the inputs'
dtype: x, dt [B,S,di] and b, c [B,S,ds] (all f32 or all bf16), a_log
[di,ds] f32, h0 [B,di,ds] f32 or None (zeros), with A = -exp(a_log),

  a_t = exp(dt_t A);  h_t = a_t * h_{t-1} + (dt_t x_t) b_t;  y_t = h_t . c_t

returning y in x's dtype, h_final = h_{S-1} and h_ckpt [B, nc, di, ds]
(nc = ceil(S / chunk)), the state entering each chunk (``h_ckpt[:, 0]``
is h0). Neither pads nor asserts: a ragged last chunk is shorter, and d
needs no block multiple (the JAX package's Pallas kernel asserts both).

The backward sweeps the chunks in reverse, recomputes each chunk's states
from its checkpoint and runs the adjoint (the carry g enters as gh):

  lam_t = g + gy_t c_t;  sb = lam_t . b_t;  dadt = lam_t * h_{t-1} * a_t
  dx_t = dt_t sb;  ddt_t = x_t sb + dadt . A;  db_t = sum_d (dt_t x_t) lam_t
  dc_t = sum_d gy_t h_t;  dA_log += dadt * dt_t * A;  g = a_t * lam_t

and returns (dx, ddt, db, dc, dA_log, dh0 = the final g): dx and ddt in
the inputs' dtypes, the rest f32 (the caller casts). The kernel writes
db/dc as per-block partials [B, nd, S, ds] and dA_log as per-batch
partials [B, di, ds]; the wrapper sums them, so no atomics are needed and
the result does not depend on the order blocks run in.

How the kernels split the work (``fwd_seg_chunks``, ``kernel_chunk``):
the forward runs a small grid as segments of whole chunks (local end
states from zero, a combine in order, then a sweep from the true
entries); the backward recomputes a chunk in pieces of ``PIECE`` steps,
and the autograd Function checkpoints every ``kernel_chunk(chunk)`` steps
so that a piece is a chunk. Neither changes the function.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

STATE_SIZES = (4, 8, 16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The backward kernel's sizes (csrc/selective_scan_bwd.cu, which asserts
# them): its piece, the steps it recomputes from one entry state with each
# state computed twice; the sub-chunk it holds in registers; the channels
# a block covers (the db/dc partials' nd = ceil(di / BWD_CHANNELS)).
PIECE = 64
BWD_SUB = 8
BWD_CHANNELS = 64
# The forward splits the sequence when fewer (batch, channel) threads than
# this would run (one thread each): a grid that does not fill the card.
# Timed on an H100 (PERF.md, PR 16): hymba-1.5b's prefill (4 x 3200) gains
# from the split, its train shape (8 x 3200) and falcon-mamba's serve
# prefill (4 x 8192) lose.
SPLIT_BELOW = 16384
# Threads the split aims for: 8 blocks of 128 an SM.
SPLIT_TARGET_PER_SM = 1024


def kernel_chunk(chunk: int) -> int:
    """The checkpoint interval the kernel path uses for a requested scan
    chunk: at most a backward piece, so the backward walks no chunk twice.
    The scan's outputs do not depend on it; h_ckpt's length does."""
    return min(chunk, PIECE)


def fwd_seg_chunks(bsz: int, di: int, nc: int, sm_count: int = 132) -> int:
    """Chunks a forward segment spans: nc (one sweep) when bsz * di
    threads fill the card, else enough segments for ~SPLIT_TARGET_PER_SM
    threads an SM, each a whole number of chunks."""
    threads = bsz * di
    if threads >= SPLIT_BELOW or nc == 1:
        return nc
    want = -(-sm_count * SPLIT_TARGET_PER_SM // threads)
    return -(-nc // min(want, nc))


# ---------------------------------------------------------------------------
# plain versions


def _n_chunks(s: int, chunk: int) -> int:
    return -(-s // chunk)


def _step(h, a_neg, xt, dtt, bt):
    """One step of the recurrence in f32: (a_t, h_t)."""
    a = torch.exp(dtt[..., None] * a_neg)
    return a, a * h + (dtt * xt)[..., None] * bt[:, None, :]


def selective_scan_fwd_plain(x, dt, b, c, a_log, h0=None, *, chunk=256):
    """The forward kernel's function in plain PyTorch: vectorised over
    (B, di, ds), a loop over t. Returns (y, h_final, h_ckpt)."""
    bsz, s, di = x.shape
    ds = b.shape[-1]
    a_neg = -torch.exp(a_log.float())
    h = (torch.zeros((bsz, di, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_ckpt = torch.empty((bsz, _n_chunks(s, chunk), di, ds),
                         dtype=torch.float32, device=x.device)
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=x.device)
    for t in range(s):
        if t % chunk == 0:
            h_ckpt[:, t // chunk] = h
        _, h = _step(h, a_neg, x[:, t].float(), dt[:, t].float(),
                     b[:, t].float())
        y[:, t] = torch.einsum("bns,bs->bn", h, c[:, t].float())
    return y.to(x.dtype), h, h_ckpt


def selective_scan_bwd_plain(x, dt, b, c, a_log, h_ckpt, gy, gh, *,
                             chunk=256):
    """The backward kernel's function in plain PyTorch: chunks in reverse,
    each chunk's states recomputed from its checkpoint, then the adjoint
    through them. Returns (dx, ddt, db, dc, dA_log, dh0)."""
    bsz, s, di = x.shape
    ds = b.shape[-1]
    dev = x.device
    a_neg = -torch.exp(a_log.float())
    dx = torch.empty((bsz, s, di), dtype=torch.float32, device=dev)
    ddt = torch.empty_like(dx)
    db = torch.empty((bsz, s, ds), dtype=torch.float32, device=dev)
    dc = torch.empty_like(db)
    da = torch.zeros((bsz, di, ds), dtype=torch.float32, device=dev)
    g = gh.float()
    for ci in reversed(range(_n_chunks(s, chunk))):
        t0, t1 = ci * chunk, min((ci + 1) * chunk, s)
        hs = [h_ckpt[:, ci]]                   # hs[i] enters step t0 + i
        for t in range(t0, t1):
            hs.append(_step(hs[-1], a_neg, x[:, t].float(), dt[:, t].float(),
                            b[:, t].float())[1])
        for t in reversed(range(t0, t1)):
            xt, dtt = x[:, t].float(), dt[:, t].float()
            bt, ct, gyt = b[:, t].float(), c[:, t].float(), gy[:, t].float()
            hprev, ht = hs[t - t0], hs[t - t0 + 1]
            lam = g + gyt[..., None] * ct[:, None, :]
            a = torch.exp(dtt[..., None] * a_neg)
            sb = torch.einsum("bns,bs->bn", lam, bt)
            dadt = lam * hprev * a
            dc[:, t] = torch.einsum("bn,bns->bs", gyt, ht)
            db[:, t] = torch.einsum("bn,bns->bs", dtt * xt, lam)
            dx[:, t] = dtt * sb
            ddt[:, t] = xt * sb + (dadt * a_neg).sum(-1)
            da += dadt * dtt[..., None] * a_neg
            g = a * lam
    return (dx.to(x.dtype), ddt.to(dt.dtype), db, dc, da.sum(0), g)


# ---------------------------------------------------------------------------
# the kernels


@functools.cache
def _lib():
    ptr = ctypes.c_void_p
    lib = build.load("selective_scan_fwd")
    lib.selective_scan_fwd.argtypes = ([ctypes.c_int] * 2 + [ptr] * 10
                                       + [ctypes.c_int] * 5 + [ptr])
    lib.selective_scan_fwd.restype = ctypes.c_int
    bwd = build.load("selective_scan_bwd")
    bwd.selective_scan_bwd.argtypes = ([ctypes.c_int] * 2 + [ptr] * 14
                                       + [ctypes.c_int] * 4 + [ptr])
    bwd.selective_scan_bwd.restype = ctypes.c_int
    bwd.selective_scan_bwd_max_chunk.argtypes = []
    bwd.selective_scan_bwd_max_chunk.restype = ctypes.c_int
    return lib, bwd


def _check_inputs(x, dt, b, c, a_log, chunk):
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c),
                    ("a_log", a_log)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"the CUDA kernel takes CUDA tensors on one "
                             f"device, got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if any(t.dtype != x.dtype for t in (dt, b, c)):
        raise TypeError("x, dt, b and c must share one dtype")
    if a_log.dtype != torch.float32:
        raise TypeError(f"a_log must be float32, got {a_log.dtype}")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be [B,S,di], got {tuple(x.shape)} "
                         f"and {tuple(dt.shape)}")
    bsz, s, di = x.shape
    ds = b.shape[-1]
    if b.shape != (bsz, s, ds) or c.shape != b.shape:
        raise ValueError("b and c must be [B,S,ds]")
    if a_log.shape != (di, ds):
        raise ValueError(f"a_log must be [di, ds] = [{di}, {ds}]")
    if ds not in STATE_SIZES:
        raise ValueError(f"d_state {ds} is not one of {STATE_SIZES}")
    if s < 1 or bsz < 1 or di < 1 or chunk < 1:
        raise ValueError("empty input or chunk < 1")
    return bsz, s, di, ds


def _check_state(name, t, shape, device):
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous f32 {list(shape)} on "
                         f"{device}")


def selective_scan_fwd(x, dt, b, c, a_log, h0=None, *, chunk=256):
    """Launch the forward kernel on the current stream (no sync), split
    into segments as ``fwd_seg_chunks`` plans for this card. Returns (y,
    h_final, h_ckpt)."""
    bsz, s, di, ds = _check_inputs(x, dt, b, c, a_log, chunk)
    if h0 is not None:
        _check_state("h0", h0, (bsz, di, ds), x.device)
    lib, _ = _lib()
    nc = _n_chunks(s, chunk)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    seg_chunks = fwd_seg_chunks(bsz, di, nc, sms)
    y = torch.empty_like(x)
    h_final = torch.empty((bsz, di, ds), dtype=torch.float32,
                          device=x.device)
    h_ckpt = torch.empty((bsz, nc, di, ds), dtype=torch.float32,
                         device=x.device)
    seg_dt = (None if seg_chunks == nc else
              torch.empty((bsz, -(-nc // seg_chunks), di),
                          dtype=torch.float32, device=x.device))
    with torch.cuda.device(x.device):
        err = lib.selective_scan_fwd(
            _DTYPE_CODES[x.dtype], ds, x.data_ptr(), dt.data_ptr(),
            b.data_ptr(), c.data_ptr(), a_log.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), h_ckpt.data_ptr(),
            None if seg_dt is None else seg_dt.data_ptr(), bsz, s, di,
            chunk, seg_chunks,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "selective_scan_fwd")
    selective_scan_fwd.launches += 1
    return y, h_final, h_ckpt


selective_scan_fwd.launches = 0


def selective_scan_bwd(x, dt, b, c, a_log, h_ckpt, gy, gh, *, chunk=256):
    """Launch the backward kernel on the current stream (no sync) and sum
    its partials. Returns (dx, ddt, db, dc, dA_log, dh0)."""
    bsz, s, di, ds = _check_inputs(x, dt, b, c, a_log, chunk)
    _check_state("h_ckpt", h_ckpt, (bsz, _n_chunks(s, chunk), di, ds),
                 x.device)
    _check_state("gh", gh, (bsz, di, ds), x.device)
    if gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device \
            or not gy.is_contiguous():
        raise ValueError("gy must be contiguous, of x's shape and dtype")
    _, lib = _lib()
    if chunk > lib.selective_scan_bwd_max_chunk():
        raise ValueError(f"chunk {chunk} exceeds the backward kernel's "
                         f"{lib.selective_scan_bwd_max_chunk()}")
    nd = -(-di // BWD_CHANNELS)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    db_part = torch.empty((bsz, nd, s, ds), **f32)
    dc_part = torch.empty((bsz, nd, s, ds), **f32)
    da_part = torch.empty((bsz, di, ds), **f32)
    dh0 = torch.empty((bsz, di, ds), **f32)
    with torch.cuda.device(x.device):
        err = lib.selective_scan_bwd(
            _DTYPE_CODES[x.dtype], ds, x.data_ptr(), dt.data_ptr(),
            b.data_ptr(), c.data_ptr(), a_log.data_ptr(), h_ckpt.data_ptr(),
            gy.data_ptr(), gh.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            db_part.data_ptr(), dc_part.data_ptr(), da_part.data_ptr(),
            dh0.data_ptr(), bsz, s, di, chunk,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return (dx, ddt, db_part.sum(1), dc_part.sum(1), da_part.sum(0), dh0)


selective_scan_bwd.launches = 0
