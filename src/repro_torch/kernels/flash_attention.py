"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Replaces the TPU kernels ``repro/kernels/flash_attention.py:
flash_attention_fwd`` (Pallas body ``_fwd_kernel``) and
``flash_attention_bwd`` (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) with the
hand-written Hopper kernels ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``; each source says what bounds it on an
H100 and what its design does about that.

Both versions compute the same function: q [B,Sq,H,hd], k/v [B,Sk,K,hd]
(q head h reads kv head h // (H/K)), masked by absolute int32 positions
(causal, sliding window) and the key-validity bits, with

  s = (q * scale) . k in f32;  p = exp(s - max) where the mask holds, else 0
  o = (p in v's dtype) . v / max(l, 1e-30)   in q's dtype
  lse = m + log(l) where l > 0, else 0        [B,H,Sq] f32

so a row with no valid key gives o = 0 and lse = 0 (the oracle in
``ref.py`` softmaxes such a row into a uniform average instead). The
backward rebuilds p from lse, with delta = rowsum(dO * O):

  p = exp(s - lse) where the mask holds, else 0;  ds = p * (dO.v - delta)
  dq = ds . k * scale;  dk = ds^T . (q * scale);  dv = p^T . dO

in f32, returned in q's, k's and v's dtypes.

Routes on the card (``csrc/flash_attention_fwd.cu``, ``_bwd.cu``):

* bf16, tiled: the products run on the tensor cores (mma.sync, bf16
  operands, f32 accumulators). s = (q . k) * scale in f32, the scale
  applied after the product (q is never rounded after scaling); p is
  rounded to bf16 before PV, as above. In the backward p and ds are also
  rounded to bf16 before their products, where the TPU kernels keep them
  in f32: that route's one deviation, within bf16's 2e-2 tolerance.
* f32, tiled (``pieces``): every product on the tensor cores from bf16
  pieces of its f32 operands, three bf16 products summed in f32
  (``pieces.product``; ``route_products`` counts them), the scale applied
  to q before its split; p and ds stay f32 in value, split in two.
  ``flash_attention_fwd_pieces`` and ``flash_attention_bwd_pieces`` are
  that route in plain PyTorch, for the tests and the card's checks.
* split-KV (forward, f32 and bf16): taken when a kv head's G q heads x Sq
  queries fit ``SPLIT_MAX_ROWS`` rows (every decode step). The keys are cut
  into ``split_plan`` chunks; one block per (chunk, kv head, batch) reads
  its K/V rows once for all G heads and writes a partial o (f32) and lse,
  -inf where no key of the chunk passes the mask; a combine kernel merges
  them by lse (``merge_partials`` is its plain version).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, pieces
from repro_torch.kernels.ref import NEG_INF

MAX_HEAD_DIM = 128
# the split-KV route: at most this many (q head, query) rows a kv head,
# keys in chunks of a multiple of SPLIT_TILE
SPLIT_MAX_ROWS = 16
SPLIT_TILE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_SPLIT_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])


def pair_mask(q_pos, k_pos, k_valid, causal, window):
    """[B, Sq, Sk] bool: which (query, key) pairs attend."""
    ok = k_valid[:, None, :].expand(-1, q_pos.shape[1], -1)
    if causal:
        ok = ok & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        ok = ok & ((q_pos[:, :, None] - k_pos[:, None, :]) < window)
    return ok


def _pieces_einsum(eq, a, b):
    """einsum(eq, a, b) as the f32 route forms it: three bf16 products of
    the operands' pieces, summed in f32 (``pieces.product``)."""
    return pieces.product(a, b, functools.partial(torch.einsum, eq))


def _forward(q, k, v, q_pos, k_pos, k_valid, causal, window, mul):
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = (q.float() * hd ** -0.5).reshape(b, sq, kh, g, hd)
    s = mul("bqkgd,bskd->bkgqs", qg, k.float())
    ok = pair_mask(q_pos, k_pos, k_valid, causal, int(window))[:, None, None]
    m = torch.where(ok, s, NEG_INF).amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)                                       # [b,kh,g,sq]
    acc = mul("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    o = acc / l.clamp_min(1e-30)[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-30)), 0.0)
    return o, lse.reshape(b, h, sq)


def flash_attention_plain(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                          k_valid):
    """The kernel's function in plain PyTorch (materialized scores).

    Returns (o [B,Sq,H,hd] in q's dtype, lse [B,H,Sq] f32)."""
    return _forward(q, k, v, q_pos, k_pos, k_valid, causal, window,
                    torch.einsum)


def flash_attention_fwd_pieces(q, k, v, q_pos, k_pos, *, causal=True,
                               window=0, k_valid):
    """The f32 tiled route in plain PyTorch: s = (q * scale) . k and
    o = p . v each from bf16 pieces, p masked and kept in f32 before its
    split. Returns (o, lse) as ``flash_attention_plain``; the kernel's gap
    to it is summation order and its running max alone."""
    return _forward(q, k, v, q_pos, k_pos, k_valid, causal, window,
                    _pieces_einsum)


def route_products(dtype) -> tuple:
    """(forward, backward) bf16 products a tiled call runs on the tensor
    cores: each of the forward's 2 products (s, o) and the backward's 5 (s,
    dp, dq, dk, dv) is three in f32 (the pieces route), one in bf16."""
    n = pieces.n_products(pieces.n_pieces(dtype), pieces.n_pieces(dtype))
    return 2 * n, 5 * n


def uses_split(sq, h, kh) -> bool:
    """Whether the forward takes the split-KV route: a kv head's G q heads
    x Sq queries fit one block's rows (every decode step does)."""
    return (h // kh) * sq <= SPLIT_MAX_ROWS


def split_plan(b, kh, sk, sm_count):
    """(n_chunks, chunk) of the split-KV route: chunks of `chunk` keys, a
    multiple of SPLIT_TILE, that cover [0, sk) once, with b * kh *
    n_chunks blocks near four a streaming multiprocessor, as many as can
    be resident at once in bf16 (the chunk length is rounded to the
    nearest multiple of the tile). Decode is latency-bound: more, shorter
    chunks run more of their one-tile copies side by side."""
    want = max(1, -(-4 * sm_count // (b * kh)))
    chunk = max(1, round(sk / want / SPLIT_TILE)) * SPLIT_TILE
    return -(-sk // chunk), chunk


def merge_partials(o_parts, lse_parts, dtype):
    """The combine kernel's function: merge per-chunk partials by lse.

    o_parts [n, B, Sq, H, hd] (each chunk's o, normalised), lse_parts
    [n, B, H, Sq] f32 with -inf where no key of the chunk passed the mask
    (such a chunk gets weight 0). Returns (o [B,Sq,H,hd] in `dtype`, lse
    [B,H,Sq] f32); a row no chunk saw gives o = 0 and lse = 0."""
    m = lse_parts.amax(dim=0)                                # [B,H,Sq]
    empty = torch.isneginf(m)
    w = torch.exp(lse_parts - torch.where(empty, 0.0, m))   # -inf -> 0
    wsum = w.sum(dim=0)
    o = (w.permute(0, 1, 3, 2)[..., None] * o_parts.float()).sum(dim=0)
    o = o / wsum.transpose(1, 2).clamp_min(1e-30)[..., None]
    lse = torch.where(empty, 0.0, m + torch.log(wsum.clamp_min(1e-30)))
    return o.to(dtype), lse


def attention_delta(o, do):
    """delta = rowsum(dO * O) in f32, [B,H,Sq], for the backward's plain
    version (outside the kernel, as the TPU's caller computes it; the CUDA
    dq kernels compute it themselves)."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).contiguous()


def _backward(q, k, v, q_pos, k_pos, k_valid, o, lse, do, causal, window,
              mul):
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    qg = (q.float() * scale).reshape(b, sq, kh, g, hd)
    dog = do.float().reshape(b, sq, kh, g, hd)
    s = mul("bqkgd,bskd->bkgqs", qg, k.float())
    ok = pair_mask(q_pos, k_pos, k_valid, causal, int(window))[:, None, None]
    lse_g = lse.reshape(b, kh, g, sq)[..., None]
    delta = attention_delta(o, do).reshape(b, kh, g, sq)[..., None]
    p = torch.where(ok, torch.exp(s - lse_g), 0.0)
    dp = mul("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta)
    dq = mul("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = mul("bkgqs,bqkgd->bskd", ds, qg)
    dv = mul("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_plain(q, k, v, q_pos, k_pos, k_valid, o, lse, do, *,
                              causal=True, window=0):
    """The backward kernels' function in plain PyTorch (materialized
    scores). Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    return _backward(q, k, v, q_pos, k_pos, k_valid, o, lse, do, causal,
                     window, torch.einsum)


def flash_attention_bwd_pieces(q, k, v, q_pos, k_pos, k_valid, o, lse, do,
                               *, causal=True, window=0):
    """The f32 tiled route of the backward in plain PyTorch: s, dp, dq, dk
    and dv each from bf16 pieces, p and ds built in f32 and split before
    their products (delta = rowsum(dO * O) in f32). Returns (dq, dk, dv)
    as ``flash_attention_bwd_plain``."""
    return _backward(q, k, v, q_pos, k_pos, k_valid, o, lse, do, causal,
                     window, _pieces_einsum)


def _check(q, k, v, q_pos, k_pos, k_valid):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos),
                    ("k_valid", k_valid)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of float32/bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("positions must be int32")
    if k_valid.dtype != torch.bool:
        raise TypeError("k_valid must be bool")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    _, sk, kh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or h % kh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if min(b, sq, sk) == 0 or b > 65535 or h > 65535:
        raise ValueError(f"unsupported sizes B={b} Sq={sq} Sk={sk} H={h}")
    if (q_pos.shape != (b, sq) or k_pos.shape != (b, sk)
            or k_valid.shape != (b, sk)):
        raise ValueError("positions / k_valid do not match q / k")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("k_pos", k_pos), ("k_valid", k_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _entry():
    fn = build.load("flash_attention_fwd").flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _split_entry():
    fn = build.load("flash_attention_fwd").flash_attention_fwd_split
    fn.argtypes = _SPLIT_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _bwd_entry():
    fn = build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                        k_valid, return_lse=False):
    """Launch the CUDA kernels on the current stream (no synchronisation):
    the split-KV pair where ``uses_split`` holds, else the tiled kernel of
    the dtype.

    Every tensor lies on one CUDA device and is contiguous; the kernels
    build at first use. Raises on anything the kernels do not take."""
    _check(q, k, v, q_pos, k_pos, k_valid)
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), k_valid.data_ptr(), o.data_ptr(),
            lse.data_ptr())
    tail = (hd ** -0.5, int(bool(causal)), int(window))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if uses_split(sq, h, kh):
            nc, chunk = split_plan(b, kh, sk, _sm_count(q.device.index))
            rows = (h // kh) * sq
            o_part = torch.empty((b, kh, nc, rows, hd), dtype=torch.float32,
                                 device=q.device)
            lse_part = torch.empty((b, kh, nc, rows), dtype=torch.float32,
                                   device=q.device)
            err = _split_entry()(_DTYPE_CODES[q.dtype], *ptrs,
                                 o_part.data_ptr(), lse_part.data_ptr(), b,
                                 sq, sk, h, kh, hd, *tail, nc, chunk, stream)
        else:
            err = _entry()(_DTYPE_CODES[q.dtype], *ptrs, b, sq, sk, h, kh,
                           hd, *tail, stream)
    build.check(build.load("flash_attention_fwd"), err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return (o, lse) if return_lse else o


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, q_pos, k_pos, k_valid, o, lse, do, *,
                        causal=True, window=0):
    """Launch the CUDA backward kernels (dq, then dk/dv) on the current
    stream. The residuals are the forward's; the dq kernel computes delta
    = rowsum(dO * O) into a scratch buffer that the dk/dv kernel reads.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    _check(q, k, v, q_pos, k_pos, k_valid)
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    for name, t, shape, dtype in (("o", o, q.shape, q.dtype),
                                  ("do", do, q.shape, q.dtype),
                                  ("lse", lse, (b, h, sq), torch.float32)):
        if t.device != q.device or t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _bwd_entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                 k_valid.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kh, hd,
                 hd ** -0.5, int(bool(causal)), int(window), stream)
    build.check(build.load("flash_attention_bwd"), err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
