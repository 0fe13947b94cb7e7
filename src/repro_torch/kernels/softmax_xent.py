"""Fused LM-head cross-entropy, forward and backward: the CUDA kernels'
wrappers, their plain versions, and a plain model of the kernels'
split-bf16 route.

Replaces the TPU kernels ``repro/kernels/softmax_xent.py:
softmax_xent_fwd`` (Pallas body ``_fwd_kernel``) and ``softmax_xent_bwd``
(``_bwd_dh_kernel``, ``_bwd_dw_kernel``) with the hand-written Hopper
kernels of ``csrc/softmax_xent.cu``; the source says what bounds them on
an H100 and what their design does about that.

Both versions compute, for h [T,D] and w [D,V] (each f32 or bf16) and
labels [T]:

  logits = h . w in f32;  lse = logsumexp(logits);  loss = lse - logits[label]
  ds = g * (exp(logits - lse) - onehot(label))
  dh = ds . w^T (h's dtype);  dw = h^T . ds (w's dtype)

A label may lie outside [0, V): it then has no gold logit (loss = lse)
and no one-hot. That is how a model rank of the vocab-parallel CE
(``ops.softmax_xent_vocab_parallel``) runs on its shard w[:, v0 : v0 +
V/m] with labels - v0; there the backward's lse is the global one, so its
ds is the shard's columns of the global softmax's. The kernels only ever
compare a label with a column index, never index by it.

The kernels never hold [T, V] logits; the plain versions materialize them.
The kernels run every product on the tensor cores from bf16 pieces of the
f32 operands (``pieces.split_bf16``): an f32 x is hi + lo, and a product
of two split operands is the sum of three bf16 products (lo . lo
dropped), accumulated in f32. ``softmax_xent_fwd_pieces`` and
``softmax_xent_bwd_pieces`` are that route in plain PyTorch, for the tests
and the card's checks; the plain versions stay the oracle.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, pieces
from repro_torch.kernels.pieces import n_pieces, split_bf16  # noqa: F401
from repro_torch.kernels.ref import gold_logits, softmax_xent_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# (loss [T], lse [T]) in f32 through materialized logits: the oracle is
# the forward's plain version as it stands
softmax_xent_fwd_plain = softmax_xent_ref


def _ds(logits, labels, lse, g):
    """ds = g * (exp(logits - lse) - onehot(label)) in f32 (no one-hot for
    a label outside [0, V))."""
    p = torch.exp(logits - lse[:, None])
    labels = labels.long()
    # every row subtracts at its label, 0 where the label lies outside
    # (p - 0 is p): no data-dependent shape, so a fake tensor traces it
    inside = (labels >= 0) & (labels < logits.shape[1])
    rows = torch.arange(labels.shape[0], device=labels.device)
    p[rows, torch.where(inside, labels, 0)] -= inside.float()
    return p * g.float()[:, None]


def softmax_xent_bwd_plain(h, w, labels, lse, g):
    """(dh [T,D] in h's dtype, dw [D,V] in w's dtype)."""
    ds = _ds(h.float() @ w.float(), labels, lse, g)
    return (ds @ w.float().T).to(h.dtype), (h.float().T @ ds).to(w.dtype)


# ---------------------------------------------------------------------------
# the split-bf16 route (its pieces in ``pieces.py``, shared with the flash
# kernels' f32 route)


def products(h_dtype, w_dtype) -> tuple:
    """(forward, backward) bf16 products a call runs on the tensor cores:
    the logits (h . w), and in the backward the logits again, dh (ds . w^T)
    and dw (h^T . ds), with ds always split in two."""
    nh, nw = n_pieces(h_dtype), n_pieces(w_dtype)
    fwd = pieces.n_products(nh, nw)
    return fwd, fwd + pieces.n_products(2, nw) + pieces.n_products(nh, 2)


def softmax_xent_fwd_pieces(h, w, labels):
    """The forward's route in plain PyTorch: (loss [T], lse [T]) in f32
    from the split-bf16 logits."""
    logits = pieces.product(h, w)
    lse = torch.logsumexp(logits, dim=-1)
    return lse - gold_logits(logits, labels), lse


def softmax_xent_bwd_pieces(h, w, labels, lse, g):
    """The backward's route in plain PyTorch: (dh in h's dtype, dw in w's
    dtype), with the logits, dh and dw each from bf16 pieces and ds split
    in two (it is built in f32, as the TPU kernel keeps it)."""
    ds = _ds(pieces.product(h, w), labels, lse, g)
    return (pieces.product(ds, w.T).to(h.dtype),
            pieces.product(h.T, ds).to(w.dtype))


# ---------------------------------------------------------------------------
# the CUDA kernels


def _check(h, w, labels):
    if h.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {h.device}")
    if w.device != h.device or labels.device != h.device:
        raise ValueError("h, w and labels must lie on one device")
    for name, t in (("h", h), ("w", w)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError("labels must be int32")
    if h.dim() != 2 or w.dim() != 2 or w.shape[0] != h.shape[1]:
        raise ValueError(f"bad shapes h {tuple(h.shape)} w {tuple(w.shape)}")
    if labels.shape != (h.shape[0],) or min(h.shape[0], *w.shape) == 0:
        raise ValueError(f"labels {tuple(labels.shape)} do not fit h "
                         f"{tuple(h.shape)}")
    for name, t in (("h", h), ("w", w), ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _lib():
    lib = build.load("softmax_xent")
    lib.softmax_xent_fwd.argtypes = ([ctypes.c_int] * 2
                                     + [ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.softmax_xent_bwd.argtypes = ([ctypes.c_int] * 2
                                     + [ctypes.c_void_p] * 10
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for fn in (lib.softmax_xent_fwd, lib.softmax_xent_bwd,
               lib.softmax_xent_fwd_scratch, lib.softmax_xent_bwd_slab):
        fn.restype = ctypes.c_int
    lib.softmax_xent_fwd_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.softmax_xent_bwd_slab.argtypes = []
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _padded(n: int) -> int:
    """Columns of a row of the bf16 pieces: n rounded up to 8, so that a
    row is a whole number of 16-byte units (TMA's rule for a row stride);
    the pad columns are zero."""
    return -(-n // 8) * 8


def _pieces_scratch(h, w):
    """bf16 scratch for the split pass: the pieces of h [pieces, T, D_pad]
    and of w [pieces, D, V_pad]. An f32 operand has two pieces; a bf16 one
    is read in place where its rows are 16-byte aligned (None), else copied
    padded as one piece."""
    t, d = h.shape
    v = w.shape[1]
    dp, vp = _padded(d), _padded(v)
    hp = wp = None
    if h.dtype == torch.float32 or dp != d:
        hp = torch.empty((n_pieces(h.dtype), t, dp), dtype=torch.bfloat16,
                         device=h.device)
    if w.dtype == torch.float32 or vp != v:
        wp = torch.empty((n_pieces(w.dtype), d, vp), dtype=torch.bfloat16,
                         device=h.device)
    return hp, wp, dp, vp


def _ptr(t):
    return None if t is None else t.data_ptr()


def softmax_xent_fwd(h, w, labels):
    """Launch the CUDA forward (split pass, logits GEMM with the stats
    epilogue, merge) on the current stream. Returns (loss [T], lse [T]) in
    f32."""
    _check(h, w, labels)
    t, d = h.shape
    v = w.shape[1]
    lib = _lib()
    hp, wp, dp, vp = _pieces_scratch(h, w)
    part = torch.empty((lib.softmax_xent_fwd_scratch(t, v), t),
                       dtype=torch.float32, device=h.device)
    loss = torch.empty(t, dtype=torch.float32, device=h.device)
    lse = torch.empty(t, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        err = lib.softmax_xent_fwd(
            _DTYPE_CODES[h.dtype], _DTYPE_CODES[w.dtype], h.data_ptr(),
            w.data_ptr(), labels.data_ptr(), _ptr(hp), _ptr(wp),
            part.data_ptr(), loss.data_ptr(), lse.data_ptr(), t, d, v, dp, vp,
            _stream(h))
    build.check(lib, err, "softmax_xent_fwd")
    softmax_xent_fwd.launches += 1
    return loss, lse


softmax_xent_fwd.launches = 0


def softmax_xent_bwd(h, w, labels, lse, g):
    """Launch the CUDA backward (split pass; per vocab slab: ds, dh +=, dw)
    on the current stream. Returns (dh in h's dtype, dw in w's dtype)."""
    _check(h, w, labels)
    t, d = h.shape
    v = w.shape[1]
    for name, x in (("lse", lse), ("g", g)):
        if (x.device != h.device or x.dtype != torch.float32
                or x.shape != (t,) or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 [{t}] on "
                             f"{h.device}")
    lib = _lib()
    hp, wp, dp, vp = _pieces_scratch(h, w)
    ds = torch.empty((2, t, lib.softmax_xent_bwd_slab()),
                     dtype=torch.bfloat16, device=h.device)
    dh = torch.empty((t, d), dtype=torch.float32, device=h.device)
    dw = torch.empty_like(w)
    with torch.cuda.device(h.device):
        err = lib.softmax_xent_bwd(
            _DTYPE_CODES[h.dtype], _DTYPE_CODES[w.dtype], h.data_ptr(),
            w.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
            _ptr(hp), _ptr(wp), ds.data_ptr(), dh.data_ptr(), dw.data_ptr(),
            t, d, v, dp, vp, _stream(h))
    build.check(lib, err, "softmax_xent_bwd")
    softmax_xent_bwd.launches += 1
    return dh.to(h.dtype), dw


softmax_xent_bwd.launches = 0
