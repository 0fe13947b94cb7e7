"""Fused LM-head cross-entropy, forward and backward: the CUDA kernels'
wrappers and their plain versions.

Replaces the TPU kernels ``repro/kernels/softmax_xent.py:
softmax_xent_fwd`` (Pallas body ``_fwd_kernel``) and ``softmax_xent_bwd``
(``_bwd_dh_kernel``, ``_bwd_dw_kernel``) with the hand-written Hopper
kernels of ``csrc/softmax_xent.cu``; the source says what bounds them on
an H100 and what their design does about that.

Both versions compute, for h [T,D], w [D,V] (f32 or bf16) and labels [T]:

  logits = h . w in f32;  lse = logsumexp(logits);  loss = lse - logits[label]
  ds = g * (softmax(logits) - onehot(label))
  dh = ds . w^T (h's dtype);  dw = h^T . ds (w's dtype)

The kernels never hold [T, V] logits; the plain versions materialize them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import softmax_xent_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# (loss [T], lse [T]) in f32 through materialized logits: the oracle is
# the forward's plain version as it stands
softmax_xent_fwd_plain = softmax_xent_ref


def softmax_xent_bwd_plain(h, w, labels, lse, g):
    """(dh [T,D] in h's dtype, dw [D,V] in w's dtype)."""
    logits = h.float() @ w.float()
    p = torch.exp(logits - lse[:, None])
    p[torch.arange(h.shape[0], device=h.device), labels.long()] -= 1.0
    ds = p * g.float()[:, None]
    return (ds @ w.float().T).to(h.dtype), (h.float().T @ ds).to(w.dtype)


def _check(h, w, labels):
    if h.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {h.device}")
    if w.device != h.device or labels.device != h.device:
        raise ValueError("h, w and labels must lie on one device")
    if h.dtype not in _DTYPE_CODES or w.dtype != h.dtype:
        raise TypeError(f"h and w must share one of float32/bfloat16, got "
                        f"{h.dtype}/{w.dtype}")
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
    lib.softmax_xent_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.softmax_xent_bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    for fn in (lib.softmax_xent_fwd, lib.softmax_xent_bwd,
               lib.softmax_xent_fwd_scratch, lib.softmax_xent_bwd_slab):
        fn.restype = ctypes.c_int
    lib.softmax_xent_fwd_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.softmax_xent_bwd_slab.argtypes = []
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def softmax_xent_fwd(h, w, labels):
    """Launch the CUDA forward (partials, then their merge) on the current
    stream. Returns (loss [T], lse [T]) in f32."""
    _check(h, w, labels)
    t, d = h.shape
    v = w.shape[1]
    lib = _lib()
    part = torch.empty((lib.softmax_xent_fwd_scratch(t, v), t),
                       dtype=torch.float32, device=h.device)
    loss = torch.empty(t, dtype=torch.float32, device=h.device)
    lse = torch.empty(t, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        err = lib.softmax_xent_fwd(_DTYPE_CODES[h.dtype], h.data_ptr(),
                                   w.data_ptr(), labels.data_ptr(),
                                   part.data_ptr(), loss.data_ptr(),
                                   lse.data_ptr(), t, d, v, _stream(h))
    build.check(lib, err, "softmax_xent_fwd")
    softmax_xent_fwd.launches += 1
    return loss, lse


softmax_xent_fwd.launches = 0


def softmax_xent_bwd(h, w, labels, lse, g):
    """Launch the CUDA backward (per vocab slab: ds, dh +=, dw) on the
    current stream. Returns (dh in h's dtype, dw in w's dtype)."""
    _check(h, w, labels)
    t, d = h.shape
    v = w.shape[1]
    for name, x in (("lse", lse), ("g", g)):
        if (x.device != h.device or x.dtype != torch.float32
                or x.shape != (t,) or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 [{t}] on "
                             f"{h.device}")
    lib = _lib()
    ds = torch.empty((t, min(v, lib.softmax_xent_bwd_slab())),
                     dtype=torch.float32, device=h.device)
    dh = torch.empty((t, d), dtype=torch.float32, device=h.device)
    dw = torch.empty_like(w)
    with torch.cuda.device(h.device):
        err = lib.softmax_xent_bwd(_DTYPE_CODES[h.dtype], h.data_ptr(),
                                   w.data_ptr(), labels.data_ptr(),
                                   lse.data_ptr(), g.data_ptr(),
                                   ds.data_ptr(), dh.data_ptr(),
                                   dw.data_ptr(), t, d, v, _stream(h))
    build.check(lib, err, "softmax_xent_bwd")
    softmax_xent_bwd.launches += 1
    return dh.to(h.dtype), dw


softmax_xent_bwd.launches = 0
