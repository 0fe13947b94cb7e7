"""Public entry points of the kernels, by device.

Counterpart of the JAX package's ``kernels/ops.py``. A CPU tensor goes to
the kernel's plain PyTorch version; a CUDA tensor goes to the hand-written
kernel, or the call raises. Nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q, k, v, q_pos, k_pos, causal=True, window=0,
                    k_valid=None):
    """q [B,Sq,H,hd], k/v [B,Sk,K,hd] -> [B,Sq,H,hd] (see `_fa`).

    The key-validity mask is resolved once here (None -> all ones). No
    backward kernel exists yet, so on CUDA an input that requires grad
    raises rather than silently dropping its gradient."""
    kv = k_valid if k_valid is not None else torch.ones(
        k_pos.shape, dtype=torch.bool, device=k_pos.device)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, q_pos, k_pos, causal=causal,
                                         window=window, k_valid=kv)[0]
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention on CUDA has no backward kernel "
                           "yet; call it under torch.no_grad()")
    return _fa.flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), q_pos.contiguous(),
        k_pos.contiguous(), causal=causal, window=window,
        k_valid=kv.contiguous())
