"""Losses: the LM-head cross-entropy without [T, V] f32 logits, and the
classification CE. Counterpart of the JAX package's ``core/losses.py``
(the contrastive loss and retrieval metric come with the paper-mode
slice)."""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops as kops


def _chunk_xent(hx, lx, w):
    logits = (hx @ w.to(hx.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, lx[:, None])[:, 0]
    return lse - gold


def chunked_softmax_xent(h, w, labels, valid=None, chunk: int = 512,
                         impl: str = "plain"):
    """Per-token CE without materializing full [T, V] f32 logits.

    h [T, D], w [D, V], labels [T] -> per-token loss [T] (f32).

    impl='plain' (the oracle): `chunk`-token slices under checkpointing,
    so the backward recomputes each chunk's logits instead of saving them.
    impl='kernel': the fused online-softmax kernels (``kernels.ops``),
    vocab-tiled in both directions."""
    if impl == "kernel":
        losses = kops.softmax_xent_tokens(h, w, labels)
    elif impl == "plain":
        labels = labels.long()
        parts = [torch.utils.checkpoint.checkpoint(
                     _chunk_xent, h[i:i + chunk], labels[i:i + chunk], w,
                     use_reentrant=False, preserve_rng_state=False)
                 for i in range(0, h.shape[0], chunk)]
        losses = torch.cat(parts)
    else:
        raise ValueError(f"unknown CE impl {impl!r} (plain | kernel)")
    if valid is not None:
        losses = losses * valid.float()
    return losses


def softmax_xent(logits, labels):
    """Plain CE for small output spaces (classification heads)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - gold
