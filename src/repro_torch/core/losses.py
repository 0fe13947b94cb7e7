"""Losses: the LM-head cross-entropy without [T, V] f32 logits, the
classification CE, and the ONE-PEACE-style symmetric contrastive loss the
paper uses for retrieval. Counterpart of the JAX package's
``core/losses.py``."""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.parallel import collectives as C


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
    vocab-tiled in both directions.

    Under the SPMD program `w` is this rank's shard: its fsdp dim (D on
    `data`) is gathered at use, and where its V lies on `model` the CE is
    vocab-parallel (``kernels.ops.softmax_xent_vocab_parallel``: the
    kernel, or for 'plain' the plain version, on each rank's V/m
    columns)."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown CE impl {impl!r} (plain | kernel)")
    vocab_parallel = C.model_parallel(w)
    w = C.gather_param(w)
    if vocab_parallel:
        losses = kops.softmax_xent_vocab_parallel(h, w, labels,
                                                  plain=impl == "plain")
    elif impl == "kernel":
        losses = kops.softmax_xent_tokens(h, w, labels)
    elif impl == "plain":
        labels = labels.long()
        parts = [torch.utils.checkpoint.checkpoint(
                     _chunk_xent, h[i:i + chunk], labels[i:i + chunk], w,
                     use_reentrant=False, preserve_rng_state=False)
                 for i in range(0, h.shape[0], chunk)]
        losses = torch.cat(parts)
    if valid is not None:
        losses = losses * valid.float()
    return losses


def softmax_xent(logits, labels):
    """Plain CE for small output spaces (classification heads)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - gold


def _unit(x, norm_dtype):
    n = torch.linalg.vector_norm(x.to(norm_dtype), dim=-1, keepdim=True)
    return x / n.clamp_min(1e-6)


def contrastive_loss(emb_a, emb_b, temperature=0.07):
    """Symmetric InfoNCE over the GLOBAL batch (paper Sec. 4: batch size
    drives modality alignment / feature collapse). emb_* [B, D] ->
    per-sample loss [B] (f32). `temperature` may be a 0-d tensor (the
    retrieval head's learned 1 / exp(logit_scale)).

    Under the SPMD program emb_* are this client rank's samples [B/d, D]
    (whole on every model rank): both are all-gathered over the client
    axis (``collectives.gather_from``: each rank's loss reaches every
    rank's embeddings, so the gradients are reduce-scattered back), and
    the rank returns its samples' losses, its rows a_loc . b_all / t and
    its columns b_loc . a_all / t, each labelled by the sample's global
    index: every other client's samples stand among the negatives, as
    they do in one process."""
    a = _unit(emb_a, torch.float32)
    b = _unit(emb_b, torch.float32)
    axis = C.client_axis()
    n = a.shape[0]
    labels = torch.arange(n, device=a.device)
    if C.size(axis) == 1:
        logits = (a @ b.T) / temperature
        return 0.5 * (softmax_xent(logits, labels)
                      + softmax_xent(logits.T, labels))
    a_all = C.gather_from(a, 0, axis)
    b_all = C.gather_from(b, 0, axis)
    labels = labels + C.index(axis) * n
    return 0.5 * (softmax_xent((a @ b_all.T) / temperature, labels)
                  + softmax_xent((b @ a_all.T) / temperature, labels))


def recall_at_k(emb_a, emb_b, k: int = 1):
    """Retrieval metric: fraction of a->b matches ranked in top-k."""
    a = _unit(emb_a, emb_a.dtype)
    b = _unit(emb_b, emb_b.dtype)
    sims = a @ b.T
    gold = sims.diagonal()[:, None]
    rank = (sims > gold).sum(dim=-1)
    return (rank < k).float().mean()
