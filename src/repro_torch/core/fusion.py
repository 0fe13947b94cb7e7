"""Modality fusion (paper Sec. 3.2). Counterpart of the JAX package's
``core/fusion.py``.

  early — tokenized modalities are concatenated CLIENT-side into one joint
          sequence; the server encodes the joint vector once.
  late  — each modality is encoded independently by the server body; the
          cls tokens (vision/audio) / pooled text are concatenated after.

Either way a global-average-pool over the fused representation feeds the
task head (paper Eq. 3)."""
from __future__ import annotations

from typing import Dict

import torch


def fuse_early(tokenized: Dict[str, torch.Tensor]) -> torch.Tensor:
    """{modality: [..., T_m, D]} -> [..., sum(T_m), D] (client-side concat),
    modalities in sorted order (text before vision).

    Works on both the plain [B, T, D] and the stacked client [N, Bn, T, D]
    layouts (token axis is -2)."""
    return torch.cat([tokenized[m] for m in sorted(tokenized)], dim=-2)


def summarize_modality(name: str, encoded: torch.Tensor) -> torch.Tensor:
    """Per-modality summary after the encoder (late fusion): cls token for
    vision/audio (prepended by the tokenizer), mean-pool for text."""
    if name == "text":
        return encoded.mean(dim=-2, keepdim=True)
    return encoded[..., :1, :]


def fuse_late(encoded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """{modality: [B, T_m, D]} (post-encoder) -> [B, M, D]."""
    return torch.cat([summarize_modality(m, encoded[m])
                      for m in sorted(encoded)], dim=-2)


def gap(fused: torch.Tensor) -> torch.Tensor:
    """Global average pooling -> the final multimodal embedding [B, D]."""
    return fused.mean(dim=-2)
