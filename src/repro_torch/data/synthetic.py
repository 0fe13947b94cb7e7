"""Synthetic LM data with real learnable structure (copy of the JAX
package's ``data/synthetic.py: SyntheticLM``; the multimodal and
retrieval sets come with the paper-mode slice).

Token streams with induction structure (repeated bigram patterns) so LM
fine-tuning shows a real loss drop. Generation is (seed, index)-
deterministic, so streams are seekable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Token streams with induction structure: [p, a, ..., p, a] so that a
    model that learns in-context copying drops well below unigram loss."""
    vocab_size: int = 256
    seq_len: int = 128
    size: int = 4096
    n_patterns: int = 8
    seed: int = 0

    def sample(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        toks = []
        for i in idx:
            r = np.random.default_rng(
                (self.seed * 2_654_435_761 + int(i)) % (2**63))
            seq = r.integers(0, self.vocab_size, self.seq_len + 1)
            # plant repeated bigrams: whenever trigger t_k appears, the
            # next token is its bound partner
            triggers = r.integers(0, self.vocab_size, self.n_patterns)
            partners = r.integers(0, self.vocab_size, self.n_patterns)
            bind = dict(zip(triggers.tolist(), partners.tolist()))
            for j in range(self.seq_len):
                if int(seq[j]) in bind and r.random() < 0.9:
                    seq[j + 1] = bind[int(seq[j])]
            toks.append(seq)
        arr = np.stack(toks)
        # labels ARE the shifted tokens; the loss fn shifts internally, so
        # hand both the same array
        return {"tokens": arr[:, :-1], "labels": arr[:, :-1],
                "full": arr}

    @property
    def labels(self):
        return np.zeros(self.size, np.int64)     # single-"class" partition
