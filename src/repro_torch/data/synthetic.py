"""Synthetic datasets with real learnable structure (a copy of the JAX
package's ``data/synthetic.py``, which is numpy: the same seed and
indices give the same samples bit for bit).

The paper's 7 datasets are not shippable in this container, so each task
family gets a synthetic stand-in whose *difficulty knobs* mirror the
paper's phenomena:

  * SyntheticMultimodal — classification over (vision, text) / (vision,
    audio) / (audio, text) pairs. Each class has a modality-specific
    template; per-sample noise controls how much each modality alone
    suffices (cross-modal information is injected so fusion matters).
  * SyntheticRetrieval — paired embeddings-generating data for contrastive
    image-text retrieval; exhibits feature collapse at small batch sizes.
  * SyntheticLM — token streams with induction structure (repeated
    bigram patterns) so LM fine-tuning shows a real loss drop.

All generation is (seed, index)-deterministic => seekable streams, which
is what makes checkpoint-restart bitwise reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.models import tokenizers as tok


def _raw_shape(spec) -> tuple:
    """Raw array shape for a non-text modality (vision carries RGB)."""
    if spec.name == "vision":
        return tuple(spec.input_shape) + (3,)
    return tuple(spec.input_shape)


@dataclasses.dataclass
class SyntheticMultimodal:
    modalities: Tuple[str, ...] = ("vision", "text")
    n_classes: int = 10
    size: int = 2048
    noise: float = 0.6
    cross_noise: float = 0.3     # prob a modality's template is swapped
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.templates = {}
        for m in self.modalities:
            spec = tok.MODALITIES[m]
            if spec.name == "text":
                self.templates[m] = rng.integers(
                    0, spec.vocab_size, (self.n_classes, spec.input_shape[0]))
            else:
                self.templates[m] = rng.normal(
                    0, 1, (self.n_classes,) + _raw_shape(spec)
                ).astype(np.float32)
        self.labels = rng.integers(0, self.n_classes, self.size)

    def sample(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Deterministic batch for absolute sample indices."""
        out: Dict[str, np.ndarray] = {"labels": self.labels[idx]}
        for m in self.modalities:
            spec = tok.MODALITIES[m]
            xs = []
            for i in idx:
                r = np.random.default_rng(
                    (self.seed * 1_000_003 + int(i)) % (2**63))
                y = int(self.labels[i])
                # occasionally corrupt this modality's class signal so the
                # other modality carries the information (fusion matters)
                y_eff = int(r.integers(0, self.n_classes)) \
                    if r.random() < self.cross_noise else y
                if spec.name == "text":
                    t = self.templates[m][y_eff].copy()
                    n_corrupt = int(len(t) * self.noise)
                    pos = r.choice(len(t), n_corrupt, replace=False)
                    t[pos] = r.integers(0, spec.vocab_size, n_corrupt)
                    xs.append(t)
                else:
                    t = self.templates[m][y_eff]
                    xs.append(t + self.noise
                              * r.normal(0, 1, t.shape).astype(np.float32))
            out[m] = np.stack(xs)
        return out


@dataclasses.dataclass
class SyntheticRetrieval:
    """Paired (vision, text) samples sharing a latent code per pair."""
    size: int = 2048
    n_latents: int = 64
    noise: float = 0.4
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        vspec, tspec = tok.MODALITIES["vision"], tok.MODALITIES["text"]
        self.v_latents = rng.normal(
            0, 1, (self.n_latents,) + _raw_shape(vspec)
        ).astype(np.float32)
        self.t_latents = rng.integers(
            0, tspec.vocab_size, (self.n_latents, tspec.input_shape[0]))
        self.codes = rng.integers(0, self.n_latents, self.size)

    def sample(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        vs, ts = [], []
        tspec = tok.MODALITIES["text"]
        for i in idx:
            r = np.random.default_rng(
                (self.seed * 998_244_353 + int(i)) % (2**63))
            c = int(self.codes[i])
            v = self.v_latents[c]
            vs.append(v + self.noise * r.normal(0, 1, v.shape)
                      .astype(np.float32))
            t = self.t_latents[c].copy()
            n_corrupt = int(len(t) * self.noise * 0.5)
            pos = r.choice(len(t), n_corrupt, replace=False)
            t[pos] = r.integers(0, tspec.vocab_size, n_corrupt)
            ts.append(t)
        return {"vision": np.stack(vs), "text": np.stack(ts),
                "labels": self.codes[idx]}


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
