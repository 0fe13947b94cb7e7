"""Non-IID data partitioning over clients.

The paper splits every dataset with a Dirichlet distribution over classes,
Dir(alpha = 0.1), following Li et al. 2021. We reproduce that exactly:
for each class c, a draw p ~ Dir(alpha * 1_N) apportions class-c samples
among the N clients."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int,
                        alpha: float = 0.1, seed: int = 0,
                        min_per_client: int = 1) -> List[np.ndarray]:
    """Returns a list of index arrays, one per client."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    shards: List[list] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(n_clients, alpha))
        # proportional split with largest-remainder rounding
        counts = np.floor(p * len(idx)).astype(int)
        rem = len(idx) - counts.sum()
        order = np.argsort(-(p * len(idx) - counts))
        counts[order[:rem]] += 1
        start = 0
        for n in range(n_clients):
            shards[n].extend(idx[start:start + counts[n]])
            start += counts[n]
    # guarantee a minimum shard size (steal from the largest shards)
    sizes = np.array([len(s) for s in shards])
    for n in range(n_clients):
        while len(shards[n]) < min_per_client:
            donor = int(np.argmax([len(s) for s in shards]))
            if donor == n or len(shards[donor]) <= min_per_client:
                break
            shards[n].append(shards[donor].pop())
    out = [np.array(sorted(s), dtype=np.int64) for s in shards]
    return out


def partition_stats(shards, labels, n_classes: int):
    """Per-client class histograms (for non-IID-ness reporting)."""
    hist = np.zeros((len(shards), n_classes), np.int64)
    for i, s in enumerate(shards):
        for c in range(n_classes):
            hist[i, c] = int(np.sum(labels[s] == c))
    return hist
