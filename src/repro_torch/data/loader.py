"""Client-sharded, step-indexed loader (copy of the JAX package's
``data/loader.py: ClientLoader``).

Produces MPSL batches {modality: [N, Bn, ...], labels, mask} for a given
global step. Sampling within each client's Dirichlet shard is a pure
function of (seed, step): a restarted job at step k sees exactly the
batch the failed job would have seen.

Elastic participation: after the static Bernoulli dropout mask is drawn,
the ambient fault injector (``repro_torch.faults``) applies RUNTIME
straggler cutoffs, client drops, and batch poisoning for the step; with
no plan active the hook is a no-op and the batches are the JAX loader's
bit for bit (under a plan too, the same plan giving the same batch). The
final per-step participation is reported to ``obs.comm`` so link
accounting can weight per-step wire bytes by who actually transmitted.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch import faults
from repro_torch.obs import comm as obs_comm


class ClientLoader:
    def __init__(self, dataset, shards: List[np.ndarray], batch_per_client:
                 int, seed: int = 0, drop_prob: float = 0.0):
        self.dataset = dataset
        self.shards = shards
        self.bn = batch_per_client
        self.seed = seed
        self.drop_prob = drop_prob      # simulated client dropout/stragglers
        self.n_clients = len(shards)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        # one batched RNG draw for all clients, one dataset gather over the
        # concatenated indices; a pure function of (seed, step)
        r = np.random.default_rng((self.seed, step, 0xC1EA7))
        u = r.random((self.n_clients, self.bn))
        idx = np.concatenate([
            shard[(u[n] * len(shard)).astype(np.int64)]
            for n, shard in enumerate(self.shards)])
        flat = self.dataset.sample(idx)
        out: Dict[str, np.ndarray] = {
            k: v.reshape((self.n_clients, self.bn) + v.shape[1:])
            for k, v in flat.items()}
        rmask = np.random.default_rng((self.seed, step, 0xD0D0))
        mask = (rmask.random(self.n_clients) >= self.drop_prob)
        if not mask.any():
            mask[int(rmask.integers(0, self.n_clients))] = True
        out["mask"] = mask.astype(np.float32)
        out = faults.get().batch_hook(step, out)
        m = np.asarray(out["mask"])
        # a NaN-poisoned client counts as non-participating on the wire
        obs_comm.note_participation(
            step, float(m[np.isfinite(m)].sum()), int(m.shape[0]))
        return out
