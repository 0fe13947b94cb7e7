"""Client-head aggregation (paper Sec. 3.3): post-training FedAvg over the
stacked client axis. Counterpart of the JAX package's
``core/aggregation.py``."""
from __future__ import annotations

import torch

from repro_torch import tree


def fedavg_heads(client_params, weights=None):
    """FedAvg the stacked [N, ...] client heads -> single head [...]."""
    def agg(p):
        if weights is None:
            return p.mean(dim=0)
        w = weights.to(p.dtype)
        w = w / w.sum()
        return torch.tensordot(w, p, dims=([0], [0]))
    return tree.map_(agg, client_params)


def select_client_head(client_params, index: int):
    """Personalization: pick client n's head (paper's [F_Cn ; F_S])."""
    return tree.map_(lambda p: p[index], client_params)


def broadcast_head(head, n_clients: int):
    """Re-populate a client bank from one head (elastic join / restart)."""
    return tree.map_(
        lambda p: p[None].expand((n_clients,) + tuple(p.shape)).clone(), head)
