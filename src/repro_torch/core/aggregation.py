"""Client-head aggregation (paper Sec. 3.3): post-training FedAvg over the
stacked client axis. Counterpart of the JAX package's
``core/aggregation.py``."""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.parallel import collectives as C


def fedavg_heads(client_params, weights=None):
    """FedAvg the stacked [N, ...] client heads -> single head [...].

    Under the SPMD program a leaf whose client dim lies on the client axis
    (``place_state``'s layout) holds this rank's N/d clients, and
    `weights` their entries: the average runs over the GLOBAL client
    axis, the local sum (weighted) all-reduced over it and divided by the
    global count (or the global weights' sum, all-reduced too). The head
    is whole, and the same bits, on every rank. A leaf not cut on the
    client axis (no program, a client axis of 1, N not dividing it) is
    averaged as it is."""
    axis = C.client_axis()

    def agg(p):
        if not C.dim_axes(p, 0) or C.size(axis) == 1:
            if weights is None:
                return p.mean(dim=0)
            w = weights.to(p.dtype)
            w = w / w.sum()
            return torch.tensordot(w, p, dims=([0], [0]))
        if weights is None:
            return C.all_reduce(p.sum(dim=0), axis) / (p.shape[0]
                                                       * C.size(axis))
        w = weights.to(p.dtype)
        part = torch.tensordot(w, p, dims=([0], [0]))
        return C.all_reduce(part, axis) / C.all_reduce(w.sum(), axis)
    return tree.map_(agg, client_params)


def select_client_head(client_params, index: int):
    """Personalization: pick client n's head (paper's [F_Cn ; F_S])."""
    return tree.map_(lambda p: p[index], client_params)


def broadcast_head(head, n_clients: int):
    """Re-populate a client bank from one head (elastic join / restart)."""
    return tree.map_(
        lambda p: p[None].expand((n_clients,) + tuple(p.shape)).clone(), head)
