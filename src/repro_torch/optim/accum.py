"""Microbatch gradient accumulation: split the leading batch dim of a
batch tree into `microbatches` slices, run a grad fn over each, sum the
grads in f32 and scale by 1/microbatches.

Counterpart of the JAX package's ``optim/accum.py``, whose ``lax.scan``
becomes a Python loop here. Peak activation memory is that of one
microbatch. (The MPSL step splits each client's local batch instead:
``core.mpsl._grad_agg``.)"""
from __future__ import annotations

import torch

from repro_torch import tree


def accumulate_grads(grad_fn, params, batch, microbatches: int):
    """grad_fn(params, microbatch) -> ((loss, aux), grads). Returns
    ((mean loss, None), mean grads in f32) over the microbatches, or
    grad_fn's own result where microbatches <= 1."""
    if microbatches <= 1:
        return grad_fn(params, batch)

    def split(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} is not divisible into "
                             f"{microbatches} microbatches")
        return x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))

    micro = tree.map_(split, batch)
    acc_g = tree.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
    acc_l = torch.zeros((), dtype=torch.float32)
    for i in range(microbatches):
        (loss, _aux), grads = grad_fn(params, tree.map_(lambda x: x[i], micro))
        acc_g = tree.map_(torch.add, acc_g, grads)
        acc_l = acc_l.to(loss.device) + loss
    scale = 1.0 / microbatches
    return (acc_l * scale, None), tree.map_(lambda g: g * scale, acc_g)
