"""AdamW over param trees, updated in place.

Counterpart of the JAX package's ``optim/adamw.py``: the same moments
(f32, b2 = 0.95, eps = 1e-8), decoupled weight decay added to the step,
bias correction by the step count, and global-norm clipping with a 1e-9
floor. Where JAX donates the state and aliases its buffers, the port
updates params and both moments in place under ``torch.no_grad()``: the
update of each leaf is written into its gradient's buffer, so no second
copy of params or moments is made (one leaf's temporaries at a time).
The step count and what derives from it stay 0-d tensors on the params'
device, so nothing waits on the host.

Under the SPMD program the params are this rank's shards, so the moments
are too (ZeRO-1, as ``repro/optim/adamw.py`` says: they shard like their
params, and carry the params' specs), and the update is elementwise.
The global norm sums each leaf's local squares weighted by
1 / its replica count (``collectives.replica_weight``) and all-reduces
that over the world, so each shard counts once.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import collectives as C
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import map_


def adamw_init(params):
    def zeros(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        C.set_spec(z, C.spec_of(p))
        return z

    dev = tree_leaves(params)[0].device
    return {"mu": map_(zeros, params), "nu": map_(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0, ok=None):
    """Advance the moments in place and return the updates, written into
    the gradients' buffers (f32). ``ok`` (a 0-d bool tensor, or None for
    always) keeps the moments and the count unchanged where it is false."""
    count = state["count"] + 1
    c = count.float()
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    # a 0-d CPU tensor: it scales a CUDA tensor without a host-device copy
    lr = torch.as_tensor(lr, dtype=torch.float32)
    for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                            tree_leaves(state["nu"]), tree_leaves(params)):
        if g.dtype != torch.float32:
            raise TypeError(f"gradients must be f32, got {g.dtype}")
        if ok is None:                      # the moments' own buffers
            mu_new, nu_new = mu.mul_(b1), nu.mul_(b2)
        else:
            mu_new, nu_new = b1 * mu, b2 * nu
        mu_new.add_((1.0 - b1) * g)
        g2 = g.square()
        nu_new.add_(g2.mul_(1.0 - b2))
        del g2
        denom = (nu_new / bc2).sqrt_().add_(eps)
        step = (mu_new / bc1).div_(denom)
        del denom
        if weight_decay:
            step.add_(weight_decay * p.float())
        step.mul_(-lr)
        if ok is not None:
            mu.copy_(torch.where(ok, mu_new, mu))
            nu.copy_(torch.where(ok, nu_new, nu))
            step = torch.where(ok, step, 0.0)
        del mu_new, nu_new
        g.copy_(step)
    if ok is None:
        state["count"].copy_(count)
    else:
        state["count"].copy_(torch.where(ok, count, state["count"]))
    return grads


@torch.no_grad()
def apply_updates(params, updates, ok=None):
    """params += updates, in place; where ``ok`` is false the params keep
    every bit."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        new = (p.float() + u).to(p.dtype)
        p.copy_(new if ok is None else torch.where(ok, new, p))


def global_norm(tree, params=None):
    """The L2 norm over every leaf of `tree`. Under the SPMD program, with
    `params` (the leaves the gradients belong to, whose specs say how
    they are laid out), the norm of the whole leaves over all ranks."""
    weights = ([C.replica_weight(p) for p in tree_leaves(params)]
               if params is not None and C.active() is not None else None)
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(tree)[0].device)
    for i, g in enumerate(tree_leaves(tree)):
        sq = g.float().square().sum()
        total = total + (sq if weights is None else sq * weights[i])
    if weights is not None:
        total = C.all_reduce(total, C.WORLD)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm, params=None):
    """Scale the gradients in place so their global norm is at most
    `max_norm`. Returns (grads, the norm before clipping). `params`: as
    ``global_norm``'s."""
    norm = global_norm(grads, params)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm
