"""Mixture-of-Experts FFN (Qwen-MoE family): routed top-k experts with an
optional always-on shared expert, plus a load-balance auxiliary loss.

Counterpart of the JAX package's ``models/moe.py``. Two dispatches, the
same function:

  * dense  — every expert processes every token; the combine weights
             (zero off the top k) scale each expert's activations before
             the down-projection, so no [T, E, D] is formed. E / k times
             the expert FLOPs; the plain path and the oracle.
  * ragged — the T*k (token, choice) slots sorted by expert (a stable
             argsort), the group sizes read to the host once, and per
             non-empty expert three products on its contiguous slice;
             FLOPs of the activated experts only. The default. Where the
             JAX package runs ``jax.lax.ragged_dot`` (an XLA op, no
             Pallas kernel) this runs one cuBLAS GEMM per expert and
             projection. The combine unsorts by the inverse permutation to
             [T, k, D] and adds the k choices in order: no scatter-add,
             whose CUDA atomics would change the bits from run to run.

``impl="ep"`` (expert parallel) comes with the multi-GPU slice.

``routing_tape`` is a check-only tool: a comparison of the kernel path
with the plain path records the kernel path's expert choices and replays
them in the plain path, so that a token whose top-k set flips on float
noise between the two does not make the comparison discontinuous; it
counts those flips. Nothing enters it unless a caller opens one.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models import layers, mlp


def init_moe(generator, cfg, device=None):
    """Leaves and shapes of the JAX package's ``init_moe``: router [D, E],
    wi / wg [E, D, F], wo [E, F, D]; with shared experts, shared.{wi, wg,
    wo} and shared_gate [D, 1]. Each expert's matrices are drawn with
    their own fan-in (D for wi / wg, F for wo); the JAX init scales the
    stacked wi / wg by the expert count instead."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    p = {
        "router": layers.dense_init(generator, (d, e), device=device),
        "wi": layers.dense_init(generator, (e, d, f), in_axis_size=d,
                                device=device),
        "wo": layers.dense_init(generator, (e, f, d), in_axis_size=f,
                                device=device),
    }
    if layers.gated_activation(cfg.activation):
        p["wg"] = layers.dense_init(generator, (e, d, f), in_axis_size=d,
                                    device=device)
    if m.num_shared_experts:
        p["shared"] = mlp.init_mlp(generator, d, m.d_ff_shared,
                                   cfg.activation, device)
        p["shared_gate"] = layers.dense_init(generator, (d, 1),
                                             device=device)
    return p


# ---------------------------------------------------------------------------
# The routing tape (checks only)


class RoutingTape:
    """The expert choices of every ``_routing`` call made while the tape is
    open, in call order. Given the choices of an earlier tape, each call
    uses them instead of its own top k, and counts the tokens whose own
    top-k set differs."""

    def __init__(self, replay=None):
        self.idx = []               # [T, k] per call, as recorded
        self.replay = replay
        self.calls = 0
        self.flips = 0              # a 0-d tensor once a call is replayed
        self.decisions = 0          # tokens routed in replayed calls

    def take(self, probs, idx, weights):
        if self.replay is None:
            self.idx.append(idx.detach().clone())
            return weights, idx
        if self.calls >= len(self.replay):
            raise RuntimeError(f"the routing tape holds {len(self.replay)} "
                               f"calls; call {self.calls + 1} has none")
        rec = self.replay[self.calls].to(idx.device)
        if rec.shape != idx.shape:
            raise RuntimeError(f"routing call {self.calls}: the tape holds "
                               f"{tuple(rec.shape)}, the call routes "
                               f"{tuple(idx.shape)}")
        self.calls += 1
        own, want = idx.sort(dim=-1).values, rec.sort(dim=-1).values
        self.flips = self.flips + (own != want).any(dim=-1).sum()
        self.decisions += idx.shape[0]
        return probs.gather(-1, rec), rec


# The open tape. A module global and not a ContextVar: on CUDA the
# autograd engine runs the backward, and with it the recompute of a
# checkpointed block, on a thread of its own, which must see the tape too.
_TAPE = None


@contextlib.contextmanager
def routing_tape(replay=None):
    """Open a ``RoutingTape``: records each routing call's choices, or,
    with ``replay`` (an earlier tape's ``idx``), replays them. Routing
    calls from any thread use it while it is open."""
    global _TAPE
    tape = RoutingTape(replay)
    prev, _TAPE = _TAPE, tape
    try:
        yield tape
    finally:
        _TAPE = prev


# ---------------------------------------------------------------------------
# Routing and the two dispatches


def _routing(params, x, cfg):
    """x [T, D] -> (weights [T, k] in x's dtype, idx [T, k], aux f32)."""
    m = cfg.moe
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, m.top_k, dim=-1)
    tape = _TAPE
    if tape is not None:
        weights, idx = tape.take(probs, idx, weights)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    # Switch-style load-balance loss; the density carries no gradient
    density = F.one_hot(idx, m.num_experts).sum(dim=1).float().mean(dim=0)
    aux = m.num_experts * (density * probs.mean(dim=0)).sum() \
        * m.router_aux_coef
    return weights.to(x.dtype), idx, aux


def _apply_dense(params, x, cfg, weights, idx):
    """Every expert on every token, weighted by combine [T, E]."""
    m = cfg.moe
    act = layers.act_fn(cfg.activation)
    combine = (F.one_hot(idx, m.num_experts).to(x.dtype)
               * weights[..., None]).sum(dim=1)
    h = torch.einsum("td,edf->tef", x, params["wi"].to(x.dtype))
    if "wg" in params:
        g = torch.einsum("td,edf->tef", x, params["wg"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    # weight the activations BEFORE the down-projection: no [T, E, D]
    h = h * combine[:, :, None]
    return torch.einsum("tef,efd->td", h, params["wo"].to(x.dtype))


def _apply_ragged(params, x, cfg, weights, idx):
    """Slots sorted by expert, one product per expert and projection."""
    t, d = x.shape
    k = idx.shape[1]
    act = layers.act_fn(cfg.activation)
    flat = idx.reshape(-1)                                  # [T*k]
    order = torch.argsort(flat, stable=True)
    # replicate each token k times and permute: a gather by a permutation,
    # whose backward adds one value into each row (the same bits each run)
    xs = x.repeat_interleave(k, dim=0)[order]               # [T*k, D]
    # the dispatch's one host sync: the GEMM shapes come from the routing
    sizes = torch.bincount(flat, minlength=cfg.moe.num_experts).tolist()
    # unbind / split: one backward each (stack / cat), not one per expert
    wi = params["wi"].unbind(0)
    wg = params["wg"].unbind(0) if "wg" in params else None
    wo = params["wo"].unbind(0)
    ys = []
    for e, xe in enumerate(xs.split(sizes)):
        if not sizes[e]:
            continue
        h = xe @ wi[e].to(x.dtype)
        h = act(xe @ wg[e].to(x.dtype)) * h if wg is not None else act(h)
        ys.append(h @ wo[e].to(x.dtype))
    y = torch.cat(ys) * weights.reshape(-1)[order][:, None]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    y = y[inverse].reshape(t, k, d)
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]
    return out


def apply_moe(params, x, cfg, impl: str = "ragged"):
    """x [B, S, D] -> (y [B, S, D], aux f32 scalar)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    weights, idx, aux = _routing(params, xt, cfg)
    if impl == "dense":
        y = _apply_dense(params, xt, cfg, weights, idx)
    elif impl == "ragged":
        y = _apply_ragged(params, xt, cfg, weights, idx)
    elif impl == "ep":
        raise NotImplementedError(
            "expert-parallel dispatch comes with the multi-GPU slice (8) of "
            "the port (ROADMAP.md)")
    else:
        raise ValueError(f"unknown moe impl {impl!r} (dense | ragged)")
    if "shared" in params:
        ys = mlp.apply_mlp(params["shared"], xt, cfg.activation)
        gate = torch.sigmoid(xt.float() @ params["shared_gate"].float())
        y = y + ys * gate.to(y.dtype)
    return y.reshape(b, s, d), aux
