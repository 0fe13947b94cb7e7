"""Mixture-of-Experts FFN (Qwen-MoE family): routed top-k experts with an
optional always-on shared expert, plus a load-balance auxiliary loss.

Counterpart of the JAX package's ``models/moe.py``. Three dispatches,
the same function up to ep's capacity:

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

  * ep     — the JAX package's expert-parallel dispatch under the active
             mesh (``parallel.sharding.use_mesh``). With no mesh, or
             experts not divisible by the model axis, it is ragged, as
             there. With a model axis of 1 (one card) it is the JAX
             ``local`` function on each data shard's tokens: a stable
             sort of the (token, k) slots by expert, each expert's first
             ``cap_e = max(1, int(capacity * T * k / E))`` slots kept and
             the rest dropped (``ep_drop_mask`` says which), three
             grouped products over [E, cap_e] padded rows, a scatter-add
             back to the tokens. Static shapes: no host readback. A model
             axis above 1 is the multi-GPU work of ROADMAP.md.

``routing_tape`` is a check-only tool: a comparison of the kernel path
with the plain path records the kernel path's expert choices and replays
them in the plain path, so that a token whose top-k set flips on float
noise between the two does not make the comparison discontinuous; it
counts those flips. Nothing enters it unless a caller opens one.
"""
from __future__ import annotations

import contextlib
import math

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


def _ep_capacity(t: int, k: int, e: int, capacity: float) -> int:
    return max(1, int(capacity * t * k / e))


def _data_shards(mesh) -> int:
    return math.prod(int(mesh.shape[a]) for a in ("pod", "data")
                     if a in mesh.axis_names)


def _ep_local(params, x, cfg, weights, idx, capacity: float):
    """The JAX ``_apply_ep``'s per-device ``local`` on one (data, model)
    device holding every expert: x [T, D] -> [T, D]."""
    t, d = x.shape
    k = idx.shape[1]
    e = cfg.moe.num_experts
    cap_e = _ep_capacity(t, k, e, capacity)
    act = layers.act_fn(cfg.activation)
    flat_e = idx.reshape(-1)                                 # [T*k]
    order = torch.argsort(flat_e, stable=True)
    # hits per expert, with a static shape (bincount would read its
    # length back to the host)
    gs = torch.zeros(e, dtype=torch.long, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(gs, 0) - gs
    slot = torch.arange(cap_e, device=x.device)
    pos = (starts[:, None] + slot[None, :]).clamp(0, t * k - 1)
    rows = order[pos]                                        # [E, cap_e]
    valid = slot[None, :] < gs.clamp(max=cap_e)[:, None]
    toks = rows // k
    xs = x[toks] * valid[..., None].to(x.dtype)
    h = torch.einsum("ecd,edf->ecf", xs, params["wi"].to(x.dtype))
    if "wg" in params:
        g = torch.einsum("ecd,edf->ecf", xs, params["wg"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    y = torch.einsum("ecf,efd->ecd", h, params["wo"].to(x.dtype))
    wsel = weights.reshape(-1)[rows] * valid.to(weights.dtype)
    y = y * wsel[..., None].to(y.dtype)
    return torch.zeros_like(x).index_add(0, toks.reshape(-1),
                                         y.reshape(-1, d))


def _apply_ep(params, x, cfg, weights, idx, capacity: float = 2.0):
    from repro_torch.parallel import sharding

    mesh = sharding.current_mesh()
    e = cfg.moe.num_experts
    if mesh is None or "model" not in mesh.axis_names \
            or e % int(mesh.shape["model"]) != 0:
        return _apply_ragged(params, x, cfg, weights, idx)
    if int(mesh.shape["model"]) > 1:
        raise NotImplementedError(
            "ep with a model axis above 1 places experts across GPUs: the "
            "multi-GPU work of ROADMAP.md")
    shards = _data_shards(mesh)
    if shards == 1:
        return _ep_local(params, x, cfg, weights, idx, capacity)
    return torch.cat([_ep_local(params, xs, cfg, ws, js, capacity)
                      for xs, ws, js in zip(x.chunk(shards), weights.chunk(
                          shards), idx.chunk(shards))])


def ep_drop_mask(idx, num_experts: int, capacity: float = 2.0,
                 shards: int = 1):
    """[T, k] bool: the (token, k) slots of routing choices idx [T, k]
    that ep drops past capacity over `shards` data shards (each expert
    keeps its first cap_e slots in token order, as the stable sort
    does)."""
    out = []
    for js in idx.chunk(shards):
        t, k = js.shape
        flat = js.reshape(-1)
        order = torch.argsort(flat, stable=True)
        gs = torch.zeros(num_experts, dtype=torch.long,
                         device=js.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        starts = torch.cumsum(gs, 0) - gs
        rank = torch.empty_like(flat)
        rank[order] = torch.arange(flat.numel(), device=js.device) \
            - starts[flat[order]]
        out.append((rank >= _ep_capacity(t, k, num_experts, capacity))
                   .reshape(t, k))
    return torch.cat(out)


def apply_moe(params, x, cfg, impl: str = "ragged", capacity: float = 2.0):
    """x [B, S, D] -> (y [B, S, D], aux f32 scalar); `capacity` is ep's
    per-expert slack."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    weights, idx, aux = _routing(params, xt, cfg)
    if impl == "dense":
        y = _apply_dense(params, xt, cfg, weights, idx)
    elif impl == "ragged":
        y = _apply_ragged(params, xt, cfg, weights, idx)
    elif impl == "ep":
        y = _apply_ep(params, xt, cfg, weights, idx, capacity)
    else:
        raise ValueError(f"unknown moe impl {impl!r} (dense | ragged | ep)")
    if "shared" in params:
        ys = mlp.apply_mlp(params["shared"], xt, cfg.activation)
        gate = torch.sigmoid(xt.float() @ params["shared_gate"].float())
        y = y + ys * gate.to(y.dtype)
    return y.reshape(b, s, d), aux
