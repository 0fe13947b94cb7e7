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

  * ep     — the JAX package's expert-parallel dispatch: tokens stay on
             their data shard, experts lie on the model axis (E / m a
             device), each device keeps an expert's first ``cap_e =
             max(1, int(capacity * T_loc * k / E))`` slots in token order
             (a stable sort; ``ep_drop_mask`` says which are dropped),
             runs three grouped products over [E/m, cap_e] padded rows
             and scatter-adds back, and the partials add over `model`.
             Static shapes: no host readback. Under the SPMD program
             (``parallel.collectives``) each rank is one such device;
             with only the mesh record of ``parallel.sharding.use_mesh``
             one process computes every device's share and adds them.
             With no mesh, or experts that do not divide the model axis,
             it is ragged, as in the JAX package.

Under the SPMD program the router and the load-balance loss are computed
on every model rank from the same tokens (the loss's means over every
data rank's tokens); the routed experts and the shared expert are a
model-parallel region (``_moe_program``), the experts on `model` (E/m a
rank) where m divides E, else each expert's F (qwen2-moe's 60 experts
on a model axis of 8 or 16). Every dispatch runs in both layouts; ep,
where the experts do not divide the axis, as ragged.

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
from repro_torch.parallel import collectives as C


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
    top-k set differs. Each ep ``local`` call (``_ep_local``) adds the
    (token, k) slots it dropped past capacity among its own experts'
    (``drops``); each ragged call over a rank's share of the experts the
    slots routed to them (``hits``: over the model ranks, each slot is
    one rank's)."""

    def __init__(self, replay=None):
        self.idx = []               # [T, k] per call, as recorded
        self.drops = []             # [T, k] bool per ep ``local`` call
        self.hits = []              # [T, k] bool per ragged call on a share
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
    """x [T, D] -> (weights [T, k] in x's dtype, idx [T, k], aux f32).

    Under the SPMD program with a client axis (``collectives.
    client_axis``: `data`, or (pod, data)) the load-balance loss takes
    its two means over every client rank's tokens (sums all-reduced over
    it, the probabilities' by ``reduce_from``: each rank's tokens then get
    their own gradient of it), as the JAX package's over the global
    batch."""
    m = cfg.moe
    logits = x.float() @ C.gather_param(params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, m.top_k, dim=-1)
    tape = _TAPE
    if tape is not None:
        weights, idx = tape.take(probs, idx, weights)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    # Switch-style load-balance loss; the density carries no gradient
    hits = F.one_hot(idx, m.num_experts).sum(dim=1).float()
    axis = C.client_axis()
    if C.size(axis) > 1:
        t = x.shape[0] * C.size(axis)
        density = C.all_reduce(hits.sum(dim=0), axis) / t
        mean_p = C.reduce_from(probs.sum(dim=0), axis) / t
    else:
        density, mean_p = hits.mean(dim=0), probs.mean(dim=0)
    aux = m.num_experts * (density * mean_p).sum() * m.router_aux_coef
    return weights.to(x.dtype), idx, aux


def _apply_dense(params, x, cfg, weights, idx, eid0: int = 0):
    """Every expert on every token, weighted by combine [T, E]; with
    `eid0`, the experts eid0 .. of ``params`` only (this rank's share:
    the other experts' combine columns dropped)."""
    m = cfg.moe
    act = layers.act_fn(cfg.activation)
    combine = (F.one_hot(idx, m.num_experts).to(x.dtype)
               * weights[..., None]).sum(dim=1)
    e_loc = params["wi"].shape[0]
    if e_loc != m.num_experts:
        combine = combine[:, eid0:eid0 + e_loc]
    h = torch.einsum("td,edf->tef", x, params["wi"].to(x.dtype))
    if "wg" in params:
        g = torch.einsum("td,edf->tef", x, params["wg"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    # weight the activations BEFORE the down-projection: no [T, E, D]
    h = h * combine[:, :, None]
    return torch.einsum("tef,efd->td", h, params["wo"].to(x.dtype))


def _apply_ragged(params, x, cfg, weights, idx, eid0: int = 0):
    """Slots sorted by expert, one product per expert and projection.

    With `eid0` and fewer experts in ``params`` than the config routes to
    (this rank's E/m under the SPMD program), the slots routed to experts
    eid0 .. eid0 + e_loc - 1 only: the others sort last and contribute
    zeros (no capacity, so nothing is dropped). Weights whose F is this
    rank's part give this rank's partial sums."""
    t, d = x.shape
    k = idx.shape[1]
    act = layers.act_fn(cfg.activation)
    e_loc = params["wi"].shape[0]
    flat = idx.reshape(-1)                                  # [T*k]
    if e_loc != cfg.moe.num_experts:
        # ``_ep_local``'s hit mask: another rank's experts sort last
        local = flat - eid0
        hit = (local >= 0) & (local < e_loc)
        flat = torch.where(hit, local, e_loc)
        tape = _TAPE
        if tape is not None:
            tape.hits.append(hit.reshape(t, k))
    order = torch.argsort(flat, stable=True)
    # the dispatch's one host sync: the GEMM shapes come from the routing
    sizes = torch.bincount(flat, minlength=e_loc).tolist()
    n_hit = sum(sizes[:e_loc])
    rows = order if n_hit == t * k else order[:n_hit]
    # replicate each token k times and permute: a gather by a permutation,
    # whose backward adds one value into each row (the same bits each run)
    xs = x.repeat_interleave(k, dim=0)[rows]                # [hits, D]
    # unbind / split: one backward each (stack / cat), not one per expert
    wi = params["wi"].unbind(0)
    wg = params["wg"].unbind(0) if "wg" in params else None
    wo = params["wo"].unbind(0)
    ys = []
    for e, xe in enumerate(xs.split(sizes[:e_loc])):
        # with no hit at all, expert 0 over the empty slice: the weights
        # stay in the graph, so their gradients' collectives run on every
        # rank
        if not sizes[e] and (e or n_hit):
            continue
        h = xe @ wi[e].to(x.dtype)
        h = act(xe @ wg[e].to(x.dtype)) * h if wg is not None else act(h)
        ys.append(h @ wo[e].to(x.dtype))
    y = torch.cat(ys) * weights.reshape(-1)[rows][:, None]
    if n_hit != t * k:
        y = torch.cat([y, y.new_zeros(t * k - n_hit, d)])
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


def _ep_local(x, cfg, weights, idx, capacity: float, wi, wg, wo,
              eid0: int = 0):
    """The JAX ``_apply_ep``'s per-device ``local``: the (token, k) slots
    of x [T, D] routed to the experts eid0 .. eid0 + e_loc - 1, whose
    weights wi / wg [e_loc, D, F] and wo [e_loc, F, D] are given; each
    expert keeps its first ``cap_e`` slots (cap_e from the global expert
    count), the rest are dropped. Returns this device's partial [T, D]
    (the sum over the model axis of every device's is the layer's)."""
    t, d = x.shape
    k = idx.shape[1]
    e = cfg.moe.num_experts
    e_loc = wi.shape[0]
    cap_e = _ep_capacity(t, k, e, capacity)
    act = layers.act_fn(cfg.activation)
    local_e = idx.reshape(-1) - eid0                         # [T*k]
    hit = (local_e >= 0) & (local_e < e_loc)
    key = torch.where(hit, local_e, e_loc)                   # misses last
    order = torch.argsort(key, stable=True)
    # hits per expert, with a static shape (bincount would read its
    # length back to the host)
    gs = torch.zeros(e_loc + 1, dtype=torch.long,
                     device=x.device).scatter_add_(
        0, key, torch.ones_like(key))[:e_loc]
    starts = torch.cumsum(gs, 0) - gs
    slot = torch.arange(cap_e, device=x.device)
    pos = (starts[:, None] + slot[None, :]).clamp(0, t * k - 1)
    rows = order[pos]                                        # [e_loc, cap_e]
    valid = slot[None, :] < gs.clamp(max=cap_e)[:, None]
    toks = rows // k
    xs = x[toks] * valid[..., None].to(x.dtype)
    h = torch.einsum("ecd,edf->ecf", xs, wi.to(x.dtype))
    if wg is not None:
        g = torch.einsum("ecd,edf->ecf", xs, wg.to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    y = torch.einsum("ecf,efd->ecd", h, wo.to(x.dtype))
    wsel = weights.reshape(-1)[rows] * valid.to(weights.dtype)
    y = y * wsel[..., None].to(y.dtype)
    tape = _TAPE
    if tape is not None:
        kept = torch.zeros(t * k, dtype=torch.bool, device=x.device)
        kept[rows[valid]] = True
        tape.drops.append((hit & ~kept).reshape(t, k))
    return torch.zeros_like(x).index_add(0, toks.reshape(-1),
                                         y.reshape(-1, d))


def _apply_ep(params, x, cfg, weights, idx, capacity: float = 2.0):
    """The JAX package's expert-parallel dispatch: tokens stay on their
    data shard, experts lie on the model axis, each device runs ``local``
    over its experts' slots and the partial sums add over `model`.

    Under the SPMD program x is this rank's tokens and wi / wg / wo its
    experts (``_moe_program``). Otherwise the mesh record of
    ``sharding.use_mesh`` says the layout, and one process computes what
    its devices would: each data shard's tokens, each model shard's
    experts, the partials summed. With no mesh, or experts that do not
    divide the model axis, it is ragged, as in the JAX package."""
    from repro_torch.parallel import sharding

    mesh = sharding.current_mesh()
    e = cfg.moe.num_experts
    if mesh is None or "model" not in mesh.axis_names \
            or e % int(mesh.shape["model"]) != 0:
        return _apply_ragged(params, x, cfg, weights, idx)
    m = int(mesh.shape["model"])
    e_loc = e // m
    wg = params.get("wg")

    def experts(xs, ws, js):
        out = None
        for r in range(m):
            sl = slice(r * e_loc, (r + 1) * e_loc)
            y = _ep_local(xs, cfg, ws, js, capacity, params["wi"][sl],
                          None if wg is None else wg[sl], params["wo"][sl],
                          eid0=r * e_loc)
            out = y if out is None else out + y
        return out

    shards = _data_shards(mesh)
    if shards == 1:
        return experts(x, weights, idx)
    return torch.cat([experts(xs, ws, js) for xs, ws, js in zip(
        x.chunk(shards), weights.chunk(shards), idx.chunk(shards))])


def _moe_program(params, xt, cfg, weights, idx, impl, capacity):
    """The routed experts under the SPMD program: this rank's tokens
    (`data`) and its share of the experts (`model`), their fsdp dim
    gathered; the tokens and the combine weights enter the model-parallel
    region by ``copy_to``, the partial sums leave by ``reduce_from``
    (``apply_moe``). Two layouts, as the rule table gives them:

      * experts on `model` (E/m a rank, where m divides E): ep runs the
        JAX ``local`` (capacity from the global E); ragged this rank's
        experts' slots, a GEMM per non-empty local expert, no capacity;
        dense every local expert on every token;
      * each expert's F on `model` (wi / wg [E, D, F/m], wo [E, F/m, D],
        where m does not divide E): every expert a column- and
        row-parallel MLP; dense and ragged over the local F columns (the
        tokens and router are replicated over `model`, so every model
        rank sorts the same slots and reads the same group sizes); ep
        runs as ragged, as the JAX ``_apply_ep`` does where E % m != 0."""
    tp = C.model_parallel(params["wi"])
    local = {k: C.gather_param(params[k]) for k in ("wi", "wg", "wo")
             if k in params}
    eid0 = 0
    if tp:
        xt, weights = C.copy_to(xt, "model"), C.copy_to(weights, "model")
        if C.spec_of(params["wi"])[0] == "model":       # experts on `model`
            eid0 = C.index("model") * local["wi"].shape[0]
        elif impl == "ep":                              # F on `model`
            impl = "ragged"
    if impl == "dense":
        return _apply_dense(local, xt, cfg, weights, idx, eid0=eid0)
    if impl == "ragged":
        return _apply_ragged(local, xt, cfg, weights, idx, eid0=eid0)
    return _ep_local(xt, cfg, weights, idx, capacity, local["wi"],
                     local.get("wg"), local["wo"], eid0)


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
    if impl not in ("dense", "ragged", "ep"):
        raise ValueError(f"unknown moe impl {impl!r} (dense | ragged | ep)")
    if C.active() is not None:
        y = _moe_program(params, xt, cfg, weights, idx, impl, capacity)
    elif impl == "dense":
        y = _apply_dense(params, xt, cfg, weights, idx)
    elif impl == "ragged":
        y = _apply_ragged(params, xt, cfg, weights, idx)
    else:
        y = _apply_ep(params, xt, cfg, weights, idx, capacity)
    tp = C.model_parallel(params["wi"])
    if "shared" in params:
        # the shared expert's partial sums join the routed experts' before
        # the one reduction; its gate, computed outside the region, enters
        # it by copy_to
        ys = mlp.apply_mlp(params["shared"], xt, cfg.activation,
                           reduce=not tp)
        gate = torch.sigmoid(
            xt.float() @ C.gather_param(params["shared_gate"]).float())
        if tp and C.model_parallel(params["shared"]["wi"]):
            gate = C.copy_to(gate, "model")
        elif tp:
            raise NotImplementedError(
                "a shared expert replicated beside experts on the model "
                "axis: ROADMAP.md Queue 1 item 7")
        y = y + ys * gate.to(y.dtype)
    if tp:
        y = C.reduce_from(y, "model")
    return y.reshape(b, s, d), aux
