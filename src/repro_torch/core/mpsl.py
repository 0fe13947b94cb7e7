"""MPSL train step — the paper's technique, for the LM family.

Counterpart of the JAX package's ``core/mpsl.py`` (``make_lm_loss``,
``make_train_step``). One step realizes the client/server exchange:

  1. client forward  — per-client adapters (stacked [N, ...] params) on a
     frozen embedding make the smashed data a_n;
  2. uplink          — the clients' activations become the server's global
     batch (int8-compressed when enabled);
  3. server forward  — ONE pass over the concatenated global batch (frozen
     prefix + trainable suffix);
  4. tail + losses   — back in client layout, each client's loss against
     its own labels; L_S = sum_n w_n L_n with w_n = |B_n|/|B| over the
     participating clients;
  5. single backward — the gradient of L_S IS the paper's one aggregated
     backward pass; cut-layer gradients reach each client's adapter
     through it (int8-compressed when enabled).

``backward_mode='per_client'`` is the vanilla-PSL baseline: N backward
passes, one per client, summed with the same weights.

Randomness. JAX threads a key; here a step's ``rng`` is an int derived
from the state's seed and the step, and the loss draws the links'
stochastic rounding from generators seeded by it, so the same rng gives
the same draws (as the same key does). A test may pass instead a dict
``{"uplink": u, "downlink": u}`` of uniforms to use as given.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import compression, losses, split
from repro_torch.models import layers, model as M
from repro_torch.optim import (adamw_init, adamw_update, apply_updates,
                               clip_by_global_norm)

DEFAULT_IMPLS = {"attn": "kernel", "ce": "kernel", "ssm": "kernel"}


# ---------------------------------------------------------------------------
# Shared pieces


def _client_weights(mask, n):
    """w_n = |B_n| / |B| over participating clients (uniform B_n here)."""
    m = mask.float()
    return m / torch.clamp(m.sum(), min=1.0)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data): splitmix64 of their mix."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) % 2 ** 64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2 ** 64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2 ** 64
    return (z ^ (z >> 31)) >> 1


def _link_rng(rng, link: str, index: int, device):
    if isinstance(rng, dict):
        return rng[link]
    return torch.Generator(device=device).manual_seed(fold_in(rng, index))


def len_from_params(tree_) -> int:
    return sum(len(sp) for sp in tree_["segments"])


def _run_body(frozen, server, cfg, h, positions, impls, remat):
    """Frozen prefix + trainable suffix, then final norm."""
    fsegs, tsegs = split.split_segments(M.body_segments(cfg),
                                        len_from_params(frozen))
    for sp, seg in zip(frozen["segments"], fsegs):
        h, _ = M.apply_segment(sp, h, cfg, seg, positions=positions,
                               impls=impls, remat=remat)
    for sp, seg in zip(server["segments"], tsegs):
        h, _ = M.apply_segment(sp, h, cfg, seg, positions=positions,
                               impls=impls, remat=remat)
    return layers.apply_norm(h, server["final_norm"], cfg.norm)


# ---------------------------------------------------------------------------
# LM-family MPSL loss


def make_lm_loss(cfg, run, impls=None):
    """Returns loss_fn(trainable, frozen, batch, rng) -> (L_S, metrics).

    batch: tokens [N, Bn, S], labels [N, Bn, S] (int), mask [N] (f32).
    impls: {"attn": "kernel" | "naive", "ce": "kernel" | "plain", "ssm":
    "kernel" | "plain", "ssm_chunk": int, "ssm_bwd": "fused" |
    "recompute"}; the kernels by default, the chunk and the scan's
    backward from ``run``."""
    if cfg.family not in M.PORTED_FAMILIES or cfg.encoder_layers:
        raise NotImplementedError(
            f"the {cfg.family} family comes with a later slice of the port "
            f"(ROADMAP.md)")
    mpsl = run.mpsl
    cdt = getattr(torch, run.compute_dtype)
    impls = {**DEFAULT_IMPLS, "ssm_chunk": run.ssm_chunk,
             "ssm_bwd": run.ssm_bwd_impl, **(impls or {})}
    remat = run.remat != "none"

    def loss_fn(trainable, frozen, batch, rng):
        if "patch_embeds" in batch or "frame_embeds" in batch:
            raise NotImplementedError(
                "VLM and audio inputs come with the enc-dec / VLM slice of "
                "the port (ROADMAP.md)")
        tokens = batch["tokens"]
        n, bn, s = tokens.shape
        dev = tokens.device

        # ---- 1. client forward: frozen tokenizer + per-client adapter ----
        h = frozen["embed"]["table"][tokens].to(cdt)           # [N,Bn,S,D]
        if cfg.pos_embed == "learned":
            h = h + frozen["embed"]["pos"][:s].to(cdt)
        h = split.apply_client_adapter(trainable["client"]["adapter"], h)

        # ---- 2. uplink (smashed data) ----
        if mpsl.compress_uplink:
            h = compression.compress_activations(
                h, _link_rng(rng, "uplink", 1, dev))
        if mpsl.compress_downlink:
            h = compression.compress_gradients(
                h, _link_rng(rng, "downlink", 2, dev))
        hb = h.reshape(n * bn, s, cfg.d_model)
        positions = layers.positions_from_shape(n * bn, s, device=dev)

        # ---- 3. server forward: ONE pass over the global batch ----
        hb = _run_body(frozen, trainable["server"], cfg, hb, positions,
                       impls, remat)

        # ---- 4. tail in CLIENT layout: labels never leave their client ----
        hc = hb.reshape(n, bn, s, cfg.d_model)
        flat_h = hc[:, :, :-1, :].reshape(-1, cfg.d_model)
        flat_l = batch["labels"][:, :, 1:].reshape(-1)
        w_tail = (trainable["server"]["lm_head"]
                  if "lm_head" in trainable["server"]
                  else frozen["embed"]["table"].T)
        per_tok = losses.chunked_softmax_xent(flat_h, w_tail, flat_l,
                                              chunk=run.ce_chunk,
                                              impl=impls["ce"])
        per_client = per_tok.reshape(n, -1).mean(dim=1)        # L_n

        # ---- 5. aggregated loss => single backward pass ----
        w = _client_weights(batch["mask"], n)
        l_s = (w * per_client).sum()
        metrics = {"loss": l_s.detach(), "per_client": per_client.detach(),
                   "aux": torch.zeros((), device=dev),
                   "participating": batch["mask"].sum()}
        return l_s, metrics

    return loss_fn


# ---------------------------------------------------------------------------
# Train step


def value_and_grad(loss_fn, params, frozen, batch, rng):
    """(loss, metrics, gradients of the loss w.r.t. `params` leaves, in
    ``tree.leaves`` order); the params must require grad."""
    leaves = tree.leaves(params)
    loss, metrics = loss_fn(params, frozen, batch, rng)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, grads


def _split_microbatches(batch, mu: int):
    """[N, Bn, ...] client batches -> mu batches of [N, Bn/mu, ...]: each
    client's LOCAL minibatch is split (the client axis is kept)."""
    out = []
    for j in range(mu):
        mb = {}
        for k, x in batch.items():
            if k == "mask":
                mb[k] = x
                continue
            bn = x.shape[1]
            if bn % mu:
                raise ValueError(f"{k}: {bn} per client is not divisible "
                                 f"into {mu} microbatches")
            mb[k] = x[:, j * (bn // mu):(j + 1) * (bn // mu)]
        out.append(mb)
    return out


def _grad_agg(loss_fn, params, frozen, batch, rng, microbatches):
    if microbatches <= 1:
        return value_and_grad(loss_fn, params, frozen, batch, rng)
    g_acc, l_acc, mets = None, 0.0, []
    for mb in _split_microbatches(batch, microbatches):
        loss, met, g = value_and_grad(loss_fn, params, frozen, mb, rng)
        g_acc = list(g) if g_acc is None else [a + b for a, b in zip(g_acc, g)]
        l_acc = l_acc + loss
        mets.append(met)
        del g
    inv = 1.0 / microbatches
    metrics = {k: torch.stack([m[k] for m in mets]).mean(dim=0)
               for k in mets[0]}
    return l_acc * inv, metrics, [g * inv for g in g_acc]


def _per_client_grads(loss_fn, params, frozen, batch, rng):
    """Vanilla PSL: one backward per client, combined with the same global
    weights w_n the aggregated mode uses."""
    mask = batch["mask"]
    n = mask.shape[0]
    w = _client_weights(mask, n)
    grads, ls = None, []
    for i in range(n):
        m = torch.zeros_like(mask)
        m[i] = mask[i]
        l, _, g = value_and_grad(loss_fn, params, frozen,
                                  dict(batch, mask=m), rng)
        g = [x * w[i] for x in g]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        ls.append(l)
    ls = torch.stack(ls)
    loss = (w * ls).sum()
    return grads, loss, {"loss": loss, "per_client": ls,
                         "aux": torch.zeros((), device=loss.device),
                         "participating": mask.sum()}


def make_train_step(loss_fn, run, sched, backward_mode: str = "aggregated",
                    microbatches: int = 1, guard_nonfinite: bool = False):
    """One MPSL optimization step (client + server updates):
    ``step(state, batch) -> (state, metrics)``, updating the state's params
    and AdamW moments in place.

    aggregated  — the paper's single backward pass over L_S.
    per_client  — vanilla-PSL baseline: N separate backward passes,
                  summed (same gradients by linearity, N times the cost).

    guard_nonfinite — when the aggregated loss or the grad norm is not
    finite, params and both Adam moments (and its count) keep every bit,
    decided on the device with no host readback; the step counter still
    advances and ``metrics["skipped"]`` carries the flag."""
    if backward_mode not in ("aggregated", "per_client"):
        raise ValueError(f"unknown backward mode {backward_mode!r}")

    def step(state, batch):
        rng = fold_in(state["rng"], state["step"])
        params = state["params"]
        if backward_mode == "aggregated":
            loss, metrics, grads = _grad_agg(loss_fn, params, state["frozen"],
                                             batch, rng, microbatches)
        else:
            grads, loss, metrics = _per_client_grads(
                loss_fn, params, state["frozen"], batch, rng)
        grads = list(grads)
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        lr = sched(state["step"])
        ok = None
        if guard_nonfinite:
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        updates = adamw_update(grads, state["opt"], tree.leaves(params),
                               lr=lr, weight_decay=run.weight_decay, ok=ok)
        apply_updates(tree.leaves(params), updates, ok=ok)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        if guard_nonfinite:
            okf = ok.float()
            metrics["skipped"] = 1.0 - okf
            p = metrics["participating"]
            metrics["participating"] = torch.where(torch.isfinite(p), p,
                                                   0.0) * okf
        state["step"] += 1
        return state, metrics

    return step


def init_state(params, frozen, seed: int = 0):
    """The train state: trainable params (made leaves that require grad),
    the frozen tree, AdamW's moments, the step counter and the seed."""
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return {"params": params, "frozen": frozen, "opt": adamw_init(params),
            "step": 0, "rng": int(seed)}
