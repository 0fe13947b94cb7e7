"""MPSL train step — the paper's technique, for the LM family and the
paper's own Meta-Transformer (ViT) setup.

Counterpart of the JAX package's ``core/mpsl.py`` (``make_lm_loss``,
``make_vit_loss``, ``make_train_step``). One step realizes the
client/server exchange:

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
``{"uplink": u, "downlink": u}`` of uniforms to use as given; the ViT
loss, whose late-fusion and retrieval paths send one link a modality,
takes one such dict a link name (``{"joint": {...}}`` under early
fusion, else ``{"vision": {...}, "text": {...}, ...}``).
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import compression, fusion, losses, split
from repro_torch.models import layers, model as M, tokenizers as tok
from repro_torch.optim import (adamw_init, adamw_update, apply_updates,
                               clip_by_global_norm)

DEFAULT_IMPLS = {"attn": "kernel", "ce": "kernel", "ssm": "kernel",
                 "moe": "ragged"}


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
    """Frozen prefix + trainable suffix, then final norm. Returns (h, the
    router's aux loss summed over both)."""
    fsegs, tsegs = split.split_segments(M.body_segments(cfg),
                                        len_from_params(frozen))
    aux = 0.0
    for sp, seg in ([*zip(frozen["segments"], fsegs)]
                    + [*zip(server["segments"], tsegs)]):
        h, _, a = M.apply_segment(sp, h, cfg, seg, positions=positions,
                                  impls=impls, remat=remat)
        aux = aux + a
    return layers.apply_norm(h, server["final_norm"], cfg.norm), aux


# ---------------------------------------------------------------------------
# LM-family MPSL loss


def make_lm_loss(cfg, run, impls=None):
    """Returns loss_fn(trainable, frozen, batch, rng) -> (L_S, metrics).

    batch: tokens [N, Bn, S], labels [N, Bn, S] (int), mask [N] (f32).
    impls: {"attn": "kernel" | "naive", "ce": "kernel" | "plain", "ssm":
    "kernel" | "plain", "ssm_chunk": int, "ssm_bwd": "fused" |
    "recompute", "moe": "ragged" | "dense"}; the kernels and the ragged
    dispatch by default, the chunk and the scan's backward from ``run``.

    L_S = sum_n w_n L_n + aux, the router's load-balance loss of the MoE
    blocks, as in the JAX package. aux is taken over every client's tokens
    and added after the client weights, so with ``router_aux_coef > 0`` a
    client with mask 0 still gets an adapter gradient, and one client's
    tokens move another's gradient through the expert density."""
    if cfg.family == "vit":
        raise ValueError("the vit family trains through make_vit_loss")
    if cfg.family not in M.LM_FAMILIES or cfg.encoder_layers:
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
        hb, aux = _run_body(frozen, trainable["server"], cfg, hb, positions,
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
        l_s = (w * per_client).sum() + aux
        metrics = {"loss": l_s.detach(), "per_client": per_client.detach(),
                   "aux": (aux.detach() if torch.is_tensor(aux)
                           else torch.zeros((), device=dev)),
                   "participating": batch["mask"].sum()}
        return l_s, metrics

    return loss_fn


# ---------------------------------------------------------------------------
# Paper-mode (ViT / Meta-Transformer) MPSL loss


def _vit_link_rng(rng, link: str, direction: str, device):
    """A link's stochastic rounding. Every link draws from the same two
    streams, seeded from fold_in(rng, 2), as the JAX package's loss splits
    one (r_up, r_down) from fold_in(rng, 2) for all of them; a dict gives
    each link its own uniforms."""
    if isinstance(rng, dict):
        return rng[link][direction]
    seed = fold_in(fold_in(rng, 2), 1 if direction == "uplink" else 2)
    return torch.Generator(device=device).manual_seed(seed)


def make_vit_loss(cfg, run, modalities=("vision", "text"),
                  task: str = "classification", n_classes: int = 10,
                  impls=None):
    """Returns loss_fn(trainable, frozen, batch, rng) -> (L_S, metrics).

    batch: one raw input a modality ({vision: [N, Bn, 224, 224, 3], text:
    [N, Bn, 77] ids, audio: [N, Bn, 1024, 128]}), labels [N, Bn] (for
    classification) and mask [N]. Each client's tokenizers make its
    smashed data. Classification: under early fusion the modalities'
    tokens are joined client-side and cross one link ("joint") into one
    encoder pass; under late fusion each modality crosses its own link
    into its own pass, and the passes' summaries are joined after; the
    pooled embedding feeds the task head. Retrieval (task="retrieval"):
    one pass a modality, the two pooled embeddings projected (proj_a on
    the first modality in sorted order) into a symmetric InfoNCE at
    temperature 1 / exp(logit_scale). impls as for ``make_lm_loss``."""
    if task not in ("classification", "retrieval"):
        raise ValueError(f"unknown task {task!r}")
    mpsl = run.mpsl
    cdt = getattr(torch, run.compute_dtype)
    impls = {**DEFAULT_IMPLS, **(impls or {})}
    remat = run.remat != "none"

    def encode(frozen, server, h):
        positions = layers.positions_from_shape(h.shape[0], h.shape[1],
                                                device=h.device)
        return _run_body(frozen, server, cfg, h, positions, impls, remat)

    def loss_fn(trainable, frozen, batch, rng):
        mask = batch["mask"]
        n = mask.shape[0]
        dev = mask.device
        server = trainable["server"]

        # ---- client tokenizers (each client its own params) ----
        tokenized = {m: tok.apply_stacked(
                         trainable["client"]["tokenizers"][m], batch[m],
                         tok.MODALITIES[m], cdt)
                     for m in modalities}
        bn = tokenized[modalities[0]].shape[1]

        def uplink(a, link):
            if mpsl.compress_uplink:
                a = compression.compress_activations(
                    a, _vit_link_rng(rng, link, "uplink", dev))
            if mpsl.compress_downlink:
                a = compression.compress_gradients(
                    a, _vit_link_rng(rng, link, "downlink", dev))
            return a.reshape((n * bn,) + a.shape[2:])

        def encode_each():
            enc, aux = {}, 0.0
            for m in modalities:
                enc[m], a = encode(frozen, server, uplink(tokenized[m], m))
                aux = aux + a
            return enc, aux

        if task == "retrieval":
            enc, aux = encode_each()
            ma, mb = sorted(modalities)
            emb_a = fusion.gap(fusion.summarize_modality(ma, enc[ma]))
            emb_b = fusion.gap(fusion.summarize_modality(mb, enc[mb]))
            pa = emb_a @ server["proj_a"].to(cdt)
            pb = emb_b @ server["proj_b"].to(cdt)
            temp = 1.0 / torch.exp(server["logit_scale"])
            per_sample = losses.contrastive_loss(pa, pb, temp)   # [N*Bn]
        else:
            if mpsl.fusion == "early":
                joint = fusion.fuse_early(tokenized)             # [N,Bn,T,D]
                h, aux = encode(frozen, server, uplink(joint, "joint"))
                emb = fusion.gap(h)                              # [N*Bn, D]
            else:
                enc, aux = encode_each()
                emb = fusion.gap(fusion.fuse_late(enc))
            th = server["task_head"]
            logits = emb @ th["w"].to(cdt) + th["b"].to(cdt)
            per_sample = losses.softmax_xent(logits,
                                             batch["labels"].reshape(-1))
        per_client = per_sample.reshape(n, bn).mean(dim=1)       # L_n

        w = _client_weights(mask, n)
        l_s = (w * per_client).sum() + aux
        metrics = {"loss": l_s.detach(), "per_client": per_client.detach(),
                   "aux": (aux.detach() if torch.is_tensor(aux)
                           else torch.zeros((), device=dev)),
                   "participating": mask.sum()}
        return l_s, metrics

    return loss_fn


# ---------------------------------------------------------------------------
# Train step


def grad(loss, leaves):
    """Gradients of `loss` w.r.t. `leaves`. A leaf with no path to the
    loss (a paper-mode client's text table, read detached) gets zeros, as
    JAX's stop_gradient gives it: AdamW's decoupled decay still moves that
    leaf, and the global norm counts it."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def value_and_grad(loss_fn, params, frozen, batch, rng):
    """(loss, metrics, gradients of the loss w.r.t. `params` leaves, in
    ``tree.leaves`` order, zeros for a leaf the loss does not reach); the
    params must require grad."""
    leaves = tree.leaves(params)
    loss, metrics = loss_fn(params, frozen, batch, rng)
    return loss.detach(), metrics, grad(loss, leaves)


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
