"""Distributed-learning baselines the paper compares against. Counterpart
of the JAX package's ``core/baselines.py``.

  * Centralized fine-tuning — pooled data, full model, one optimizer.
  * FedAvg  [McMahan et al., 2017] — every client trains the FULL model
    locally (tokenizers + encoder + head); rounds of local steps followed
    by parameter averaging.
  * FedCLIP [Lu et al., 2023] — lightweight adapters + head trained on a
    FROZEN backbone, FL-aggregated; the backbone still runs on-client.
  * Sequential SL — vanilla (non-parallel) split learning; provided as an
    analytic latency model in core.costs (its wall-clock is N * MPSL).

Attention takes ``impls`` as the MPSL path does: the flash kernel by
default (its plain version on a CPU tensor), ``{"attn": "naive"}`` for
materialized scores. A client bank (``make_fl_round``) is an
``init_full_vit`` tree whose every leaf is stacked [N, ...] (per layer,
in the body's per-layer lists); ``bridge.from_repro(..., client_axis=
True)`` carries the JAX package's vmapped bank over.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import fusion, losses, mpsl
from repro_torch.models import layers, model as M, tokenizers as tok
from repro_torch.optim import adamw_init, adamw_update, apply_updates


# ---------------------------------------------------------------------------
# Full (unsplit) multimodal model


def init_full_vit(generator, cfg, modalities=("vision", "text"), n_classes=10,
                  retrieval=False, with_adapter=False, device=None):
    p = {
        "tokenizers": {m: tok.init_tokenizer(generator, tok.MODALITIES[m],
                                             cfg.d_model, device)
                       for m in modalities},
        "segments": [M.init_segment(generator, cfg, s, device)
                     for s in M.body_segments(cfg)],
        "final_norm": layers.init_norm(cfg.norm, cfg.d_model, device),
    }
    init = lambda shape: layers.dense_init(generator, shape, device=device)
    if retrieval:
        p["proj_a"] = init((cfg.d_model, 512))
        p["proj_b"] = init((cfg.d_model, 512))
        p["logit_scale"] = torch.tensor(2.659, dtype=torch.float32,
                                        device=device)
    else:
        p["task_head"] = {"w": init((cfg.d_model, n_classes)),
                          "b": torch.zeros((n_classes,), device=device)}
    if with_adapter:                      # FedCLIP: adapter atop frozen body
        p["adapter"] = {"wi": init((cfg.d_model, cfg.d_model // 4)),
                        "wo": init((cfg.d_model // 4, cfg.d_model))}
    return p


def _encode(params, tokens_bnd, cfg, remat=False, impls=None):
    positions = layers.positions_from_shape(
        tokens_bnd.shape[0], tokens_bnd.shape[1], device=tokens_bnd.device)
    h = tokens_bnd
    for sp, seg in zip(params["segments"], M.body_segments(cfg)):
        h, _, _ = M.apply_segment(sp, h, cfg, seg, positions=positions,
                                  impls=impls, remat=remat)
    h = layers.apply_norm(h, params["final_norm"], cfg.norm)
    if "adapter" in params:
        a = params["adapter"]
        h = h + torch.einsum("btd,df,fe->bte", layers.gelu(h),
                             a["wi"].to(h.dtype), a["wo"].to(h.dtype))
    return h


def _tokenize(params, batch, modalities, dtype):
    return {m: tok.apply_tokenizer(params["tokenizers"][m], batch[m],
                                   tok.MODALITIES[m], dtype)
            for m in modalities}


def _retrieval_pair(params, tokenized, cfg, dtype, impls):
    enc = {m: _encode(params, t, cfg, impls=impls)
           for m, t in tokenized.items()}
    ma, mb = sorted(tokenized)
    pa = fusion.gap(fusion.summarize_modality(ma, enc[ma])) \
        @ params["proj_a"].to(dtype)
    pb = fusion.gap(fusion.summarize_modality(mb, enc[mb])) \
        @ params["proj_b"].to(dtype)
    return pa, pb


def full_vit_logits(params, batch, cfg, *, modalities=("vision", "text"),
                    fusion_mode="early", dtype=torch.float32, impls=None):
    tokenized = _tokenize(params, batch, modalities, dtype)
    if fusion_mode == "early":
        emb = fusion.gap(_encode(params, fusion.fuse_early(tokenized), cfg,
                                 impls=impls))
    else:
        enc = {m: _encode(params, t, cfg, impls=impls)
               for m, t in tokenized.items()}
        emb = fusion.gap(fusion.fuse_late(enc))
    th = params["task_head"]
    return emb @ th["w"].to(dtype) + th["b"].to(dtype)


def full_vit_loss(params, batch, cfg, *, modalities=("vision", "text"),
                  fusion_mode="early", task="classification",
                  dtype=torch.float32, impls=None):
    """Single-worker loss over batch {modality: [B, ...], labels: [B]}."""
    if task == "retrieval":
        pa, pb = _retrieval_pair(params, _tokenize(params, batch, modalities,
                                                   dtype), cfg, dtype, impls)
        temp = 1.0 / torch.exp(params["logit_scale"])
        return losses.contrastive_loss(pa, pb, temp).mean()
    logits = full_vit_logits(params, batch, cfg, modalities=modalities,
                             fusion_mode=fusion_mode, dtype=dtype,
                             impls=impls)
    return losses.softmax_xent(logits, batch["labels"]).mean()


def retrieval_embeddings(params, batch, cfg, modalities=("text", "vision"),
                         dtype=torch.float32, impls=None):
    return _retrieval_pair(params, _tokenize(params, batch, modalities,
                                             dtype), cfg, dtype, impls)


# ---------------------------------------------------------------------------
# Federated rounds


def make_fl_round(loss_fn, lr: float, local_steps: int,
                  trainable_filter=None):
    """Returns round(params_stack, batches) -> (bank, avg, mean loss): each
    client, in turn, takes `local_steps` AdamW steps of loss_fn(params,
    batch) from its own row of the bank (batches: {key: [N, local_steps,
    ...]}), then the clients' params are averaged; the new bank is the
    average broadcast back to the N rows (a view of `avg`).

    trainable_filter(path) -> bool freezes leaves (FedCLIP backbone)."""

    def local_train(params, client_batches):
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = adamw_init(params)
        ls = []
        for s in range(local_steps):
            loss = loss_fn(params, {k: v[s] for k, v in
                                    client_batches.items()})
            grads = mpsl.grad(loss, leaves)
            if trainable_filter is not None:
                grads = _mask_grads(grads, tree.paths(params),
                                    trainable_filter)
            apply_updates(leaves, adamw_update(grads, opt, leaves, lr=lr))
            ls.append(loss.detach())
        return params, torch.stack(ls).mean()

    def fl_round(params_stack, batches_stack):
        n = params_stack_count(params_stack)
        steps = {v.shape[1] for v in batches_stack.values()}
        if steps != {local_steps}:
            raise ValueError(f"batches hold {steps} local steps, the round "
                             f"takes {local_steps}")
        new, client_losses = [], []
        for i in range(n):
            p, loss = local_train(
                tree.map_(lambda a: a[i].detach().clone(), params_stack),
                {k: v[i] for k, v in batches_stack.items()})
            new.append(tree.map_(torch.Tensor.detach, p))
            client_losses.append(loss)
        avg = tree.map_(lambda *xs: torch.stack(xs).mean(dim=0), *new)
        bank = tree.map_(lambda p: p[None].expand((n,) + tuple(p.shape)),
                         avg)
        return bank, avg, torch.stack(client_losses).mean()

    return fl_round


def params_stack_count(stack) -> int:
    return tree.leaves(stack)[0].shape[0]


def _mask_grads(grads, paths, keep):
    return [g if keep(path) else torch.zeros_like(g)
            for g, path in zip(grads, paths)]


FEDCLIP_TRAINABLE = ("adapter", "task_head", "proj_a", "proj_b",
                     "logit_scale")


def fedclip_filter(path: str) -> bool:
    return any(t in path for t in FEDCLIP_TRAINABLE)
