"""The MPSL three-way split  W = [W_h ; W_b ; W_t]  (paper Sec. 3.1).

Counterpart of the JAX package's ``core/split.py``. Parameters are
partitioned into three trees:

  client  — W_h: per-client heads, STACKED along a leading client axis
            [N, ...]: low-rank tokenizer adapters on a frozen embedding
            for the LM family; the Meta-Transformer modality tokenizers
            for the paper's own ViT setup.
  server  — W_b (the fine-tuned suffix of the body) + W_t (the LM head,
            or the ViT's task head / retrieval projections): shared, one
            copy, one backward pass.
  frozen  — the embedding table and the non-fine-tuned prefix of the
            body: on the activation/gradient path but never updated,
            stored in bf16 with no optimizer state.

The body boundary follows the paper's "fine-tune the last k blocks"
protocol. Where the JAX package slices stacked scan segments at the
boundary, the port slices its per-layer lists.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import tree
from repro_torch.models import layers, model as M, tokenizers as tok


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    cfg: Any
    mpsl: Any
    trainable_blocks: int
    segments_frozen: Tuple[M.Segment, ...]
    segments_train: Tuple[M.Segment, ...]

    @property
    def boundary(self) -> int:
        return self.cfg.num_layers - self.trainable_blocks


def resolve_trainable_blocks(cfg, mpsl) -> int:
    k = mpsl.trainable_blocks
    return cfg.num_layers if k < 0 else min(k, cfg.num_layers)


def split_segments(segs: List[M.Segment], boundary: int):
    """Split a Segment list at a layer boundary (counted from layer 0)."""
    frozen, train, seen = [], [], 0
    for seg in segs:
        if seen + seg.count <= boundary:
            frozen.append(seg)
        elif seen >= boundary:
            train.append(seg)
        else:
            cut = boundary - seen
            frozen.append(M.Segment(seg.kind, cut))
            train.append(M.Segment(seg.kind, seg.count - cut))
        seen += seg.count
    return frozen, train


def make_split_plan(cfg, mpsl) -> SplitPlan:
    k = resolve_trainable_blocks(cfg, mpsl)
    fsegs, tsegs = split_segments(M.body_segments(cfg), cfg.num_layers - k)
    return SplitPlan(cfg, mpsl, k, tuple(fsegs), tuple(tsegs))


def _slice_stacked(seg_params_list, segs: List[M.Segment], boundary: int):
    """Slice per-layer segment params at the layer boundary."""
    frozen, train, seen = [], [], 0
    for sp, seg in zip(seg_params_list, segs):
        if seen + seg.count <= boundary:
            frozen.append(sp)
        elif seen >= boundary:
            train.append(sp)
        else:
            cut = boundary - seen
            frozen.append(sp[:cut])
            train.append(sp[cut:])
        seen += seg.count
    return frozen, train


def _cast(t, dtype):
    return t.to(dtype) if t.is_floating_point() else t


def _cast_in_place(tree_, dtype):
    """Cast every leaf of a tree of dicts and lists, replacing each leaf
    where it lies: its original is freed before the next is cast, so the
    frozen tree never lies on the device in both dtypes at once (at
    qwen2-moe-a2.7b's width the two would not fit one 80 GB card beside
    the trainable tree)."""
    items = tree_.items() if isinstance(tree_, dict) else enumerate(tree_)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            _cast_in_place(v, dtype)
        else:
            tree_[k] = _cast(v, dtype)


# ---------------------------------------------------------------------------
# Client heads


def init_client_adapters(generator, cfg, mpsl, device=None):
    """Low-rank per-client tokenizer adapter: h + (h @ a_n) @ b_n.

    a ~ N(0, 1/D), b = 0 (LoRA-style: identity at init). Stacked [N, ...]."""
    n, r, d = mpsl.n_clients, mpsl.head_adapter_rank, cfg.d_model
    return {
        "a": layers.dense_init(generator, (n, d, r), in_axis_size=d,
                               device=device),
        "b": torch.zeros((n, r, d), dtype=torch.float32, device=device),
    }


def apply_client_adapter(adapter, h):
    """h [N, ..., D] with each client's own low-rank delta."""
    a = adapter["a"].to(h.dtype)
    b = adapter["b"].to(h.dtype)
    delta = torch.einsum("n...d,ndr->n...r", h, a)
    return h + torch.einsum("n...r,nrd->n...d", delta, b)


def init_client_tokenizers(generator, cfg, mpsl, modalities, device=None):
    """Paper-mode client heads: per-client Meta-Transformer tokenizers,
    each leaf stacked [N, ...]."""
    out = {}
    for m in modalities:
        spec = tok.MODALITIES[m]
        per = [tok.init_tokenizer(generator, spec, cfg.d_model, device)
               for _ in range(mpsl.n_clients)]
        out[m] = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    return out


# ---------------------------------------------------------------------------
# MPSL parameter trees


def init_mpsl_lm(generator, cfg, run, device=None):
    """MPSL split parameters for an LM-family arch: (params, frozen, plan).

    Weights are drawn from `generator` (on `device`); trainable params are
    f32, the frozen tree is cast to ``run.frozen_dtype``."""
    plan = make_split_plan(cfg, run.mpsl)
    base = M.init_lm(cfg, generator, device)
    fseg_p, tseg_p = _slice_stacked(base.pop("segments"),
                                    M.body_segments(cfg), plan.boundary)
    server: Dict[str, Any] = {"segments": tseg_p,
                              "final_norm": base["final_norm"]}
    if not cfg.tie_embeddings:
        server["lm_head"] = base["lm_head"]
    else:
        # the tail stays trainable and shared with tied embeddings: a
        # trainable copy (the frozen table is the client-side tokenizer)
        server["lm_head"] = base["embed"]["table"].T.contiguous()
    frozen = {"embed": base.pop("embed"), "segments": fseg_p}
    _cast_in_place(frozen, getattr(torch, run.frozen_dtype))
    client = {"adapter": init_client_adapters(generator, cfg, run.mpsl,
                                              device)}
    return {"client": client, "server": server}, frozen, plan


def init_mpsl_vit(generator, cfg, run, modalities=("vision", "text"),
                  n_classes: int = 10, retrieval: bool = False, device=None):
    """MPSL split parameters for the paper's Meta-Transformer setup:
    (params, frozen, plan). The server holds the body's trainable suffix,
    the final norm and a task head (or, for retrieval, the two 512-wide
    projections and the learned logit scale ln(1/0.07)); each client its
    modality tokenizers."""
    plan = make_split_plan(cfg, run.mpsl)
    segs = M.body_segments(cfg)
    seg_p = [M.init_segment(generator, cfg, s, device) for s in segs]
    fseg_p, tseg_p = _slice_stacked(seg_p, segs, plan.boundary)
    frozen = {"segments": fseg_p}
    _cast_in_place(frozen, getattr(torch, run.frozen_dtype))
    server: Dict[str, Any] = {
        "segments": tseg_p,
        "final_norm": layers.init_norm(cfg.norm, cfg.d_model, device)}
    if retrieval:
        for k in ("proj_a", "proj_b"):
            server[k] = layers.dense_init(generator, (cfg.d_model, 512),
                                          device=device)
        server["logit_scale"] = torch.tensor(2.659, dtype=torch.float32,
                                             device=device)  # ln(1/0.07)
    else:
        server["task_head"] = {
            "w": layers.dense_init(generator, (cfg.d_model, n_classes),
                                   device=device),
            "b": torch.zeros((n_classes,), device=device)}
    client = {"tokenizers": init_client_tokenizers(generator, cfg, run.mpsl,
                                                   modalities, device)}
    return {"client": client, "server": server}, frozen, plan


# ---------------------------------------------------------------------------
# Post-training model construction (paper Sec. 3.3)


def assemble_full_params(params, frozen, plan, client_head=None):
    """[F_C ; F_S] — rebuild a full model's body from the split trees: the
    frozen segments (back in f32) and the trainable ones merged, the final
    norm, and the embedding and LM head where the trees have them (an LM
    then feeds ``launch.serve``). The client heads are not part of it:
    ``core.aggregation`` FedAvgs or selects them. `client_head` is kept
    from the JAX package's signature, which does not read it either."""
    f32 = lambda t: _cast(t, torch.float32)
    segs = M.body_segments(plan.cfg)
    fseg = [tree.map_(f32, sp) for sp in frozen["segments"]]
    tseg = list(params["server"]["segments"])
    merged = []
    for seg in segs:
        layers_ = []
        while len(layers_) < seg.count:
            layers_ += fseg.pop(0) if fseg else tseg.pop(0)
        merged.append(layers_)
    out = {"segments": merged, "final_norm": params["server"]["final_norm"]}
    if "embed" in frozen:
        out["embed"] = tree.map_(f32, frozen["embed"])
    if "lm_head" in params["server"]:
        out["lm_head"] = params["server"]["lm_head"]
    return out
