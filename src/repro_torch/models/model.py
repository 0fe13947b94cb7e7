"""Model assembly: init + forward of the dense, SSM and hybrid decoders and
the paper's ViT encoder.

The transformer body is a list of SEGMENTS — runs of consecutive layers
with identical static structure — as in the JAX package. There each
segment is a stacked pytree scanned with jax.lax.scan; here it is a list
of per-layer param dicts run by a Python loop, and its cache a list of
per-layer cache dicts updated in place.

Block kinds: dense (norm1 -> attention -> residual, norm2 -> MLP ->
residual), ssm (norm1 -> Mamba -> residual; no MLP) and hybrid (norm1 ->
parallel attention + Mamba -> residual, norm2 -> MLP -> residual) and moe
(as dense, with the MoE FFN of ``models/moe.py`` for the MLP) and vit (as
dense, bidirectional: the Meta-Transformer encoder, whose tokenizers
add learned positions, so attention applies no RoPE). Cross-attention and
encoder blocks raise NotImplementedError naming the slice of ROADMAP.md
that brings them. The segment plan and the
analytic parameter counts cover every family.

A block, a segment and the body return the router's load-balance loss
beside the hidden states, as in the JAX package: a 0-d f32 tensor summed
over the MoE blocks, or 0.0 where there is none.

``impls``: {"attn": "kernel" | "naive", "ssm": "kernel" | "plain",
"ssm_chunk": the scan's chunk (256), "ssm_bwd": "fused" | "recompute",
"moe": "ragged" | "dense"}; the kernels and the ragged dispatch by
default.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import attention, hybrid, layers, mamba, mlp, moe


@dataclasses.dataclass(frozen=True)
class BlockKind:
    family: str                 # dense | moe | ssm | hybrid | vit | enc | dec
    is_global: bool = True      # full vs sliding-window attention
    causal: bool = True
    cross: bool = False         # cross-attention (whisper decoder)


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: BlockKind
    count: int


def body_segments(cfg) -> List[Segment]:
    """Static segment plan for the (decoder-side) body."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return [Segment(BlockKind("dense"), cfg.num_layers)]
    if fam == "moe":
        return [Segment(BlockKind("moe"), cfg.num_layers)]
    if fam == "ssm":
        return [Segment(BlockKind("ssm"), cfg.num_layers)]
    if fam == "hybrid":
        segs, i = [], 0
        glb = set(cfg.global_layers)
        while i < cfg.num_layers:
            g = i in glb
            j = i
            while j < cfg.num_layers and (j in glb) == g:
                j += 1
            segs.append(Segment(BlockKind("hybrid", is_global=g), j - i))
            i = j
        return segs
    if fam == "vit":
        return [Segment(BlockKind("vit", causal=False), cfg.num_layers)]
    if fam == "audio":
        return [Segment(BlockKind("dec", cross=True), cfg.num_layers)]
    raise ValueError(f"unknown family {fam!r}")


LM_FAMILIES = ("dense", "moe", "ssm", "hybrid")
PORTED_FAMILIES = LM_FAMILIES + ("vit",)
_LATER_SLICES = {
    "dec": "the enc-dec / VLM slice",
    "enc": "the enc-dec / VLM slice",
}


def _require_ported(kind: BlockKind) -> None:
    if kind.family not in PORTED_FAMILIES or kind.cross:
        raise NotImplementedError(
            f"{kind.family} blocks come with "
            f"{_LATER_SLICES.get(kind.family, 'a later slice')} of the "
            f"port (ROADMAP.md)")


# ---------------------------------------------------------------------------
# Block init / apply


def init_block(generator, cfg, kind: BlockKind, device=None):
    _require_ported(kind)
    p = {"norm1": layers.init_norm(cfg.norm, cfg.d_model, device)}
    if kind.family == "ssm":
        p["ssm"] = mamba.init_mamba(generator, cfg, device)
        return p
    if kind.family == "hybrid":
        p["mix"] = hybrid.init_hybrid(generator, cfg, device)
    else:
        p["attn"] = attention.init_attention(generator, cfg, device)
    p["norm2"] = layers.init_norm(cfg.norm, cfg.d_model, device)
    if kind.family == "moe":
        p["moe"] = moe.init_moe(generator, cfg, device)
    else:
        p["mlp"] = mlp.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                cfg.activation, device)
    return p


def apply_block(params, x, cfg, kind: BlockKind, *, positions, cache=None,
                impls=None):
    """One transformer block. Returns (x, cache, aux)."""
    _require_ported(kind)
    impls = impls or {}
    h = layers.apply_norm(x, params["norm1"], cfg.norm)
    ssm_kw = dict(ssm_impl=impls.get("ssm", "kernel"),
                  ssm_chunk=impls.get("ssm_chunk", 256),
                  ssm_bwd=impls.get("ssm_bwd", "fused"))
    if kind.family == "ssm":
        out, cache = mamba.apply_mamba(
            params["ssm"], h, cfg, cache=cache, impl=ssm_kw["ssm_impl"],
            chunk=ssm_kw["ssm_chunk"], bwd_impl=ssm_kw["ssm_bwd"])
        return x + out, cache, 0.0
    if kind.family == "hybrid":
        out, cache = hybrid.apply_hybrid(
            params["mix"], h, cfg, positions=positions,
            is_global=kind.is_global, cache=cache,
            impl=impls.get("attn", "kernel"), **ssm_kw)
    else:
        window = 0 if kind.is_global else cfg.sliding_window
        out, cache = attention.apply_attention(
            params["attn"], h, cfg, positions=positions, causal=kind.causal,
            window=window, cache=cache, impl=impls.get("attn", "kernel"))
    x = x + out
    h = layers.apply_norm(x, params["norm2"], cfg.norm)
    if "moe" in params:
        out, aux = moe.apply_moe(params["moe"], h, cfg,
                                 impl=impls.get("moe", "ragged"))
        return x + out, cache, aux
    return x + mlp.apply_mlp(params["mlp"], h, cfg.activation), cache, 0.0


# ---------------------------------------------------------------------------
# Segment init / loop


def init_segment(generator, cfg, seg: Segment, device=None):
    return [init_block(generator, cfg, seg.kind, device)
            for _ in range(seg.count)]


def init_segment_cache(cfg, seg: Segment, batch: int, cache_len: int,
                       dtype=torch.bfloat16, device=None):
    kind = seg.kind
    _require_ported(kind)
    if kind.family == "ssm":
        return [mamba.init_mamba_cache(cfg, batch, dtype, device)
                for _ in range(seg.count)]
    if kind.family == "hybrid":
        return [hybrid.init_hybrid_cache(cfg, batch, cache_len,
                                         kind.is_global, dtype, device)
                for _ in range(seg.count)]
    return [attention.init_cache(cfg, batch, cache_len, dtype, device)
            for _ in range(seg.count)]


def apply_segment(layer_params, x, cfg, seg: Segment, *, positions,
                  cache=None, impls=None, remat=False):
    """Run a segment's layers in order. Returns (x, cache, aux summed over
    the layers); the per-layer caches are updated in place.

    remat (train path, no cache): each block keeps only its input for the
    backward and recomputes the rest there, as ``jax.checkpoint`` with
    ``nothing_saveable`` does around the JAX package's scan step."""
    aux = 0.0
    for i, lp in enumerate(layer_params):
        if remat and cache is None:
            def block(h, lp=lp):
                y, _, a = apply_block(lp, h, cfg, seg.kind,
                                      positions=positions, impls=impls)
                return y, a
            # blocks draw no random numbers: no RNG state to carry over
            x, a = torch.utils.checkpoint.checkpoint(
                block, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, _, a = apply_block(lp, x, cfg, seg.kind, positions=positions,
                                  cache=None if cache is None else cache[i],
                                  impls=impls)
        aux = aux + a
    return x, cache, aux


# ---------------------------------------------------------------------------
# Whole-model init


def init_lm(cfg, generator, device=None):
    """Full model params: embed + body segments + final norm + head.

    Weights are f32, drawn from `generator` (which lives on `device`)."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            "encoders come with the enc-dec / VLM slice of the port")
    if cfg.family == "vit":
        raise NotImplementedError(
            "the vit family is an encoder with no embedding table or LM "
            "head: its params come from core.split.init_mpsl_vit and "
            "core.baselines.init_full_vit (the paper-mode slice of the port)")
    segs = body_segments(cfg)
    for seg in segs:
        _require_ported(seg.kind)
    params: Dict[str, Any] = {}
    embed: Dict[str, Any] = {
        "table": layers.dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                   in_axis_size=cfg.d_model, device=device)}
    if cfg.pos_embed == "learned":
        embed["pos"] = layers.dense_init(
            generator, (cfg.max_seq, cfg.d_model), in_axis_size=cfg.d_model,
            device=device)
    params["embed"] = embed
    params["segments"] = [init_segment(generator, cfg, s, device)
                          for s in segs]
    params["final_norm"] = layers.init_norm(cfg.norm, cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), device=device)
    return params


# ---------------------------------------------------------------------------
# Forward passes


def embed_tokens(params, tokens, cfg, positions=None, dtype=torch.bfloat16):
    """Token ids [B, S] -> embeddings [B, S, D] in `dtype`.

    The JAX package casts the whole table before the gather; a cast is
    elementwise, so gathering first gives the same bits without copying
    the table on every call."""
    h = params["embed"]["table"][tokens].to(dtype)
    if cfg.pos_embed == "learned":
        pos = positions if positions is not None else \
            layers.positions_from_shape(tokens.shape[0], tokens.shape[1],
                                        device=tokens.device)
        h = h + params["embed"]["pos"][pos].to(dtype)
    return h


def forward_body(params, h, cfg, *, positions, cache=None, impls=None,
                 remat=False):
    """Embeddings -> final hidden states. Returns (h, caches, aux); the
    caches are updated in place."""
    aux = 0.0
    for i, (seg_params, seg) in enumerate(zip(params["segments"],
                                              body_segments(cfg))):
        h, _, a = apply_segment(seg_params, h, cfg, seg, positions=positions,
                                cache=None if cache is None else cache[i],
                                impls=impls, remat=remat)
        aux = aux + a
    h = layers.apply_norm(h, params["final_norm"], cfg.norm)
    return h, cache, aux


def lm_logits(params, h, cfg):
    # Tied archs may carry an explicitly trained head (MPSL fine-tuning
    # keeps the embedding frozen client-side but trains the tail copy).
    if "lm_head" in params:
        w = params["lm_head"]
    else:
        w = params["embed"]["table"].T
    return h @ w.to(h.dtype)


def init_body_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
                    device=None):
    return [init_segment_cache(cfg, seg, batch, cache_len, dtype, device)
            for seg in body_segments(cfg)]


# ---------------------------------------------------------------------------
# Analytic parameter counts


def _attn_params(cfg) -> int:
    d, h, k, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    n = d * h * hd + 2 * d * k * hd + h * hd * d
    if cfg.qkv_bias:
        n += (h + 2 * k) * hd
    if cfg.qk_norm:
        n += 2 * hd
    return n


def _mlp_params(d, f, activation) -> int:
    return d * f * (3 if layers.gated_activation(activation) else 2)


def _mamba_params(cfg) -> int:
    d = cfg.d_model
    di, ds, dc = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    dtr = cfg.dt_rank
    return (d * 2 * di + dc * di + di + di * (dtr + 2 * ds)
            + dtr * di + di + di * ds + di + di * d)


def _norm_params(cfg) -> int:
    return cfg.d_model * (2 if cfg.norm == "layernorm" else 1)


def _block_params(cfg, kind: BlockKind) -> int:
    n = _norm_params(cfg)
    if kind.family == "ssm":
        return n + _mamba_params(cfg)
    if kind.family == "hybrid":
        n += _attn_params(cfg) + _mamba_params(cfg) + 2 * cfg.d_model + 2
    else:
        n += _attn_params(cfg)
    if kind.cross:
        n += _norm_params(cfg) + _attn_params(cfg)
    n += _norm_params(cfg)
    if cfg.moe and kind.family == "moe":
        m = cfg.moe
        gated = 3 if layers.gated_activation(cfg.activation) else 2
        n += cfg.d_model * m.num_experts
        n += m.num_experts * cfg.d_model * m.d_ff_expert * gated
        if m.num_shared_experts:
            n += _mlp_params(cfg.d_model, m.d_ff_shared, cfg.activation)
            n += cfg.d_model
    else:
        n += _mlp_params(cfg.d_model, cfg.d_ff, cfg.activation)
    return n


def count_params_analytic(cfg, trainable_blocks: Optional[int] = None) -> int:
    """Total params, or params of the last `trainable_blocks` blocks only."""
    per_block = [(_block_params(cfg, seg.kind), seg.count)
                 for seg in body_segments(cfg)]
    if trainable_blocks is not None and trainable_blocks >= 0:
        want = min(trainable_blocks, cfg.num_layers)
        total, seen = 0, 0
        for n, count in reversed(per_block):
            take = min(count, want - seen)
            total += n * take
            seen += take
            if seen >= want:
                break
        return total
    total = sum(n * c for n, c in per_block)
    total += cfg.vocab_size * cfg.d_model           # embed
    if cfg.pos_embed == "learned":
        total += cfg.max_seq * cfg.d_model
    total += _norm_params(cfg)
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (
            _block_params(cfg, BlockKind("enc", causal=False)))
        total += _norm_params(cfg) + cfg.encoder_seq * cfg.d_model
    return total
