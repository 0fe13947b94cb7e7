"""Model assembly: init + forward of the dense, MoE, SSM, hybrid and VLM
decoders, the whisper encoder-decoder and the paper's ViT encoder.

The transformer body is a list of SEGMENTS — runs of consecutive layers
with identical static structure — as in the JAX package. There each
segment is a stacked pytree scanned with jax.lax.scan; here it is a list
of per-layer param dicts run by a Python loop, and its cache a list of
per-layer cache dicts updated in place.

Block kinds: dense (norm1 -> attention -> residual, norm2 -> MLP ->
residual), ssm (norm1 -> Mamba -> residual; no MLP) and hybrid (norm1 ->
parallel attention + Mamba -> residual, norm2 -> MLP -> residual) and moe
(as dense, with the MoE FFN of ``models/moe.py`` for the MLP), vit (as
dense, bidirectional: the Meta-Transformer encoder, whose tokenizers
add learned positions, so attention applies no RoPE), enc (whisper's
encoder: as vit) and dec (whisper's decoder: norm1 -> causal
self-attention -> residual, norm_cross -> cross-attention over the
encoder's output -> residual, norm2 -> MLP -> residual). The VLM family
(qwen2-vl) is dense blocks under M-RoPE positions [B, 3, S].

A block, a segment and the body return the router's load-balance loss
beside the hidden states, as in the JAX package: a 0-d f32 tensor summed
over the MoE blocks, or 0.0 where there is none.

``impls``: {"attn": "kernel" | "naive" | "blockwise" | "auto",
"attn_block": the blockwise KV block (1024), "ssm": "kernel" | "plain",
"ssm_chunk": the scan's chunk (256), "ssm_bwd": "fused" | "recompute",
"moe": "ragged" | "dense" | "ep", "moe_capacity": ep's slack (2.0)}; the
kernels and the ragged dispatch by default.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import attention, hybrid, layers, mamba, mlp, moe
from repro_torch.parallel import collectives as C


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


def encoder_segments(cfg) -> List[Segment]:
    if cfg.encoder_layers:
        return [Segment(BlockKind("enc", causal=False), cfg.encoder_layers)]
    return []


# the config families that train through core.mpsl.make_lm_loss and serve
# through launch.serve (vit trains through make_vit_loss)
LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


# ---------------------------------------------------------------------------
# Block init / apply


def init_block(generator, cfg, kind: BlockKind, device=None):
    p = {"norm1": layers.init_norm(cfg.norm, cfg.d_model, device)}
    if kind.family == "ssm":
        p["ssm"] = mamba.init_mamba(generator, cfg, device)
        return p
    if kind.family == "hybrid":
        p["mix"] = hybrid.init_hybrid(generator, cfg, device)
    else:
        p["attn"] = attention.init_attention(generator, cfg, device)
    if kind.cross:
        p["norm_cross"] = layers.init_norm(cfg.norm, cfg.d_model, device)
        p["cross"] = attention.init_attention(generator, cfg, device)
    p["norm2"] = layers.init_norm(cfg.norm, cfg.d_model, device)
    if kind.family == "moe":
        p["moe"] = moe.init_moe(generator, cfg, device)
    else:
        p["mlp"] = mlp.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                cfg.activation, device)
    return p


def apply_block(params, x, cfg, kind: BlockKind, *, positions, cache=None,
                enc_out=None, cross_kv=None, impls=None):
    """One transformer block. Returns (x, cache, aux).

    A cross block attends over `cross_kv` (this layer's precomputed K/V)
    where given, else over `enc_out` [B, Sk, D]."""
    impls = impls or {}
    if C.active() is not None and kind.family not in (
            "dense", "moe", "ssm", "hybrid", "vit", "enc", "dec"):
        raise NotImplementedError(
            f"{cfg.family} ({kind.family} blocks) under the SPMD program: "
            f"ROADMAP.md Queue 1 item 7")
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
            impl=impls.get("attn", "kernel"),
            block=impls.get("attn_block", 1024),
            seq_shard=impls.get("attn_seq_shard", False), **ssm_kw)
    else:
        window = 0 if kind.is_global else cfg.sliding_window
        out, cache = attention.apply_attention(
            params["attn"], h, cfg, positions=positions, causal=kind.causal,
            window=window, cache=cache, impl=impls.get("attn", "kernel"),
            block=impls.get("attn_block", 1024),
            seq_shard=impls.get("attn_seq_shard", False))
    x = x + out
    if kind.cross:
        h = layers.apply_norm(x, params["norm_cross"], cfg.norm)
        out, _ = attention.apply_attention(
            params["cross"], h, cfg, positions=positions, causal=False,
            kv_x=enc_out, precomputed_kv=cross_kv,
            impl=impls.get("attn", "kernel"),
            block=impls.get("attn_block", 1024))
        x = x + out
    h = layers.apply_norm(x, params["norm2"], cfg.norm)
    if "moe" in params:
        out, aux = moe.apply_moe(params["moe"], h, cfg,
                                 impl=impls.get("moe", "ragged"),
                                 capacity=impls.get("moe_capacity", 2.0))
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
                  cache=None, enc_out=None, cross_kv=None, impls=None,
                  remat=False, seq_cut=False):
    """Run a segment's layers in order. Returns (x, cache, aux summed over
    the layers); the per-layer caches are updated in place. cross_kv: the
    segment's per-layer list from ``compute_cross_kv_stacked``.

    remat (train path, no cache): each block keeps only its input (and the
    encoder output it reads) for the backward and recomputes the rest
    there, as ``jax.checkpoint`` with ``nothing_saveable`` does around the
    JAX package's scan step; the non-reentrant checkpoint carries
    enc_out's gradient back to the encoder.

    seq_cut: x [B, S/m, D] is this model rank's slice of the sequence
    (``cut_stream``); each block all-gathers it whole (``gather_to``),
    runs unchanged on the replicated whole, and keeps its output's slice
    (``slice_to``). So a checkpoint keeps the S/m slice, and the values
    and gradients are those of the whole stream, bit for bit."""
    aux = 0.0
    for i, lp in enumerate(layer_params):
        ckv = None if cross_kv is None else cross_kv[i]
        lc = None if cache is None else cache[i]

        def block(h, enc, lp=lp, ckv=ckv, lc=lc):
            if seq_cut:
                h = C.gather_to(h, 1, "model")
            y, _, a = apply_block(lp, h, cfg, seg.kind, positions=positions,
                                  cache=lc, enc_out=enc, cross_kv=ckv,
                                  impls=impls)
            if seq_cut:
                y = C.slice_to(y, 1, "model")
            return y, a

        if remat and cache is None:
            # blocks draw no random numbers: no RNG state to carry over
            x, a = torch.utils.checkpoint.checkpoint(
                block, x, enc_out, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, a = block(x, enc_out)
        aux = aux + a
    return x, cache, aux


SEQ_MODEL = ("batch", "seq_model", None)


def cut_stream(h, impls):
    """(h, cut): the stream entering the first block, cut to this model
    rank's slice of the sequence (``slice_to``: its gradient comes back
    whole) where ``impls["act_dims"]`` asks for ``SEQ_MODEL``
    (``RunConfig.seq_shard_acts``, the JAX package's constraint on each
    block's output) under a program whose model axis is above 1 and
    divides the sequence. Elsewhere the stream stays whole, the rule
    table's fallback (a decode step's S = 1 among them)."""
    dims = tuple((impls or {}).get("act_dims") or ("batch", None, None))
    m = C.size("model")
    if dims == ("batch", None, None) or m == 1:
        return h, False
    if dims != SEQ_MODEL:
        raise NotImplementedError(
            f"activations laid out {dims} between blocks: the program "
            f"holds ('batch', None, None) and {SEQ_MODEL} (ROADMAP.md Queue "
            f"1 item 7)")
    cut = h.shape[1] % m == 0
    return (C.slice_to(h, 1, "model") if cut else h), cut


def whole_stream(h, cut: bool):
    """The stream leaving the last block, gathered whole where it was cut
    (``gather_to``: each rank's slice of the gradient backward)."""
    return C.gather_to(h, 1, "model") if cut else h


# ---------------------------------------------------------------------------
# Whole-model init


def init_lm(cfg, generator, device=None):
    """Full model params: embed + body segments (+ encoder) + final norm +
    head. The encoder (whisper) is {"segments", "norm", "pos"
    [encoder_seq, D]}, as in the JAX package.

    Weights are f32, drawn from `generator` (which lives on `device`)."""
    if cfg.family == "vit":
        raise NotImplementedError(
            "the vit family is an encoder with no embedding table or LM "
            "head: its params come from the paper-mode slice's "
            "constructors, core.split.init_mpsl_vit and "
            "core.baselines.init_full_vit")
    segs = body_segments(cfg)
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
    enc_segs = encoder_segments(cfg)
    if enc_segs:
        params["encoder"] = {
            "segments": [init_segment(generator, cfg, s, device)
                         for s in enc_segs],
            "norm": layers.init_norm(cfg.norm, cfg.d_model, device),
            "pos": layers.dense_init(generator,
                                     (cfg.encoder_seq, cfg.d_model),
                                     in_axis_size=cfg.d_model,
                                     device=device),
        }
    return params


# ---------------------------------------------------------------------------
# Forward passes


def embed_tokens(params, tokens, cfg, positions=None, dtype=torch.bfloat16):
    """Token ids [B, S] -> embeddings [B, S, D] in `dtype`.

    The JAX package casts the whole table before the gather; a cast is
    elementwise, so gathering first gives the same bits without copying
    the table on every call. Under the SPMD program the lookup is
    ``layers.embed_lookup``'s, the same bits."""
    h = layers.embed_lookup(params["embed"]["table"], tokens).to(dtype)
    if cfg.pos_embed == "learned":
        pos = positions if positions is not None else \
            layers.positions_from_shape(tokens.shape[0], tokens.shape[1],
                                        device=tokens.device)
        h = h + layers.embed_lookup(params["embed"]["pos"], pos).to(dtype)
    return h


def run_encoder(params, frame_embeds, cfg, impls=None, remat=False):
    """Whisper encoder over precomputed (stub) frame embeddings [B, F, D]:
    the learned positions added (whole: ``layers.learned_positions``),
    the bidirectional blocks, the norm."""
    enc = params["encoder"]
    pos = layers.learned_positions(enc["pos"])
    h = frame_embeds + pos.to(frame_embeds.dtype)[None]
    positions = layers.positions_from_shape(h.shape[0], h.shape[1],
                                            device=h.device)
    h, cut = cut_stream(h, impls)
    for seg_params, seg in zip(enc["segments"], encoder_segments(cfg)):
        h, _, _ = apply_segment(seg_params, h, cfg, seg, positions=positions,
                                impls=impls, remat=remat, seq_cut=cut)
    return layers.apply_norm(whole_stream(h, cut), enc["norm"], cfg.norm)


def forward_body(params, h, cfg, *, positions, cache=None, enc_out=None,
                 cross_kv=None, impls=None, remat=False):
    """Embeddings -> final hidden states. Returns (h, caches, aux); the
    caches are updated in place. Cross blocks attend over `cross_kv` (from
    ``compute_cross_kv_stacked``) where given, else over `enc_out`. Where
    ``impls["act_dims"]`` asks for seq_model the stream is cut on the
    sequence over `model` between the blocks (``cut_stream``) and
    gathered whole before the final norm."""
    aux = 0.0
    h, cut = cut_stream(h, impls)
    for i, (seg_params, seg) in enumerate(zip(params["segments"],
                                              body_segments(cfg))):
        h, _, a = apply_segment(seg_params, h, cfg, seg, positions=positions,
                                cache=None if cache is None else cache[i],
                                enc_out=enc_out,
                                cross_kv=None if cross_kv is None
                                else cross_kv[i],
                                impls=impls, remat=remat, seq_cut=cut)
        aux = aux + a
    h = layers.apply_norm(whole_stream(h, cut), params["final_norm"],
                          cfg.norm)
    return h, cache, aux


def lm_logits(params, h, cfg):
    """h [..., D] -> logits [..., V].

    Under the SPMD program the logits are vocab-sharded, [..., V/m] on
    `model` (the JAX ``("batch", None, "model")``), where the head
    [D, V] lies (fsdp, model): its D gathered over `data`, h entering the
    region by ``copy_to``. A tied head (the table [V, D], D on `model`)
    gives each model rank the partial sums of its D columns, all-reduced
    into the whole [..., V] on every rank. ``greedy`` takes the argmax of
    either."""
    # Tied archs may carry an explicitly trained head (MPSL fine-tuning
    # keeps the embedding frozen client-side but trains the tail copy).
    if "lm_head" in params:
        w = params["lm_head"]
        if C.model_parallel(w):
            h = C.copy_to(h, "model")
        return h @ C.gather_param(w).to(h.dtype)
    table = params["embed"]["table"]
    if C.model_parallel(table):
        rows = C.gather_param(table)                       # [V, D/m]
        d_loc = rows.shape[1]
        i = C.index("model")
        part = h[..., i * d_loc:(i + 1) * d_loc] @ rows.T.to(h.dtype)
        return C.reduce_from(part, "model")
    return h @ C.gather_param(table).T.to(h.dtype)


def greedy(logits, cfg):
    """The argmax over the vocabulary of logits [..., V], or of a rank's
    vocab shard [..., V/m] under the SPMD program: each model rank's max
    and its global index all-gathered, the first rank holding the largest
    wins (ties go to the lowest index, as ``torch.argmax``'s)."""
    v = logits.shape[-1]
    idx = logits.argmax(dim=-1)
    if v == cfg.vocab_size or C.size("model") == 1:
        return idx
    top = logits.gather(-1, idx[..., None])[..., 0].float()
    idx = idx + C.index("model") * v
    tops = C.all_gather(top[None], 0, "model")
    idxs = C.all_gather(idx[None], 0, "model")
    return idxs.gather(0, tops.argmax(dim=0, keepdim=True))[0]


def init_body_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
                    device=None):
    return [init_segment_cache(cfg, seg, batch, cache_len, dtype, device)
            for seg in body_segments(cfg)]


def compute_cross_kv_stacked(params, enc_out, cfg):
    """Per segment, None (no cross blocks) or the list of its layers'
    cross-attention K/V over `enc_out` (``attention.compute_cross_kv``)."""
    return [[attention.compute_cross_kv(lp["cross"], enc_out, cfg)
             for lp in seg_params] if seg.kind.cross else None
            for seg_params, seg in zip(params["segments"],
                                       body_segments(cfg))]


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
