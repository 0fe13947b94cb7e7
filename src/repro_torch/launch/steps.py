"""Step constructors for train / prefill / decode across all (arch x shape)
cells: abstract inputs (``device="meta"`` tensors, never allocated), the
per-leaf specs of the rule table, and the step functions the dry run
traces and ``chip_smoke.py`` drives on the card.

Counterpart of the JAX package's ``launch/steps.py``. Train cells run
the MPSL step (the paper's technique IS the training step); decode and
prefill cells serve the assembled model (post-training construction,
paper Sec. 3.3).

Where the JAX package jits a pure function, the port's functions update
in place: the train step updates params and AdamW moments
(``core.mpsl.make_train_step``), decode writes its token into the cache.
The port's state keeps the step and the seed as host ints, where the
JAX state holds a step [] int32 and a key [2] uint32. The VLM prefill
hands ``layers.build_positions`` its patch count (the JAX
``build_prefill`` reads it off the wrong axis; ROADMAP.md Queue 3).

On a mesh of several ranks every builder's function runs as the SPMD
program (``parallel.collectives``, started by ``launch.mesh.
init_device_mesh`` and made active by ``collectives.program``): it takes
and returns this rank's shards, laid out by the builder's in_specs
(``shard_inputs`` cuts whole arguments by them), and the model code
calls the collectives. With no program it is the one-rank function.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import tree
from repro_torch.configs import MPSLConfig, RunConfig
from repro_torch.core import mpsl, split
from repro_torch.models import layers, model as M
from repro_torch.optim import adamw_init, schedules
from repro_torch.parallel import collectives, sharding

VLM_PATCH_TOKENS = 256
# Per-device activation-stash budget for the microbatch heuristic (the
# JAX package's: its measured temp footprint ran ~3-4x the naive
# L*B*S*D*2 stash estimate, so the target is conservative).
STASH_TARGET_BYTES = 1.5e9


# ---------------------------------------------------------------------------
# Run defaults per cell


def n_data_shards(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= int(mesh.shape[a])
    return n


def choose_microbatches(cfg, shape, n_shards: int, bn: int) -> int:
    """Smallest power-of-two microbatch count keeping the per-device
    activation stash (L x B_local x S_eff x D x 2B) under budget, capped
    at bn (each client's local batch is split). Encoder-decoder archs pay
    for encoder and cross-attention tokens too."""
    seq_eff = shape.seq_len + 2 * cfg.encoder_seq
    layers_eff = cfg.num_layers + cfg.encoder_layers
    mu = 1
    while mu < bn:
        local_batch = max(1, shape.global_batch // mu // n_shards)
        stash = layers_eff * local_batch * seq_eff * cfg.d_model * 2
        if stash <= STASH_TARGET_BYTES:
            break
        mu *= 2
    return mu


def default_run(cfg, shape, mesh, **overrides) -> RunConfig:
    """The JAX package's RunConfig for a cell: one client group a data
    shard, microbatches by ``choose_microbatches``, blockwise attention
    past 2048 tokens (else auto), the ep dispatch for MoE serving where
    the experts divide 16, else dense. Overrides of MPSLConfig fields go
    to ``run.mpsl``, the rest to the RunConfig."""
    n_shards = n_data_shards(mesh)
    n_clients = n_shards
    bn = max(1, shape.global_batch // n_clients)
    mu = choose_microbatches(cfg, shape, n_shards, bn) \
        if shape.is_training else 1
    mp = MPSLConfig(n_clients=n_clients,
                    trainable_blocks=max(1, min(cfg.num_layers // 2, 24)))
    kw: Dict[str, Any] = dict(
        model=cfg, shape=shape, mpsl=mp,
        multi_pod="pod" in mesh.axis_names,
        microbatches=mu,
        attn_impl="blockwise" if shape.seq_len > 2048 else "auto",
        seq_shard_acts=bool(shape.is_training and cfg.d_model >= 8192),
        moe_impl="ep" if (cfg.moe and not shape.is_training
                          and cfg.moe.num_experts % 16 == 0) else "dense",
    )
    mp_fields = {f.name for f in dataclasses.fields(MPSLConfig)}
    mp_over = {k: v for k, v in overrides.items() if k in mp_fields}
    if mp_over:
        kw["mpsl"] = dataclasses.replace(mp, **mp_over)
    kw.update({k: v for k, v in overrides.items() if k not in mp_over})
    return RunConfig(**kw)


# ---------------------------------------------------------------------------
# Abstract inputs


def _meta(shape, dtype):
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg, run) -> Dict[str, torch.Tensor]:
    """The MPSL train batch of a cell as meta tensors: tokens and labels
    [N, Bn, S_text] int32, mask [N] f32, and the stub frontend's
    embeddings in the compute dtype (patches before the text for vlm,
    frames for audio)."""
    shape = run.shape
    n = run.mpsl.n_clients
    bn = shape.global_batch // n
    s = shape.seq_len
    batch = {"mask": _meta((n,), "float32")}
    s_text = s - VLM_PATCH_TOKENS if cfg.family == "vlm" else s
    batch["tokens"] = _meta((n, bn, s_text), "int32")
    batch["labels"] = _meta((n, bn, s_text), "int32")
    if cfg.family == "vlm":
        batch["patch_embeds"] = _meta((n, bn, VLM_PATCH_TOKENS, cfg.d_model),
                                      run.compute_dtype)
    elif cfg.family == "audio":
        batch["frame_embeds"] = _meta((n, bn, cfg.encoder_seq, cfg.d_model),
                                      run.compute_dtype)
    return batch


def abstract_train_state(cfg, run):
    """The train state of ``mpsl.init_state`` on the meta device: the
    MPSL params (trainable f32, frozen in ``run.frozen_dtype``), AdamW's
    moments and count, and the host step and seed."""
    params, frozen, _plan = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), cfg, run, device="meta")
    return {"params": params, "frozen": frozen, "opt": adamw_init(params),
            "step": 0, "rng": run.seed}


def state_specs(abstract_state, mesh):
    """Specs of a train state (the JAX ``state_shardings``:
    ``mpsl.state_shardings``); the count is replicated, the host step and
    seed have none."""
    return mpsl.state_shardings(abstract_state, mesh)


def shard_inputs(args, in_specs, dmesh=None):
    """This rank's shards of a builder's whole arguments (a tuple laid out
    as its in_specs), for the program `dmesh` (``collectives.Program``;
    the active one by default); the train state's params are made leaves
    that require grad."""
    out = tuple(sharding.shard_tree(a, sp, dmesh)
                for a, sp in zip(args, in_specs))
    for a in out:
        if isinstance(a, dict) and "params" in a and "opt" in a:
            for p in tree.leaves(a["params"]):
                p.requires_grad_(True)
    return out


# ---------------------------------------------------------------------------
# Train step (MPSL)


def build_train(cfg, run, mesh):
    """Returns (step_fn, abstract_state, abstract_batch, in_specs).
    step_fn(state, batch) -> (state, metrics) takes the batch as
    ``train_batch_specs`` lays it out (token ids int32 or int64)."""
    loss_fn = mpsl.make_lm_loss(cfg, run)
    sched = schedules.warmup_cosine(run.learning_rate, 100, 10_000)
    step_fn = mpsl.make_train_step(loss_fn, run, sched,
                                   backward_mode=run.mpsl.backward_mode,
                                   microbatches=run.microbatches)
    a_state = abstract_train_state(cfg, run)
    a_batch = train_batch_specs(cfg, run)
    in_specs = (state_specs(a_state, mesh),
                sharding.batch_specs(a_batch, mesh))
    return step_fn, a_state, a_batch, in_specs


# ---------------------------------------------------------------------------
# Serving (assembled model)


def abstract_serve_params(cfg, dtype="bfloat16"):
    """``M.init_lm``'s params on the meta device, floating leaves in
    `dtype`."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    params = M.init_lm(cfg, torch.Generator().manual_seed(0), device="meta")
    split._cast_in_place(params, dt)
    return params


def abstract_serve_cache(cfg, batch: int, cache_len: int,
                         dtype="bfloat16"):
    """The whole body cache on the meta device (made with no program
    active: under one, ``init_cache`` would make this rank's part)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    with collectives.program(None):
        return M.init_body_cache(cfg, batch, cache_len, dt, device="meta")


def abstract_cross_kv(cfg, batch: int, dtype="bfloat16"):
    """Per segment, None or the per-layer cross-attention K/V {"k", "v"
    [B, S_enc, K, hd], "pos" [B, S_enc] int32} (``compute_cross_kv``'s
    layout); None for an arch without an encoder."""
    if not cfg.encoder_layers:
        return None
    k, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    enc = cfg.encoder_seq
    return [[{"k": _meta((batch, enc, k, hd), dtype),
              "v": _meta((batch, enc, k, hd), dtype),
              "pos": _meta((batch, enc), "int32")}
             for _ in range(seg.count)] if seg.kind.cross else None
            for seg in M.body_segments(cfg)]


def cross_kv_specs(a_ckv, mesh):
    if a_ckv is None:
        return None
    # [B, S_enc, K, hd] / [B, S_enc]: batch on dim 0
    return sharding._map_with_path(
        lambda _p, leaf: sharding.resolve_spec(
            mesh, leaf.shape, ("batch",) + (None,) * (leaf.dim() - 1)),
        a_ckv)


def serve_cache_specs(a_cache, mesh, cfg=None):
    return sharding.cache_specs(
        a_cache, mesh, stacked=False,
        kv_heads=cfg.num_kv_heads if cfg is not None else None)


def _drop_fsdp(specs):
    """Replicate weights over the data axis (the TP-only serving layout):
    "data" leaves every entry of every spec."""
    def fix(spec):
        out = []
        for entry in spec:
            if entry == "data" or entry == ("data",):
                out.append(None)
            elif isinstance(entry, tuple):
                kept = tuple(a for a in entry if a != "data")
                out.append(kept if kept else None)
            else:
                out.append(entry)
        return tuple(out)
    return _map_specs(fix, specs)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def batch_specs_2d(batch, mesh):
    return {k: sharding.resolve_spec(
        mesh, v.shape, ("batch",) + (None,) * (v.dim() - 1))
        for k, v in batch.items()}


def build_decode(cfg, run, mesh):
    """One-token decode step over a seq_len KV / SSM cache. Returns
    (decode_fn, args, in_specs, out_specs); decode_fn(params, cache,
    cross_kv, tokens [B, 1], positions [B, 1] or [B, 3, 1]) -> (logits
    [B, 1, V], cache), the cache updated in place."""
    shape = run.shape
    b = shape.global_batch
    cache_len = shape.seq_len
    cdt = getattr(torch, run.compute_dtype)
    impls = mpsl.run_impls(run)

    @torch.no_grad()
    def decode_fn(params, cache, cross_kv, tokens, positions):
        flat_pos = positions[:, 0] if positions.dim() == 3 else positions
        h = M.embed_tokens(params, tokens, cfg, positions=flat_pos,
                           dtype=cdt)
        h, cache, _ = M.forward_body(
            params, h, cfg, positions=positions, cache=cache,
            cross_kv=cross_kv, impls=impls, remat=False)
        return M.lm_logits(params, h, cfg), cache

    a_params = abstract_serve_params(cfg, run.compute_dtype)
    param_sp = sharding.param_specs(a_params, mesh)
    if not run.serve_weights_fsdp:
        param_sp = _drop_fsdp(param_sp)
    a_cache = abstract_serve_cache(cfg, b, cache_len, run.compute_dtype)
    a_ckv = abstract_cross_kv(cfg, b, run.compute_dtype)
    a_pos = _meta((b, 3, 1) if cfg.pos_embed == "mrope" else (b, 1),
                  "int32")
    a_tok = _meta((b, 1), "int32")
    cache_sp = serve_cache_specs(a_cache, mesh, cfg)
    with sharding.use_mesh(mesh):
        logits_sp = sharding.resolve_spec(mesh, (b, 1, cfg.vocab_size),
                                          ("batch", None, "model"))
    in_specs = (param_sp, cache_sp, cross_kv_specs(a_ckv, mesh),
                sharding.resolve_spec(mesh, a_tok.shape, ("batch", None)),
                sharding.resolve_spec(mesh, a_pos.shape, ("batch",) + (None,)
                                      * (a_pos.dim() - 1)))
    out_specs = (logits_sp, cache_sp)
    args = (a_params, a_cache, a_ckv, a_tok, a_pos)
    return decode_fn, args, in_specs, out_specs


def build_prefill(cfg, run, mesh):
    """Full-sequence prefill producing the populated cache and the last
    position's logits. Returns (prefill_fn, (params, batch), in_specs);
    prefill_fn(params, batch) -> (logits [B, 1, V], cache). The vlm batch
    holds tokens [B, S - 256] and patch_embeds [B, 256, D]; audio adds
    frame_embeds [B, S_enc, D] (the encoder runs once, its cross K/V
    feeding every decoder layer)."""
    shape = run.shape
    b = shape.global_batch
    s = shape.seq_len
    cdt = getattr(torch, run.compute_dtype)
    impls = mpsl.run_impls(run)

    @torch.no_grad()
    def prefill_fn(params, batch):
        tokens = batch["tokens"]
        dev = tokens.device
        b = tokens.shape[0]                    # this rank's batch rows
        h = M.embed_tokens(params, tokens, cfg, dtype=cdt)
        n_patches = None
        if cfg.family == "vlm":
            n_patches = batch["patch_embeds"].shape[1]
            h = torch.cat([batch["patch_embeds"].to(cdt), h], dim=1)
        positions = layers.build_positions(cfg, b, s, n_patches, dev)
        cross_kv = None
        if cfg.family == "audio":
            enc_out = M.run_encoder(params, batch["frame_embeds"].to(cdt),
                                    cfg, impls=impls, remat=False)
            cross_kv = M.compute_cross_kv_stacked(params, enc_out, cfg)
        cache = M.init_body_cache(cfg, b, s, cdt, dev)
        h, cache, _ = M.forward_body(
            params, h, cfg, positions=positions, cache=cache,
            cross_kv=cross_kv, impls=impls, remat=False)
        return M.lm_logits(params, h[:, -1:], cfg), cache

    a_params = abstract_serve_params(cfg, run.compute_dtype)
    batch: Dict[str, Any] = {}
    if cfg.family == "vlm":
        batch["tokens"] = _meta((b, s - VLM_PATCH_TOKENS), "int32")
        batch["patch_embeds"] = _meta((b, VLM_PATCH_TOKENS, cfg.d_model),
                                      run.compute_dtype)
    else:
        batch["tokens"] = _meta((b, s), "int32")
        if cfg.family == "audio":
            batch["frame_embeds"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                          run.compute_dtype)
    in_specs = (sharding.param_specs(a_params, mesh),
                batch_specs_2d(batch, mesh))
    return prefill_fn, (a_params, batch), in_specs
