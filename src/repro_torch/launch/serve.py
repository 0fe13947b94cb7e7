"""Serving entry point: batched prefill + greedy decode of an (assembled) model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \
      --full --batch 4 --prompt-len 512 --decode-steps 16

Serves the post-training construction [F_C_agg ; F_S] (paper Sec. 3.3):
greedy decode over a batch of requests with a per-layer cache (KV for
attention, the state and conv history for Mamba), updated in place.
Attention runs the hand-written flash-attention kernel, prefill and
decode; a Mamba layer's prefill runs the selective-scan kernel seeded
with the cached state, its decode the O(1) recurrence step; an MoE
layer's experts run the ragged dispatch (one GEMM per active expert and
projection). The dense, MoE (``--arch qwen2-moe-a2.7b``), SSM (``--arch
falcon-mamba-7b``), hybrid (``--arch hymba-1.5b``), encoder-decoder
(``--arch whisper-tiny``: the prefill runs the encoder over the frames
once and keeps each decoder layer's cross-attention K/V beside its cache)
and VLM (``--arch qwen2-vl-72b``: patch embeddings before the text, M-RoPE
positions) families serve; the last two on seeded stub frames and patches
(``stub_embeds``), their frontends being stubs in the configs. Runs on
``cuda`` unless ``--device cpu`` is given (then the kernels' plain
versions run); without a card it raises rather than carry on on the CPU.

Several ranks (the SPMD program of ``parallel.collectives``):

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --device cpu \
      --arch hymba-1.5b

runs one process a rank on the host mesh (N, 1): each rank draws the
whole model and prompt from the seed and keeps its shards of the serving
layout (the requests split over `data`; in a world that
``launch.spmd.spawn`` started, on its mesh, weights on `model` too);
rank 0 alone logs.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.launch import spmd, steps
from repro_torch.models import attention, layers, model as M
from repro_torch.parallel import collectives, sharding


def resolve_device(name) -> torch.device:
    """The device to run on; a CUDA device must exist (no CPU fallback)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device='cpu') "
                           "to run the plain versions on the CPU")
    return device


def stub_embeds(cfg, lead, rng) -> dict:
    """The stub frontend's inputs for `lead` (e.g. (N, Bn) or (B,))
    sequences, f32, 0.02 x N(0, 1) from the numpy Generator `rng`:
    {"frame_embeds": [*lead, encoder_seq, D]} for audio, {"patch_embeds":
    [*lead, frontend_tokens, D]} for vlm, {} for any other family."""
    key, n = {"audio": ("frame_embeds", cfg.encoder_seq),
              "vlm": ("patch_embeds", cfg.frontend_tokens)}.get(
                  cfg.family, (None, 0))
    if key is None:
        return {}
    x = rng.standard_normal((*lead, n, cfg.d_model), dtype=np.float32)
    x *= np.float32(0.02)       # in place: no second buffer of the frames
    return {key: x}


def stub_inputs(cfg, batch: int, seed: int, device) -> dict:
    """``generate``'s frontend arguments for `batch` requests:
    ``stub_embeds`` drawn from `seed`, as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in stub_embeds(cfg, (batch,),
                                    np.random.default_rng(seed)).items()}


def check_cache_room(cfg, cache, n: int = 1) -> None:
    """Raise before `n` more tokens would overwrite a KV entry that some
    query may still attend to. A cache writes at index % length, so once
    full it evicts the entry `length` positions back: harmless where the
    layer's window is no longer than the cache (that entry is out of the
    window), wrong in a global layer or a window longer than its cache,
    which would then attend over a window it was not built with."""
    for seg, seg_cache in zip(M.body_segments(cfg), cache):
        kind = seg.kind
        if kind.family == "ssm":
            continue
        span = 0 if kind.is_global else (cfg.sliding_window or 0)
        for layer in seg_cache:
            kv = layer["kv"] if kind.family == "hybrid" else layer
            length = attention.cache_slots(kv)[1]    # every rank's slots
            if kv["index"] + n > length and (not span or length < span):
                raise ValueError(
                    f"the KV cache holds {length} positions and has "
                    f"{length - kv['index']} left; {n} more would evict "
                    f"entries still attended to (build_serving_fns' "
                    f"decode_slots sizes it)")


def _cross_kv(cfg, cache):
    """The cross-attention K/V that prefill kept beside each decoder
    layer's cache, per segment (None where the arch has none)."""
    if not cfg.encoder_layers:
        return None
    return [[layer["cross"] for layer in seg_cache] if seg.kind.cross
            else None
            for seg, seg_cache in zip(M.body_segments(cfg), cache)]


def build_serving_fns(cfg, compute_dtype=torch.float32, device="cuda",
                      attn_impl="kernel", ssm_impl="kernel",
                      moe_impl="ragged", decode_slots=512):
    """(prefill, decode) for `cfg`. The KV cache holds prompt +
    `decode_slots` slots (a sliding-window layer's, at most the window) in
    the compute dtype; ``prefill(params, tokens, frame_embeds=None,
    patch_embeds=None)`` returns the last position's logits and the
    cache. An audio arch needs `frame_embeds` [B, F, D]: prefill runs the
    encoder over them once and keeps each decoder layer's cross-attention
    K/V in its layer cache (under "cross"), so decode does no encoder
    work. A vlm prompt may lead with `patch_embeds` [B, P, D] (positions from
    ``layers.build_positions``). decode(params, cache, tokens, positions)
    updates the cache in place and returns it; ``decode.positions(b,
    s_text, n_patches, i)`` gives decode step i's positions after a prompt
    of s_text tokens behind n_patches patches (None: no patches), and
    ``decode.check_room(cache, n)`` raises if n more steps would write
    past a cache that cannot wrap (``check_cache_room``); ``generate``
    calls it once before its first step; ``decode.greedy(logits)`` is the
    greedy token (``M.greedy``). Under the SPMD program the params, the
    tokens and the cache are this rank's shards (batch on `data`, heads
    and vocab on `model`) and the logits its vocab shard. attn_impl: "kernel" | "naive";
    ssm_impl: "kernel" | "plain"; moe_impl: "ragged" | "dense"."""
    device = resolve_device(device)
    impls = {"attn": attn_impl, "ssm": ssm_impl, "moe": moe_impl}

    @torch.inference_mode()
    def prefill(params, tokens, frame_embeds=None, patch_embeds=None):
        if (frame_embeds is not None) != bool(cfg.encoder_layers):
            raise ValueError(f"{cfg.name}: frame embeddings are the input "
                             f"of an encoder-decoder arch, and only of one")
        if patch_embeds is not None and cfg.family != "vlm":
            raise ValueError(f"{cfg.name}: patch embeddings are a vlm input")
        h = M.embed_tokens(params, tokens, cfg, dtype=compute_dtype)
        n_patches = None
        if patch_embeds is not None:
            h = torch.cat([patch_embeds.to(compute_dtype), h], dim=1)
            n_patches = patch_embeds.shape[1]
        b, s = h.shape[:2]
        positions = layers.build_positions(cfg, b, s, n_patches, device)
        cache = M.init_body_cache(cfg, b, s + decode_slots, compute_dtype,
                                  device)
        cross_kv = None
        if frame_embeds is not None:
            enc_out = M.run_encoder(params, frame_embeds.to(compute_dtype),
                                    cfg, impls=impls)
            cross_kv = M.compute_cross_kv_stacked(params, enc_out, cfg)
            for seg_cache, seg_kv in zip(cache, cross_kv):
                for layer, kv in zip(seg_cache, seg_kv or ()):
                    layer["cross"] = kv
        h, cache, _ = M.forward_body(params, h, cfg, positions=positions,
                                     cache=cache, cross_kv=cross_kv,
                                     impls=impls)
        logits = M.lm_logits(params, h[:, -1:], cfg)
        return logits, cache

    @torch.inference_mode()
    def decode(params, cache, tokens, positions):
        flat = positions[:, 0] if positions.dim() == 3 else positions
        h = M.embed_tokens(params, tokens, cfg, positions=flat,
                           dtype=compute_dtype)
        h, cache, _ = M.forward_body(params, h, cfg, positions=positions,
                                     cache=cache,
                                     cross_kv=_cross_kv(cfg, cache),
                                     impls=impls)
        logits = M.lm_logits(params, h, cfg)
        return logits, cache

    def positions(b, s_text, n_patches, i):
        if n_patches is None:
            return torch.full((b, 1), s_text + i, dtype=torch.int32,
                              device=device)
        return torch.full((b, 3, 1), layers.text_start(n_patches) + s_text + i,
                          dtype=torch.int32, device=device)

    decode.positions = positions
    # the greedy token of (a rank's vocab shard of) the logits
    decode.greedy = lambda logits: M.greedy(logits, cfg)
    decode.check_room = lambda cache, n: check_cache_room(cfg, cache, n)
    return prefill, decode


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(prefill, decode, params, tokens, steps: int,
             forced_tokens=None, frame_embeds=None,
             patch_embeds=None) -> dict:
    """Prefill `tokens` [B, S] (with an encoder-decoder's `frame_embeds`,
    or a vlm's leading `patch_embeds`), then `steps` greedy decode steps.

    Returns {"tokens" [B, steps+1]: the greedy token after the prompt and
    after each decode step; "logits" [B, steps+1, V]: the logits they came
    from; "prefill_s", "decode_s": host seconds, each ending in a device
    sync}. With `forced_tokens` [B, steps], decode step i is fed
    forced_tokens[:, i] instead of the greedy token (teacher forcing).
    Raises after the prefill, before any decode step, if the cache has no
    room for `steps` (``decode.check_room``)."""
    device = tokens.device
    b, s = tokens.shape
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens, frame_embeds=frame_embeds,
                            patch_embeds=patch_embeds)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    decode.check_room(cache, steps)

    all_logits = [logits[:, -1]]
    greedy = [decode.greedy(logits[:, -1])]
    t0 = time.perf_counter()
    for i in range(steps):
        tok = greedy[-1] if forced_tokens is None else forced_tokens[:, i]
        pos = decode.positions(
            b, s, None if patch_embeds is None else patch_embeds.shape[1], i)
        logits, cache = decode(params, cache, tok[:, None].to(torch.int64),
                               pos)
        all_logits.append(logits[:, -1])
        greedy.append(decode.greedy(logits[:, -1]))
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.stack(greedy, dim=1),
            "logits": torch.stack(all_logits, dim=1),
            "prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="minitron-4b")
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false",
                   help="serve the published widths and depth")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--decode-steps", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--obs-log", default=None,
                   help="write a JSONL telemetry run log to this path "
                        "(render with `python -m repro_torch.obs.report`)")
    args = p.parse_args(argv)

    with spmd.world(resolve_device(args.device)) as (prog, device):
        return _main(args, device, prog)


def _main(args, device, prog):
    writer = prog is None or prog.rank == 0     # the log and run log
    log = obs.get_logger("serve")
    if args.obs_log and writer:
        obs.configure(args.obs_log,
                      meta={"driver": "serve", "arch": args.arch,
                            "batch": args.batch,
                            "prompt_len": args.prompt_len,
                            "decode_steps": args.decode_steps,
                            "device": str(device)})
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_lm(cfg, gen, device)
    # room for every requested step (the default 512 slots and more)
    prefill, decode = build_serving_fns(
        cfg, device=device, decode_slots=max(512, args.decode_steps))
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    stub = stub_inputs(cfg, args.batch, args.seed, device)
    if prog is not None:
        # every rank drew the whole model and batch from the seed; it keeps
        # its shards of the serving layout (weights on `model`, replicated
        # over `data`, which splits the requests)
        params = sharding.shard_tree(params, steps._drop_fsdp(
            sharding.param_specs(params, prog.mesh)))
        rows = lambda t: sharding.shard_leaf(t, sharding.resolve_spec(
            prog.mesh, t.shape, ("batch",) + (None,) * (t.dim() - 1)))
        tokens = rows(tokens)
        stub = {k: rows(v) for k, v in stub.items()}
    out = generate(prefill, decode, params, tokens, args.decode_steps,
                   **stub)
    if prog is not None:        # the requests back whole, as they lay
        out["tokens"] = sharding.gather_leaf(out["tokens"],
                                             collectives.spec_of(tokens))

    t_prefill, t_decode = out["prefill_s"], out["decode_s"]
    ms_per_tok = t_decode / max(1, args.decode_steps) * 1e3
    if not writer:
        return 0
    log.info(f"batch={args.batch} prefill({args.prompt_len} tok)="
             f"{t_prefill*1e3:.1f}ms decode={args.decode_steps} steps in "
             f"{t_decode*1e3:.1f}ms ({ms_per_tok:.1f} ms/tok) on {device}",
             prefill_ms=round(t_prefill * 1e3, 2),
             decode_ms=round(t_decode * 1e3, 2),
             ms_per_tok=round(ms_per_tok, 2))
    log.info(f"sample generations (token ids): "
             f"{out['tokens'][:2, 1:].tolist()}")
    if args.obs_log and writer:
        obs.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
