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
falcon-mamba-7b``) and hybrid (``--arch hymba-1.5b``) families serve.
Runs on
``cuda`` unless ``--device cpu`` is given (then the kernels' plain
versions run); without a card it raises rather than carry on on the CPU.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import layers, model as M

log = logging.getLogger("repro_torch.serve")


def resolve_device(name) -> torch.device:
    """The device to run on; a CUDA device must exist (no CPU fallback)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device='cpu') "
                           "to run the plain versions on the CPU")
    return device


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
            length = kv["k"].shape[1]
            if kv["index"] + n > length and (not span or length < span):
                raise ValueError(
                    f"the KV cache holds {length} positions and has "
                    f"{length - kv['index']} left; {n} more would evict "
                    f"entries still attended to (build_serving_fns' "
                    f"decode_slots sizes it)")


def build_serving_fns(cfg, compute_dtype=torch.float32, device="cuda",
                      attn_impl="kernel", ssm_impl="kernel",
                      moe_impl="ragged", decode_slots=512):
    """(prefill, decode) for `cfg`. The KV cache holds prompt +
    `decode_slots` slots (a sliding-window layer's, at most the window) in
    the compute dtype; prefill returns the last position's logits. decode
    updates the cache in place and returns it; ``decode.check_room(cache,
    n)`` raises if n more steps would write past a cache that cannot wrap
    (``check_cache_room``), and ``generate`` calls it once before its
    first step. attn_impl: "kernel" | "naive"; ssm_impl: "kernel" |
    "plain"; moe_impl: "ragged" | "dense"."""
    device = resolve_device(device)
    impls = {"attn": attn_impl, "ssm": ssm_impl, "moe": moe_impl}

    @torch.inference_mode()
    def prefill(params, tokens):
        b, s = tokens.shape
        cache = M.init_body_cache(cfg, b, s + decode_slots, compute_dtype,
                                  device)
        h = M.embed_tokens(params, tokens, cfg, dtype=compute_dtype)
        positions = layers.positions_from_shape(b, s, device=device)
        h, cache, _ = M.forward_body(params, h, cfg, positions=positions,
                                     cache=cache, impls=impls)
        logits = M.lm_logits(params, h[:, -1:], cfg)
        return logits, cache

    @torch.inference_mode()
    def decode(params, cache, tokens, positions):
        h = M.embed_tokens(params, tokens, cfg, positions=positions,
                           dtype=compute_dtype)
        h, cache, _ = M.forward_body(params, h, cfg, positions=positions,
                                     cache=cache, impls=impls)
        logits = M.lm_logits(params, h, cfg)
        return logits, cache

    decode.check_room = lambda cache, n: check_cache_room(cfg, cache, n)
    return prefill, decode


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(prefill, decode, params, tokens, steps: int,
             forced_tokens=None) -> dict:
    """Prefill `tokens` [B, S], then `steps` greedy decode steps.

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
    logits, cache = prefill(params, tokens)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    decode.check_room(cache, steps)

    all_logits = [logits[:, -1]]
    greedy = [logits[:, -1].argmax(dim=-1)]
    t0 = time.perf_counter()
    for i in range(steps):
        tok = greedy[-1] if forced_tokens is None else forced_tokens[:, i]
        pos = torch.full((b, 1), s + i, dtype=torch.int32, device=device)
        logits, cache = decode(params, cache, tok[:, None].to(torch.int64),
                               pos)
        all_logits.append(logits[:, -1])
        greedy.append(logits[:, -1].argmax(dim=-1))
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
                   help="append the run's summary as one JSON line here")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    device = resolve_device(args.device)
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
    out = generate(prefill, decode, params, tokens, args.decode_steps)

    t_prefill, t_decode = out["prefill_s"], out["decode_s"]
    summary = {"arch": cfg.name, "device": str(device), "batch": args.batch,
               "prompt_len": args.prompt_len,
               "decode_steps": args.decode_steps,
               "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
               "ms_per_tok": t_decode / max(1, args.decode_steps) * 1e3}
    log.info(f"batch={args.batch} prefill({args.prompt_len} tok)="
             f"{t_prefill*1e3:.1f}ms decode={args.decode_steps} steps in "
             f"{t_decode*1e3:.1f}ms ({summary['ms_per_tok']:.1f} ms/tok) "
             f"on {device}")
    log.info(f"sample generations (token ids): "
             f"{out['tokens'][:2, 1:].tolist()}")
    if args.obs_log:
        with open(args.obs_log, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
