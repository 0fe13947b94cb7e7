#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

1. card:    the card's name, power limit and count.
2. build:   every CUDA kernel of the serving path, built with nvcc from
            the sources in this checkout (``build/repro_torch/``).
3. kernels: each kernel against its plain PyTorch version on the card,
            at the serving path's shapes and at edge cases, in f32 and
            bf16; timed beside its plain version, its roofline bound and
            one PyTorch library call computing the same function.
4. serve:   the port's serving entry points at full-width minitron-4b
            (32 layers, d_model 3072, vocab 256000, random weights from a
            seed), f32, batch 4, prompt 512, 16 greedy decode steps. The
            launch counters must show that every layer's prefill and decode
            attention ran the kernel; logits must be finite and agree with
            the same prompts teacher-forced through the plain (naive)
            attention on the same params.
5. profile: device time by kernel over one prefill and a few decode
            steps (torch.profiler), and the device's busy share.

One JSON line per phase; then the {"kernels": [...]} line and the card's
``nvidia-smi`` line; the last line is {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; so does a machine without CUDA.

TF32 is turned off for matmuls and cuDNN, so every f32 product on both
sides of a comparison is full f32.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Imported before anything is printed: without the repo beside it, the
# script fails here and prints no result.
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

# Kernel vs plain version on the card. f32: both sum f32 products, in
# other orders. bf16: p is rounded to bf16 against different running
# maxima, and o is rounded to bf16 at the end.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Served logits, kernel path vs naive path, f32: 32 layers of f32 sums in
# other orders.
SERVE_TOL = 1e-3

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s by input type (f32 outside the tensor cores, bf16 inside them).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

SERVE = dict(arch="minitron-4b", batch=4, prompt_len=512, decode_steps=16,
             seed=0)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of one fn() call, by CUDA events over `iters`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    info = {"phase": "card", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "tf32": False}
    emit(info)
    return smi


def phase_build():
    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs),
          "ptxas": ptxas})


# ---------------------------------------------------------------------------
# kernels


def _attn_inputs(g, b, sq, sk, h, kh, hd, dtype, *, q_pos, k_pos, k_valid):
    dev = "cuda"
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, kh, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, kh, hd), generator=g, device=dev).to(dtype)
    return (q, k, v, q_pos.to(dev, torch.int32).contiguous(),
            k_pos.to(dev, torch.int32).contiguous(),
            k_valid.to(dev, torch.bool).contiguous())


def _attn_cases():
    """(name, shape dict, masks) of every case; `main_path` marks the
    shapes the serve phase gives the kernel."""
    b, s, h, kh, hd = 4, 512, 24, 8, 128
    ar = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    cache_len, filled = 1024, 513
    k_pos = torch.full((b, cache_len), -1, dtype=torch.int32)
    k_pos[:, :filled] = torch.arange(filled, dtype=torch.int32)
    cases = [
        ("prefill", dict(b=b, sq=s, sk=s, h=h, kh=kh, hd=hd), dict(
            q_pos=ar, k_pos=ar, k_valid=torch.ones(b, s, dtype=torch.bool),
            causal=True, window=0), True),
        ("decode", dict(b=b, sq=1, sk=cache_len, h=h, kh=kh, hd=hd), dict(
            q_pos=torch.full((b, 1), filled - 1, dtype=torch.int32),
            k_pos=k_pos, k_valid=k_pos >= 0, causal=True, window=0), True),
    ]
    w = torch.arange(300, dtype=torch.int32)[None].expand(2, 300)
    cases.append(("window", dict(b=2, sq=300, sk=300, h=8, kh=2, hd=64), dict(
        q_pos=w, k_pos=w, k_valid=torch.ones(2, 300, dtype=torch.bool),
        causal=True, window=100), False))
    g = torch.Generator().manual_seed(1)
    kv = torch.rand((2, 203), generator=g) < 0.8
    cases.append(("ragged", dict(b=2, sq=77, sk=203, h=6, kh=3, hd=96), dict(
        q_pos=torch.arange(126, 203, dtype=torch.int32)[None].expand(2, 77),
        k_pos=torch.arange(203, dtype=torch.int32)[None].expand(2, 203),
        k_valid=kv, causal=True, window=0), False))
    return cases


def _bound(q, k, q_pos, k_pos, k_valid, causal, window, dtype):
    """(ms, 'bytes' | 'operations'): the least time for this call's work.

    Operations: 4*hd FLOPs per (query head, key) pair the mask admits.
    Bytes: q, positions, validity, o and lse once, and the K/V rows of the
    keys that at least one query of their batch row attends."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    ok = fa.pair_mask(q_pos, k_pos, k_valid, causal, window)       # [b, sq, sk]
    flops = 4.0 * hd * h * ok.sum().item()
    keys_needed = ok.any(dim=1).sum().item()                  # over b, sk
    es = q.element_size()
    nbytes = (2 * q.numel() * es + b * h * sq * 4            # q, o, lse
              + 2 * keys_needed * kh * hd * es                # k, v
              + q_pos.numel() * 4 + k_pos.numel() * 4 + k_valid.numel())
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _library_call(q, k, v, k_valid, name):
    """One PyTorch call computing the same function (a yardstick only;
    the port never calls it), or None where none takes these masks."""
    if name not in ("prefill", "decode"):
        return None
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if name == "prefill":
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    mask = k_valid[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def phase_kernels():
    """Compare and time the flash-attention kernel; returns the kernel's
    report, filled in with the serve phase's launch count later."""

    g = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for name, shp, m, main_path in _attn_cases():
        for dtype in (torch.float32, torch.bfloat16):
            # four input sets, cycled, so timed launches find K/V cold in L2
            sets = [_attn_inputs(g, dtype=dtype, q_pos=m["q_pos"],
                                 k_pos=m["k_pos"], k_valid=m["k_valid"],
                                 **shp) for _ in range(4)]
            kw = dict(causal=m["causal"], window=m["window"])
            q, k, v, qp, kp, kv = sets[0]
            o, lse = fa.flash_attention_fwd(q, k, v, qp, kp, k_valid=kv,
                                            return_lse=True, **kw)
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, qp, kp,
                                                      k_valid=kv, **kw)
            tol = TOL[dtype]
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            bad = [n for n, a, r in (("o", o, o_ref), ("lse", lse, lse_ref))
                   if not torch.allclose(a.float(), r.float(), atol=tol,
                                         rtol=tol)]
            rec = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": shp, "main_path": main_path,
                   "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                   "tol": tol}
            if bad:
                emit({"phase": "kernels", **rec, "failed": bad})
                raise AssertionError(f"flash_attention_fwd {name} {dtype}: "
                                     f"{bad} disagree with the plain version")
            pick = itertools.cycle(sets).__next__

            def run_kernel():
                q, k, v, qp, kp, kv = pick()
                fa.flash_attention_fwd(q, k, v, qp, kp, k_valid=kv, **kw)

            def run_plain():
                q, k, v, qp, kp, kv = pick()
                fa.flash_attention_plain(q, k, v, qp, kp, k_valid=kv, **kw)

            rec["ms"] = time_ms(run_kernel)
            rec["plain_ms"] = time_ms(run_plain)
            lib = _library_call(q, k, v, kv, name)
            rec["library_ms"] = time_ms(lib) if lib else None
            rec["bound_ms"], rec["bound_by"] = _bound(
                q, k, qp, kp, kv, m["causal"], m["window"], dtype)
            emit({"phase": "kernels", **rec})
            results.append(rec)
    torch.cuda.empty_cache()
    # the line's headline numbers: the serve path's prefill shape, in f32
    head = next(r for r in results
                if r["case"] == "prefill" and r["dtype"] == "float32")
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:138",
        "launches": None,
        "max_abs_err": max(max(r["max_abs_err_o"], r["max_abs_err_lse"])
                           for r in results),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "cases": results,
    }


# ---------------------------------------------------------------------------
# serve


def phase_serve():
    """Drive the serving path at full width. Returns the kernel launches,
    and what the profile phase needs to drive the same path again."""
    cfg = get_config(SERVE["arch"])
    device = serve.resolve_device("cuda")
    gen = torch.Generator(device=device).manual_seed(SERVE["seed"])
    t0 = time.perf_counter()
    params = M.init_lm(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab_size,
                           (SERVE["batch"], SERVE["prompt_len"]),
                           generator=gen, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = SERVE["decode_steps"]
    prefill, decode = serve.build_serving_fns(cfg, torch.float32, device,
                                              attn_impl="kernel")
    # warm-up at the timed shapes: the allocator's and cuBLAS's first-use
    # costs for them would otherwise land in the timed prefill
    serve.generate(prefill, decode, params, tokens, 1)

    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    out = serve.generate(prefill, decode, params, tokens, steps)
    launches = fa.flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()

    want = cfg.num_layers * (1 + steps)
    if launches != want:
        raise AssertionError(f"flash kernel launched {launches} times in the "
                             f"serve run, expected {want}")
    logits = out["logits"]
    if logits.shape != (SERVE["batch"], steps + 1, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")

    p_naive, d_naive = serve.build_serving_fns(cfg, torch.float32, device,
                                               attn_impl="naive")
    ref = serve.generate(p_naive, d_naive, params, tokens, steps,
                         forced_tokens=out["tokens"][:, :steps])
    diff = (logits - ref["logits"]).abs().max().item()
    agree = (out["tokens"] == ref["tokens"]).float().mean().item()
    rec = {"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": cfg.param_count(), "dtype": "float32",
           "batch": SERVE["batch"], "prompt_len": SERVE["prompt_len"],
           "decode_steps": steps, "init_s": init_s,
           "kernel_launches": launches, "expected_launches": want,
           "prefill_ms": out["prefill_s"] * 1e3,
           "decode_ms_per_token": out["decode_s"] / steps * 1e3,
           "naive_prefill_ms": ref["prefill_s"] * 1e3,
           "naive_decode_ms_per_token": ref["decode_s"] / steps * 1e3,
           "peak_mem_bytes": peak,
           "max_logit_diff_vs_naive": diff, "tol": SERVE_TOL,
           "greedy_token_agreement": agree}
    emit(rec)
    if not torch.allclose(logits, ref["logits"], atol=SERVE_TOL,
                          rtol=SERVE_TOL):
        raise AssertionError(f"served logits differ from the naive path by "
                             f"{diff}")
    return launches, (cfg, prefill, decode, params, tokens, rec)


def _device_time_by_kernel(prof):
    """{kernel name: device ms} of the CUDA kernels a profile recorded."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key] = out.get(evt.key, 0.0) + \
                evt.self_device_time_total / 1e3
    return out


def phase_profile(cfg, prefill, decode, params, tokens, serve_rec,
                  steps=4, top=8):
    """Where the serve path's time goes: device time by kernel over one
    prefill and over `steps` decode steps (torch.profiler), and the
    device's busy share of the unprofiled host times of the serve phase."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    b, s = tokens.shape
    with profile(activities=acts) as prof:
        logits, cache = prefill(params, tokens)
        torch.cuda.synchronize()
    by_kernel = {"prefill": _device_time_by_kernel(prof)}
    tok = logits[:, -1].argmax(dim=-1)
    with profile(activities=acts) as prof:
        for i in range(steps):
            pos = torch.full((b, 1), s + i, dtype=torch.int32, device="cuda")
            logits, cache = decode(params, cache, tok[:, None], pos)
            tok = logits[:, -1].argmax(dim=-1)
        torch.cuda.synchronize()
    by_kernel["decode"] = {k: v / steps for k, v in
                           _device_time_by_kernel(prof).items()}
    wall = {"prefill": serve_rec["prefill_ms"],
            "decode": serve_rec["decode_ms_per_token"]}
    for part, times in by_kernel.items():
        busy = sum(times.values())
        ranked = sorted(times.items(), key=lambda kv: -kv[1])[:top]
        emit({"phase": "profile", "part": part,
              "per": "call" if part == "prefill" else "token",
              "device_busy_ms": busy, "host_ms_unprofiled": wall[part],
              "device_idle_share": max(0.0, 1 - busy / wall[part]),
              "top_kernels_ms": [[k[:90], v] for k, v in ranked]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    kernel = phase_kernels()
    kernel["launches"], served = phase_serve()
    phase_profile(*served)
    if not kernel["launches"]:
        raise AssertionError("a kernel of the serving path never launched")
    emit({"kernels": [kernel]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
