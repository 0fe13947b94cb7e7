#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

1. card:    the card's name, power limit and count.
2. build:   every CUDA kernel of the port, built with nvcc from the
            sources in this checkout (``build/repro_torch/``), one nvcc
            each, all started together; a ptxas spill past a source's
            limit (``SPILL_LIMITS``) fails the run.
3. kernels: each kernel against its plain PyTorch version on the card,
            at the main paths' shapes and at edge cases, in f32 and bf16;
            timed by device time (torch.profiler) beside its plain
            version, its roofline bound and one PyTorch library call
            computing the same function, where one does (each such call
            first held to the plain version). The f32 flash and CE
            kernels, whose products run on the tensor cores from bf16
            pieces, also record their gap to the route's plain model
            (``*_pieces``). quant8 is held bitwise in
            every route (nearest, streamed, in-kernel Philox) and timed
            with a cold L2 (a ring of distinct buffers).
4. moe_layer: one full-width MoE layer at a prefill's 2048 tokens and a
   decode step's 4, the ragged dispatch held to the dense one, each timed
   with its GEMM launches and the ragged dispatch's host sync.
5. the main paths, each driven through the port's entry points with
   every launch counter set to 0 just before and read just after; each
   must launch exactly the kernels its code calls, and agree with the
   same path through the plain versions on the same params:
   serve         full-width minitron-4b (32 layers, d_model 3072, vocab
                 256000), f32, batch 4, prompt 512, 16 greedy decode
                 steps: flash forward in every layer's prefill and decode;
   train         the MPSL LM train step at full-width minitron-4b (frozen
                 tree bf16, compute f32), 4 clients x 2 x 512 tokens, the
                 last 4 blocks trainable, block remat, int8 links: flash
                 forward and backward, the fused LM-head CE, quant8 (its
                 in-kernel Philox), 3 steps;
   ssm_serve     full-width falcon-mamba-7b (64 Mamba blocks, d_model
                 4096, d_inner 8192, d_state 16, vocab 65024), as serve:
                 the scan forward in every layer's prefill (decode is the
                 recurrence step, outside any kernel);
   ssm_train     falcon-mamba-7b, as train: the scan forward (block and
                 remat recompute) and backward in every block, 3 steps;
   hybrid_serve  full-width hymba-1.5b (32 hybrid blocks: parallel
                 attention, 25 heads / 5 KV heads, hd 64, window 1024 on
                 local layers, and Mamba heads), prompt 1536 (past the
                 window: local caches wrap their ring), 16 decode steps;
   hybrid_train  hymba-1.5b, as train, 2 steps;
   serve_bf16    minitron-4b as serve, at the JAX package's default bf16
                 compute: the tensor-core flash forward in prefill, its
                 split-KV route in decode;
   train_bf16    minitron-4b as train, RunConfig(compute_dtype="bfloat16"):
                 the tensor-core flash backward in every block, and the CE
                 kernels on the mixed pair (bf16 h, the f32 trainable head)
                 as it comes;
   moe_serve     full-width qwen2-moe-a2.7b (24 MoE blocks, d_model 2048,
                 16 heads on 16 KV heads, 60 experts top 4 and a shared
                 expert, vocab 151936), as serve: flash forward, the ragged
                 expert dispatch (cuBLAS GEMMs, no kernel of its own);
   moe_train     qwen2-moe-a2.7b as train, the last 2 blocks trainable
                 (4 would not fit 80 GB with the AdamW state), with the
                 router's aux loss in the MPSL loss.
   vit_train     the paper mode: full-width vit-base (12 bidirectional
                 blocks, d_model 768, 12 heads on 12 KV heads, hd 64),
                 every block trainable, 4 clients x 16 samples of the
                 synthetic (vision, text) task on Dirichlet(0.1) shards,
                 early fusion (77 + 197 = 274 tokens), int8 links, f32,
                 3 steps: the flash kernels' non-causal route at G 1 and
                 quant8 at a 768-wide link; then the post-training model
                 (the client tokenizers FedAvg-ed, the body assembled) on
                 the batch, kernel path against plain path;
   vit_train_bf16  vit_train at bf16 compute;
   vit_late      vision + audio + text, late fusion: three encoder passes
                 (197, 513, 77 tokens), each behind its own link, 2 steps;
   vit_retrieval vision + text, contrastive (two 512-wide projections),
                 two passes, 2 steps;
   vit_fedavg    FedAvg baseline rounds of the full model
                 (``core.baselines.make_fl_round``): 4 clients x 2 local
                 AdamW steps x 8 samples, 3 rounds from the same bank
                 (timed from the second), kernel attention against naive
                 (the mean loss and the averaged params' updates).
   encdec_serve  the encoder-decoder inputs: full-width whisper-tiny (4
                 encoder + 4 decoder layers, d_model 384, 6 heads on 6 KV
                 heads, hd 64, vocab 51865), f32, batch 4, 1500 stub
                 frames a request and whisper's long-form segment: 223
                 previous-text tokens and the 4-token start sequence, then
                 221 greedy steps to the 448-token context: the non-causal
                 flash forward in the encoder, causal self- and
                 cross-attention (227 queries on 1500 keys) in prefill,
                 the split-KV route over the self cache and over the
                 1500-key cross cache in decode;
   encdec_train  whisper-tiny, the MPSL step: 4 clients x 8 x 448 text
                 tokens (the published text context) and 1500 frames a
                 sample, every decoder block trainable, the frozen tree
                 (embedding, encoder) bf16: flash forward and backward in
                 the encoder (the frames' gradient reaches the client
                 adapters through it), self- and cross-attention; CE at D
                 384; quant8 at a 384-wide link;
   vlm_serve     qwen2-vl-72b at its published widths (d_model 8192, 64
                 heads on 8 KV heads, hd 128, d_ff 29568, vocab 152064,
                 qkv bias, M-RoPE sections (16, 24, 24)), depth cut to 18
                 of 80 layers (the most whose f32 weights one card holds
                 beside the plain path's run), f32, batch 4, 256 stub
                 patches and 256 text tokens, 16 decode steps:
                 flash at G 8 under M-RoPE positions (every patch at
                 temporal position 0, the text from 16);
   vlm_train     qwen2-vl-72b, 4 layers, the MPSL step: 4 clients x 2 x
                 (256 patches + 256 text tokens), the last block
                 trainable (two would need ~75 GB with the AdamW state and
                 the plain path's gradients); CE at D 8192, quant8 at an
                 8192-wide f32 link (the widest row held in registers).
   Each path's serve or train is followed by its profile: device time by
   kernel (torch.profiler) and the device's busy share. The MoE paths'
   plain versions (dense dispatch, naive attention) replay the kernel
   path's expert choices (``moe.routing_tape``), and the flips it counts
   must stay under ROUTING_FLIP_LIMIT of the routing decisions.

One JSON line per phase; then the {"kernels": [...]} line and the card's
``nvidia-smi`` line; the last line is {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; so does a machine without CUDA.

TF32 is turned off for matmuls and cuDNN, so every f32 product on both
sides of a comparison is full f32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Imported before anything is printed: without the repo beside it, the
# script fails here and prints no result.
from repro_torch import tree  # noqa: E402
from repro_torch.configs import (MPSLConfig, RunConfig, SHAPES,  # noqa: E402
                                 get_config)
from repro_torch.core import (aggregation, baselines, losses,  # noqa: E402
                              mpsl, split)
from repro_torch.data import (ClientLoader, SyntheticMultimodal,  # noqa: E402
                              SyntheticRetrieval, dirichlet_partition)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quant8 as q8  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels import softmax_xent as sx  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers, model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import tokenizers  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402

# Kernel vs plain version on the card. f32: both sum f32 products, in
# other orders. bf16: p is rounded to bf16 against different running
# maxima, and o is rounded to bf16 at the end.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Served logits, kernel path vs plain path (naive attention, the plain
# scan), f32: 32 to 64 layers of f32 sums in other orders.
SERVE_TOL = 1e-3
# The same at bf16 compute, relative to the largest |logit|: bf16's ulp is
# 2^-8, every layer's activations round to it on both paths, and the
# kernel rounds p against its running max where the plain path rounds the
# normalised softmax.
SERVE_TOL_BF16 = 2e-2
# Backward kernels vs plain versions, relative to the largest element of
# each output: f32 sums over up to 512 keys / 4088 tokens / 4096 vocab
# columns in other orders (1e-4); bf16 outputs round to bf16, one ulp is
# 2^-8 (2e-2).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Train step, kernel path vs plain path on the same params, batch and link
# uniforms, f32: the loss sums over 32-64 layers in other orders (1e-4
# relative); each trainable gradient leaf in relative L2 (1e-3): the same
# sums, and the int8 downlink quantizes a cut-layer cotangent that differs
# by float noise, so a few elements round to the neighbouring level.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# The same at bf16 compute: loss 1e-2 relative (bf16 activations through
# 32 layers, rounded at other points by the kernels and by autograd through
# the naive path); each gradient leaf 5e-2 in relative L2 (the backward
# kernel also rounds p and ds to bf16 before its products, and the plain
# path's autograd rounds dP and dS to bf16 in its own places).
TRAIN_LOSS_TOL_BF16 = 1e-2
TRAIN_GRAD_TOL_BF16 = 5e-2
# A FedAvg round, kernel vs naive attention, f32: each averaged leaf's
# update (from the clients' mean start) in relative L2. AdamW's steps are
# ~lr * sign(g), so an element whose gradient lies within the two paths'
# float noise of 0 may step the other way (2 lr a step): a share f of such
# elements gives ~2 sqrt(f). 1e-3, the CPU parity test's limit, admits f up
# to 2.5e-7; a wrong attention moves most elements (a gap near 1).
FEDAVG_UPDATE_TOL = 1e-3
# The MoE paths' plain versions replay the kernel path's expert choices. A
# token whose own top-k set differs there (a flip) is one whose k-th and
# next router probabilities lie within the two paths' float noise of each
# other, which few do; many flips mean that the router inputs really
# differ.
ROUTING_FLIP_LIMIT = 1e-3
# Scan kernels vs plain versions, relative to the largest element of each
# output, f32: one f32 recurrence in both, the kernel's a*h + bx fused into
# one FMA and its sums over d_state in another order; the rounding, a few
# ulp a step, is carried through up to 1536 steps of a decaying state
# (1e-4). bf16: y, dx and ddt round to bf16, one ulp is 2^-8 (2e-2).
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s by input type (f32 outside the tensor cores, bf16 inside them).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Exponentials on the SFU: 16 a clock an SM (sm_90's ex2 rate), 132 SMs at
# the 1.98 GHz boost clock.
PEAK_EXPS = 132 * 16 * 1.98e9

# The main paths, in the order they run. The paper's protocol fine-tunes
# the last k blocks; with all 32 of minitron-4b trainable the AdamW state
# alone would be ~54 GB (PERF.md).
SERVE = dict(arch="minitron-4b", batch=4, prompt_len=512, decode_steps=16,
             seed=0, compute_dtype="float32")
TRAIN = dict(arch="minitron-4b", n_clients=4, batch_per_client=2, seq=512,
             trainable_blocks=4, steps=3, lr=3e-4, seed=0,
             compute_dtype="float32")
# The paper mode: full-width vit-base (12 layers, d_model 768, 12 heads,
# hd 64, d_ff 3072), every block trainable (MPSLConfig's default), 4
# clients x 16 samples of the synthetic multimodal task on Dirichlet(0.1)
# shards, 10 classes, both links int8, f32 compute, frozen tree bf16,
# block remat. Early fusion (77 text + 197 vision tokens) unless the path
# says otherwise.
VIT = dict(arch="vit-base", n_clients=4, batch_per_client=16,
           modalities=("vision", "text"), task="classification",
           fusion="early", n_classes=10, trainable_blocks=-1, steps=3,
           lr=3e-4, seed=0, compute_dtype="float32")
PATHS = {
    "serve": SERVE,
    "train": TRAIN,
    "ssm_serve": dict(SERVE, arch="falcon-mamba-7b"),
    "ssm_train": dict(TRAIN, arch="falcon-mamba-7b"),
    "hybrid_serve": dict(SERVE, arch="hymba-1.5b", prompt_len=1536),
    "hybrid_train": dict(TRAIN, arch="hymba-1.5b", steps=2),
    "serve_bf16": dict(SERVE, compute_dtype="bfloat16"),
    "train_bf16": dict(TRAIN, compute_dtype="bfloat16"),
    "moe_serve": dict(SERVE, arch="qwen2-moe-a2.7b"),
    "moe_train": dict(TRAIN, arch="qwen2-moe-a2.7b", trainable_blocks=2),
    "vit_train": VIT,
    "vit_train_bf16": dict(VIT, compute_dtype="bfloat16"),
    "vit_late": dict(VIT, modalities=("vision", "audio", "text"),
                     fusion="late", steps=2),
    "vit_retrieval": dict(VIT, task="retrieval", steps=2),
    "vit_fedavg": dict(VIT, batch_per_client=8, local_steps=2, rounds=3),
    # the encoder-decoder and VLM inputs, on seeded stub frames and patches
    # (both frontends are stubs in the configs). whisper-tiny at full width
    # and depth, served as whisper decodes a segment of long-form audio: a
    # prompt of 223 previous-text tokens (n_text_ctx // 2 - 1) and the
    # 4-token start sequence, then greedy steps to the 448-token text
    # context; trained on 448 text tokens beside 1500 frames. qwen2-vl-72b
    # at its published widths, 256 patches before 256 text tokens, its
    # depth cut as deep as one card holds for each path (`reduced` says
    # why).
    "encdec_serve": dict(SERVE, arch="whisper-tiny", prompt_len=227,
                         decode_steps=221),
    "encdec_train": dict(TRAIN, arch="whisper-tiny", batch_per_client=8,
                         seq=448),
    "vlm_serve": dict(SERVE, arch="qwen2-vl-72b", layers=18, prompt_len=256,
                      reduced="depth only: f32 weights are 3.51 GB a layer "
                      "beside 9.97 GB of embedding and head; 18 layers "
                      "(73.2 GB) leave ~10 GB of the 85 GB card for the "
                      "caches, activations and the plain path's run; 20 "
                      "would not fit"),
    "vlm_train": dict(TRAIN, arch="qwen2-vl-72b", layers=4,
                      trainable_blocks=1,
                      reduced="depth only: the 72 B params exceed one 80 GB "
                      "card; at 4 layers the trainable block's f32 weights, "
                      "AdamW moments and both gradient sets, with the bf16 "
                      "frozen tree and remat activations, peak near 58 GB"),
}
# every path's plain version: naive attention, the plain scan, chunked CE,
# the dense expert dispatch
PLAIN_IMPLS = {"attn": "naive", "ssm": "plain", "ce": "plain", "moe": "dense"}


# The launch counter of every kernel wrapper: each adds one where it
# launches its kernel, and nowhere else.
COUNTERS = {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "softmax_xent_fwd": sx.softmax_xent_fwd,
            "softmax_xent_bwd": sx.softmax_xent_bwd,
            "quant_dequant": q8.quant_dequant,
            "selective_scan_fwd": ss.selective_scan_fwd,
            "selective_scan_bwd": ss.selective_scan_bwd}


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase line gets the script's elapsed s."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - T0)
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3) -> float:
    """Wall time of one fn() call, by CUDA events around `iters` calls
    back to back: where the host cannot enqueue a call as fast as the card
    runs it, this is the host's dispatch time."""
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


def device_ms_by_kernel(fn, iters=20, warmup=3) -> dict:
    """{kernel name: device ms a call} of one fn() call: the durations of
    the CUDA kernels its calls launched (torch.profiler), by name, divided
    by `iters`. Host dispatch is left out, so a call shorter than its
    Python wrapper is timed as the card runs it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):   # a profile that caught no kernel is taken again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = _device_time_by_kernel(prof)
        if sum(times.values()) > 0:
            return {k: v / iters for k, v in times.items()}
    raise AssertionError("torch.profiler recorded no device time for a call "
                         "that launches kernels")


def device_ms(fn, iters=20, warmup=3) -> float:
    """Device time of one fn() call: its kernels' durations, summed."""
    return sum(device_ms_by_kernel(fn, iters, warmup).values())


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


def _kernel_name(mangled: str) -> str:
    """A short readable form of a mangled kernel name, e.g.
    ``dkv::kernel<f32,128>``: its namespaces and its template arguments
    (float, __nv_bfloat16, and integer and bool values)."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    parts = []
    while s and s[0].isdigit():
        n = re.match(r"\d+", s).group()
        parts.append(s[len(n):len(n) + int(n)])
        s = s[len(n) + int(n):]
    name = "::".join(p for p in parts if not p.startswith("_GLOBAL"))
    if not s.startswith("I"):
        return name
    args, s = [], s[1:]
    while s and s[0] != "E":
        if s[0] == "f":
            args.append("f32")
            s = s[1:]
        elif s[0].isdigit() or s[0] == "S":       # a named type, or a
            m = re.match(r"(\d+)|S\d*_", s)       # repeat of one: bf16
            k = m.end() + (int(m.group(1)) if m.group(1) else 0)
            args.append("bf16")
            s = s[k:]
        elif s[0] == "L":
            m = re.match(r"L[a-z](\d+)E", s)
            args.append(m.group(1))
            s = s[m.end():]
        else:
            break
    return f"{name}<{','.join(args)}>"


def _spills(log: str, limit: int = 0) -> list:
    """The lines of nvcc's ``-Xptxas -v`` log that report a spill of more
    than `limit` bytes of stores, or loads where no store is allowed."""
    return [ln.strip() for ln in log.splitlines()
            if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                               r"loads", ln))
            and (int(m[1]) > limit or (limit == 0 and int(m[2])))]


def _ptxas_report(log: str) -> list:
    """One line per kernel of nvcc's ``-Xptxas -v`` log: registers, stack
    frame and spills."""
    out, name, frame = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, frame = _kernel_name(m.group(1)), ""
        elif "spill" in ln:
            frame = ln.strip()
        else:
            m = re.search(r"Used (\d+) registers", ln)
            if m and name:
                out.append(f"{name}: {m.group(1)} registers, {frame}")
                name = None
    return out


# the spill stores ptxas may report for one kernel of a source, in bytes
# (the build phase fails past them): none for the flash kernels and the CE
# GEMM (whose consumers hold a 64 x 256 f32 accumulator in 128 registers a
# thread); the scan forward's bf16 local pass at ds 16 spills 4 bytes, and
# the scan backward's ds-16 kernel 88 under its two-blocks-an-SM cap of 128
# registers (PERF.md); none for quant8, whose thread holds 16 words of its
# row under a cap of 128 registers (512-thread blocks): a spill there would
# put the row in local memory and read it from device memory twice
SPILL_LIMITS = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                "softmax_xent": 0, "quant8": 0, "selective_scan_fwd": 4,
                "selective_scan_bwd": 88}


def phase_build():
    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    spills = {name: _spills(logs[name], limit)
              for name, limit in SPILL_LIMITS.items()
              if name in logs and _spills(logs[name], limit)}
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs),
          "ptxas": {name: _ptxas_report(log) for name, log in logs.items()},
          "spills": spills})
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")


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
    """(name, shape dict, masks, main_path) of every case; `main_path`
    marks the shapes the serve and train phases give the kernels."""
    b, s, h, kh, hd = 4, 512, 24, 8, 128
    ar = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    cache_len, filled = 1024, 513
    k_pos = torch.full((b, cache_len), -1, dtype=torch.int32)
    k_pos[:, :filled] = torch.arange(filled, dtype=torch.int32)
    tr = torch.arange(s, dtype=torch.int32)[None].expand(8, s)
    cases = [
        ("prefill", dict(b=b, sq=s, sk=s, h=h, kh=kh, hd=hd), dict(
            q_pos=ar, k_pos=ar, k_valid=torch.ones(b, s, dtype=torch.bool),
            causal=True, window=0), True),
        ("train", dict(b=8, sq=s, sk=s, h=h, kh=kh, hd=hd), dict(
            q_pos=tr, k_pos=tr, k_valid=torch.ones(8, s, dtype=torch.bool),
            causal=True, window=0), True),
        ("decode", dict(b=b, sq=1, sk=cache_len, h=h, kh=kh, hd=hd), dict(
            q_pos=torch.full((b, 1), filled - 1, dtype=torch.int32),
            k_pos=k_pos, k_valid=k_pos >= 0, causal=True, window=0), True),
    ]
    w = torch.arange(300, dtype=torch.int32)[None].expand(2, 300)
    cases.append(("window", dict(b=2, sq=300, sk=300, h=8, kh=2, hd=64), dict(
        q_pos=w, k_pos=w, k_valid=torch.ones(2, 300, dtype=torch.bool),
        causal=True, window=100), False))
    # hymba-1.5b: G = 5, hd 64, window 1024; prefill past the window, the
    # train shape, and decode over a full local ring (positions 513..1536)
    hp = torch.arange(1536, dtype=torch.int32)[None].expand(b, 1536)
    cases.append(("hymba_prefill", dict(b=b, sq=1536, sk=1536, h=25, kh=5,
                                        hd=64), dict(
        q_pos=hp, k_pos=hp, k_valid=torch.ones(b, 1536, dtype=torch.bool),
        causal=True, window=1024), True))
    cases.append(("hymba_train", dict(b=8, sq=s, sk=s, h=25, kh=5, hd=64),
                  dict(q_pos=tr, k_pos=tr,
                       k_valid=torch.ones(8, s, dtype=torch.bool),
                       causal=True, window=1024), True))
    ring = (torch.arange(1024, dtype=torch.int32) + 512) % 1024 + 513
    cases.append(("hymba_decode", dict(b=b, sq=1, sk=1024, h=25, kh=5, hd=64),
                  dict(q_pos=torch.full((b, 1), 1536, dtype=torch.int32),
                       k_pos=ring[None].expand(b, 1024),
                       k_valid=torch.ones(b, 1024, dtype=torch.bool),
                       causal=True, window=1024), True))
    # qwen2-moe-a2.7b: 16 heads on 16 KV heads (G = 1), hd 128
    for name, bb in (("moe_prefill", b), ("moe_train", 8)):
        pp = torch.arange(s, dtype=torch.int32)[None].expand(bb, s)
        cases.append((name, dict(b=bb, sq=s, sk=s, h=16, kh=16, hd=hd), dict(
            q_pos=pp, k_pos=pp, k_valid=torch.ones(bb, s, dtype=torch.bool),
            causal=True, window=0), True))
    cases.append(("moe_decode", dict(b=b, sq=1, sk=cache_len, h=16, kh=16,
                                     hd=hd), dict(
        q_pos=torch.full((b, 1), filled - 1, dtype=torch.int32),
        k_pos=k_pos, k_valid=k_pos >= 0, causal=True, window=0), True))
    g = torch.Generator().manual_seed(1)
    kv = torch.rand((2, 203), generator=g) < 0.8
    cases.append(("ragged", dict(b=2, sq=77, sk=203, h=6, kh=3, hd=96), dict(
        q_pos=torch.arange(126, 203, dtype=torch.int32)[None].expand(2, 77),
        k_pos=torch.arange(203, dtype=torch.int32)[None].expand(2, 203),
        k_valid=kv, causal=True, window=0), False))
    # the split-KV route at a ragged Sk: two queries a row (6 rows a kv
    # head), hd 96, a fifth of the slots empty, and batch row 2 with no
    # valid key at all (o = 0, lse = 0)
    kv = torch.rand((3, 333), generator=g) < 0.8
    kv[2] = False
    cases.append(("ragged_decode", dict(b=3, sq=2, sk=333, h=12, kh=4, hd=96),
                  dict(q_pos=torch.tensor([[331, 332]] * 3, dtype=torch.int32),
                       k_pos=torch.arange(333, dtype=torch.int32)[None].expand(
                           3, 333),
                       k_valid=kv, causal=True, window=0), False))
    # vit-base (the paper mode): bidirectional, 12 heads on 12 KV heads
    # (G 1), hd 64; the early-fusion joint sequence (77 text + 197 vision
    # tokens) and late fusion's and retrieval's passes over 4 clients x 16
    # samples, and a FedAvg client's local step (8 samples, early fusion)
    for name, (bv, sv) in VIT_ATTN.items():
        vp = torch.arange(sv, dtype=torch.int32)[None].expand(bv, sv)
        cases.append((name, dict(b=bv, sq=sv, sk=sv, h=12, kh=12, hd=64),
                      dict(q_pos=vp, k_pos=vp,
                           k_valid=torch.ones(bv, sv, dtype=torch.bool),
                           causal=False, window=0), True))
    # whisper-tiny: 6 heads on 6 KV heads (G 1), hd 64, non-causal; the
    # encoder over 1500 frames and the cross-attention of 448 text queries
    # over them (encdec_train's 4 x 8 samples), and a decode step's query
    # over the 1500-key cross cache (encdec_serve, batch 4)
    fr = torch.arange(1500, dtype=torch.int32)
    wh = dict(h=6, kh=6, hd=64)
    for name, bw, sq, q_pos in (
            ("encdec_enc", 32, 1500, fr), ("encdec_cross", 32, 448,
                                           torch.arange(448)),
            ("encdec_cross_decode", 4, 1, torch.tensor([399]))):
        cases.append((name, dict(b=bw, sq=sq, sk=1500, **wh), dict(
            q_pos=q_pos.to(torch.int32)[None].expand(bw, sq),
            k_pos=fr[None].expand(bw, 1500),
            k_valid=torch.ones(bw, 1500, dtype=torch.bool), causal=False,
            window=0), True))
    # qwen2-vl-72b: 64 heads on 8 KV heads (G 8), hd 128, causal under
    # M-RoPE's row 0 (vlm_train's 4 x 2 samples): its 256 patches all at
    # temporal position 0, so they attend to each other both ways, and the
    # text from position 16
    vp = layers.build_positions(get_config("qwen2-vl-72b"), 8, 512, 256)[:, 0]
    cases.append(("vlm_train", dict(b=8, sq=512, sk=512, h=64, kh=8, hd=hd),
                  dict(q_pos=vp, k_pos=vp,
                       k_valid=torch.ones(8, 512, dtype=torch.bool),
                       causal=True, window=0), True))
    return cases


# the vit cases: (batch, sequence length); only the early-fusion joint
# sequence runs at bf16 compute on a main path (vit_train_bf16), the others
# f32 only
VIT_ATTN = {"vit_early": (64, 274), "vit_vision": (64, 197),
            "vit_text": (64, 77), "vit_audio": (64, 513),
            "vit_fedavg": (8, 274)}


# the cases where every query sees every key (no mask for SDPA)
ENCDEC_ATTN = ("encdec_enc", "encdec_cross", "encdec_cross_decode")
FULL_ATTN = (*VIT_ATTN, *ENCDEC_ATTN)
# the cases no bf16 path runs
F32_ONLY = (*(n for n in FULL_ATTN if n != "vit_early"), "vlm_train")


def _attn_dtypes(name):
    return (torch.float32,) if name in F32_ONLY else (torch.float32,
                                                      torch.bfloat16)


def _route(dtype, sq, h, kh):
    """The forward's route for a call: "split" (split-KV, CUDA cores),
    "pieces" (f32 tiled: bf16 pieces on the tensor cores) or "tc" (bf16
    tiled)."""
    if fa.uses_split(sq, h, kh):
        return "split"
    return "pieces" if dtype == torch.float32 else "tc"


def _attn_bound(flops_per_product, nbytes, dtype, route, backward):
    """(ms, bound_by, products, CUDA-core ms) of a flash call. Operations:
    a tiled route's bf16 products (``fa.route_products``) at the tensor
    cores' bf16 peak; the split-KV route's two products at its dtype's
    peak. Bytes: `nbytes` at the HBM rate. The last number bounds the same
    function's products (2, or 5 in the backward) as f32 on the CUDA
    cores, the f32 route's first design's ceiling (None off that route)."""
    n = 5 if backward else 2
    if route == "split":
        t_ops = n * flops_per_product / PEAK_FLOPS[dtype]
        products = n
    else:
        products = fa.route_products(dtype)[backward]
        t_ops = products * flops_per_product / PEAK_FLOPS[torch.bfloat16]
    t_bytes = nbytes / PEAK_BYTES
    cuda_core = None
    if route == "pieces":
        cuda_core = max(n * flops_per_product / PEAK_FLOPS[torch.float32],
                        t_bytes) * 1e3
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", products,
            cuda_core)


def _bound(q, k, q_pos, k_pos, k_valid, causal, window, dtype):
    """(ms, bound_by, products, CUDA-core ms): the least time for this
    call's work (``_attn_bound``).

    Operations: 2*hd FLOPs a product per (query head, key) pair the mask
    admits. Bytes: q, positions, validity, o and lse once, and the K/V
    rows of the keys that at least one query of their batch row attends."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    ok = fa.pair_mask(q_pos, k_pos, k_valid, causal, window)       # [b, sq, sk]
    keys_needed = ok.any(dim=1).sum().item()                  # over b, sk
    es = q.element_size()
    nbytes = (2 * q.numel() * es + b * h * sq * 4            # q, o, lse
              + 2 * keys_needed * kh * hd * es                # k, v
              + q_pos.numel() * 4 + k_pos.numel() * 4 + k_valid.numel())
    return _attn_bound(2.0 * hd * h * ok.sum().item(), nbytes, dtype,
                       _route(dtype, sq, h, kh), backward=False)


# the cases whose positions are 0..S-1 on both sides under a plain causal
# mask: SDPA takes them with is_causal; the vit cases attend every key
PLAIN_CAUSAL = ("prefill", "train", "moe_prefill", "moe_train")


def _sdpa_inputs(q, k, v, q_pos, k_pos, k_valid, causal, window, name):
    """SDPA's layout of q, k, v ([B, heads, S, hd]) and its keyword mask:
    is_causal where positions are 0..S-1 on both sides and the mask is
    plain causal, none where every query sees every key (the vit and
    whisper non-causal cases), else a boolean attn_mask [B, 1, Sq, Sk]
    from the kernel's own pair mask."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if name in PLAIN_CAUSAL:
        return qt, kt, vt, dict(is_causal=True, enable_gqa=True)
    if name in FULL_ATTN:
        return qt, kt, vt, dict(is_causal=False, enable_gqa=True)
    mask = fa.pair_mask(q_pos, k_pos, k_valid, causal, window)[:, None]
    return qt, kt, vt, dict(attn_mask=mask, enable_gqa=True)


def _library_call(q, k, v, q_pos, k_pos, k_valid, m, name):
    """One PyTorch call computing the same function (a yardstick only;
    the port never calls it) and its o [B, Sq, H, hd]: SDPA, with a
    boolean mask where the case is neither plain causal nor full."""
    qt, kt, vt, kw = _sdpa_inputs(q, k, v, q_pos, k_pos, k_valid,
                                  m["causal"], m["window"], name)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw) \
        .transpose(1, 2)


def _hold_yardstick(kernel, name, dtype, got, want, rows, tol):
    """A yardstick must compute the kernel's function: its o within `tol`
    of the plain version's on the rows that have a key (SDPA's softmax of
    a row with none is NaN where the TPU kernel's is 0)."""
    err = (got.float() - want.float())[rows].abs().max().item()
    if not (math.isfinite(err) and torch.allclose(
            got.float()[rows], want.float()[rows], atol=tol, rtol=tol)):
        raise AssertionError(f"{kernel} {name} {dtype}: the library "
                             f"yardstick differs from the plain version by "
                             f"{err}")
    return err


def kernels_flash_fwd():
    """Compare and time the flash-attention forward kernel; returns its
    report, filled in with the main paths' launch counts later."""

    g = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for name, shp, m, main_path in _attn_cases():
        for dtype in _attn_dtypes(name):
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
            route = _route(dtype, shp["sq"], shp["h"], shp["kh"])
            rec = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": shp, "main_path": main_path, "route": route,
                   "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                   "tol": tol}
            if bad:
                emit({"phase": "kernels", "kernel": "flash_attention_fwd",
                      **rec, "failed": bad})
                raise AssertionError(f"flash_attention_fwd {name} {dtype}: "
                                     f"{bad} disagree with the plain version")
            if route == "pieces":
                _rel_gaps(rec, zip(("o", "lse"), (o, lse),
                                   fa.flash_attention_fwd_pieces(
                                       q, k, v, qp, kp, k_valid=kv, **kw)))
            pick = itertools.cycle(sets).__next__

            def run_kernel():
                q, k, v, qp, kp, kv = pick()
                fa.flash_attention_fwd(q, k, v, qp, kp, k_valid=kv, **kw)

            def run_plain():
                q, k, v, qp, kp, kv = pick()
                fa.flash_attention_plain(q, k, v, qp, kp, k_valid=kv, **kw)

            rec["ms"] = device_ms(run_kernel)
            rec["wall_ms"] = time_ms(run_kernel)
            rec["plain_ms"] = device_ms(run_plain)
            lib = _library_call(q, k, v, qp, kp, kv, m, name)
            rows = fa.pair_mask(qp, kp, kv, m["causal"], m["window"]).any(-1)
            rec["library_max_abs_err_o"] = _hold_yardstick(
                "flash_attention_fwd", name, dtype, lib(), o_ref, rows, tol)
            rec["library_ms"] = device_ms(lib)
            rec["library_wall_ms"] = time_ms(lib)
            (rec["bound_ms"], rec["bound_by"], rec["bound_products"],
             rec["bound_f32_cuda_core_ms"]) = _bound(
                q, k, qp, kp, kv, m["causal"], m["window"], dtype)
            emit({"phase": "kernels", "kernel": "flash_attention_fwd", **rec})
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


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _check_close(kernel, case, dtype, pairs, tol, rec):
    """Each (name, kernel out, plain out): within tol of the plain output's
    largest element. Raises, after emitting the record, if not."""
    bad = []
    for name, got, want in pairs:
        err = _max_err(got, want)
        rec[f"max_abs_err_{name}"] = err
        scale = want.float().abs().max().item()
        rec[f"scale_{name}"] = scale
        if not math.isfinite(err) or err > tol * max(scale, 1e-30):
            bad.append(name)
    if bad:
        emit({"phase": "kernels", "kernel": kernel, **rec, "failed": bad})
        raise AssertionError(f"{kernel} {case} {dtype}: {bad} disagree with "
                             f"the plain version")


def _errs(rec):
    return max(v for k, v in rec.items() if k.startswith("max_abs_err"))


def _bwd_bound(q, k, q_pos, k_pos, k_valid, causal, window, dtype):
    """(ms, bound_by, products, CUDA-core ms) of the flash backward
    (``_attn_bound``): 2*hd FLOPs a product per (query head, admitted
    pair), five products (s, dp, dq, dk, dv); bytes: q, o, dO, dq once,
    lse, the positions and validity, and k, v, dk, dv of the keys some
    query sees."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    ok = fa.pair_mask(q_pos, k_pos, k_valid, causal, window)
    keys_needed = ok.any(dim=1).sum().item()
    es = q.element_size()
    nbytes = (4 * q.numel() * es + b * h * sq * 4
              + 4 * keys_needed * kh * hd * es
              + q_pos.numel() * 4 + k_pos.numel() * 4 + k_valid.numel())
    route = "pieces" if dtype == torch.float32 else "tc"
    return _attn_bound(2.0 * hd * h * ok.sum().item(), nbytes, dtype, route,
                       backward=True)


def kernels_flash_bwd():
    """Compare and time the flash-attention backward kernels (dq, dk/dv)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    results = []
    for name, shp, m, main_path in _attn_cases():
        if name.endswith(("prefill", "decode")):  # serve shapes: no backward
            continue
        for dtype in _attn_dtypes(name):
            q, k, v, qp, kp, kv = _attn_inputs(
                g, dtype=dtype, q_pos=m["q_pos"], k_pos=m["k_pos"],
                k_valid=m["k_valid"], **shp)
            kw = dict(causal=m["causal"], window=m["window"])
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            o, lse = fa.flash_attention_fwd(q, k, v, qp, kp, k_valid=kv,
                                            return_lse=True, **kw)
            args = (q, k, v, qp, kp, kv, o, lse, do)
            got = fa.flash_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_plain(*args, **kw)
            rec = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": shp, "main_path": main_path,
                   "route": "pieces" if dtype == torch.float32 else "tc",
                   "tol": GRAD_TOL[dtype]}
            _check_close("flash_attention_bwd", name, dtype,
                         zip(("dq", "dk", "dv"), got, want),
                         GRAD_TOL[dtype], rec)
            if dtype == torch.float32:
                _rel_gaps(rec, zip(("dq", "dk", "dv"), got,
                                   fa.flash_attention_bwd_pieces(*args,
                                                                 **kw)))
            del got
            # the dq and the dk/dv kernels apart, and together
            by = device_ms_by_kernel(
                lambda: fa.flash_attention_bwd(*args, **kw), iters=10)
            rec["ms_by_kernel"] = {
                re.sub(r"^void |\(anonymous namespace\)::|\(.*", "", n): ms
                for n, ms in by.items()}
            rec["ms"] = sum(by.values())
            rec["plain_ms"] = device_ms(
                lambda: fa.flash_attention_bwd_plain(*args, **kw), iters=5)
            # the backward of SDPA (a yardstick only), held to the plain
            # version first
            qt, kt, vt, skw = _sdpa_inputs(q, k, v, qp, kp, kv, m["causal"],
                                           m["window"], name)
            for t in (qt, kt, vt):
                t.requires_grad_()
            out = F.scaled_dot_product_attention(qt, kt, vt, **skw)
            dot = do.transpose(1, 2).contiguous()
            lib = torch.autograd.grad(out, (qt, kt, vt), dot,
                                      retain_graph=True)
            lrec = {}
            _check_close("flash_attention_bwd library", name, dtype,
                         zip(("dq", "dk", "dv"),
                             (x.transpose(1, 2) for x in lib), want),
                         GRAD_TOL[dtype], lrec)
            rec["library_max_abs_err"] = max(lrec[f"max_abs_err_{n}"]
                                             for n in ("dq", "dk", "dv"))
            del want, lib
            rec["library_ms"] = device_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), iters=10)
            del out, qt, kt, vt
            (rec["bound_ms"], rec["bound_by"], rec["bound_products"],
             rec["bound_f32_cuda_core_ms"]) = _bwd_bound(
                q, k, qp, kp, kv, m["causal"], m["window"], dtype)
            emit({"phase": "kernels", "kernel": "flash_attention_bwd", **rec})
            results.append(rec)
    torch.cuda.empty_cache()
    head = next(r for r in results
                if r["case"] == "train" and r["dtype"] == "float32")
    return _entry_of("flash_attention_bwd", "flash_attention_bwd.cu",
                     "src/repro/kernels/flash_attention.py:273", results,
                     head)


def _entry_of(name, source, replaces, results, head):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(_errs(r) for r in results),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"].split(",")[0],
            "library_ms": head["library_ms"], "cases": results}


def _ce_bound(t, d, v, h_dtype, w_dtype, backward):
    """(ms, bound_by, f32 CUDA-core ms) of one CE call. Operations: the
    route's bf16 products (``sx.products``), 2TDV FLOPs each, at the
    tensor cores' bf16 peak. Bytes: the bf16 pieces of h and w read once,
    labels (and lse, g) read once, loss and lse (or dh, dw) written once.
    The third number is the bound of the same work as f32 products on the
    CUDA cores (1 forward, 3 backward), the first design's ceiling."""
    products = sx.products(h_dtype, w_dtype)[backward]
    flop = 2.0 * t * d * v
    pieces = 2 * (sx.n_pieces(h_dtype) * t * d
                  + sx.n_pieces(w_dtype) * d * v)
    if backward:
        nbytes = (pieces + 3 * t * 4 + t * d * h_dtype.itemsize
                  + d * v * w_dtype.itemsize)
    else:
        nbytes = pieces + 3 * t * 4
    t_ops = products * flop / PEAK_FLOPS[torch.bfloat16]
    t_bytes = nbytes / PEAK_BYTES
    by = (f"operations, {products} bf16 products" if t_ops >= t_bytes
          else "bytes")
    cuda_core = (3 if backward else 1) * flop / PEAK_FLOPS[torch.float32]
    return max(t_ops, t_bytes) * 1e3, by, cuda_core * 1e3


def _rel_gaps(rec, pairs):
    """Each (name, kernel out, pieces-model out): the largest difference
    relative to the model's largest element, recorded (summation order
    only: the model forms the same bf16 products)."""
    for name, got, model in pairs:
        rec[f"rel_gap_vs_pieces_{name}"] = _max_err(got, model) / max(
            model.float().abs().max().item(), 1e-30)


def kernels_softmax_xent():
    """Compare and time the fused LM-head cross-entropy, forward and
    backward, at every train path's shape and dtype pair (T = 8 x 511
    tokens): minitron-4b in f32 and at bf16 compute (bf16 h, f32 head),
    falcon-mamba-7b, hymba-1.5b (V 32001: rows of unaligned stride),
    qwen2-moe-a2.7b (D 2048, V 151936), whisper-tiny (T 4 x 8 x 447, D
    384, V 51865) and qwen2-vl-72b (T 4 x 2 x 255 text tokens, D 8192, V
    152064); and a ragged small shape in f32, bf16 and the mixed pair.
    Each against the plain version (the oracle) and beside the split-bf16
    pieces model."""
    g = torch.Generator(device="cuda").manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("train", 4088, 3072, 256000, f32, f32, True),
             ("train_bf16", 4088, 3072, 256000, bf16, f32, True),
             ("ssm_train", 4088, 4096, 65024, f32, f32, True),
             ("hybrid_train", 4088, 1600, 32001, f32, f32, True),
             ("moe_train", 4088, 2048, 151936, f32, f32, True),
             ("encdec_train", 14304, 384, 51865, f32, f32, True),
             ("vlm_train", 2040, 8192, 152064, f32, f32, True),
             ("ragged", 1000, 200, 10007, f32, f32, False),
             ("ragged", 1000, 200, 10007, bf16, bf16, False),
             ("ragged", 1000, 200, 10007, bf16, f32, False)]
    fwd_res, bwd_res = [], []
    for name, t, d, v, h_dtype, w_dtype, main_path in cases:
        h = (torch.randn((t, d), generator=g, device="cuda")).to(h_dtype)
        w = (torch.randn((d, v), generator=g, device="cuda")
             * d ** -0.5).to(w_dtype)
        lab = torch.randint(0, v, (t,), generator=g, device="cuda",
                            dtype=torch.int32)
        gg = torch.randn((t,), generator=g, device="cuda") / t
        dtype = f"{str(h_dtype)[6:]}/{str(w_dtype)[6:]}"
        base = {"case": name, "dtype": dtype,
                "shape": dict(t=t, d=d, v=v), "main_path": main_path}
        iters = 3 if main_path else 10
        # the library call on the same function: one dtype for both
        lt = torch.promote_types(h_dtype, w_dtype)
        hl, wl = h.to(lt), w.to(lt)

        loss, lse = sx.softmax_xent_fwd(h, w, lab)
        torch.cuda.synchronize()
        want = sx.softmax_xent_fwd_plain(h, w, lab)
        rec = dict(base, tol=TOL[torch.float32])
        _check_close("softmax_xent_fwd", name, dtype,
                     zip(("loss", "lse"), (loss, lse), want),
                     TOL[torch.float32], rec)
        del want
        _rel_gaps(rec, zip(("loss", "lse"), (loss, lse),
                           sx.softmax_xent_fwd_pieces(h, w, lab)))
        rec["ms"] = device_ms(lambda: sx.softmax_xent_fwd(h, w, lab),
                              iters=iters, warmup=1)
        rec["plain_ms"] = device_ms(
            lambda: sx.softmax_xent_fwd_plain(h, w, lab), iters=iters,
            warmup=1)
        rec["library_ms"] = device_ms(lambda: F.cross_entropy(
            hl @ wl, lab.long(), reduction="none"), iters=iters, warmup=1)
        rec["bound_ms"], rec["bound_by"], rec["bound_f32_cuda_core_ms"] = \
            _ce_bound(t, d, v, h_dtype, w_dtype, backward=False)
        _hold_to_bound("softmax_xent_fwd", rec)
        emit({"phase": "kernels", "kernel": "softmax_xent_fwd", **rec})
        fwd_res.append(rec)

        dh, dw = sx.softmax_xent_bwd(h, w, lab, lse, gg)
        torch.cuda.synchronize()
        want_dh, want_dw = sx.softmax_xent_bwd_plain(h, w, lab, lse, gg)
        # each output in its own dtype's tolerance
        rec = dict(base, tol_dh=GRAD_TOL[h_dtype], tol_dw=GRAD_TOL[w_dtype])
        _check_close("softmax_xent_bwd", name, dtype,
                     [("dh", dh, want_dh)], GRAD_TOL[h_dtype], rec)
        _check_close("softmax_xent_bwd", name, dtype,
                     [("dw", dw, want_dw)], GRAD_TOL[w_dtype], rec)
        del want_dh, want_dw
        _rel_gaps(rec, zip(("dh", "dw"), (dh, dw),
                           sx.softmax_xent_bwd_pieces(h, w, lab, lse, gg)))
        del dh, dw
        rec["ms"] = device_ms(lambda: sx.softmax_xent_bwd(h, w, lab, lse, gg),
                              iters=iters, warmup=1)
        rec["plain_ms"] = device_ms(
            lambda: sx.softmax_xent_bwd_plain(h, w, lab, lse, gg),
            iters=iters, warmup=1)
        hg, wg = hl.clone().requires_grad_(), wl.clone().requires_grad_()
        lib = F.cross_entropy(hg @ wg, lab.long(), reduction="none")
        rec["library_ms"] = device_ms(lambda: torch.autograd.grad(
            lib, (hg, wg), gg, retain_graph=True), iters=iters, warmup=1)
        del lib, hg, wg
        rec["bound_ms"], rec["bound_by"], rec["bound_f32_cuda_core_ms"] = \
            _ce_bound(t, d, v, h_dtype, w_dtype, backward=True)
        _hold_to_bound("softmax_xent_bwd", rec)
        emit({"phase": "kernels", "kernel": "softmax_xent_bwd", **rec})
        bwd_res.append(rec)
        del h, w, hl, wl
        torch.cuda.empty_cache()
    return [_entry_of(kname, "softmax_xent.cu",
                      f"src/repro/kernels/softmax_xent.py:{line}", res,
                      res[0])
            for kname, line, res in (("softmax_xent_fwd", 131, fwd_res),
                                     ("softmax_xent_bwd", 170, bwd_res))]


def _hold_to_bound(kernel, rec):
    """A kernel never runs faster than the least time the card could take:
    a time under its bound means a wrong bound or a wrong timing."""
    if not rec["ms"] >= rec["bound_ms"]:
        emit({"phase": "kernels", "kernel": kernel, **rec, "failed": "bound"})
        raise AssertionError(f"{kernel} {rec['case']} {rec['dtype']}: "
                             f"{rec['ms']} ms is under its bound "
                             f"{rec['bound_ms']} ms")


# quant8's cases: (case, rows, d, dtype, route, offset). The train paths'
# links (4096 token rows: 4 clients x 2 x 512) at each path's width; rows
# wider than the register route holds in f32 (8192) and near it in bf16
# (nemotron-4-15b's 6144, command-r-plus-104b's 12288); and edges: a
# ragged d, an x one element off 16-byte alignment (both on the scalar
# route), short rows (d < 32, blocks shared by rows, a row count that
# fills no whole block), and the two-read route in bf16 vectors and f32
# scalars. route: "vector" or "scalar", as the wrapper must pick it.
QUANT8_CASES = [
    ("hybrid_train", 4096, 1600, torch.float32, "vector", 0),
    ("moe_train", 4096, 2048, torch.float32, "vector", 0),
    ("train", 4096, 3072, torch.float32, "vector", 0),
    ("ssm_train", 4096, 4096, torch.float32, "vector", 0),
    ("train_bf16", 4096, 3072, torch.bfloat16, "vector", 0),
    *[("wide", 4096, d, dt, "vector", 0) for d in (6144, 12288)
      for dt in (torch.float32, torch.bfloat16)],
    *[(name, rows, d, dt, "scalar", off)
      for name, rows, d, off in (("ragged", 4096, 1001, 0),
                                 ("misaligned", 4096, 3072, 1))
      for dt in (torch.float32, torch.bfloat16)],
    *[("short_rows", 1001, 24, dt, "vector", 0)
      for dt in (torch.float32, torch.bfloat16)],
    ("two_reads", 512, 20480, torch.bfloat16, "vector", 0),
    ("two_reads", 512, 10001, torch.float32, "scalar", 0),
    # vit-base's links: 4 clients x 16 samples x 274 tokens (early
    # fusion), and the 197-, 513- and 77-token passes of late fusion (the
    # vision and text ones also retrieval's)
    ("vit_train", 17536, 768, torch.float32, "vector", 0),
    ("vit_train_bf16", 17536, 768, torch.bfloat16, "vector", 0),
    *[("vit_late", 64 * s, 768, torch.float32, "vector", 0)
      for s in (197, 513, 77)],
    # whisper-tiny's link (4 x 8 x 448 text tokens, d 384) and qwen2-vl's
    # (4 x 2 x 512, d 8192 f32: the widest row the register route holds)
    ("encdec_train", 14336, 384, torch.float32, "vector", 0),
    ("vlm_train", 4096, 8192, torch.float32, "vector", 0),
]
# distinct buffers a timed ring holds (x, u, y): 4 x the H100's 50 MB L2
RING_BYTES = 200e6


def _quant8_input(g, rows, d, dtype, offset):
    """x [rows, d]: normal values scaled by 0.1..3 along the row; with an
    offset, a contiguous view that many elements into its buffer."""
    x = (torch.randn((rows, d), generator=g, device="cuda")
         * torch.linspace(0.1, 3.0, d, device="cuda")).to(dtype)
    if not offset:
        return x
    buf = torch.empty(rows * d + offset, dtype=dtype, device="cuda")
    view = buf[offset:].view(rows, d)
    view.copy_(x)
    return view


def _hold_quant8_bits(rec, x, u):
    """Each route bitwise equal to the plain version: nearest, streamed u,
    and the in-kernel Philox against the plain Philox, from two generators
    in the same state; then the Philox route's range and unbiasedness over
    64 draws (a stream that is reproducible but wrong passes the bitwise
    check alone)."""
    routes = {"nearest": (q8.quant_dequant(x), q8.quant_dequant_plain(x)),
              "streamed": (q8.quant_dequant(x, u),
                           q8.quant_dequant_plain(x, u))}
    ga = torch.Generator(device="cuda").manual_seed(41)
    gb = torch.Generator(device="cuda").manual_seed(41)
    routes["philox"] = (q8.quant_dequant(x, ga), q8.quant_dequant_plain(x, gb))
    bits = torch.int32 if x.dtype == torch.float32 else torch.int16
    for route, (got, want) in routes.items():
        rec[f"max_abs_err_{route}"] = _max_err(got, want)
        rec[f"bitwise_{route}"] = torch.equal(got.view(bits), want.view(bits))
    del routes
    gen = torch.Generator(device="cuda").manual_seed(4)
    scale = x.float().abs().amax(-1, keepdim=True) / 127
    # one draw lands on one of the two levels around x, less than a level
    # away; in bf16 that value is rounded to bf16 after, by up to 2^-8 of
    # its size (|x| + a level)
    slack = scale if x.dtype == torch.float32 else \
        scale + (x.float().abs() + scale) * 2 ** -8
    slack = slack * (1 + 1e-5)
    mean = torch.zeros(x.shape, device="cuda")
    in_range = True
    for _ in range(64):
        y = q8.quant_dequant(x, gen).float()
        in_range &= bool(((y - x.float()).abs() <= slack).all())
        mean += y / 64
    torch.cuda.synchronize()
    rec["philox_in_range"] = in_range
    ok = in_range and all(rec[f"bitwise_{r}"]
                          for r in ("nearest", "streamed", "philox"))
    if x.dtype == torch.float32:
        # a draw errs by less than a level and on average by nothing: the
        # mean of 64 draws spreads by at most 1/16 of a level
        err = (mean - x.float()) / scale
        rec["philox_mean_abs_err_levels"] = err.abs().mean().item()
        rec["philox_mean_err_levels"] = err.mean().item()
        ok = (ok and rec["philox_mean_abs_err_levels"] < 0.1
              and abs(rec["philox_mean_err_levels"]) < 0.01)
    if not ok:
        emit({"phase": "kernels", "kernel": "quant_dequant", **rec,
              "failed": True})
        raise AssertionError(f"quant_dequant {rec['case']} {rec['shape']} "
                             f"{rec['dtype']}: differs from the plain "
                             f"version, leaves its range or is biased")


def _ring_ms(fn, xs, us, rng, iters):
    """{kernel name: device ms a call} of fn(x, rng(u)), every call on
    the next (x, u) of the ring and writing a y of its own (each output is
    kept until the window ends), so no call finds its buffers in L2."""
    ring, keep = itertools.cycle(range(len(xs))), []

    def call():
        i = next(ring)
        keep.append(fn(xs[i], rng(us[i])))

    times = device_ms_by_kernel(call, iters=iters, warmup=len(xs))
    keep.clear()
    return times


def kernels_quant8():
    """Compare and time quant8 at every train path's link shape, at wide
    rows and at edges (``QUANT8_CASES``). Every case holds all three
    routes bitwise to the plain version (``_hold_quant8_bits``). Timed
    with a cold L2: each call takes the next x and u of a ring of distinct
    buffers, x, u and the outputs together at least RING_BYTES (4 x the
    50 MB L2), so no call finds its input in L2. The kernel's time is its
    own kernels' device time (named ``quant8::kernel``); the Philox
    route's whole call adds the seed's ``torch.randint`` kernel
    (``ms_call``). Each route is held to its own bytes bound: nearest and
    Philox x in, y out; streamed u in as well."""
    g = torch.Generator(device="cuda").manual_seed(3)
    results = []
    for name, rows, d, dtype, route, offset in QUANT8_CASES:
        xb = rows * d * dtype.itemsize
        n_sets = max(2, math.ceil(RING_BYTES / (2 * xb + rows * d * 4)))
        xs = [_quant8_input(g, rows, d, dtype, offset)
              for _ in range(n_sets)]
        us = [torch.rand((rows, d), generator=g, device="cuda")
              for _ in range(n_sets)]
        rec = {"case": name, "dtype": str(dtype).split(".")[-1],
               "shape": [rows, d], "route": route,
               "main_path": name in PATHS, "ring_sets": n_sets}
        if q8.vector_route(xs[0], us[0]) != (route == "vector"):
            raise AssertionError(f"quant_dequant {name} {d} {dtype}: the "
                                 f"wrapper does not take the {route} route")
        _hold_quant8_bits(rec, xs[0], us[0])
        gen = torch.Generator(device="cuda").manual_seed(5)
        rngs = {"nearest": lambda u: None, "streamed": lambda u: u,
                "philox": lambda u: gen}
        iters = 20
        for r, rng in rngs.items():
            times = _ring_ms(q8.quant_dequant, xs, us, rng, iters)
            own = {k: v for k, v in times.items() if "quant8" in k}
            rec[f"ms_{r}"] = sum(own.values())
            rec[f"kernels_{r}"] = sorted(own)
            if r == "philox":
                rec["ms_call"] = sum(times.values())
            rec[f"plain_ms_{r}"] = sum(_ring_ms(
                q8.quant_dequant_plain, xs, us, rng, 5).values())
        rec["library_ms"] = None    # no single PyTorch call computes it
        io = 2 * xb / PEAK_BYTES * 1e3              # x in, y out
        rec["bound_ms_nearest"] = rec["bound_ms_philox"] = io
        rec["bound_ms_streamed"] = io + rows * d * 4 / PEAK_BYTES * 1e3
        for r in rngs:
            _hold_to_bound("quant_dequant", {
                "case": f"{name} ({r})", "dtype": rec["dtype"],
                "ms": rec[f"ms_{r}"], "bound_ms": rec[f"bound_ms_{r}"]})
        # the train paths' route: the in-kernel Philox
        rec["ms"], rec["plain_ms"] = rec["ms_philox"], rec["plain_ms_philox"]
        rec["bound_ms"], rec["bound_by"] = io, "bytes"
        rec["share_of_bound_rate"] = io / rec["ms"]
        emit({"phase": "kernels", "kernel": "quant_dequant", **rec})
        results.append(rec)
        del xs, us
        torch.cuda.empty_cache()
    head = next(r for r in results if r["case"] == "train")
    return _entry_of("quant_dequant", "quant8.cu",
                     "src/repro/kernels/quant8.py:63", results, head)


def _scan_cases():
    """(name, b, s, di, ds, chunk, ref_chunk, dtype, h0, main_path): the
    train shapes of falcon-mamba-7b and hymba-1.5b, their serve prefills
    (with a nonzero h0), ragged S and d, d_state 4, and bf16 inputs. The
    main paths' cases run at the chunk the kernel path checkpoints at
    (``ss.kernel_chunk`` of the default 256); the ragged case keeps 256, so
    the backward walks to a later piece's entry. ref_chunk is the chunk
    whose residual the function must keep, for the bound: the JAX
    package's and the plain path's 256 where the kernel path takes a finer
    one, whose extra checkpoints are the design's cost."""
    f32, bf16 = torch.float32, torch.bfloat16
    ck = ss.kernel_chunk(256)
    return [("train", 8, 512, 8192, 16, ck, 256, f32, False, True),
            ("prefill", 4, 512, 8192, 16, ck, 256, f32, True, True),
            ("hymba_train", 8, 512, 3200, 16, ck, 256, f32, False, True),
            ("hymba_prefill", 4, 1536, 3200, 16, ck, 256, f32, True, True),
            ("ragged", 2, 300, 1000, 16, 256, 256, f32, True, False),
            ("ds4", 2, 200, 512, 4, 64, 64, f32, True, False),
            ("train", 8, 512, 8192, 16, ck, 256, bf16, False, False)]


def _scan_inputs(g, b, s, di, ds, dtype, with_h0):
    dev = "cuda"
    x = (torch.randn((b, s, di), generator=g, device=dev) * 0.5).to(dtype)
    dt = (F.softplus(torch.randn((b, s, di), generator=g, device=dev))
          * 0.1).to(dtype)
    bm = torch.randn((b, s, ds), generator=g, device=dev).to(dtype)
    cm = torch.randn((b, s, ds), generator=g, device=dev).to(dtype)
    a_log = torch.log(torch.randn((di, ds), generator=g, device=dev).abs()
                      + 0.5)
    h0 = (torch.randn((b, di, ds), generator=g, device=dev) * 0.3
          if with_h0 else None)
    return x, dt, bm, cm, a_log, h0


def _scan_bound(b, s, di, ds, nc, es, with_h0, backward):
    """(ms, bound_by) of one scan call: the largest of three limits. Bytes:
    each input read once, each output written once. Operations per (b, t,
    d, s) state-step: forward 6 (dt*A, exp, a*h + bx, bx, the y term);
    backward 22 (the forward's 4 to recompute the state, then lam, a, the
    sb and dt-sum terms, dadt, the dA_log term, the db and dc terms and the
    carry), at the f32 peak. Exponentials: one a state-step, the least
    either direction needs, at the SFU's rate (PEAK_EXPS)."""
    act = b * s * di * es                   # one [B, S, di] tensor
    bc = b * s * ds * es                    # one [B, S, ds] tensor
    st = b * di * ds * 4                    # one [B, di, ds] f32 state
    if backward:
        # x, dt, gy in; dx, ddt out; B, C in; db, dc out (f32); a_log in,
        # dA_log out; h_ckpt and gh in, dh0 out
        nbytes = (5 * act + 2 * bc + 2 * b * s * ds * 4 + 2 * di * ds * 4
                  + b * nc * di * ds * 4 + 2 * st)
        flops = 22.0 * b * s * di * ds
    else:
        # x, dt in, y out; B, C, a_log (and h0) in; h_final, h_ckpt out
        nbytes = (3 * act + 2 * bc + di * ds * 4 + (st if with_h0 else 0)
                  + st + b * nc * di * ds * 4)
        flops = 6.0 * b * s * di * ds
    limits = {"operations": flops / PEAK_FLOPS[torch.float32],
              "bytes": nbytes / PEAK_BYTES,
              "exps": b * s * di * ds / PEAK_EXPS}
    by = max(limits, key=limits.get)
    return limits[by] * 1e3, by


def _hold_bitwise(kernel, case, dtype, fn, rec):
    """Two calls on the same inputs give the same bits (no atomics, no
    order that depends on how the blocks run)."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    rec["bitwise_repeat"] = all(torch.equal(a, b)
                                for a, b in zip(first, second))
    if not rec["bitwise_repeat"]:
        emit({"phase": "kernels", "kernel": kernel, **rec,
              "failed": "bitwise"})
        raise AssertionError(f"{kernel} {case} {dtype}: two calls on the "
                             f"same inputs differ")


def kernels_scan():
    """Compare and time the selective-scan forward (y, h_final, h_ckpt)
    and backward (every output) against their plain versions, and hold
    each to bitwise repeatability."""
    g = torch.Generator(device="cuda").manual_seed(5)
    fwd_res, bwd_res = [], []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (name, b, s, di, ds, chunk, ref_chunk, dtype, with_h0,
         main) in _scan_cases():
        x, dt, bm, cm, a_log, h0 = _scan_inputs(g, b, s, di, ds, dtype,
                                                with_h0)
        nc, nc_ref = -(-s // chunk), -(-s // ref_chunk)
        base = {"case": name, "dtype": str(dtype).split(".")[-1],
                "shape": dict(b=b, s=s, di=di, ds=ds, chunk=chunk,
                              ref_chunk=ref_chunk, h0=with_h0),
                "main_path": main}
        tol = SCAN_TOL[dtype]
        # a profile window of several ms: the card's clock, lowered while
        # the profiler starts, is back at its boost for most of it
        iters = 50

        def fwd():
            return ss.selective_scan_fwd(x, dt, bm, cm, a_log, h0,
                                         chunk=chunk)

        got = fwd()
        torch.cuda.synchronize()
        want = ss.selective_scan_fwd_plain(x, dt, bm, cm, a_log, h0,
                                           chunk=chunk)
        rec = dict(base, tol=tol,
                   seg_chunks=ss.fwd_seg_chunks(b, di, nc, sms))
        _check_close("selective_scan_fwd", name, dtype,
                     zip(("y", "h_final", "h_ckpt"), got, want), tol, rec)
        h_ckpt = want[2]
        del got, want
        _hold_bitwise("selective_scan_fwd", name, dtype, fwd, rec)
        rec["ms"] = device_ms(fwd, iters=iters)
        # (one profiled call: the plain scans launch thousands of kernels)
        rec["plain_ms"] = device_ms(lambda: ss.selective_scan_fwd_plain(
            x, dt, bm, cm, a_log, h0, chunk=chunk), iters=1, warmup=1)
        rec["library_ms"] = None        # no PyTorch call computes the scan
        rec["bound_ms"], rec["bound_by"] = _scan_bound(
            b, s, di, ds, nc_ref, x.element_size(), with_h0, backward=False)
        rec["bound_ms_at_chunk"] = _scan_bound(
            b, s, di, ds, nc, x.element_size(), with_h0, backward=False)[0]
        _hold_to_bound("selective_scan_fwd", rec)
        emit({"phase": "kernels", "kernel": "selective_scan_fwd", **rec})
        fwd_res.append(rec)

        gy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
        gh = torch.randn((b, di, ds), generator=g, device="cuda")
        args = (x, dt, bm, cm, a_log, h_ckpt, gy, gh)

        def bwd():
            return ss.selective_scan_bwd(*args, chunk=chunk)

        got = bwd()
        torch.cuda.synchronize()
        want = ss.selective_scan_bwd_plain(*args, chunk=chunk)
        rec = dict(base, tol=tol)
        _check_close("selective_scan_bwd", name, dtype,
                     zip(("dx", "ddt", "db", "dc", "dA_log", "dh0"), got,
                         want), tol, rec)
        del got, want
        _hold_bitwise("selective_scan_bwd", name, dtype, bwd, rec)
        rec["ms"] = device_ms(bwd, iters=iters)
        rec["plain_ms"] = device_ms(
            lambda: ss.selective_scan_bwd_plain(*args, chunk=chunk), iters=1,
            warmup=1)
        rec["library_ms"] = None
        rec["bound_ms"], rec["bound_by"] = _scan_bound(
            b, s, di, ds, nc_ref, x.element_size(), with_h0, backward=True)
        rec["bound_ms_at_chunk"] = _scan_bound(
            b, s, di, ds, nc, x.element_size(), with_h0, backward=True)[0]
        _hold_to_bound("selective_scan_bwd", rec)
        emit({"phase": "kernels", "kernel": "selective_scan_bwd", **rec})
        bwd_res.append(rec)
        del x, dt, bm, cm, gy, args, h_ckpt
        torch.cuda.empty_cache()
    return [_entry_of(kname, f"{kname}.cu",
                      f"src/repro/kernels/selective_scan.py:{line}", res,
                      res[0])
            for kname, line, res in (("selective_scan_fwd", 75, fwd_res),
                                     ("selective_scan_bwd", 190, bwd_res))]


def phase_kernels():
    """Every kernel against its plain version; {name: report entry}."""
    entries = [kernels_flash_fwd(), kernels_flash_bwd(),
               *kernels_softmax_xent(), kernels_quant8(), *kernels_scan()]
    return {e["name"]: e for e in entries}


# ---------------------------------------------------------------------------
# the main paths


def _layers(cfg):
    """(self-attention layers, Mamba layers) of cfg's body."""
    segs = M.body_segments(cfg)
    return (sum(g.count for g in segs
                if g.kind.family in ("dense", "moe", "hybrid", "vit", "dec")),
            sum(g.count for g in segs if g.kind.family in ("ssm", "hybrid")))


def _encdec_layers(cfg):
    """(cross-attention layers of cfg's body, encoder layers)."""
    return (sum(g.count for g in M.body_segments(cfg) if g.kind.cross),
            cfg.encoder_layers)


def serve_launches(cfg, steps) -> dict:
    """Each kernel's launches in one serve call, from the code: attention
    runs the flash forward in every attention layer's prefill and each
    decode step (a decoder layer twice: self- and cross-attention), an
    encoder layer once, in the prefill; a Mamba layer runs the scan
    forward in its prefill only (decode steps the recurrence outside any
    kernel)."""
    attn, ssm = _layers(cfg)
    cross, enc = _encdec_layers(cfg)
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention_fwd"] = (attn + cross) * (1 + steps) + enc
    want["selective_scan_fwd"] = ssm
    return want


def _config(spec):
    """(the path's config, its record's depth keys): the published config,
    its depth cut to spec["layers"] where the spec gives one."""
    cfg = get_config(spec["arch"])
    if "layers" not in spec:
        return cfg, {"layers": cfg.num_layers}
    cut = dataclasses.replace(cfg, num_layers=spec["layers"])
    return cut, {"layers": f"{cut.num_layers} of {cfg.num_layers}",
                 "reduced": spec["reduced"]}


def _frontend(cfg) -> dict:
    """The record's stub frontend sizes (frames or patches a sample)."""
    if cfg.family == "audio":
        return {"encoder_layers": cfg.encoder_layers,
                "frames": cfg.encoder_seq}
    if cfg.family == "vlm":
        return {"patches": cfg.frontend_tokens,
                "mrope_sections": list(cfg.mrope_sections)}
    return {}


def phase_serve(path, spec):
    """Drive a serving path at full width. Returns the kernel launches,
    and what the profile phase needs to drive the same path again."""
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    t0 = time.perf_counter()
    params = M.init_lm(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab_size,
                           (spec["batch"], spec["prompt_len"]),
                           generator=gen, device=device)
    stub = serve.stub_inputs(cfg, spec["batch"], spec["seed"], device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = spec["decode_steps"]
    cdt = getattr(torch, spec["compute_dtype"])
    prefill, decode = serve.build_serving_fns(cfg, cdt, device)
    # warm-up at the timed shapes: the allocator's and cuBLAS's first-use
    # costs for them would otherwise land in the timed prefill
    serve.generate(prefill, decode, params, tokens, 1, **stub)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve.generate(prefill, decode, params, tokens, steps, **stub)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    want = serve_launches(cfg, steps)
    if counts != want:
        raise AssertionError(f"kernel launches in the {path} run: {counts}, "
                             f"expected {want}")
    logits = out["logits"]
    if logits.shape != (spec["batch"], steps + 1, cfg.vocab_size):
        raise AssertionError(f"{path}: logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{path}: non-finite logits")

    routing, replay = {}, None
    if cfg.family == "moe":
        # the kernel path again with its expert choices recorded (the main
        # path ran outside any tape), for the plain path to replay
        with _tape(cfg) as tape:
            again = serve.generate(prefill, decode, params, tokens, steps,
                                   **stub)
        routing["recorded_run_bitwise_equal_to_main"] = torch.equal(
            again["logits"], logits)
        replay = tape.idx
        del again
    p_plain, d_plain = serve.build_serving_fns(
        cfg, cdt, device, attn_impl=PLAIN_IMPLS["attn"],
        ssm_impl=PLAIN_IMPLS["ssm"], moe_impl=PLAIN_IMPLS["moe"])
    torch.cuda.reset_peak_memory_stats()
    with _tape(cfg, replay) as tape:
        ref = serve.generate(p_plain, d_plain, params, tokens, steps,
                             forced_tokens=out["tokens"][:, :steps], **stub)
    routing.update(_flips(tape))
    plain_peak = torch.cuda.max_memory_allocated()
    diff = (logits.float() - ref["logits"].float()).abs().max().item()
    ref_max = ref["logits"].float().abs().max().item()
    agree = (out["tokens"] == ref["tokens"]).float().mean().item()
    rec = {"phase": path, "arch": cfg.name, **depth,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": cfg.param_count(), **_frontend(cfg),
           "dtype": spec["compute_dtype"],
           "batch": spec["batch"], "prompt_len": spec["prompt_len"],
           "decode_steps": steps, "init_s": init_s,
           "launches": counts, "expected_launches": want,
           "prefill_ms": out["prefill_s"] * 1e3,
           "decode_ms_per_token": out["decode_s"] / steps * 1e3,
           "plain_prefill_ms": ref["prefill_s"] * 1e3,
           "plain_decode_ms_per_token": ref["decode_s"] / steps * 1e3,
           "peak_mem_bytes": peak, "plain_peak_mem_bytes": plain_peak,
           **routing,
           "max_abs_logit": logits.float().abs().max().item(),
           "max_logit_diff_vs_plain": diff,
           "tol": SERVE_TOL if cdt == torch.float32 else SERVE_TOL_BF16,
           "tol_is": ("atol and rtol" if cdt == torch.float32
                      else "of the plain path's largest |logit|"),
           "greedy_token_agreement": agree,
           "greedy_tokens": out["tokens"][:2].tolist()}
    emit(rec)
    if cdt == torch.float32:
        ok = torch.allclose(logits, ref["logits"], atol=SERVE_TOL,
                            rtol=SERVE_TOL)
    else:
        ok = math.isfinite(diff) and diff <= SERVE_TOL_BF16 * ref_max
    if not ok:
        raise AssertionError(f"{path}: served logits differ from the plain "
                             f"path by {diff}")
    # every layer routes in the prefill and in each decode step
    _hold_flips(path, routing, cfg.num_layers * (1 + steps))
    return counts, (path, prefill, decode, params, tokens, stub, rec)


def _tape(cfg, replay=None):
    """For an MoE arch a routing tape, recording or replaying `replay`
    (an earlier tape's idx); for any other arch no tape."""
    return (MOE.routing_tape(replay) if cfg.family == "moe"
            else contextlib.nullcontext())


def _flips(tape) -> dict:
    if tape is None:
        return {}
    return {"routing_flips": int(tape.flips),
            "routing_decisions": tape.decisions,
            "routing_calls": tape.calls,
            "recorded_calls": len(tape.replay),
            "routing_flip_limit": ROUTING_FLIP_LIMIT}


def _hold_flips(path, routing, calls):
    """The plain path replayed the kernel path's expert choices, one per
    routing call the code makes (`calls`, each recorded and each
    replayed), and the tokens whose own top-k set differs stay under the
    limit."""
    if not routing:
        return
    if not (routing["routing_calls"] == routing["recorded_calls"] == calls
            and routing["routing_flips"] <= ROUTING_FLIP_LIMIT
            * routing["routing_decisions"]):
        raise AssertionError(f"{path}: {routing['routing_flips']} routing "
                             f"flips in {routing['routing_decisions']} "
                             f"decisions; {routing['recorded_calls']} "
                             f"routing calls recorded and "
                             f"{routing['routing_calls']} replayed, "
                             f"{calls} expected")


def _device_time_by_kernel(prof):
    """{kernel name: device ms} of the CUDA kernels a profile recorded."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key] = out.get(evt.key, 0.0) + \
                evt.self_device_time_total / 1e3
    return out


def phase_profile(path, prefill, decode, params, tokens, stub, serve_rec,
                  steps=4, top=8):
    """Where a serve path's time goes: device time by kernel over one
    prefill and over `steps` decode steps (torch.profiler), and the
    device's busy share of the unprofiled host times of the serve phase."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    b, s = tokens.shape
    n_patches = (stub["patch_embeds"].shape[1] if "patch_embeds" in stub
                 else None)
    with profile(activities=acts) as prof:
        logits, cache = prefill(params, tokens, **stub)
        torch.cuda.synchronize()
    by_kernel = {"prefill": _device_time_by_kernel(prof)}
    tok = logits[:, -1].argmax(dim=-1)
    with profile(activities=acts) as prof:
        for i in range(steps):
            pos = decode.positions(b, s, n_patches, i)
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
        emit({"phase": "profile", "path": path, "part": part,
              "per": "call" if part == "prefill" else "token",
              "device_busy_ms": busy, "host_ms_unprofiled": wall[part],
              "device_idle_share": max(0.0, 1 - busy / wall[part]),
              "top_kernels_ms": [[k[:90], v] for k, v in ranked]})


def train_launches_per_step(cfg) -> dict:
    """Each kernel's launches in one train step, from the code: attention
    and the scan run once per block forward and again in the block's remat
    recompute, and their backward once (every block: the cut-layer
    gradient flows through the frozen prefix to the client adapters; a
    decoder block attends twice, self and cross; the frozen encoder's
    blocks too, the frames' gradient reaching the adapters through them);
    the LM-head CE once each way over all clients' tokens; quant8 once on
    the uplink value, once on the downlink cotangent (the frames take no
    link compression)."""
    attn, ssm = _layers(cfg)
    attn += sum(_encdec_layers(cfg))
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"flash_attention_fwd": 2 * attn,
                 "flash_attention_bwd": attn,
                 "selective_scan_fwd": 2 * ssm,
                 "selective_scan_bwd": ssm,
                 "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                 "quant_dequant": 2})
    return want


def _rel_l2(a, b, ref=None) -> float:
    """|a - b| / |ref| (ref: b unless given), or |a - b| where |ref| is 0."""
    den = (b if ref is None else ref).float().norm().item()
    num = (a.float() - b.float()).norm().item()
    return num / den if den else num


def _grad_gaps(names, got, want, den_for=None) -> dict:
    """{leaf: relative L2 gap of got against want}. A leaf whose name ends
    in a key of `den_for` is held against the norm of the same layer's leaf
    that the key maps to: its own gradient is 0 in exact arithmetic, each
    side's float noise."""
    ref = dict(zip(names, want))
    errs = {}
    for n, a, b in zip(names, got, want):
        end = next((k for k in den_for or () if n.endswith(k)), None)
        den = b if end is None else ref[n[:-len(end)] + den_for[end]]
        errs[n] = _rel_l2(a, b, den)
    return errs


def _timed_grads(loss_fn, params, frozen, batch, rng):
    """(loss, metrics, gradients, seconds) of one ``mpsl.value_and_grad``,
    ending in a sync."""
    t = time.perf_counter()
    loss, met, grads = mpsl.value_and_grad(loss_fn, params, frozen, batch,
                                           rng)
    torch.cuda.synchronize()
    return loss, met, grads, time.perf_counter() - t


def _hold_vs_plain(path, kernel, plain, errs, f32, ok=True, **extra):
    """Record the kernel path's loss and every trainable gradient leaf
    (`errs`, from ``_grad_gaps``) against the plain path's, with the peak
    bytes since the caller's reset, and fail outside the f32 or bf16
    limits or where `ok` is false. kernel, plain: (loss, seconds)."""
    (l_k, kernel_s), (l_p, plain_s) = kernel, plain
    loss_err = abs(float(l_k) - float(l_p)) / abs(float(l_p))
    worst = max(errs, key=errs.get)
    loss_tol = TRAIN_LOSS_TOL if f32 else TRAIN_LOSS_TOL_BF16
    grad_tol = TRAIN_GRAD_TOL if f32 else TRAIN_GRAD_TOL_BF16
    emit({"phase": f"{path}_vs_plain", "loss_kernel": float(l_k),
          "loss_plain": float(l_p), "loss_rel_err": loss_err,
          "loss_tol": loss_tol, "grad_leaves": len(errs),
          "grad_rel_l2_max": errs[worst], "grad_rel_l2_worst_leaf": worst,
          "grad_tol": grad_tol, **extra,
          "kernel_loss_and_grad_s": kernel_s,
          "plain_loss_and_grad_s": plain_s,
          "peak_mem_bytes_with_both": torch.cuda.max_memory_allocated()})
    if not (loss_err <= loss_tol and errs[worst] <= grad_tol and ok):
        raise AssertionError(f"{path}: kernel path differs from the plain "
                             f"path: loss {loss_err}, gradient {worst} "
                             f"{errs[worst]}, {extra}")


def _run_steps(step_fn, state, batches, per_step):
    """Take a step on each batch, every launch counter set to 0 just
    before the first. Returns the counts, and the record's losses, grad
    norms, host ms a step (ending in a sync), the median from the second
    step on, peak bytes and each step's launches beside `per_step`."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, norms, times, step_counts = [], [], [], []
    for batch in batches:
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step_fn(state, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        after = read_counts()
        step_counts.append({k: after[k] - before[k] for k in after})
    return read_counts(), {
        "losses": losses, "grad_norms": norms,
        "step_ms": [x * 1e3 for x in times],
        "median_step_ms": statistics.median(times[1:]) * 1e3,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches_per_step": step_counts, "expected_per_step": per_step}


def _hold_steps(path, rec):
    """Each step launched exactly the kernels its code calls; every loss
    and grad norm is finite."""
    want = rec["expected_per_step"]
    if any(c != want for c in rec["launches_per_step"]):
        raise AssertionError(f"{path}: train-step launches "
                             f"{rec['launches_per_step']}, expected {want} "
                             f"each step")
    if not all(math.isfinite(x) for x in rec["losses"] + rec["grad_norms"]):
        raise AssertionError(f"{path}: non-finite loss or grad norm: "
                             f"{rec['losses']} {rec['grad_norms']}")


def phase_train(path, spec):
    """Drive the MPSL train step at full width. Returns the kernels'
    launches and what the profile phase needs to drive it again."""
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    mp = MPSLConfig(n_clients=spec["n_clients"],
                    trainable_blocks=spec["trainable_blocks"],
                    compress_uplink=True, compress_downlink=True)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype=spec["compute_dtype"],
                    learning_rate=spec["lr"], seed=spec["seed"])
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    params, frozen, plan = split.init_mpsl_lm(gen, cfg, run, device)
    state = mpsl.init_state(params, frozen, spec["seed"])
    loader = train.make_lm_loader(cfg, spec["n_clients"],
                                  spec["batch_per_client"], spec["seq"],
                                  spec["seed"])
    steps = spec["steps"]
    batches = [train.to_device(loader(i), device) for i in range(steps)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    loss_fn = mpsl.make_lm_loss(cfg, run)               # the kernels
    step_fn = mpsl.make_train_step(
        loss_fn, run, schedules.warmup_cosine(spec["lr"], 10, steps))

    counts, steps_rec = _run_steps(step_fn, state, batches,
                                   train_launches_per_step(cfg))
    keys = ("arch", "n_clients", "batch_per_client", "seq",
            "trainable_blocks", "steps", "lr", "seed")
    n, bn, n_text = batches[0]["tokens"].shape
    rec = {"phase": path, **depth,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": cfg.param_count(), **_frontend(cfg),
           "trainable_params": sum(p.numel()
                                   for p in tree.leaves(state["params"])),
           "frozen_dtype": run.frozen_dtype,
           "compute_dtype": run.compute_dtype,
           "remat": run.remat, "compress": True,
           **{k: spec[k] for k in keys},
           "text_tokens": n_text, "ce_tokens": n * bn * (n_text - 1),
           "init_s": init_s, **steps_rec}
    emit(rec)
    _hold_steps(path, rec)

    # the kernel path against the plain path: same params, batch and the
    # first timed step's int seed, so both sides' links run quant8's
    # in-kernel Philox from generators in the same state (the same bits)
    b0 = batches[0]
    rng = mpsl.fold_in(spec["seed"], 0)
    # (an MoE arch's plain path replays the kernel path's expert choices)
    params = state["params"]
    torch.cuda.reset_peak_memory_stats()
    with _tape(cfg) as tape:
        l_k, m_k, g_k, kernel_s = _timed_grads(loss_fn, params, frozen, b0,
                                               rng)
    plain_fn = mpsl.make_lm_loss(cfg, run, impls=PLAIN_IMPLS)
    with _tape(cfg, None if tape is None else tape.idx) as tape:
        l_p, m_p, g_p, plain_s = _timed_grads(plain_fn, params, frozen, b0,
                                              rng)
    routing = _flips(tape)
    if tape is not None:
        routing.update(aux_kernel=float(m_k["aux"]),
                       aux_plain=float(m_p["aux"]))
    names = _leaf_names(params)
    errs = _grad_gaps(names, g_k, g_p)
    worst = max(errs, key=errs.get)
    f32 = run.compute_dtype == "float32"
    cmp = {"grad_rel_l2_adapter": {n: e for n, e in errs.items()
                                   if "adapter" in n}, **routing}
    if not f32:
        # where the bf16 gradient gap comes from: the same path with naive
        # attention (the CE kernels and every other bf16 rounding kept)
        # against the plain path; what is left of the kernel path's gap
        # beyond this is the bf16 flash backward's rounding of p and ds
        naive_fn = mpsl.make_lm_loss(cfg, run, impls={"attn": "naive"})
        _, _, g_n = mpsl.value_and_grad(naive_fn, params, frozen, b0, rng)
        errs_n = _grad_gaps(names, g_n, g_p)
        worst_n = max(errs_n, key=errs_n.get)
        cmp["naive_attn_grad_rel_l2_max"] = errs_n[worst_n]
        cmp["naive_attn_grad_rel_l2_worst_leaf"] = worst_n
        cmp["naive_attn_grad_rel_l2_of_kernel_worst_leaf"] = errs_n[worst]
        del g_n
    del g_k, g_p
    torch.cuda.empty_cache()
    _hold_vs_plain(path, (l_k, kernel_s), (l_p, plain_s), errs, f32, **cmp)
    # every block routes in the forward and again in its remat recompute
    _hold_flips(path, routing, 2 * cfg.num_layers)
    return counts, (path, step_fn, state, batches[-1], rec)


def _leaf_names(t):
    """"."-joined paths of a tree's leaves, in ``tree.leaves`` order."""
    return [p.replace("/", ".") for p in tree.paths(t)]


def phase_train_profile(path, step_fn, state, batch, train_rec, top=10,
                        per="step"):
    """Where a train step's time goes: device time by kernel over one step
    (torch.profiler), the device's idle share of the unprofiled median
    step time, and the kernels launched a step with the unprofiled host
    time per launch (a step whose host time per launch nears the host's
    cost of a launch is bound by the launches). `per` names what a step
    is (a FedAvg path: a round)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, met = step_fn(state, batch)
        float(met["loss"])
        torch.cuda.synchronize()
    times = _device_time_by_kernel(prof)
    launched = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = sum(times.values())
    wall = train_rec["median_step_ms"]
    ranked = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    emit({"phase": "train_profile", "path": path, "per": per,
          "device_busy_ms": busy,
          "host_ms_unprofiled": wall,
          "device_idle_share": max(0.0, 1 - busy / wall),
          "device_kernels": launched,
          "host_us_per_kernel": wall * 1e3 / max(launched, 1),
          "top_kernels_ms": [[k[:90], v] for k, v in ranked]})


# ---------------------------------------------------------------------------
# the paper mode (vit-base)


def _vit_passes(spec) -> int:
    """Encoder passes a step: one over the early-fusion joint sequence,
    else one a modality (late fusion, retrieval), each behind its own
    link."""
    if spec["task"] == "classification" and spec["fusion"] == "early":
        return 1
    return len(spec["modalities"])


def vit_launches_per_step(cfg, spec) -> dict:
    """Each kernel's launches in one paper-mode train step, from the code:
    each encoder pass runs the flash forward once per block and again in
    the block's remat recompute, and the backward once per block (every
    block trains; with a frozen prefix the cut-layer gradient would still
    cross it to the tokenizers); each pass's link runs quant8 on its
    uplink value and its downlink cotangent. The task head's CE over [B,
    10] logits is plain PyTorch, as the JAX package's is (no kernel)."""
    attn, _ = _layers(cfg)
    p = _vit_passes(spec)
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"flash_attention_fwd": 2 * attn * p,
                 "flash_attention_bwd": attn * p,
                 "quant_dequant": 2 * p})
    return want


def _vit_loader(spec):
    """The step-indexed client loader over the path's synthetic set
    (SyntheticMultimodal, or SyntheticRetrieval for retrieval), with
    Dirichlet(0.1) shards over its classes (retrieval: its latent codes)."""
    if spec["task"] == "retrieval":
        ds = SyntheticRetrieval(seed=spec["seed"])
        labels = ds.codes
    else:
        ds = SyntheticMultimodal(modalities=spec["modalities"],
                                 n_classes=spec["n_classes"],
                                 seed=spec["seed"])
        labels = ds.labels
    shards = dirichlet_partition(labels, spec["n_clients"], alpha=0.1,
                                 seed=spec["seed"],
                                 min_per_client=spec["batch_per_client"])
    return ClientLoader(ds, shards, spec["batch_per_client"],
                        seed=spec["seed"])


def _vit_to_device(batch, device):
    """A numpy batch as tensors on `device` (ids and labels int64)."""
    return {k: torch.from_numpy(v).to(device, torch.int64
                                      if v.dtype.kind in "iu" else None)
            for k, v in batch.items()}


def _vit_eval(path, spec, cfg, run, state, frozen, plan, batch):
    """The post-training model (paper Sec. 3.3): the client tokenizers
    FedAvg-ed, the body assembled from the frozen and trained segments, the
    server's head; evaluated on every client's samples of `batch` as one
    centralized model, kernel path against plain path. Returns its
    launches."""
    mods, cdt = spec["modalities"], getattr(torch, run.compute_dtype)
    server = state["params"]["server"]
    with torch.no_grad():
        full = split.assemble_full_params(state["params"], frozen, plan)
        full["tokenizers"] = aggregation.fedavg_heads(
            state["params"]["client"]["tokenizers"])
        full.update({k: v for k, v in server.items()
                     if k not in ("segments", "final_norm")})
        x = {m: batch[m].flatten(0, 1) for m in mods}
        retrieval = spec["task"] == "retrieval"

        def run_eval(impls):
            if retrieval:
                return baselines.retrieval_embeddings(
                    full, x, cfg, mods, dtype=cdt, impls=impls)
            return (baselines.full_vit_logits(
                full, x, cfg, modalities=mods, fusion_mode=spec["fusion"],
                dtype=cdt, impls=impls),)

        reset_counts()
        got = run_eval(None)                      # the kernels
        torch.cuda.synchronize()
        counts = read_counts()
        want = run_eval(PLAIN_IMPLS)
    expected = dict.fromkeys(COUNTERS, 0)
    expected["flash_attention_fwd"] = _layers(cfg)[0] * _vit_passes(spec)
    diff = max(_max_err(a, b) for a, b in zip(got, want))
    ref_max = max(b.float().abs().max().item() for b in want)
    f32 = cdt == torch.float32
    rec = {"phase": f"{path}_eval", "samples": x[mods[0]].shape[0],
           "launches": counts, "expected_launches": expected,
           "max_abs_diff_vs_plain": diff, "max_abs_plain": ref_max,
           "tol": SERVE_TOL if f32 else SERVE_TOL_BF16,
           "tol_is": ("atol and rtol" if f32
                      else "of the plain path's largest |output|")}
    if retrieval:
        rec["recall_at_1"] = float(losses.recall_at_k(*got, 1))
        rec["recall_at_5"] = float(losses.recall_at_k(*got, 5))
    else:
        labels = batch["labels"].flatten()
        rec["accuracy"] = (got[0].argmax(-1) == labels).float().mean().item()
    emit(rec)
    if counts != expected:
        raise AssertionError(f"{path}: evaluation launches {counts}, "
                             f"expected {expected}")
    ok = all(torch.isfinite(a).all() for a in got) and (
        all(torch.allclose(a.float(), b.float(), atol=SERVE_TOL,
                           rtol=SERVE_TOL) for a, b in zip(got, want))
        if f32 else diff <= SERVE_TOL_BF16 * ref_max)
    if not ok:
        raise AssertionError(f"{path}: the post-training model differs from "
                             f"its plain path by {diff}")
    return counts


def phase_vit_train(path, spec):
    """Drive the paper-mode MPSL train step at full-width vit-base, then
    its post-training model (``_vit_eval``). Returns the launches of the
    steps and the evaluation, and what the profile phase needs to drive a
    step again."""
    cfg = get_config(spec["arch"])
    device = serve.resolve_device("cuda")
    mods, retrieval = spec["modalities"], spec["task"] == "retrieval"
    mp = MPSLConfig(n_clients=spec["n_clients"],
                    trainable_blocks=spec["trainable_blocks"],
                    fusion=spec["fusion"], compress_uplink=True,
                    compress_downlink=True)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype=spec["compute_dtype"],
                    learning_rate=spec["lr"], seed=spec["seed"])
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    params, frozen, plan = split.init_mpsl_vit(
        gen, cfg, run, mods, spec["n_classes"], retrieval, device)
    state = mpsl.init_state(params, frozen, spec["seed"])
    loader = _vit_loader(spec)
    batches = [_vit_to_device(loader.batch(i), device)
               for i in range(spec["steps"])]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kw = dict(modalities=mods, task=spec["task"],
              n_classes=spec["n_classes"])
    loss_fn = mpsl.make_vit_loss(cfg, run, **kw)          # the kernels
    step_fn = mpsl.make_train_step(
        loss_fn, run, schedules.warmup_cosine(spec["lr"], 10, spec["steps"]))

    counts, steps_rec = _run_steps(step_fn, state, batches,
                                   vit_launches_per_step(cfg, spec))
    keys = ("arch", "modalities", "task", "fusion", "n_classes",
            "n_clients", "batch_per_client", "trainable_blocks", "steps",
            "lr", "seed")
    tokens = {m: tokenizers.MODALITIES[m].num_tokens for m in mods}
    rec = {"phase": path, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "d_ff": cfg.d_ff,
           "encoder_params": cfg.param_count(cfg.num_layers),
           "trainable_params": sum(p.numel()
                                   for p in tree.leaves(state["params"])),
           "frozen_dtype": run.frozen_dtype,
           "compute_dtype": run.compute_dtype, "remat": run.remat,
           "compress": True, **{k: spec[k] for k in keys},
           "tokens_per_sample": tokens, "encoder_passes": _vit_passes(spec),
           "init_s": init_s, **steps_rec}
    emit(rec)
    _hold_steps(path, rec)

    # the kernel path against the plain path: same params, batch and the
    # first step's int seed, so both sides' links run quant8's in-kernel
    # Philox from generators in the same state (the same bits)
    b0, rng = batches[0], mpsl.fold_in(spec["seed"], 0)
    params = state["params"]
    torch.cuda.reset_peak_memory_stats()
    l_k, _, g_k, kernel_s = _timed_grads(loss_fn, params, frozen, b0, rng)
    plain_fn = mpsl.make_vit_loss(cfg, run, impls=PLAIN_IMPLS, **kw)
    l_p, _, g_p, plain_s = _timed_grads(plain_fn, params, frozen, b0, rng)
    names = _leaf_names(params)
    # a key bias's gradient against its layer's query bias's norm: no RoPE,
    # so softmax is invariant to its shift along a row
    errs = _grad_gaps(names, g_k, g_p, den_for={"attn.bk": "attn.bq"})
    zero_table = all(not g.any() for n, g in zip(names, g_k)
                     if n.endswith("text.embed"))
    del g_k, g_p
    torch.cuda.empty_cache()
    _hold_vs_plain(
        path, (l_k, kernel_s), (l_p, plain_s), errs,
        run.compute_dtype == "float32", ok=zero_table,
        grad_rel_l2_tokenizers={n: e for n, e in errs.items()
                                if "tokenizers" in n},
        grad_rel_l2_key_bias_max=max(e for n, e in errs.items()
                                     if n.endswith("attn.bk")),
        text_table_grad_exactly_zero=zero_table)
    ev = _vit_eval(path, spec, cfg, run, state, frozen, plan, b0)
    counts = {k: counts[k] + ev[k] for k in counts}
    return counts, (path, step_fn, state, batches[-1], rec)


def fedavg_launches(cfg, spec) -> dict:
    """A FedAvg round's launches: each client's local steps run the whole
    model without remat (``baselines._encode``), the flash forward and
    backward once per block and encoder pass; no link, no quant8."""
    attn, _ = _layers(cfg)
    n = attn * spec["n_clients"] * spec["local_steps"] * _vit_passes(spec)
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"flash_attention_fwd": n, "flash_attention_bwd": n})
    return want


def phase_vit_fedavg(path, spec):
    """FedAvg baseline rounds (``core.baselines.make_fl_round``) of
    ``full_vit_loss`` at full-width vit-base: each client, in turn, takes
    `local_steps` AdamW steps on its own shard from its row of the bank,
    then the params are averaged. `rounds` rounds from the same bank, each
    launching exactly the kernels its code calls; the round time is the
    median from the second on (the first meets the shapes cold). The
    kernel path against naive attention from the same bank and batches:
    the mean loss, and each averaged leaf's update from the clients' mean
    start. The key biases are not compared: their gradient is 0 in exact
    arithmetic (no RoPE), each side's float noise, and AdamW steps noise of
    either sign by ~lr; their gap is recorded only."""
    cfg = get_config(spec["arch"])
    device = serve.resolve_device("cuda")
    mods, steps, lr = spec["modalities"], spec["local_steps"], spec["lr"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    models = [baselines.init_full_vit(gen, cfg, mods, spec["n_classes"],
                                      device=device)
              for _ in range(spec["n_clients"])]
    bank = tree.map_(lambda *xs: torch.stack(xs), *models)
    del models
    loader = _vit_loader(spec)
    per_step = [_vit_to_device(loader.batch(i), device)
                for i in range(steps)]
    batches = {k: torch.stack([b[k] for b in per_step], dim=1)
               for k in per_step[0] if k != "mask"}
    start = tree.map_(lambda a: a.mean(dim=0), bank)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def fl_round(impls):
        return baselines.make_fl_round(
            lambda p, b: baselines.full_vit_loss(
                p, b, cfg, modalities=mods, fusion_mode=spec["fusion"],
                impls=impls), lr=lr, local_steps=steps)

    rnd = fl_round(None)                                  # the kernels
    want = fedavg_launches(cfg, spec)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, round_counts = [], []
    for _ in range(spec["rounds"]):
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, avg, loss = rnd(bank, batches)
        loss = float(loss)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        after = read_counts()
        round_counts.append({k: after[k] - before[k] for k in after})
    counts = read_counts()
    round_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    _, avg_p, loss_p = fl_round(PLAIN_IMPLS)(bank, batches)
    loss_p = float(loss_p)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    errs, bias_gaps, flips, total = {}, {}, 0, 0
    for n, a, b, s in zip(tree.paths(avg), tree.leaves(avg),
                          tree.leaves(avg_p), tree.leaves(start)):
        flips += int(((a - b).abs() > lr).sum())
        total += a.numel()
        if n.endswith("attn/bk"):
            bias_gaps[n] = _max_err(a, b)
        else:
            errs[n] = _rel_l2(a - s, b - s)
    worst = max(errs, key=errs.get)
    loss_err = abs(loss - loss_p) / abs(loss_p)
    rec = {"phase": path, "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "modalities": mods,
           "n_clients": spec["n_clients"], "local_steps": steps,
           "batch_per_step": spec["batch_per_client"], "lr": lr,
           "params_per_client": sum(a[0].numel()
                                    for a in tree.leaves(bank)),
           "init_s": init_s, "rounds": spec["rounds"],
           "round_ms_each": [x * 1e3 for x in times],
           "round_ms": round_s * 1e3,
           "plain_round_ms": plain_s * 1e3, "peak_mem_bytes": peak,
           "launches": counts, "launches_per_round": round_counts,
           "expected_per_round": want,
           "mean_loss_kernel": loss, "mean_loss_plain": loss_p,
           "loss_rel_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
           "update_rel_l2_max": errs[worst],
           "update_rel_l2_worst_leaf": worst, "update_tol": FEDAVG_UPDATE_TOL,
           "elements_apart_by_more_than_lr": flips, "elements": total,
           "key_bias_max_abs_diff_not_compared": max(bias_gaps.values())}
    emit(rec)
    if any(c != want for c in round_counts):
        raise AssertionError(f"{path}: round launches {round_counts}, "
                             f"expected {want} each round")
    if not (math.isfinite(loss) and loss_err <= TRAIN_LOSS_TOL
            and errs[worst] <= FEDAVG_UPDATE_TOL):
        raise AssertionError(f"{path}: the kernel round differs from the "
                             f"plain round: loss {loss_err}, {worst} "
                             f"{errs[worst]}")
    del avg_p, start
    torch.cuda.empty_cache()

    def one_round(state, _):
        return state, {"loss": rnd(bank, batches)[2]}

    return counts, (path, one_round, None, None,
                    {"median_step_ms": round_s * 1e3})


def _gemms_and_sync(fn, iters=10):
    """(GEMM launches a call, host ms a call blocked in CUDA syncs and
    device-to-host copies): the aten matmul ops and the CUDA runtime's
    synchronising calls a profile of `iters` calls recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    gemms, sync_us = 0, 0.0
    for evt in prof.key_averages():
        if evt.key in ("aten::mm", "aten::bmm", "aten::addmm"):
            gemms += evt.count
        elif evt.key.startswith("cuda") and ("Synchronize" in evt.key
                                             or "Memcpy" in evt.key):
            sync_us += evt.cpu_time_total
    # the profile's window ends in one synchronize of its own
    return gemms / iters, sync_us / 1e3 / iters


def phase_moe_layer():
    """One full-width qwen2-moe-a2.7b MoE layer (60 experts top 4, F 1408,
    a shared expert of F 5632), f32, at a serve prefill's 2048 tokens and a
    decode step's 4: the ragged dispatch held to the dense one (the same
    routing, within TOL of the dense output's largest element), each timed
    by device time and by host time a call, with its GEMM launches and,
    for the ragged dispatch, the host's time blocked at its group-size
    readback. The evidence on whether a grouped-GEMM kernel is needed."""
    cfg = get_config("qwen2-moe-a2.7b")
    m = cfg.moe
    g = torch.Generator(device="cuda").manual_seed(6)
    p = MOE.init_moe(g, cfg, "cuda")
    tol = TOL[torch.float32]
    for name, t in (("prefill", 2048), ("decode", 4)):
        x = torch.randn((1, t, cfg.d_model), generator=g, device="cuda")
        run = {impl: (lambda impl=impl: MOE.apply_moe(p, x, cfg, impl))
               for impl in ("ragged", "dense")}
        with torch.inference_mode():
            (yr, ar), (yd, ad) = run["ragged"](), run["dense"]()
            _, idx, _ = MOE._routing(p, x[0], cfg)
        torch.cuda.synchronize()
        active = int((torch.bincount(idx.reshape(-1),
                                     minlength=m.num_experts) > 0).sum())
        rec = {"phase": "moe_layer", "case": name, "tokens": t,
               "experts": m.num_experts, "top_k": m.top_k,
               "active_experts": active, "tol": tol}
        _check_close("moe ragged vs dense", name, "float32",
                     [("y", yr, yd)], tol, rec)
        rec["aux_ragged"], rec["aux_dense"] = float(ar), float(ad)
        if ar != ad:
            raise AssertionError(f"moe_layer {name}: aux {ar} != {ad}")
        # FLOPs: routed experts' three products over their T*k slots
        # (dense: over every expert), the shared expert's three, the router
        routed = 2 * 3 * cfg.d_model * m.d_ff_expert
        shared = 2 * 3 * cfg.d_model * m.d_ff_shared + 2 * cfg.d_model * (
            m.num_experts + 1)
        flops = {"ragged": t * (m.top_k * routed + shared),
                 "dense": t * (m.num_experts * routed + shared)}
        with torch.inference_mode():
            for impl, fn in run.items():
                rec[f"{impl}_ms"] = device_ms(fn, iters=10)
                rec[f"{impl}_host_ms"] = time_ms(fn, iters=10)
                rec[f"{impl}_gemm_launches"], sync = _gemms_and_sync(fn)
                rec[f"{impl}_tflops"] = flops[impl] / rec[f"{impl}_ms"] / 1e9
                if impl == "ragged":
                    rec["ragged_sync_wait_ms"] = sync
        rec["ragged_device_idle_share"] = max(
            0.0, 1 - rec["ragged_ms"] / rec["ragged_host_ms"])
        emit(rec)
        del x, yr, yd
    del p
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    kernels = phase_kernels()
    phase_moe_layer()
    counts = {}
    for path, spec in PATHS.items():
        if "serve" in path:
            counts[path], driven = phase_serve(path, spec)
            phase_profile(*driven)
        elif path == "vit_fedavg":
            counts[path], driven = phase_vit_fedavg(path, spec)
            phase_train_profile(*driven, per="round")
        elif path.startswith("vit"):
            counts[path], driven = phase_vit_train(path, spec)
            phase_train_profile(*driven)
        else:
            counts[path], driven = phase_train(path, spec)
            phase_train_profile(*driven)
        del driven
        torch.cuda.empty_cache()
    for name, entry in kernels.items():
        entry["launches_by_path"] = {p: c[name] for p, c in counts.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if not entry["launches"]:
            raise AssertionError(f"{name} never launched on a main path")
    emit({"kernels": list(kernels.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
