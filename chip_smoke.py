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
   trainer       the train path again through the train CLI's build, the
                 prefetcher (depth 2, placement on its producer thread)
                 and the Trainer, the run log on: each step's launches as
                 train's, every loss and grad norm bitwise equal to
                 train's, exactly 2 syncs in Trainer.run (torch's sync
                 debug mode), the run log's spans once a step and its
                 link records, wire bytes as core.costs gives them;
   ssm_serve     full-width falcon-mamba-7b (64 Mamba blocks, d_model
                 4096, d_inner 8192, d_state 16, vocab 65024), as serve:
                 the scan forward in every layer's prefill (decode is the
                 recurrence step, outside any kernel);
   ssm_train     falcon-mamba-7b at 8 of its 64 layers (`reduced` says
                 why), as train: the scan forward (block and remat
                 recompute) and backward in every block, 3 steps;
   hybrid_serve  full-width hymba-1.5b (32 hybrid blocks: parallel
                 attention, 25 heads / 5 KV heads, hd 64, window 1024 on
                 local layers, and Mamba heads), prompt 1536 (past the
                 window: local caches wrap their ring), 16 decode steps;
   hybrid_train  hymba-1.5b at 16 of its 32 layers (global layers 0 and
                 15), as train, 2 steps;
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
   trainer_resume  encdec_train through the Trainer and the prefetcher:
                 6 steps straight; 3 steps, a checkpoint, everything
                 deleted, rebuilt, auto-resumed to 6; the fault plan
                 producer_crash@1,ckpt_fail@3; nan_batch@4 under the
                 guard; the second and third held bitwise to the first,
                 the NaN step to the state before it. Beside them the old
                 CLI loop (batches assembled in series with the step) and
                 the checkpoint's bytes, save and restore times;
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
   cell_train_4k  the JAX package's train_4k cell through launch.steps
                 (default_run, build_train) on the host mesh, bf16 compute:
                 full-width minitron-4b, 8 of 32 layers, at seq 4096, 4
                 clients x 2, the last 4 blocks trainable, int8 links, mu =
                 2 microbatches
                 (choose_microbatches), 2 steps: the tensor-core flash
                 forward and backward at S 4096, CE over a microbatch's
                 16380 tokens (bf16 h, f32 head), quant8; held against
                 default_run's own impls (blockwise attention, the plain
                 CE) through _grad_agg's microbatches;
   cell_prefill_32k  prefill_32k through build_prefill: minitron-4b, 8
                 of 32 layers, batch 1, 32768 tokens, bf16 weights: the
                 flash forward at S 32768 in every layer against blockwise
                 attention (last
                 logits and every layer's cache K/V);
   cell_decode_32k  decode_32k through build_decode: minitron-4b, batch
                 4, 32768-slot caches filled to 32760 from the seed, 8
                 greedy steps: the split-KV route over 32768 slots against
                 naive (auto's decode choice), the plain path fed the same
                 tokens (logits in relative L2, each greedy token up to a
                 near tie: DECODE_CELL_TOL);
   cell_long_500k  long_500k: hymba-1.5b, batch 1, 524288-slot global
                 caches, 1024-slot rings and SSM states from the seed, 8
                 steps: the split route over 524288 slots and the window
                 ring against naive;
   cell_moe_prefill_32k  prefill_32k of qwen3-moe-235b-a22b at its
                 published widths (64 heads on 4 KV heads: G 16; 128
                 experts top 8), 2 of 94 layers: the flash forward at G 16
                 and the ep dispatch (capacity 2.0, the 1 x 1 host mesh)
                 against blockwise and the ragged dispatch (replaying the
                 kernel run's expert choices); its dropped (token, k)
                 slots recorded, and only rows no drop reached held.
   mesh_train    the SPMD program (``parallel.collectives``) as 4 rank
                 processes sharing the card over gloo
                 (``launch.spmd.spawn``), mesh (data 2, model 2): train's
                 spec at 2 of 32 layers (the last trainable), 2 steps
                 (the run's time) with
                 client 1 masked out, each rank 2 clients, 12
                 of 24 heads on 4 of 8 KV heads, d_ff 4608 and 128000
                 vocab columns (the vocab-parallel CE kernel on its
                 shard, labels outside it included), every weight's D
                 gathered at use; its steps against the one-rank train path
                 run first on the card (each loss, the first step's
                 gradients from each rank's shards, the masked client's
                 adapter gradient exactly 0); then its per-client leg:
                 one ``backward_mode="per_client"`` step (vanilla PSL,
                 4 passes) from the first state and batch against the
                 aggregated first step (loss, every gradient, the masked
                 client's adapter gradient exactly 0; its host ms beside
                 the aggregated step's, a count of passes); then its
                 attn_seq_shard leg: one step from the first state with
                 each rank's core attention over its 256 of the 512
                 queries, all 24 heads, against the first step without
                 the flag and the one-rank path (loss, every gradient,
                 the masked adapter 0; launches unchanged; collectives
                 the first step's plus exactly ``attn_seq_leg_expected``);
   mesh_serve    serve's spec at 8 of 32 layers on (2, 2), the TP-only
                 layout (batch 2 a data rank), teacher-forced with the
                 one-rank serve path's tokens: logits, greedy tokens
                 (argmax over the vocab shards) up to a near tie;
   mesh_ep       qwen3-moe-235b-a22b (2 of 94 layers, bf16) prefill of 1 x
                 4096 tokens through ``steps.build_prefill`` on (1, 4): 32
                 of 128 experts, 16 of 64 heads on 1 of 4 KV heads a
                 rank, ep at capacity 2.0, replaying the one-rank ep
                 path's expert choices: every rank's dropped slots joined
                 bitwise the one-rank ``ep_drop_mask``, last logits and
                 cache K/V against it.
   mesh_ep_ragged  the same prefill under the ragged dispatch: each rank
                 the (token, k) slots of its 32 experts, a GEMM a
                 non-empty local expert, replaying the one-rank ragged
                 path's choices: every slot run by exactly one rank
                 (nothing dropped), last logits and cache K/V against it.
   mesh_ssm      falcon-mamba-7b at full width (d_model 4096, d_inner
                 8192: 4096 channels a rank), 2 of 64 layers, on (2, 2):
                 train's spec (2 steps, the last block trainable,
                 client 1 masked, int8 links), then serve's (prompt 512, 16
                 steps), in one world: the scan kernels at 4096 local
                 channels, in_proj cut x's and z's channels alike, the
                 vocab-parallel CE; each part against its one-rank path
                 run first, at mesh_train's and mesh_serve's limits;
   mesh_hybrid   hymba-1.5b at full width, 8 of 32 layers (the last 4
                 blocks trainable), as mesh_ssm
                 (prompt 1536): 25 heads on 5 KV heads divide no model axis, so
                 every attention weight's D lies on (data, model) (dboth)
                 and each rank computes every head; 1600 local channels;
                 the lm_head (V 32001) on `data` alone, its CE whole on
                 each model rank; prefill writes each rank's half of the
                 caches' slots (the rings wrap), decode merges the ranks'
                 split-KV partials by lse;
   mesh_long_500k  cell_long_500k's decode on (1, 4) at bf16: the global
                 layers' 524288 slots 131072 a rank, the rings 256, the
                 SSM states 800 channels, 8 steps teacher-forced with the
                 one-rank kernel path's tokens (DECODE_CELL_TOL,
                 ``_token_deficit``); the seeded cache's shards gathered
                 back bitwise on every rank.
   mesh_encdec   whisper-tiny at full width, 2 + 2 of its 4 + 4 layers,
                 on (1, 4), as mesh_ssm: 6 heads divide no model axis of
                 4, so every encoder, self- and cross-attention block runs
                 dboth
                 (the cross block's q from x, k and v from the encoder
                 output, two row-parallel products); encdec_train's spec
                 (2 steps, client 1 masked), then 4 x (1500 frames + 227
                 tokens) in 448 text slots (112 a rank), 16 steps; the
                 prefill's cross K/V every head on every rank, the same
                 bits on each, within SERVE_TOL of the one-rank prefill's;
                 its attn_seq_shard leg as mesh_train's (each rank's
                 core over 375 of the 1500 frames and 112 of the 448
                 tokens, every head; the cross blocks unchanged);
   mesh_vlm      qwen2-vl-72b at its published widths, 2 of 80 layers
                 (`reduced` says why), on (2, 2): 32 of 64 heads and 4 of
                 8 KV heads a rank, the vocab-parallel CE at 76032
                 columns, fsdp over `data`; vlm_train's spec (2 steps,
                 client 1 masked), then 4 x (256 patches + 256 tokens),
                 16 steps. Its train leg runs a second time with
                 ``seq_shard_acts`` (what ``steps.default_run`` asks for
                 qwen2-vl-72b's train_4k: the residual stream cut on the
                 sequence over `model` between the blocks), from the
                 first state on the same batches: losses and first-step
                 gradients bitwise the leg's without it, the bytes
                 autograd saves over a forward fallen by exactly half of
                 each block's input, and exactly 3 L + 2 all-gathers over
                 `model` more a step (``seq_leg_expected``).
   mesh_moe      qwen2-moe-a2.7b at its published widths, 2 of 24 layers
                 (the last trainable), on the production (1, 8) model
                 axis: 8 ranks sharing the card; its 60 experts divide no
                 model axis of 8, so each expert's F lies on `model` (176
                 of 1408 columns a rank; the shared expert's 704 of
                 5632), 2 of 16 heads, the CE on 18992 of 151936
                 columns; moe_train's batch (2 steps, client 1 masked:
                 the router's aux loss, over every client's tokens, gives
                 it an adapter gradient, held to the one-rank path's),
                 then serve's (prompt 512, 16 steps), in one world, the
                 ragged dispatch replaying the one-rank path's expert
                 choices.
   mesh_pod      the pod axis: minitron-4b at full width, 2 of 32 layers
                 (the last trainable), on (pod 2, data 2, model 2): 8
                 ranks sharing the card; the clients and the batch on
                 (pod, data) flattened (a client a rank), fsdp over
                 `data` within a pod, the weights replicated across pods
                 (each fsdp gradient all-reduced over `pod` once a step);
                 mesh_train's batch (2 steps, client 1 masked), then
                 serve's (prompt 512, 16 steps), in one world.
   mesh_vit      the paper mode on the program: vit-base at its published
                 widths and depth (12 blocks, every one trainable), 4
                 clients x 4 samples (client 1 masked), int8 links, f32,
                 on (2, 2): 6 of 12 heads a rank (heads), fsdp over
                 `data`, each client's tokenizers on its data rank; an
                 early-fusion leg (2 steps), a late-fusion leg (vision +
                 audio + text: passes of 197, 513 and 77 tokens, 1 step)
                 and a retrieval leg (the InfoNCE over the global batch,
                 1 step), each against the one-rank kernel path on the
                 same params and batches (losses, the first step's
                 gradients, the masked client's tokenizer gradient: 0 in
                 classification, the one-rank path's in retrieval); after
                 the early and retrieval legs the post-training model: the
                 tokenizers FedAvg-ed over the global client axis (the
                 one-rank mean of the same clients, the same bits on every
                 rank), the body assembled from the rank's shards, the
                 logits or embeddings of its samples gathered, recall at
                 1 and 5 over the global batch.
   mesh_vit_dboth  mesh_vit's early leg (1 step) and its evaluation on the
                 production (1, 8) model axis: 12 heads divide no model
                 axis of 8, so every attention weight's D lies on (data,
                 model) and each of the 8 ranks computes every head.
   The paths of one world size share one world (``MESH_GROUPS``: the
   4-rank meshes, the 8-rank ones), a rank a device of the mesh, each
   path under a program on its own mesh. ``diagnose_beta_ssm`` (not a main path: run alone,
   as README.md says) holds mesh_hybrid's beta gradients at 4 layers to a
   float64 one-rank run. Each mesh
   path requires every rank's launches and collectives (by op
   and axis) exactly as derived from the code (``mesh_*_collectives``),
   and the ranks' peaks to sum under 80 GB; the collectives' times on
   this transport are not recorded as speed.
   Each path's serve or train is followed by its profile: device time by
   kernel (torch.profiler) and the device's busy share. The MoE paths'
   plain versions (dense dispatch, naive attention) replay the kernel
   path's expert choices (``moe.routing_tape``), and the flips it counts
   must stay under ROUTING_FLIP_LIMIT of the routing decisions.

6. examples: the port's three examples (``python -m
   repro_torch.examples.<name>``) on the card at their defaults, each a
   process of its own, each exiting 0.
7. dryrun:  ``launch.dryrun.run_cell`` on the host mesh for the five cells
   at their cut sizes (in a CPU-only process started with the build,
   beside the card's phases): argument and temp bytes and flops, the
   predicted peak beside each cell's max_memory_allocated (the ratio is
   recorded, not held). The same process traces rank 0's program
   (``launch.dryrun.trace_program`` on a fake process group) of the
   first train step of mesh_train, mesh_hybrid, mesh_encdec, mesh_moe,
   mesh_pod and mesh_vit, the serving call of the four that serve and
   the two attn_seq_shard legs (``dryrun_mesh``); each trace's
   collectives, by op and axis, calls and bytes, must equal rank 0's on
   the card exactly.

One JSON line per phase; then the {"kernels": [...]} line and the card's
``nvidia-smi`` line; the last line is {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; so does a machine without CUDA.

TF32 is turned off for matmuls and cuDNN, so every f32 product on both
sides of a comparison is full f32.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Imported before anything is printed: without the repo beside it, the
# script fails here and prints no result.
from repro_torch import faults, obs, tree  # noqa: E402
from repro_torch.configs import (MPSLConfig, RunConfig, SHAPES,  # noqa: E402
                                 ShapeConfig, get_config)
from repro_torch.core import (aggregation, baselines, compression,  # noqa: E402
                              costs, losses, mpsl, split)
from repro_torch.data import (ClientLoader, PrefetchLoader,  # noqa: E402
                              SyntheticMultimodal, SyntheticRetrieval,
                              dirichlet_partition)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quant8 as q8  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels import softmax_xent as sx  # noqa: E402
from repro_torch.launch import dryrun, serve, spmd, steps, train  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers, model as M  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import tokenizers  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.obs import comm, report  # noqa: E402
from repro_torch.optim import adamw_init, schedules  # noqa: E402
from repro_torch.parallel import collectives, sharding  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.trainer import to_host  # noqa: E402

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
# The decode cells (32k and 512k seeded caches, bf16): each step's logits,
# kernel path vs plain path, in relative L2. The split kernel's o is
# within one bf16 ulp of its plain version, but 32 layers of random bf16
# weights carry each residual element that the two attentions round to
# neighbouring values to the logits: the gap was 2.2-2.5 % (decode_32k)
# and 3.3-3.9 % (long_500k) in relative L2 on the card over three seeds,
# elementwise up to 2.6 % and 4.4 % of the largest |logit|. A plain path
# whose softmax weights stay f32 gave the same L2 gaps (elementwise up to
# 5.2 %), and its greedy token at long_500k's last step differed from the
# kernel path's: at batch 1 over 256000 random logits the top two often
# lie closer than that noise (at seeds 1 and 2 decode_32k's tokens
# differed from the plain path's in 2 and 6 of 32 (row, step), each a
# near tie within 1.2 % of the largest |logit|). serve_bf16's 512-token
# prompt already sits at 1.7 % of the 2 % serve limit. So the bf16 limit
# for a quantity carried through the stack, 5e-2 relative L2, as for the
# train paths' gradients; and each greedy token must be the plain path's
# top or a near tie: one whose plain logit lies within 2 x DECODE_CELL_TOL
# of the largest |logit| below the plain top (each of the two logits may
# move by the limit). A row whose plain top-2 margin exceeds that must so
# agree exactly.
DECODE_CELL_TOL = 5e-2
# A FedAvg round, kernel vs naive attention, f32: each averaged leaf's
# update (from the clients' mean start) in relative L2. AdamW's steps are
# ~lr * sign(g), so an element whose gradient lies within the two paths'
# float noise of 0 may step the other way (2 lr a step): a share f of such
# elements gives ~2 sqrt(f). 1e-3, the CPU parity test's limit, admits f up
# to 2.5e-7; a wrong attention moves most elements (a gap near 1).
FEDAVG_UPDATE_TOL = 1e-3
# The FedAvg-ed tokenizers under the SPMD program against the one-rank
# mean of the same clients' tokenizers (gathered whole), in relative L2:
# a mean of 4 f32 values, its sum all-reduced over the client axis in
# another order than one rank's (each element within 2 ulp).
FEDAVG_MEAN_TOL = 1e-6
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
    # the train path again through the train CLI's build, the prefetcher
    # and the Trainer (telemetry on), held bitwise to it
    "trainer": TRAIN,
    "ssm_serve": dict(SERVE, arch="falcon-mamba-7b"),
    "ssm_train": dict(TRAIN, arch="falcon-mamba-7b", layers=8,
                      reduced="depth 64 -> 16 layers (PR 24), -> 8 (PR 27): "
                      "the plain path's Python-stepped scan took 108 s of "
                      "the run at 64, 55 s at 32 and 28 s at 16, and the "
                      "script must end within 1200 s on a slower machine; "
                      "every kernel shape is the full width's"),
    "hybrid_serve": dict(SERVE, arch="hymba-1.5b", prompt_len=1536),
    "hybrid_train": dict(TRAIN, arch="hymba-1.5b", steps=2, layers=16,
                         reduced="depth 32 -> 16 layers (global layers 0 "
                         "and 15 kept) in PR 27: the plain path's "
                         "Python-stepped scan took 27 s of the run at 32, "
                         "and the script must end within 1200 s on a slower "
                         "machine; every kernel shape is the full width's "
                         "(at 8 layers the first trainable beta_attn "
                         "gradient, a sum that cancels, came 1.04e-3 off "
                         "the plain path's: ROADMAP.md Queue 3)"),
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
    # restart and chaos through the Trainer at whisper-tiny's full width
    # and depth (a full minitron-4b train state is ~19.5 GB a checkpoint)
    "trainer_resume": dict(TRAIN, arch="whisper-tiny", batch_per_client=8,
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
    # the JAX package's production cells (configs.SHAPES), each driven
    # through launch.steps' default_run and build_* on the host mesh at
    # bf16 compute, its cuts in `reduced`
    "cell_train_4k": dict(
        arch="minitron-4b", shape=("train_4k", 4096, 8, "train"),
        n_clients=4, batch_per_client=2, trainable_blocks=4, steps=2,
        lr=3e-4, seed=0, layers=8,
        reduced="global batch 256 -> 8 (4 clients x 2, default_run's "
        "n_clients override: one card's mesh gives 1 client); "
        "trainable_blocks 16 -> 4 (two AdamW states of 16 blocks do not "
        "fit beside the plain path); 2 steps; depth 32 -> 8 layers (the "
        "plain path's step took 17.8 s at 32, 11.5 s at 16): the script, "
        "with its mesh paths, must end within 1200 s on a slower "
        "machine"),
    "cell_prefill_32k": dict(
        arch="minitron-4b", shape=("prefill_32k", 32768, 1, "prefill"),
        seed=0, layers=8,
        reduced="batch 32 -> 1; depth 32 -> 8 layers in PR 27 (the plain "
        "path's blockwise prefill took ~27 s at 32): the script must end "
        "within 1200 s on a slower machine"),
    "cell_decode_32k": dict(
        arch="minitron-4b", shape=("decode_32k", 32768, 4, "decode"),
        filled=32760, decode_steps=8, seed=0,
        reduced="batch 128 -> 4 (two 32768-slot caches, the kernel "
        "path's and the plain path's, beside 8.4 GB of weights); the "
        "first 32760 slots drawn from the seed instead of a prefill; 8 "
        "greedy steps"),
    "cell_long_500k": dict(
        arch="hymba-1.5b", shape=("long_500k", 524288, 1, "decode"),
        filled=524280, decode_steps=8, seed=0,
        reduced="the caches (524280 of the global layers' 524288 slots, "
        "the local layers' 1024-slot rings, the SSM states) drawn from "
        "the seed instead of a prefill; 8 greedy steps"),
    "cell_moe_prefill_32k": dict(
        arch="qwen3-moe-235b-a22b", layers=2,
        shape=("prefill_32k", 32768, 1, "prefill"), seed=0,
        reduced="batch 32 -> 1; depth 94 -> 2 layers (235 B params exceed "
        "one card)"),
    # the SPMD program (parallel.collectives): 4 ranks sharing the card
    # over gloo, each holding its shards of the rule table's layout,
    # against the one-rank path; the new paths at full width
    "mesh_train": dict(TRAIN, mesh=(2, 2), masked_client=1, layers=2,
                       trainable_blocks=1, steps=2, per_client=True,
                       attn_seq_leg=True,
                       reduced="depth 32 -> 2 layers (the last trainable) "
                       "and 3 -> 2 steps: the run's 1200 s, beside the "
                       "per-client leg's 4 passes (47 s at 8 layers, 21-43 "
                       "s at 4 on the H100) and the other mesh paths; every "
                       "shape a rank gives the kernels is the full "
                       "width's"),
    "mesh_serve": dict(SERVE, mesh=(2, 2), layers=8,
                       reduced="depth 32 -> 16 layers in PR 26, -> 8 in PR "
                       "27: the run's 1200 s; every shape a rank gives the "
                       "kernels is the full width's"),
    "mesh_ep": dict(
        arch="qwen3-moe-235b-a22b", layers=2, mesh=(1, 4),
        shape=("prefill_4k", 4096, 1, "prefill"), seed=0,
        reduced="depth 94 -> 2 layers (235 B params exceed one card); "
        "batch 1 x 4096 tokens"),
    # the Mamba and hybrid families on (2, 2): train's spec with client 1
    # masked out (2 steps), then serve's (prompt 512, hymba 1536: its
    # sequence-sharded rings wrap), in one world; and long_500k's decode
    # on (1, 4)
    "mesh_ssm": dict(TRAIN, arch="falcon-mamba-7b", layers=2, mesh=(2, 2),
                     trainable_blocks=1, masked_client=1, steps=2, batch=4,
                     prompt_len=512, decode_steps=16,
                     reduced="depth 64 -> 2 layers, the last trainable: "
                     "the run's 1200 s beside the other mesh paths (each "
                     "layer's collectives cross gloo's host buffers); "
                     "every shape a rank gives the kernels is the full "
                     "width's"),
    "mesh_hybrid": dict(TRAIN, arch="hymba-1.5b", layers=8, mesh=(2, 2),
                        masked_client=1, steps=2, batch=4, prompt_len=1536,
                        decode_steps=16,
                        reduced="depth 32 -> 16 layers (PR 25), -> 8 (PR 26; "
                        "global layer 0 beside 7 sliding-window layers): "
                        "the run's 1200 s; every shape a rank gives the "
                        "kernels is the full width's"),
}
PATHS["mesh_long_500k"] = dict(
    PATHS["cell_long_500k"], mesh=(1, 4), layers=16,
    reduced="depth 32 -> 16 layers (global layers 0 and 15 kept) in PR 26: "
    "the run's 1200 s; the caches (the global layers' 524280 of 524288 "
    "slots) as cell_long_500k's")
# the encoder-decoder and VLM stacks on the mesh, train then serve in one
# world: whisper-tiny at full width and depth on (1, 4), its 6 heads on a
# model axis of 4 (dboth in every encoder, self- and cross-attention
# block), encdec_train's spec with client 1 masked, then 4 requests of
# 1500 frames and 227 tokens in a 448-slot text context (221 decode
# slots: 112 a rank); qwen2-vl-72b at its published widths on (2, 2)
# (32 of 64 heads and 4 of 8 KV heads a rank, the vocab-parallel CE at
# 76032 columns, fsdp over `data`), vlm_train's spec with client 1
# masked, then 4 requests of 256 patches and 256 tokens
PATHS["mesh_encdec"] = dict(
    PATHS["encdec_train"], layers=2, encoder_layers=2, mesh=(1, 4),
    masked_client=1, steps=2, batch=4, prompt_len=227, decode_steps=16,
    decode_slots=221, attn_seq_leg=True,
    reduced="depth 4 + 4 -> 2 + 2 layers and 16 of the text context's 221 "
    "decode steps: the run's 1200 s (a step's all-reduces, 5.66 GB a rank "
    "at full depth, cross gloo's host buffers); every shape a rank gives "
    "the kernels is the full model's")
PATHS["mesh_vlm"] = dict(
    PATHS["vlm_train"], layers=2, mesh=(2, 2), masked_client=1, steps=2,
    batch=4, prompt_len=256, decode_steps=16,
    reduced="depth 80 -> 2 layers (1 trainable): at vlm_train's 4 a "
    "rank's step ran out of the 80 GB the 4 ranks share (~16 GB a rank "
    "beside ~3.4 GB of allocator fragments: the lm_head's 76032-column "
    "shard with its AdamW moments and gradient, its gathered copy and "
    "the CE's scratch); 16 greedy steps")
# qwen2-vl-72b's train_4k asks for seq_model (steps.default_run: training
# at d_model >= 8192): mesh_vlm's train leg runs a second time with
# seq_shard_acts, the stream cut on the sequence over `model` between the
# blocks, held bitwise to the leg without it
PATHS["mesh_vlm"]["seq_leg"] = True
# the pod axis: minitron-4b at full width on (pod 2, data 2, model 2), 8
# ranks sharing the card: the clients and the batch on (pod, data)
# flattened (a client a rank), fsdp over `data` within a pod, the weights
# replicated across pods; mesh_train's spec with client 1 masked (2
# steps), then serve's (prompt 512, 16 steps), in one world
PATHS["mesh_pod"] = dict(
    PATHS["mesh_train"], mesh=(2, 2, 2), layers=2, trainable_blocks=1,
    per_client=False, attn_seq_leg=False, batch=4, prompt_len=512, decode_steps=16,
    reduced="depth 32 -> 2 layers, the last trainable: 8 ranks share the "
    "card's 80 GB and each pod holds a whole (2, 2) copy of the weights, "
    "the lm_head's AdamW state included; the run's 1200 s; every shape a "
    "rank gives the kernels is the full width's")
# mesh_ep's prefill again under the ragged dispatch (the kernel impl):
# each rank its 32 of 128 experts' slots, one GEMM a non-empty local
# expert and projection, nothing dropped
PATHS["mesh_ep_ragged"] = dict(PATHS["mesh_ep"], moe="ragged")
# qwen2-moe-a2.7b on the production (1, 8) model axis, 8 ranks sharing the
# card: its 60 experts divide no model axis of 8, so each expert's F lies
# on `model` (176 of 1408 columns a rank; the shared expert's 704 of 5632,
# 2 of 16 heads, 18992 of 151936 vocab columns); moe_train's spec with
# client 1 masked (2 steps), then serve's (prompt 512, 16 steps)
PATHS["mesh_moe"] = dict(
    PATHS["moe_train"], layers=2, trainable_blocks=1, mesh=(1, 8),
    masked_client=1, steps=2, batch=4, prompt_len=512, decode_steps=16,
    reduced="depth 24 -> 2 layers, the last trainable (moe_train's 2 would "
    "leave no frozen bf16 block on the path): the run's 1200 s; at 4 "
    "layers the whole script took 1060.9 s on the H100, and machines "
    "10-30 % slower in every phase occur; every shape a rank gives the "
    "kernels is the full width's")
# the paper mode on the mesh: vit-base at its published widths and depth
# (12 layers, every block trainable), 4 clients x 4 samples, client 1
# masked out, int8 links, f32; on (2, 2) (6 of 12 heads a rank: heads,
# fsdp over `data`) an early-fusion leg of 2 steps, a late-fusion leg
# (vision + audio + text: passes of 197, 513 and 77 tokens) and a
# retrieval leg (the global InfoNCE) of 1 step each, each leg's
# post-training model evaluated after it (early, retrieval); on the
# production (1, 8) model axis (12 heads divide no model axis of 8:
# dboth, every head on every rank; 8 ranks) one early-fusion step and its
# evaluation
PATHS["mesh_vit"] = dict(
    VIT, batch_per_client=4, mesh=(2, 2), masked_client=1,
    legs={"early": 2, "late": 1, "retrieval": 1},
    evals=("early", "retrieval"),
    reduced="batch 4 clients x 16 -> x 4 samples (depth and widths the "
    "published ones): 4 ranks share the card over gloo, each block's "
    "activations and each weight's fsdp gather cross the host, and the "
    "script must end within 1200 s")
PATHS["mesh_vit_dboth"] = dict(
    PATHS["mesh_vit"], mesh=(1, 8), legs={"early": 1}, evals=("early",),
    reduced="batch 4 clients x 16 -> x 4 samples, 1 step (depth and widths "
    "the published ones): 8 ranks share the card over gloo, and the script "
    "must end within 1200 s")
# every path's plain version: naive attention, the plain scan, chunked CE,
# the dense expert dispatch
PLAIN_IMPLS = {"attn": "naive", "ssm": "plain", "ce": "plain", "moe": "dense"}
# a cell's kernel run: default_run's RunConfig with the kernels asked for
# by the JAX package's names (the port translates them)
KERNEL_RUN = {"attn_impl": "pallas", "ce_impl": "pallas", "ssm_impl": "pallas"}


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


# profiles taken of a call before it is timed by CUDA events instead (one
# once FALLBACKS_TO_TRUST calls have fallen back), the key of that time,
# and the spin kernels that open and close each profile's window
PROFILE_TRIES = 3
FALLBACKS_TO_TRUST = 3
EVENTS_KEY = "whole call, CUDA events"
SENTINELS = 4
_fallbacks = 0


def device_ms_by_kernel(fn, iters=20, warmup=3) -> dict:
    """{kernel name: device ms a call} of one fn() call: the durations of
    the CUDA kernels its calls launched (torch.profiler), by name, divided
    by `iters`. Host dispatch is left out, so a call shorter than its
    Python wrapper is timed as the card runs it.

    torch.profiler has been seen on that machine to drop the launches at
    the start of a profile's window (the first call's: a kernel caught 19
    times of 20, 2 of 3), in most profiles once it starts to, and every
    launch three profiles running. So SENTINELS spin kernels open the
    window, then a synchronize, and SENTINELS close it; a profile counts
    only where it caught at least SENTINELS spins and a multiple of
    `iters` launches of each kernel of the calls (memsets and copies
    aside), so a drop that reached the calls shows; else it is taken
    again, up to PROFILE_TRIES times (once, after FALLBACKS_TO_TRUST calls
    fell back: a run that reaches that state stays in it). Where none
    counted, the call is timed by CUDA events (``time_ms``, which counts
    the host's dispatch where the card waits for it, so never less than
    the device time), as the one entry ``EVENTS_KEY``, with a
    ``timing_fallback`` line naming the spins the last profile caught and
    the kernels whose counts were off."""
    from torch.profiler import ProfilerActivity, profile

    global _fallbacks
    for _ in range(warmup):
        fn()
    tries = 1 if _fallbacks >= FALLBACKS_TO_TRUST else PROFILE_TRIES
    spins, off = 0, {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(SENTINELS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            for _ in range(SENTINELS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        counts = {}
        times = _device_time_by_kernel(prof, counts)
        spins = sum(c for k, c in counts.items() if "spin_kernel" in k)
        times = {k: v for k, v in times.items() if "spin_kernel" not in k}
        off = {k[:60]: c for k, c in counts.items()
               if c % iters and "spin_kernel" not in k
               and not k.startswith(("Memset", "Memcpy"))}
        if spins >= SENTINELS and not off and sum(times.values()) > 0:
            return {k: v / iters for k, v in times.items()}
    _fallbacks += 1
    ms = time_ms(fn, iters=iters, warmup=0)
    emit({"phase": "timing_fallback", "tries": tries, "iters": iters,
          "spins": spins, "off": off, "ms": ms})
    return {EVENTS_KEY: ms}


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
    # the production cells (bf16): minitron-4b's 32k prefill (G 3) and a
    # train_4k microbatch (4 x 4096), qwen3-moe's 32k prefill (64 heads on
    # 4 KV heads: G 16), decode over 32760 of 32768 slots, hymba-1.5b's
    # global layers over 524280 of 524288, and a qwen3 decode row: G x Sq
    # = 16, exactly SPLIT_MAX_ROWS (no path decodes qwen3)
    for name, bb, ss, hh, kk in (("cell_prefill", 1, 32768, 24, 8),
                                 ("cell_train", 4, 4096, 24, 8),
                                 ("cell_moe_prefill", 1, 32768, 64, 4)):
        cp = torch.arange(ss, dtype=torch.int32)[None].expand(bb, ss)
        cases.append((name, dict(b=bb, sq=ss, sk=ss, h=hh, kh=kk, hd=hd), dict(
            q_pos=cp, k_pos=cp, k_valid=torch.ones(bb, ss, dtype=torch.bool),
            causal=True, window=0), True))
    # the mesh paths' local head counts: mesh_train's rank (2 clients x 2
    # sequences, 12 of 24 heads on 4 of 8 KV heads, f32) and mesh_ep's
    # (16 of 64 heads on 1 of 4 KV heads: G 16, 4096 tokens, bf16)
    # mesh_moe's rank: every client (the data axis is 1), 2 of 16 heads on
    # 2 of 16 KV heads (G 1), f32; mesh_pod's rank: its client's 2
    # sequences (4 clients over (pod, data)), mesh_train's heads, f32
    for name, bb, ss, hh, kk in (("mesh_train", 4, 512, 12, 4),
                                 ("mesh_ep_prefill", 1, 4096, 16, 1),
                                 ("mesh_moe_train", 8, 512, 2, 2),
                                 ("mesh_pod_train", 2, 512, 12, 4)):
        cp = torch.arange(ss, dtype=torch.int32)[None].expand(bb, ss)
        cases.append((name, dict(b=bb, sq=ss, sk=ss, h=hh, kh=kk, hd=hd), dict(
            q_pos=cp, k_pos=cp, k_valid=torch.ones(bb, ss, dtype=torch.bool),
            causal=True, window=0), True))
    # the attn_seq_shard legs' ranks (f32): each model rank's contiguous
    # slice of the queries, every head, against the whole K/V, its query
    # positions offset by its slice (the kernels skip blocks by positions,
    # not indices): mesh_train's (2, 2) rank 1 (positions 256-511, the
    # most causal work) and rank 0 (0-255), 2 clients x 2 sequences, 24
    # heads on 8 KV heads; mesh_encdec's (1, 4) rank 3, 4 clients x 8
    # sequences, 6 heads: the decoder's 112 of 448 queries (336-447),
    # causal, and the encoder's 375 of 1500 frames, non-causal
    for name, bb, sq, sk, hh, kk, d, q0 in (
            ("mesh_train_qslice", 4, 256, 512, 24, 8, hd, 256),
            ("mesh_train_qslice0", 4, 256, 512, 24, 8, hd, 0),
            ("mesh_encdec_qslice", 32, 112, 448, 6, 6, 64, 336)):
        cases.append((name, dict(b=bb, sq=sq, sk=sk, h=hh, kh=kk, hd=d), dict(
            q_pos=torch.arange(q0, q0 + sq, dtype=torch.int32)[None].expand(
                bb, sq),
            k_pos=torch.arange(sk, dtype=torch.int32)[None].expand(bb, sk),
            k_valid=torch.ones(bb, sk, dtype=torch.bool), causal=True,
            window=0), True))
    cases.append(("mesh_encdec_enc_qslice", dict(b=32, sq=375, sk=1500,
                                                 **wh), dict(
        q_pos=torch.arange(1125, 1500, dtype=torch.int32)[None].expand(32,
                                                                        375),
        k_pos=fr[None].expand(32, 1500),
        k_valid=torch.ones(32, 1500, dtype=torch.bool), causal=False,
        window=0), True))
    for name, (bv, sv, hv) in MESH_VIT_ATTN.items():
        vp = torch.arange(sv, dtype=torch.int32)[None].expand(bv, sv)
        cases.append((name, dict(b=bv, sq=sv, sk=sv, h=hv, kh=hv, hd=64),
                      dict(q_pos=vp, k_pos=vp,
                           k_valid=torch.ones(bv, sv, dtype=torch.bool),
                           causal=False, window=0), True))
    # the hybrid mesh paths: mesh_hybrid's rank (dboth: all 25 heads on 5
    # KV heads; 2 clients x 2 sequences in training, its 2 requests in the
    # prefill and in decode over its half of a local ring, f32) and
    # mesh_long_500k's (bf16): one rank's 131072-slot shard of a global
    # cache (the last rank's: its last 8 slots empty), and a shard holding
    # only empty slots (o = 0 and lse = 0, which the merge marks -inf)
    for name, bb, ss in (("mesh_hybrid_train", 4, 512),
                         ("mesh_hybrid_prefill", 2, 1536)):
        cp = torch.arange(ss, dtype=torch.int32)[None].expand(bb, ss)
        cases.append((name, dict(b=bb, sq=ss, sk=ss, h=25, kh=5, hd=64),
                      dict(q_pos=cp, k_pos=cp,
                           k_valid=torch.ones(bb, ss, dtype=torch.bool),
                           causal=True, window=1024), True))
    half = torch.arange(512, 1024, dtype=torch.int32)
    half = torch.where(half + 1024 <= 1551, half + 1024, half)
    cases.append(("mesh_hybrid_decode", dict(b=2, sq=1, sk=512, h=25, kh=5,
                                             hd=64), dict(
        q_pos=torch.full((2, 1), 1551, dtype=torch.int32),
        k_pos=half[None].expand(2, 512),
        k_valid=torch.ones(2, 512, dtype=torch.bool), causal=True,
        window=1024), True))
    # the encoder-decoder and VLM mesh paths: mesh_vlm's rank (2 clients x
    # 2 sequences, 32 of 64 heads on 4 of 8 KV heads: G 8, causal on
    # M-RoPE's row 0), and mesh_encdec's decode (dboth: all 6 heads over
    # one rank's 112 of the 448 text slots: rank 2's holds the prompt's
    # last 3 positions and the step's, rank 3's only empty slots until
    # step 109). Its cross-attention decode over the 1500 frames, every
    # head on every rank, is encdec_cross_decode's shape.
    vp = layers.build_positions(get_config("qwen2-vl-72b"), 4, 512, 256)[:, 0]
    cases.append(("mesh_vlm_train", dict(b=4, sq=512, sk=512, h=32, kh=4,
                                         hd=hd),
                  dict(q_pos=vp, k_pos=vp,
                       k_valid=torch.ones(4, 512, dtype=torch.bool),
                       causal=True, window=0), True))
    wslots = torch.arange(224, 336, dtype=torch.int32)
    wslots = torch.where(wslots <= 227, wslots, -1)[None].expand(4, 112)
    wempty = torch.full((4, 112), -1, dtype=torch.int32)
    for name, kp, main in (("mesh_encdec_decode", wslots, True),
                           ("mesh_encdec_empty_decode", wempty, False)):
        cases.append((name, dict(b=4, sq=1, sk=112, **wh), dict(
            q_pos=torch.full((4, 1), 227, dtype=torch.int32), k_pos=kp,
            k_valid=kp >= 0, causal=True, window=0), main))
    shard = torch.arange(393216, 524288, dtype=torch.int32)[None].clone()
    shard[:, 524280 - 393216:] = -1
    empty = torch.full((1, 131072), -1, dtype=torch.int32)
    for name, kp, main in (("mesh_long_decode", shard, True),
                           ("mesh_long_empty_decode", empty, False)):
        cases.append((name, dict(b=1, sq=1, sk=131072, h=25, kh=5, hd=64),
                      dict(q_pos=torch.full((1, 1), 524280,
                                            dtype=torch.int32),
                           k_pos=kp, k_valid=kp >= 0, causal=True,
                           window=0), main))
    for name, bb, sk, filled, hh, kk, d, main in (
            ("cell_decode", 4, 32768, 32760, 24, 8, hd, True),
            ("cell_long_decode", 1, 524288, 524280, 25, 5, 64, True),
            ("qwen3_decode", 4, 32768, 32760, 64, 4, hd, False)):
        kp = torch.full((bb, sk), -1, dtype=torch.int32)
        kp[:, :filled] = torch.arange(filled, dtype=torch.int32)
        cases.append((name, dict(b=bb, sq=1, sk=sk, h=hh, kh=kk, hd=d), dict(
            q_pos=torch.full((bb, 1), filled, dtype=torch.int32), k_pos=kp,
            k_valid=kp >= 0, causal=True, window=0), main))
    return cases


# the vit cases: (batch, sequence length); only the early-fusion joint
# sequence runs at bf16 compute on a main path (vit_train_bf16), the others
# f32 only
VIT_ATTN = {"vit_early": (64, 274), "vit_vision": (64, 197),
            "vit_text": (64, 77), "vit_audio": (64, 513),
            "vit_fedavg": (8, 274)}
# the mesh vit paths' ranks (f32): (batch, sequence length, heads). On (2,
# 2) a data rank's 2 clients x 4 samples and 6 of the 12 heads (heads),
# over the early-fusion joint sequence and late fusion's passes
# (retrieval's are its vision and text ones); on (1, 8) every client's 16
# samples and all 12 heads on every rank (dboth)
MESH_VIT_ATTN = {"mesh_vit_early": (8, 274, 6),
                 "mesh_vit_vision": (8, 197, 6),
                 "mesh_vit_text": (8, 77, 6), "mesh_vit_audio": (8, 513, 6),
                 "mesh_vit_dboth": (16, 274, 12)}


# the production cells' cases and mesh_ep's: bf16 only, as they compute
CELL_ATTN = ("cell_prefill", "cell_train", "cell_moe_prefill", "cell_decode",
             "cell_long_decode", "qwen3_decode", "mesh_ep_prefill",
             "mesh_long_decode", "mesh_long_empty_decode")


# the cases where every query sees every key (no mask for SDPA)
ENCDEC_ATTN = ("encdec_enc", "encdec_cross", "encdec_cross_decode",
               "mesh_encdec_enc_qslice")
FULL_ATTN = (*VIT_ATTN, *MESH_VIT_ATTN, *ENCDEC_ATTN)
# the cases no bf16 path runs
F32_ONLY = (*(n for n in FULL_ATTN if n != "vit_early"), "vlm_train",
            "mesh_train", "mesh_hybrid_train", "mesh_hybrid_prefill",
            "mesh_hybrid_decode", "mesh_vlm_train", "mesh_encdec_decode",
            "mesh_encdec_empty_decode", "mesh_moe_train", "mesh_pod_train",
            "mesh_train_qslice", "mesh_train_qslice0", "mesh_encdec_qslice")


def _attn_dtypes(name):
    if name in CELL_ATTN:
        return (torch.bfloat16,)
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
PLAIN_CAUSAL = ("prefill", "train", "moe_prefill", "moe_train",
                "cell_prefill", "cell_train", "cell_moe_prefill",
                "mesh_train", "mesh_ep_prefill", "mesh_moe_train",
                "mesh_pod_train")
# a plain version's [heads x queries x keys] f32 scores stay under this
# many bytes a query chunk (a 32k prefill's would be 103-275 GB at once)
PLAIN_CHUNK_BYTES = 2 ** 31


def _q_chunks(q, k):
    """Query slices whose plain scores fit PLAIN_CHUNK_BYTES."""
    b, sq, h, _ = q.shape
    n = max(1, PLAIN_CHUNK_BYTES // (4 * b * h * k.shape[1]))
    return [slice(i, min(i + n, sq)) for i in range(0, sq, n)]


def _plain_fwd(q, k, v, qp, kp, k_valid, **kw):
    """``fa.flash_attention_plain`` over query chunks (each query row is
    its own softmax, so the chunks' o and lse join)."""
    parts = [fa.flash_attention_plain(q[:, sl], k, v, qp[:, sl], kp,
                                      k_valid=k_valid, **kw)
             for sl in _q_chunks(q, k)]
    return (torch.cat([o for o, _ in parts], dim=1),
            torch.cat([lse for _, lse in parts], dim=2))


def _plain_bwd(q, k, v, qp, kp, kv, o, lse, do, **kw):
    """``fa.flash_attention_bwd_plain`` over query chunks: dq of each
    chunk joined, dk and dv summed in f32 over the chunks."""
    dq, dk, dv = [], None, None
    for sl in _q_chunks(q, k):
        a, b, c = fa.flash_attention_bwd_plain(
            q[:, sl], k, v, qp[:, sl], kp, kv, o[:, sl], lse[:, :, sl],
            do[:, sl], **kw)
        dq.append(a)
        dk = b.float() if dk is None else dk + b.float()
        dv = c.float() if dv is None else dv + c.float()
    return torch.cat(dq, dim=1), dk.to(k.dtype), dv.to(v.dtype)


def _iters(q, k):
    """Timed calls of a case: fewer for the cells' long sequences."""
    return 3 if q.shape[1] * k.shape[1] > 2 ** 26 else 20


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
            o_ref, lse_ref = _plain_fwd(q, k, v, qp, kp, kv, **kw)
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
                _plain_fwd(q, k, v, qp, kp, kv, **kw)

            it = _iters(q, k)
            rec["ms"] = device_ms(run_kernel, iters=it)
            rec["wall_ms"] = time_ms(run_kernel, iters=it)
            # (the comparison's plain call above was its warm-up)
            rec["plain_ms"] = device_ms(run_plain, iters=min(it, 5),
                                        warmup=0)
            lib = _library_call(q, k, v, qp, kp, kv, m, name)
            rows = fa.pair_mask(qp, kp, kv, m["causal"], m["window"]).any(-1)
            if rows.any():
                rec["library_max_abs_err_o"] = _hold_yardstick(
                    "flash_attention_fwd", name, dtype, lib(), o_ref, rows,
                    tol)
                rec["library_ms"] = device_ms(lib, iters=it)
                rec["library_wall_ms"] = time_ms(lib, iters=it)
            else:
                # no row has a key: SDPA's softmax is NaN there, not this
                # function (o = 0, lse = 0)
                rec["library_ms"] = None
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
            want = _plain_bwd(*args, **kw)
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
            rec["plain_ms"] = device_ms(lambda: _plain_bwd(*args, **kw),
                                        iters=min(_iters(q, k), 5),
                                        warmup=0)
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
             # cell_train_4k: a microbatch's 4 x 4095 tokens, bf16 h
             ("cell_train_4k", 16380, 3072, 256000, bf16, f32, True),
             ("ragged", 1000, 200, 10007, f32, f32, False),
             ("ragged", 1000, 200, 10007, bf16, bf16, False),
             ("ragged", 1000, 200, 10007, bf16, f32, False),
             # mesh_train's rank: its 2 clients' 2044 tokens on the second
             # half of the vocab (V/2 columns from 128000), labels drawn
             # over the whole 256000 and shifted: about half lie outside
             # the shard (no gold logit, no one-hot)
             ("mesh_train", 2044, 3072, 128000, f32, f32, True, 256000,
              128000),
             # mesh_vlm's rank: its 2 clients' 2 x 2 x 255 text tokens on
             # the second half of qwen2-vl's vocab (76032 columns from
             # 76032)
             ("mesh_vlm", 1020, 8192, 76032, f32, f32, True, 152064,
              76032),
             # mesh_moe's rank: every client's 4 x 2 x 511 tokens on the
             # second eighth of qwen2-moe's vocab (18992 columns from
             # 18992): 7 labels in 8 outside the shard
             ("mesh_moe", 4088, 2048, 18992, f32, f32, True, 151936,
              18992),
             # mesh_pod's rank: its client's 2 x 511 tokens on mesh_train's
             # vocab shard
             ("mesh_pod", 1022, 3072, 128000, f32, f32, True, 256000,
              128000)]
    fwd_res, bwd_res = [], []
    for name, t, d, v, h_dtype, w_dtype, main_path, *shard in cases:
        v_all, v0 = shard or (v, 0)
        h = (torch.randn((t, d), generator=g, device="cuda")).to(h_dtype)
        w = (torch.randn((d, v), generator=g, device="cuda")
             * d ** -0.5).to(w_dtype)
        lab = torch.randint(0, v_all, (t,), generator=g, device="cuda",
                            dtype=torch.int32) - v0
        gg = torch.randn((t,), generator=g, device="cuda") / t
        dtype = f"{str(h_dtype)[6:]}/{str(w_dtype)[6:]}"
        base = {"case": name, "dtype": dtype,
                "shape": dict(t=t, d=d, v=v), "main_path": main_path}
        if shard:
            base.update(vocab_shard_first_column=v0,
                        labels_outside_shard=int(((lab < 0) | (lab >= v))
                                                 .sum().item()))
        iters = 3 if main_path else 10
        # the library call on the same function: one dtype for both
        lt = torch.promote_types(h_dtype, w_dtype)
        hl, wl = h.to(lt), w.to(lt)

        # the plain version and the pieces model in token chunks past
        # CE_CHUNK tokens ([T, V] f32 logits of a 4k-token microbatch are
        # 16.8 GB a tensor)
        plain_fwd = _ce_chunked(sx.softmax_xent_fwd_plain, t)
        pieces_fwd = _ce_chunked(sx.softmax_xent_fwd_pieces, t)
        plain_bwd = _ce_chunked(sx.softmax_xent_bwd_plain, t, backward=True)
        pieces_bwd = _ce_chunked(sx.softmax_xent_bwd_pieces, t,
                                 backward=True)
        loss, lse = sx.softmax_xent_fwd(h, w, lab)
        torch.cuda.synchronize()
        want = plain_fwd(h, w, lab)
        rec = dict(base, tol=TOL[torch.float32])
        _check_close("softmax_xent_fwd", name, dtype,
                     zip(("loss", "lse"), (loss, lse), want),
                     TOL[torch.float32], rec)
        del want
        _rel_gaps(rec, zip(("loss", "lse"), (loss, lse),
                           pieces_fwd(h, w, lab)))
        rec["ms"] = device_ms(lambda: sx.softmax_xent_fwd(h, w, lab),
                              iters=iters, warmup=1)
        # (the comparison's plain call above was its warm-up)
        rec["plain_ms"] = device_ms(lambda: plain_fwd(h, w, lab),
                                    iters=iters, warmup=0)
        # (no single PyTorch call computes a vocab shard's CE: its labels
        # outside the shard have no gold logit; beside it, the same call
        # on the shard's work with every label moved into the shard)
        rec["library_ms"] = None if shard else device_ms(
            lambda: F.cross_entropy(hl @ wl, lab.long(), reduction="none"),
            iters=iters, warmup=1)
        inside = lab.long().clamp(0, v - 1)
        if shard:
            rec["library_in_shard_labels_ms"] = device_ms(
                lambda: F.cross_entropy(hl @ wl, inside, reduction="none"),
                iters=iters, warmup=1)
        rec["bound_ms"], rec["bound_by"], rec["bound_f32_cuda_core_ms"] = \
            _ce_bound(t, d, v, h_dtype, w_dtype, backward=False)
        _hold_to_bound("softmax_xent_fwd", rec)
        emit({"phase": "kernels", "kernel": "softmax_xent_fwd", **rec})
        fwd_res.append(rec)

        dh, dw = sx.softmax_xent_bwd(h, w, lab, lse, gg)
        torch.cuda.synchronize()
        want_dh, want_dw = plain_bwd(h, w, lab, lse, gg)
        # each output in its own dtype's tolerance
        rec = dict(base, tol_dh=GRAD_TOL[h_dtype], tol_dw=GRAD_TOL[w_dtype])
        _check_close("softmax_xent_bwd", name, dtype,
                     [("dh", dh, want_dh)], GRAD_TOL[h_dtype], rec)
        _check_close("softmax_xent_bwd", name, dtype,
                     [("dw", dw, want_dw)], GRAD_TOL[w_dtype], rec)
        del want_dh, want_dw
        _rel_gaps(rec, zip(("dh", "dw"), (dh, dw),
                           pieces_bwd(h, w, lab, lse, gg)))
        del dh, dw
        rec["ms"] = device_ms(lambda: sx.softmax_xent_bwd(h, w, lab, lse, gg),
                              iters=iters, warmup=1)
        rec["plain_ms"] = device_ms(
            lambda: plain_bwd(h, w, lab, lse, gg), iters=iters, warmup=0)
        rec["library_ms"] = None
        hg = hl.clone().requires_grad_()
        wg = wl.clone().requires_grad_()
        lib = F.cross_entropy(hg @ wg, inside if shard else lab.long(),
                              reduction="none")
        lib_ms = device_ms(lambda: torch.autograd.grad(
            lib, (hg, wg), gg, retain_graph=True), iters=iters, warmup=1)
        rec["library_in_shard_labels_ms" if shard else "library_ms"] = lib_ms
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


CE_CHUNK = 4096


def _ce_chunked(fn, t, backward=False):
    """`fn` (a CE plain version or pieces model) over token chunks of
    CE_CHUNK where T exceeds it: the forward's per-token outputs and dh
    joined, dw summed in f32. Its own function where T fits one chunk."""
    if t <= CE_CHUNK:
        return fn
    parts = [slice(i, min(i + CE_CHUNK, t)) for i in range(0, t, CE_CHUNK)]
    if not backward:
        def fwd(h, w, lab):
            outs = [fn(h[sl], w, lab[sl]) for sl in parts]
            return tuple(torch.cat(x) for x in zip(*outs))
        return fwd

    def bwd(h, w, lab, lse, g):
        dh, dw = [], None
        for sl in parts:
            a, b = fn(h[sl], w, lab[sl], lse[sl], g[sl])
            dh.append(a)
            dw = b.float() if dw is None else dw + b.float()
        return torch.cat(dh), dw.to(w.dtype)
    return bwd


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
    # cell_train_4k's link: a microbatch of 4 clients x 1 x 4096 tokens
    ("cell_train_4k", 16384, 3072, torch.bfloat16, "vector", 0),
    ("hybrid_train", 4096, 1600, torch.float32, "vector", 0),
    ("moe_train", 4096, 2048, torch.float32, "vector", 0),
    ("train", 4096, 3072, torch.float32, "vector", 0),
    # mesh_train's data rank: its 2 clients' 2 x 2 x 512 rows (row0 2048
    # on the second)
    ("mesh_train", 2048, 3072, torch.float32, "vector", 0),
    # mesh_vlm's data rank: 2 clients x 2 x (256 patches + 256 tokens) at
    # d 8192 (row0 2048 on the second)
    ("mesh_vlm", 2048, 8192, torch.float32, "vector", 0),
    # mesh_pod's client rank: its client's 2 x 512 rows (row0 1024 on the
    # second rank of (pod, data))
    ("mesh_pod", 1024, 3072, torch.float32, "vector", 0),
    # mesh_vit's data rank on (2, 2): its 2 clients x 4 samples x 274
    # tokens (early fusion; row0 2192 on the second)
    ("mesh_vit", 2192, 768, torch.float32, "vector", 0),
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
L2_BYTES = 50e6
RING_BYTES = 4 * L2_BYTES


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
    # row0: the rows in two calls, the second at row0 = its first row,
    # each from a generator in the first one's state, are the one call's
    # bits (a data rank quantising its own clients' rows), in the kernel
    # and in the plain version
    half = x.shape[0] // 2
    whole = routes["philox"][0]
    parts = [q8.quant_dequant(x[sl], torch.Generator(
                 device="cuda").manual_seed(41), row0=sl.start)
             for sl in (slice(0, half), slice(half, x.shape[0]))]
    plain = q8.quant_dequant_plain(x[half:], torch.Generator(
        device="cuda").manual_seed(41), row0=half)
    routes["row0"] = (torch.cat(parts), whole)
    routes["row0_plain"] = (plain, parts[1])
    if rec["case"].startswith("mesh_"):
        # a second data rank's call at row0 = its rank's first row (the
        # case's row count), against the rows of one call over both
        rank1 = q8.quant_dequant(x, torch.Generator(
            device="cuda").manual_seed(41), row0=x.shape[0])
        both = q8.quant_dequant(torch.cat([x, x]), torch.Generator(
            device="cuda").manual_seed(41))
        routes["row0_rank"] = (rank1, both[x.shape[0]:])
        del both
    bits = torch.int32 if x.dtype == torch.float32 else torch.int16
    for route, (got, want) in routes.items():
        rec[f"max_abs_err_{route}"] = _max_err(got, want)
        rec[f"bitwise_{route}"] = torch.equal(got.view(bits), want.view(bits))
    del routes, parts, plain, whole
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
    ok = in_range and all(rec[f"bitwise_{r}"] for r in (
        "nearest", "streamed", "philox", "row0", "row0_plain",
        *(("row0_rank",) if rec["case"].startswith("mesh_") else ())))
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
    (``ms_call``). Each route's bytes bound: nearest and Philox x in, y
    out; streamed u in as well. The guard holds the same durations to
    that bound less an L2 write-back allowance (``guard_bound_ms_*``):
    up to L2_BYTES of y may still sit in L2 when the kernel ends and
    drain after it, so only the rest of y must have reached HBM (the
    durations came in up to 1.7 % under the full bound on 300-600 MB
    streams). ``share_of_bound_rate`` may so exceed 1 by at most that
    allowance. A reading under the guard (a profile that lost part of its
    window, as one on the H100 read 0.0483 ms for a 0.1015 ms call) is
    taken again, up to PROFILE_TRIES readings, each recorded
    (``retaken_ms_*``)."""
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
        io = 2 * xb / PEAK_BYTES * 1e3              # x in, y out
        rec["bound_ms_nearest"] = rec["bound_ms_philox"] = io
        rec["bound_ms_streamed"] = io + rows * d * 4 / PEAK_BYTES * 1e3
        drain = min(xb, L2_BYTES) / PEAK_BYTES * 1e3  # y left in L2
        iters = 20
        for r, rng in rngs.items():
            guard = rec[f"guard_bound_ms_{r}"] = rec[f"bound_ms_{r}"] - drain
            # a reading under the guard is a time no kernel can take: the
            # profile lost part of the window (the dropped launches
            # ``device_ms_by_kernel`` describes), so it is taken again, up
            # to PROFILE_TRIES readings; the kept one is held to the guard
            retaken = []
            for _ in range(PROFILE_TRIES):
                times = _ring_ms(q8.quant_dequant, xs, us, rng, iters)
                # where no profile caught a kernel, the whole call's time
                own = {k: v for k, v in times.items()
                       if "quant8" in k or k == EVENTS_KEY}
                if sum(own.values()) >= guard:
                    break
                retaken.append(sum(own.values()))
            if retaken:
                emit({"phase": "timing_retaken", "kernel": "quant_dequant",
                      "case": f"{name} ({r})", "readings_ms": retaken,
                      "guard_bound_ms": guard})
            rec[f"retaken_ms_{r}"] = retaken
            rec[f"ms_{r}"] = sum(own.values())
            rec[f"kernels_{r}"] = sorted(own)
            if r == "philox":
                rec["ms_call"] = sum(times.values())
            rec[f"plain_ms_{r}"] = sum(_ring_ms(
                q8.quant_dequant_plain, xs, us, rng, 5).values())
        rec["library_ms"] = None    # no single PyTorch call computes it
        for r in rngs:
            _hold_to_bound("quant_dequant", {
                "case": f"{name} ({r})", "dtype": rec["dtype"],
                "ms": rec[f"ms_{r}"], "bound_ms": rec[f"guard_bound_ms_{r}"]})
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
            # the mesh paths' local channels: falcon-mamba's 4096 and
            # hymba's 1600 a rank on (2, 2) (its 2 clients x 2 sequences
            # in training, its 2 requests in hymba's prefill), and hymba's
            # 800 on (1, 4), whose last 64-channel block of the backward's
            # db/dc partials is ragged (12.5 blocks)
            ("mesh_ssm_train", 4, 512, 4096, 16, ck, 256, f32, False, True),
            ("mesh_hybrid_train", 4, 512, 1600, 16, ck, 256, f32, False,
             True),
            ("mesh_hybrid_prefill", 2, 1536, 1600, 16, ck, 256, f32, True,
             True),
            ("local_800", 8, 512, 800, 16, ck, 256, f32, False, False),
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
        # the plain scans launch a kernel an op a step, thousands a call:
        # more than a profile holds (torch.profiler dropped launches of
        # such calls and took up to 29 s a case), so one call's wall time
        # by CUDA events, the host's launches included; the comparison's
        # plain call above was its warm-up
        rec["plain_ms"] = time_ms(lambda: ss.selective_scan_fwd_plain(
            x, dt, bm, cm, a_log, h0, chunk=chunk), iters=1, warmup=0)
        rec["plain_timed_by"] = "CUDA events (wall)"
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
        rec["plain_ms"] = time_ms(
            lambda: ss.selective_scan_bwd_plain(*args, chunk=chunk), iters=1,
            warmup=0)
        rec["plain_timed_by"] = "CUDA events (wall)"
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
    cut = dataclasses.replace(cfg, num_layers=spec["layers"],
                              encoder_layers=spec.get("encoder_layers",
                                                      cfg.encoder_layers))
    depth = {"layers": f"{cut.num_layers} of {cfg.num_layers}",
             "reduced": spec["reduced"]}
    if cut.encoder_layers != cfg.encoder_layers:
        depth["encoder_layers"] = (f"{cut.encoder_layers} of "
                                   f"{cfg.encoder_layers}")
    return cut, depth


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


def _device_time_by_kernel(prof, counts=None):
    """{kernel name: device ms} of the CUDA kernels a profile recorded;
    each name's launch count into `counts` where given."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key] = out.get(evt.key, 0.0) + \
                evt.self_device_time_total / 1e3
            if counts is not None:
                counts[evt.key] = counts.get(evt.key, 0) + evt.count
    return out


def phase_profile(path, prefill, decode, params, tokens, stub, serve_rec,
                  steps=4, top=8):
    """Where a serve path's time goes: device time by kernel over one
    prefill and over `steps` decode steps (torch.profiler), and the
    device's busy share of the unprofiled host times of the serve phase."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
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
        "median_step_ms": statistics.median(times[1:] or times) * 1e3,
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
    batches = [train.to_device(loader.batch(i), device)
               for i in range(steps)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    loss_fn = mpsl.make_lm_loss(cfg, run, impls=mpsl.KERNEL_IMPLS)
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
        naive_fn = mpsl.make_lm_loss(
            cfg, run, impls={**mpsl.KERNEL_IMPLS, "attn": "naive"})
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

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, met = step_fn(state, batch)
        float(met["loss"])
        torch.cuda.synchronize()
    counts = {}
    times = _device_time_by_kernel(prof, counts)
    launched = sum(counts.values())
    busy = sum(times.values())
    wall = train_rec["median_step_ms"]
    ranked = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    rec = {"phase": "train_profile", "path": path, "per": per,
           "device_busy_ms": busy,
           "host_ms_unprofiled": wall,
           "device_idle_share": max(0.0, 1 - busy / wall),
           "device_kernels": launched,
           "host_us_per_kernel": wall * 1e3 / max(launched, 1),
           "top_kernels_ms": [[k[:90], v] for k, v in ranked]}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# the trainer path: launch/train.py's build, the prefetcher and the Trainer


@contextlib.contextmanager
def _count_syncs():
    """Each synchronizing CUDA call made inside (torch's sync debug mode
    "warn"), on any thread, with the Python stack that made it."""
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            seen.append({"message": str(message)[:160],
                         "stack": [ln.strip() for ln in
                                   traceback.format_stack(limit=7)[:-1]]})

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _cli_args(spec, *extra):
    """The train CLI's arguments for a path's spec, parsed by its own
    parser (full width, int8 links, prefetch depth 2)."""
    argv = ["--arch", spec["arch"], "--full",
            "--n-clients", str(spec["n_clients"]),
            "--batch-per-client", str(spec["batch_per_client"]),
            "--seq", str(spec["seq"]),
            "--trainable-blocks", str(spec["trainable_blocks"]),
            "--steps", str(spec["steps"]), "--lr", str(spec["lr"]),
            "--seed", str(spec["seed"]), "--compress", "--prefetch", "2",
            *extra]
    return train.parser().parse_args(argv)


def _build_trainer(args, device, tc, fault_plan=None, per_step=None):
    """(trainer, prefetcher, cfg, run) wired as ``train.main`` wires them;
    with `per_step`, each step's launches are appended to it."""
    cfg, run, state, step_fn, inner = train.build(
        args, device, guard_nonfinite=fault_plan is not None)
    if per_step is not None:
        plain_step = step_fn

        def step_fn(state, batch):
            before = read_counts()
            out = plain_step(state, batch)
            after = read_counts()
            per_step.append({k: after[k] - before[k] for k in after})
            return out
    loader = PrefetchLoader(
        inner, depth=args.prefetch,
        place_fn=functools.partial(sharding.place_batch, device=device))
    trainer = Trainer(step_fn, state, loader, tc, log_fn=lambda s: None)
    return trainer, loader, cfg, run


def _state_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in tree.leaves(state)
               if torch.is_tensor(t))


def _snapshot_state(state):
    """Device copies of the params and AdamW state, to compare bitwise."""
    return {"params": tree.map_(lambda t: t.detach().clone(),
                                state["params"]),
            "opt": tree.map_(lambda t: t.clone(), state["opt"])}


def _bitwise(path, what, got, want) -> None:
    """Every leaf of got's params and AdamW state equals want's, bit for
    bit (NaN-free f32 and int tensors: torch.equal is bitwise)."""
    names = [f"params.{n}" for n in _leaf_names(want["params"])] + \
        [f"opt.{n}" for n in _leaf_names(want["opt"])]
    leaves = zip(names, tree.leaves(got["params"]) + tree.leaves(got["opt"]),
                 tree.leaves(want["params"]) + tree.leaves(want["opt"]))
    bad = [n for n, a, b in leaves if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"{path}: {what} differs from the straight run "
                             f"in {len(bad)} leaves, first {bad[:3]}")


def phase_trainer(path, spec, train_rec):
    """The `train` path again, through the train CLI's build, the
    prefetcher (depth 2, ``sharding.place_batch`` on its producer thread)
    and the Trainer, with the recorder writing a run log: each step
    launches exactly what a train step launches, every loss and grad norm
    equals the `train` path's kernel run bitwise, ``Trainer.run`` syncs
    exactly twice (the first step's log and the final readback), and the
    run log holds the pipeline's spans and the links' records, the wire
    bytes those of ``core.costs``. Then the Trainer's host time a step
    against the plain loop's, and a profile of two more steps."""
    from torch.profiler import ProfilerActivity, profile

    device = serve.resolve_device("cuda")
    steps = spec["steps"]
    args = _cli_args(spec)
    logdir = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    log_path = os.path.join(logdir, "run.jsonl")
    comm.reset()
    obs.configure(log_path, meta={"script": "chip_smoke", "path": path})
    try:
        per_step = []
        tc = TrainerConfig(total_steps=steps, log_every=steps + 1)
        trainer, loader, cfg, run = _build_trainer(args, device, tc,
                                                   per_step=per_step)
        state_bytes = _state_bytes(trainer.state)
        torch.cuda.synchronize()
        reset_counts()
        with _count_syncs() as syncs:
            t0 = time.perf_counter()
            result = trainer.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts()
        launched = list(per_step)
        loader.close()
    finally:
        obs.shutdown()
    records = report.load_records(log_path)
    text = report.render(records)
    shutil.rmtree(logdir, ignore_errors=True)
    got = [to_host(m) for _, m in trainer.ring.entries_after(0)]
    # two steps more, profiled: device time a step
    loader = PrefetchLoader(
        loader.inner, depth=2,
        place_fn=functools.partial(sharding.place_batch, device=device))
    trainer.loader = loader
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.run(steps + 2)
        torch.cuda.synchronize()
    loader.close()
    busy = sum(_device_time_by_kernel(prof).values()) / 2
    links = {r["name"]: r for r in records if r.get("kind") == "link"}
    spans = dict(collections.Counter(r["name"] for r in records
                                     if r.get("kind") == "span"))
    bn, seq = spec["batch_per_client"], spec["seq"]
    analytic = costs.mpsl_lm_client_cost(
        cfg, run.mpsl, dataclasses.replace(SHAPES["train_4k"], seq_len=seq),
        compressed=True).comm_mb_per_epoch * 1e6
    wire = {k: links[k]["wire_bytes_per_client"] if k in links else None
            for k in ("uplink.activations", "downlink.gradients")}
    host_ms = wall / steps * 1e3
    rec = {"phase": path, "arch": spec["arch"], "steps": steps,
           "prefetch": args.prefetch, "state_bytes": state_bytes,
           "losses": [float(m["loss"]) for m in got],
           "grad_norms": [float(m["grad_norm"]) for m in got],
           "train_losses": train_rec["losses"],
           "train_grad_norms": train_rec["grad_norms"],
           "launches_per_step": launched,
           "expected_per_step": train_launches_per_step(cfg),
           "syncs": len(syncs), "syncs_expected": 2,
           "host_ms_per_step": host_ms,
           "train_plain_loop_step_ms": train_rec["step_ms"],
           "train_plain_loop_median_step_ms": train_rec["median_step_ms"],
           "steps_per_sec": result["steps_per_sec"],
           "host_stall_frac": result["host_stall_frac"],
           "device_busy_ms_per_step": busy,
           "device_idle_share": max(0.0, 1 - busy / host_ms),
           "spans": spans, "link_wire_bytes_per_client": wire,
           "costs_bytes_per_sample": analytic,
           "scale_bytes_per_sample": 2 * seq * compression.SCALE_BYTES,
           "quantized_in_trace": {k: links.get(k, {}).get(
               "quantized_in_trace") for k in wire},
           "report_lines": len(text.splitlines())}
    if len(syncs) != 2:
        rec["sync_stacks"] = syncs[:6]
    emit(rec)
    _hold_steps(path, rec)
    if (rec["losses"], rec["grad_norms"]) != (train_rec["losses"],
                                              train_rec["grad_norms"]):
        raise AssertionError(f"{path}: losses / grad norms differ from the "
                             f"train path's bitwise")
    if len(syncs) != 2:
        raise AssertionError(f"{path}: Trainer.run synced {len(syncs)} "
                             f"times, expected 2")
    want = {"step/dispatch": steps, "step/get_batch": steps,
            "metrics/readback": 2}
    if any(spans.get(k) != v for k, v in want.items()) or any(
            spans.get(k, 0) < steps for k in ("host/assemble",
                                              "h2d/place_batch")):
        raise AssertionError(f"{path}: run log spans {spans}")
    if None in wire.values() or not all(rec["quantized_in_trace"].values()):
        raise AssertionError(f"{path}: link records {links}")
    per_sample = sum(wire.values()) / bn
    if per_sample != round(analytic) + rec["scale_bytes_per_sample"]:
        raise AssertionError(f"{path}: wire bytes a sample {per_sample}, "
                             f"core.costs {analytic} + scales "
                             f"{rec['scale_bytes_per_sample']}")
    del trainer, loader
    return counts


def _run_leg(args, device, tc, steps, fault_plan=None, per_step=None):
    """Build a trainer (auto-resuming from tc.ckpt_dir), run it to `steps`
    and close its prefetcher. Returns (trainer, cfg, the run's seconds,
    ending in a sync, its host_stall_frac)."""
    trainer, loader, cfg, _ = _build_trainer(args, device, tc, fault_plan,
                                             per_step)
    torch.cuda.synchronize()
    t = time.perf_counter()
    result = trainer.run(steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    loader.close()
    return trainer, cfg, run_s, result["host_stall_frac"]


def _ckpt_bytes(directory, step) -> int:
    d = os.path.join(directory, f"step_{step:08d}")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def phase_trainer_resume(path, spec, encdec_rec, encdec_profile):
    """Restart and chaos at full width and depth (whisper-tiny, the
    `encdec_train` spec), through the Trainer and the prefetcher:
    (i) 6 steps straight; (ii) 3 steps, ``checkpoint_now`` and ``wait``,
    everything deleted, rebuilt, auto-resumed and run to 6; (iii) the
    plan producer_crash@1,ckpt_fail@3 with a checkpoint every 3 steps;
    (iv) nan_batch@4 under the guard, run to 4, then to 5. (ii) and (iii)
    must end on (i)'s params and AdamW state bit for bit, (iv)'s step 4
    must leave them as they were. Records the checkpoint's bytes, the ms
    a save blocks the main thread and the ms of its background write, the
    restore ms, and the Trainer's host ms a step against the plain loop's
    of `encdec_train`."""
    device = serve.resolve_device("cuda")
    steps = 6
    args = _cli_args(dict(spec, steps=steps))
    root = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    rec = {"phase": path, "arch": spec["arch"], "steps": steps,
           "prefetch": args.prefetch}
    try:
        # the old CLI's loop: each batch assembled and copied in series
        # with the step, one sync a step
        _, _, state, step_fn, loader = train.build(args, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serial = []
        for i in range(steps):
            batch = train.to_device(loader.batch(i), device)
            state, met = step_fn(state, batch)
            serial.append(float(met["loss"]))
        torch.cuda.synchronize()
        rec["serial_loop_ms_per_step"] = (time.perf_counter() - t0) / \
            steps * 1e3
        del state, step_fn, loader, batch, met
        gc.collect()
        torch.cuda.empty_cache()

        # (i) straight, every launch counter set to 0 just before
        per_step = []
        tc = TrainerConfig(total_steps=steps, log_every=steps + 1)
        torch.cuda.synchronize()
        reset_counts()
        t, cfg, run_s, stall = _run_leg(args, device, tc, steps,
                                        per_step=per_step)
        counts = read_counts()
        got = [to_host(m) for _, m in t.ring.entries_after(0)]
        straight = _snapshot_state(t.state)
        host_ms = run_s / steps * 1e3
        busy = encdec_profile["device_busy_ms"]
        rec.update(state_bytes=_state_bytes(t.state),
                   launches_per_step=per_step,
                   expected_per_step=train_launches_per_step(cfg),
                   losses=[float(m["loss"]) for m in got],
                   grad_norms=[float(m["grad_norm"]) for m in got],
                   host_ms_per_step=host_ms, host_stall_frac=stall,
                   encdec_train_plain_loop_step_ms=encdec_rec["step_ms"],
                   encdec_train_plain_loop_median_step_ms=encdec_rec[
                       "median_step_ms"],
                   encdec_train_device_busy_ms=busy,
                   device_idle_share=max(0.0, 1 - busy / host_ms))
        del t
        _hold_steps(path, rec)
        if serial != rec["losses"]:
            raise AssertionError(f"{path}: the serial loop's losses "
                                 f"{serial} differ from the Trainer's")

        # (ii) 3 steps, checkpoint, delete everything, rebuild, resume
        ck = os.path.join(root, "ii")
        tc = TrainerConfig(total_steps=steps, ckpt_every=100, ckpt_dir=ck,
                           log_every=steps + 1)
        t, _, _, _ = _run_leg(args, device, tc, 3)
        t0 = time.perf_counter()
        t.checkpoint_now()
        blocked = time.perf_counter() - t0
        t.ckpt.wait()
        write = time.perf_counter() - t0 - blocked
        rec.update(ckpt_bytes=_ckpt_bytes(ck, 3),
                   ckpt_save_blocked_ms=blocked * 1e3,
                   ckpt_write_ms=write * 1e3)
        del t
        gc.collect()
        torch.cuda.empty_cache()
        trainer, loader, _, _ = _build_trainer(args, device, tc)
        if trainer.state["step"] != 3:
            raise AssertionError(f"{path}: (ii) resumed at "
                                 f"{trainer.state['step']}, not 3")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_checkpoint(ck, trainer.state)
        torch.cuda.synchronize()
        rec["restore_ms"] = (time.perf_counter() - t0) * 1e3
        trainer.run(steps)
        loader.close()
        _bitwise(path, "(ii) the resumed run", trainer.state, straight)
        del trainer, loader

        # (iii) recovered faults are invisible
        plan = faults.FaultPlan.from_spec("producer_crash@1,ckpt_fail@3")
        tc = TrainerConfig(total_steps=steps, ckpt_every=3,
                           ckpt_dir=os.path.join(root, "iii"),
                           log_every=steps + 1)
        with faults.injected(plan) as inj:
            t, _, _, _ = _run_leg(args, device, tc, steps, fault_plan=plan)
        rec["iii_fired"] = sorted(e.kind for e in inj.fired_events)
        rec["iii_skipped_steps"] = list(t.skipped_steps)
        if rec["iii_fired"] != ["ckpt_fail", "producer_crash"] or \
                t.skipped_steps:
            raise AssertionError(f"{path}: (iii) fired {rec['iii_fired']}, "
                                 f"skipped {t.skipped_steps}")
        _bitwise(path, "(iii) the run under recovered faults", t.state,
                 straight)
        del t

        # (iv) a guarded NaN step leaves the state as it was
        plan = faults.FaultPlan.from_spec("nan_batch@4")
        tc = TrainerConfig(total_steps=steps, log_every=steps + 1)
        with faults.injected(plan):
            trainer, loader, _, _ = _build_trainer(args, device, tc, plan)
            trainer.run(4)
            before = _snapshot_state(trainer.state)
            trainer.run(5)
            loader.close()
        rec["iv_skipped_steps"] = list(trainer.skipped_steps)
        rec["iv_step"] = trainer.state["step"]
        if trainer.skipped_steps != [4] or trainer.state["step"] != 5:
            raise AssertionError(f"{path}: (iv) skipped "
                                 f"{trainer.skipped_steps}, at step "
                                 f"{trainer.state['step']}")
        _bitwise(path, "(iv) the state after the NaN step", trainer.state,
                 before)
        del trainer, loader, before, straight
        rec["bitwise"] = ["ii", "iii", "iv"]
    except BaseException as e:
        rec["failed"] = repr(e)[:300]
        raise
    finally:
        emit(rec)
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return counts


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


def _post_training_model(params, frozen, plan):
    """[F_C ; F_S] (paper Sec. 3.3): the body assembled from the frozen
    and trained segments, the client tokenizers FedAvg-ed, the server's
    head (or retrieval projections)."""
    full = split.assemble_full_params(params, frozen, plan)
    full["tokenizers"] = aggregation.fedavg_heads(
        params["client"]["tokenizers"])
    full.update({k: v for k, v in params["server"].items()
                 if k not in ("segments", "final_norm")})
    return full


def _vit_outputs(cfg, spec, full, batch, dtype=torch.float32, impls=None):
    """The post-training model on every client's samples of `batch` (this
    client rank's under the program): (logits,), or the retrieval
    embeddings (pa, pb)."""
    mods = spec["modalities"]
    x = {m: batch[m].flatten(0, 1) for m in mods}
    if spec["task"] == "retrieval":
        return baselines.retrieval_embeddings(full, x, cfg, mods,
                                              dtype=dtype, impls=impls)
    return (baselines.full_vit_logits(
        full, x, cfg, modalities=mods, fusion_mode=spec["fusion"],
        dtype=dtype, impls=impls),)


def _vit_eval_launches(cfg, spec) -> dict:
    """The post-training evaluation's launches: the flash forward once a
    block and encoder pass (no backward, no link)."""
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention_fwd"] = _layers(cfg)[0] * _vit_passes(spec)
    return want


def _vit_eval(path, spec, cfg, run, state, frozen, plan, batch):
    """The post-training model (paper Sec. 3.3): the client tokenizers
    FedAvg-ed, the body assembled from the frozen and trained segments, the
    server's head; evaluated on every client's samples of `batch` as one
    centralized model, kernel path against plain path. Returns its
    launches."""
    mods, cdt = spec["modalities"], getattr(torch, run.compute_dtype)
    retrieval = spec["task"] == "retrieval"
    with torch.no_grad():
        full = _post_training_model(state["params"], frozen, plan)
        reset_counts()
        got = _vit_outputs(cfg, spec, full, batch, cdt)      # the kernels
        torch.cuda.synchronize()
        counts = read_counts()
        want = _vit_outputs(cfg, spec, full, batch, cdt, PLAIN_IMPLS)
    expected = _vit_eval_launches(cfg, spec)
    x = {m: batch[m].flatten(0, 1) for m in mods}
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
    loss_fn = mpsl.make_vit_loss(cfg, run, impls=mpsl.KERNEL_IMPLS, **kw)
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

# ---------------------------------------------------------------------------
# the JAX package's production cells on one card (launch/steps.py)


def _cell_shape(spec):
    return ShapeConfig(*spec["shape"])


def _cell_run(cfg, spec, mesh, **over):
    """(plain run, kernel run) of a cell: ``steps.default_run`` on the
    host mesh with the path's overrides (its impls: blockwise / auto
    attention, the plain CE and scan, the dense or ep dispatch), and the
    same run with the kernels asked for by the JAX package's names."""
    with sharding.use_mesh(mesh):
        run = steps.default_run(cfg, _cell_shape(spec), mesh,
                                seed=spec["seed"], **over)
    return run, dataclasses.replace(run, **KERNEL_RUN)


def _cell_record(path, spec, cfg, depth, run, mesh):
    return {"phase": path, **depth, "arch": cfg.name,
            "shape": dict(zip(("name", "seq_len", "global_batch", "kind"),
                              spec["shape"])),
            "reduced": spec["reduced"], "mesh": mesh.name,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "compute_dtype": run.compute_dtype,
            "plain_impls": {"attn": run.attn_impl, "ce": run.ce_impl,
                            "ssm": run.ssm_impl, "moe": run.moe_impl},
            "kernel_impls": KERNEL_RUN}


def _serving_params(cfg, device, seed, dtype):
    """M.init_lm's params from `seed`, cast in place to the serving dtype
    (the JAX cells serve bf16 weights: ``steps.abstract_serve_params``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_lm(cfg, gen, device)
    split._cast_in_place(params, dtype)
    return params, gen


def _rel_max(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return _max_err(got, want) / max(want.float().abs().max().item(), 1e-30)


def phase_cell_train(path, spec):
    """train_4k on one card: the MPSL step through steps.build_train with
    mu > 1 microbatches, the kernels' run against default_run's own
    (blockwise attention, the plain CE) on the same params, batch and
    seed."""
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    mesh = mesh_lib.make_host_mesh()
    shape = _cell_shape(spec)
    n, bpc = spec["n_clients"], spec["batch_per_client"]
    mu = steps.choose_microbatches(cfg, shape, steps.n_data_shards(mesh), bpc)
    run, krun = _cell_run(cfg, spec, mesh, n_clients=n,
                          trainable_blocks=spec["trainable_blocks"],
                          compress_uplink=True, compress_downlink=True,
                          microbatches=mu, learning_rate=spec["lr"])
    t0 = time.perf_counter()
    step_fn, a_state, a_batch, _ = steps.build_train(cfg, krun, mesh)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run, device)
    state = mpsl.init_state(params, frozen, spec["seed"])
    loader = train.make_lm_loader(cfg, n, bpc, shape.seq_len, spec["seed"])
    batches = [train.to_device(loader.batch(i), device)
               for i in range(spec["steps"])]
    if {k: tuple(v.shape) for k, v in batches[0].items()} != \
            {k: tuple(v.shape) for k, v in a_batch.items()}:
        raise AssertionError(f"{path}: the loader's batch is not "
                             f"steps.train_batch_specs'")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    per_step = {k: mu * c for k, c in train_launches_per_step(cfg).items()}
    with sharding.use_mesh(mesh):
        counts, steps_rec = _run_steps(step_fn, state, batches, per_step)
    rec = {**_cell_record(path, spec, cfg, depth, run, mesh),
           "n_clients": n, "batch_per_client": bpc, "microbatches": mu,
           "trainable_blocks": spec["trainable_blocks"], "compress": True,
           "ce_tokens_per_microbatch": n * bpc // mu * (shape.seq_len - 1),
           "init_s": init_s, **steps_rec}
    emit(rec)
    if mu < 2:
        raise AssertionError(f"{path}: {mu} microbatch, expected more")
    _hold_steps(path, rec)

    # the kernels against default_run's impls, through _grad_agg's mu
    # microbatches: same params, batch and seed
    b0, rng = batches[0], mpsl.fold_in(spec["seed"], 0)
    params = state["params"]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    l_k, _, g_k = mpsl._grad_agg(mpsl.make_lm_loss(cfg, krun), params,
                                 frozen, b0, rng, mu)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t
    t = time.perf_counter()
    l_p, _, g_p = mpsl._grad_agg(mpsl.make_lm_loss(cfg, run), params,
                                 frozen, b0, rng, mu)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    errs = _grad_gaps(_leaf_names(params), g_k, g_p)
    del g_k, g_p
    torch.cuda.empty_cache()
    _hold_vs_plain(path, (l_k, kernel_s), (l_p, plain_s), errs,
                   run.compute_dtype == "float32", microbatches=mu)
    return counts, (path, step_fn, state, batches[-1], rec)


def phase_cell_prefill(path, spec):
    """prefill_32k on one card through steps.build_prefill: the flash
    forward (and, for the MoE arch, the ep dispatch) against default_run's
    blockwise attention (and the ragged dispatch, replaying the kernel
    run's expert choices). ep drops (token, k) slots past its capacity:
    a layer's cache rows are held only where no earlier layer dropped a
    slot of that token, and the last logits only when nothing dropped."""
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    mesh = mesh_lib.make_host_mesh()
    run, krun = _cell_run(cfg, spec, mesh)
    cdt = getattr(torch, run.compute_dtype)
    fn_k, (_, a_batch), _ = steps.build_prefill(cfg, krun, mesh)
    plain_run = (dataclasses.replace(run, moe_impl="ragged") if cfg.moe
                 else run)
    fn_p = steps.build_prefill(cfg, plain_run, mesh)[0]
    t0 = time.perf_counter()
    params, gen = _serving_params(cfg, device, spec["seed"], cdt)
    b, s = a_batch["tokens"].shape
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=device)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with sharding.use_mesh(mesh):
        fn_k(params, batch)                           # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with _tape(cfg) as tape:
            t = time.perf_counter()
            logits, cache = fn_k(params, batch)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        with _tape(cfg, None if tape is None else tape.idx) as ptape:
            t = time.perf_counter()
            ref_logits, ref_cache = fn_p(params, batch)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention_fwd"] = _layers(cfg)[0]
    rec = {**_cell_record(path, spec, cfg, depth, plain_run, mesh),
           "batch": b, "prompt_len": s, "init_s": init_s,
           "launches": counts, "expected_launches": want,
           "prefill_ms": prefill_s * 1e3, "plain_prefill_ms": plain_s * 1e3,
           "peak_mem_bytes": peak, **_flips(ptape)}
    # which tokens an earlier layer's ep dispatch dropped a slot of
    dropped = torch.zeros(b * s, dtype=torch.bool, device=device)
    before = []
    if tape is not None:
        rec["ep_capacity"] = run.moe_capacity
        rec["ep_dropped_slots_by_layer"] = []
        for idx in tape.idx:
            before.append(dropped.clone())
            drop = MOE.ep_drop_mask(idx, cfg.moe.num_experts,
                                    run.moe_capacity,
                                    steps.n_data_shards(mesh))
            rec["ep_dropped_slots_by_layer"].append(int(drop.sum()))
            dropped |= drop.any(-1)
        rec["ep_slots"] = b * s * cfg.moe.top_k * len(tape.idx)
        rec["tokens_with_a_drop"] = int(dropped.sum())
    # each layer's cache K/V on the rows no drop reached: held in relative
    # L2 (the elementwise largest gap, over 8M-34M elements a layer after
    # up to 31 layers of bf16 rounding on both paths, is recorded)
    errs, elem = {}, {}
    for i, (lk, lp) in enumerate(zip(
            (x for seg in cache for x in seg),
            (x for seg in ref_cache for x in seg))):
        keep = (~before[i] if i < len(before) else
                torch.ones(b * s, dtype=torch.bool, device=device))
        keep = keep.reshape(b, s)
        for name in ("k", "v"):
            a, r = lk[name][keep], lp[name][keep]
            errs[f"layer{i}.{name}"] = _rel_l2(a, r)
            elem[f"layer{i}.{name}"] = _rel_max(a, r)
    worst = max(errs, key=errs.get)
    worst_elem = max(elem, key=elem.get)
    rec.update(cache_rel_l2_max=errs[worst], cache_rel_l2_worst=worst,
               cache_elem_rel_err_max=elem[worst_elem],
               cache_elem_rel_err_worst=worst_elem,
               last_logits_rel_err=_rel_max(logits, ref_logits),
               max_abs_logit=logits.float().abs().max().item(),
               tol=SERVE_TOL_BF16,
               tol_is="last logits: of the plain path's largest |logit|; "
                      "cache K/V: relative L2 a layer")
    hold_logits = not rec.get("tokens_with_a_drop")
    rec["last_logits_held"] = hold_logits
    emit(rec)
    if counts != want:
        raise AssertionError(f"{path}: launches {counts}, expected {want}")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{path}: non-finite logits")
    if not (errs[worst] <= SERVE_TOL_BF16 and (
            not hold_logits
            or rec["last_logits_rel_err"] <= SERVE_TOL_BF16)):
        raise AssertionError(f"{path}: the kernel path differs from the "
                             f"plain path: cache {worst} {errs[worst]}, "
                             f"logits {rec['last_logits_rel_err']}")
    # (expert-choice flips are recorded, not held: at bf16 compute the
    # router's inputs on the two paths differ by bf16 noise, and the plain
    # path replays the kernel path's choices)
    del cache, ref_cache
    return counts, (path, fn_k, (params, batch), rec["prefill_ms"], rec)


def _seed_cache(cache, filled, gen):
    """Fill a body cache as if `filled` tokens had been decoded: K/V of
    N(0, 1), positions 0..filled-1 (a window layer's ring holds the last
    of them at slot position % length), index = filled; SSM states and
    conv histories of 0.1 x N(0, 1)."""
    for seg in cache:
        for layer in seg:
            for c in ((layer["kv"], layer["ssm"]) if "kv" in layer
                      else (layer,)):
                if "k" in c:
                    n = c["k"].shape[1]
                    for name in ("k", "v"):
                        c[name].copy_(torch.randn(
                            c[name].shape, generator=gen,
                            device=c[name].device))
                    pos = torch.arange(max(0, filled - n), filled,
                                       dtype=torch.int32,
                                       device=c["pos"].device)
                    c["pos"].fill_(-1)
                    c["pos"][:, (pos % n).long()] = pos
                    c["index"] = filled
                else:
                    for name in ("h", "conv"):
                        c[name].copy_(0.1 * torch.randn(
                            c[name].shape, generator=gen,
                            device=c[name].device))


def _clone_cache(cache):
    return tree.map_(lambda x: x.clone() if torch.is_tensor(x) else x, cache)


def _rewind(cache, n):
    """Step a seeded cache's write index back by n (the slots are written
    again by the same steps)."""
    for seg in cache:
        for layer in seg:
            for c in ((layer["kv"],) if "kv" in layer else (layer,)):
                if "index" in c:
                    c["index"] -= n


def _token_deficit(ref, tok):
    """(the largest over rows of (plain top - plain logit of tok), the
    rows whose plain top-2 margin exceeds 2 x DECODE_CELL_TOL, so that tok
    must be the plain top) of one decode step's [B, V] plain logits and
    [B] tokens, on the scale of each row's largest |plain logit|."""
    r = ref.float()
    scale = r.abs().amax(-1)
    top2 = r.topk(2, dim=-1).values
    deficit = (top2[:, 0] - r.gather(-1, tok[:, None])[:, 0]) / scale
    margin = (top2[:, 0] - top2[:, 1]) / scale
    return (deficit.max().item(),
            int((margin > 2 * DECODE_CELL_TOL).sum().item()))


def phase_cell_decode(path, spec):
    """decode_32k / long_500k on one card: greedy steps through
    steps.build_decode over a cache seeded as filled, the flash kernel's
    split-KV route against default_run's (auto: naive at one query) on a
    second copy of the cache fed the same tokens. Each step's logits stay
    within DECODE_CELL_TOL in relative L2 (the elementwise gap is
    recorded), and each greedy token is the plain path's top or a near
    tie (``_token_deficit``)."""
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    mesh = mesh_lib.make_host_mesh()
    run, krun = _cell_run(cfg, spec, mesh)
    cdt = getattr(torch, run.compute_dtype)
    fn_k, args, _, _ = steps.build_decode(cfg, krun, mesh)
    fn_p = steps.build_decode(cfg, run, mesh)[0]
    b, cache_len = run.shape.global_batch, run.shape.seq_len
    n_steps, filled = spec["decode_steps"], spec["filled"]
    t0 = time.perf_counter()
    params, gen = _serving_params(cfg, device, spec["seed"], cdt)
    cache = M.init_body_cache(cfg, b, cache_len, cdt, device)
    _seed_cache(cache, filled, gen)
    ref_cache = _clone_cache(cache)
    serve.check_cache_room(cfg, cache, n_steps)
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                        device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def positions(i):
        p = torch.full((b, 1), filled + i, dtype=torch.int32, device=device)
        return p[:, None].expand(b, 3, 1) if cfg.pos_embed == "mrope" else p

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, outs, toks = [], [], [tok]
    with sharding.use_mesh(mesh):
        for i in range(n_steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn_k(params, cache, args[2], toks[-1],
                                 positions(i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            outs.append(logits)
            toks.append(logits[:, -1].argmax(-1)[:, None])
        counts = read_counts()
        # the plain path, fed the kernel path's tokens
        errs, elem, agree, deficit, held = [], [], [], [], []
        for i, logits in enumerate(outs):
            ref, ref_cache = fn_p(params, ref_cache, args[2], toks[i],
                                  positions(i))
            errs.append(_rel_l2(logits, ref))
            elem.append(_rel_max(logits, ref))
            agree.append((toks[i + 1][:, 0] == ref[:, -1].argmax(-1))
                         .float().mean().item())
            d, n = _token_deficit(ref[:, -1], toks[i + 1][:, 0])
            deficit.append(d)
            held.append(n)
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention_fwd"] = _layers(cfg)[0] * n_steps
    rec = {**_cell_record(path, spec, cfg, depth, run, mesh),
           "plain_attn_at_one_query": attention.resolve_impl(
               run.attn_impl, 1, cache_len),
           "batch": b, "cache_slots": cache_len, "filled": filled,
           "decode_steps": n_steps, "init_s": init_s,
           "launches": counts, "expected_launches": want,
           "decode_ms_per_token": statistics.median(times) * 1e3,
           "step_ms": [x * 1e3 for x in times], "peak_mem_bytes": peak,
           "logits_rel_l2_by_step": errs,
           "logits_elem_rel_err_by_step": elem,
           "greedy_token_agreement_by_step": agree,
           "token_deficit_by_step": deficit,
           "rows_held_exactly_by_step": held,
           "greedy_tokens": torch.cat(toks, 1)[:2].tolist(),
           "tol": DECODE_CELL_TOL,
           "tol_is": "each step's logits in relative L2; each greedy "
                     "token's plain logit within 2 x tol of the largest "
                     "|logit| below the plain top (the elementwise gap, "
                     "over the plain path's largest |logit|, is recorded)"}
    emit(rec)
    if counts != want:
        raise AssertionError(f"{path}: launches {counts}, expected {want}")
    if not (all(math.isfinite(e) and e <= DECODE_CELL_TOL for e in errs)
            and max(deficit) <= 2 * DECODE_CELL_TOL):
        raise AssertionError(f"{path}: the kernel path differs from the "
                             f"plain path: logits {errs}, token deficits "
                             f"{deficit}")
    del ref_cache
    torch.cuda.empty_cache()
    _rewind(cache, 1)
    return counts, (path, fn_k, params, cache, args[2], toks[-2], positions,
                    filled, rec)


def phase_cell_profile(path, fn, args, host_ms, rec, top=8, part="prefill"):
    """Where a cell's prefill (or a decode step) goes: device time by
    kernel over one call (torch.profiler) beside its unprofiled host
    time."""
    from torch.profiler import ProfilerActivity, profile

    mesh = mesh_lib.make_host_mesh()
    with sharding.use_mesh(mesh), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    times = _device_time_by_kernel(prof)
    busy = sum(times.values())
    ranked = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    emit({"phase": "profile", "path": path, "part": part,
          "per": "call" if part == "prefill" else "token",
          "device_busy_ms": busy, "host_ms_unprofiled": host_ms,
          "device_idle_share": max(0.0, 1 - busy / host_ms),
          "peak_mem_bytes": rec["peak_mem_bytes"],
          "top_kernels_ms": [[k[:90], v] for k, v in ranked]})


def phase_cell_decode_profile(path, fn, params, cache, ckv, tok, positions,
                              filled, rec):
    """The last decode step again (its cache rewound one step, so the
    step writes the slot it wrote before) under the profiler."""
    phase_cell_profile(path, fn, (params, cache, ckv, tok,
                                  positions(rec["decode_steps"] - 1)),
                       rec["decode_ms_per_token"], rec, part="decode")


# ---------------------------------------------------------------------------
# the mesh paths: the SPMD program as 4 ranks sharing the one card
#
# Each mesh path first runs its one-rank path on the card (the reference),
# moves what it compares to the host (a file the ranks read) and frees the
# card; then ``launch.spmd.spawn`` starts a rank process a device of its
# mesh on it (4; mesh_moe's (1, 8) 8) (gloo:
# NCCL will not put two ranks on one device; each collective staged
# through pinned host memory). Every rank builds the whole tree from the
# seed in turn (``_rank_init``: one rank's whole tree on the card at a
# time), keeps its shards, and runs the path with every launch and
# collective counter set to 0 just before. The collectives' times on this
# transport are host copies and loopback TCP, not a fabric: their counts
# and bytes are recorded, not their speed.

MESH_TIMEOUT = 900


def _rank_init(make):
    """make() on each rank in turn (every rank waits at a barrier after
    each), its whole tree freed before the next rank starts."""
    prog = collectives.active()
    out = None
    for r in range(prog.world):
        if r == prog.rank:
            out = make()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _run_tasks(tasks):
    """A group's rank side (``phase_mesh_group``): each (rank function
    name, arguments, mesh) of `tasks` in turn, under a program on its mesh
    (the world's own, or one started on the same ranks: every rank makes
    each in the same order), the card's cache emptied between; each one's
    record and its seconds on this rank."""
    world = collectives.active()
    progs = {world.mesh: world}
    out = []
    for name, args, mesh in tasks:
        if mesh not in progs:
            progs[mesh] = mesh_lib.init_device_mesh(mesh, world.device)
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        t = time.perf_counter()
        with collectives.program(progs[mesh]):
            out.append((globals()[name](*args), time.perf_counter() - t))
    return out


def phase_mesh_group(paths):
    """The mesh paths `paths` (on meshes of one size) in one world on the
    card, a rank a device of the mesh (4, or 8, sharing the card over
    gloo): each path's phase (a generator) computes its one-rank reference
    on the card and yields its rank function, mesh and arguments; one
    world (``launch.spmd.spawn``: a rank's start costs ~13 s, and its
    first training step 10-20 s more than its second) runs them in order,
    each under a program on its own mesh; each phase is then sent its
    ranks' records and the task's seconds on rank 0 (its `world_s`) and
    holds them. Returns each path's launches."""
    gens, tasks, counts = [], [], {}
    try:
        for path in paths:
            g = MESH_PHASES[path](path, PATHS[path])
            fn, mesh, args = next(g)
            gens.append(g)
            tasks.append((fn.__name__, args, mesh))
            gc.collect()
            torch.cuda.empty_cache()
        sizes = {t[2].size for t in tasks}
        if len(sizes) != 1:
            raise ValueError(f"{paths}: one world runs meshes of one size, "
                             f"not {sizes}")
        res = spmd.spawn(_run_tasks, tasks[0][2], "cuda", MESH_TIMEOUT,
                         args=(tasks,))
        for i, (path, g) in enumerate(zip(paths, gens)):
            try:
                g.send(([r[i][0] for r in res], res[0][i][1]))
            except StopIteration as done:
                counts[path] = done.value
    finally:
        for g in gens:
            g.close()
    return counts


def _collectives_step():
    """{"op/axis": calls} since the last reset (the program's record
    apart)."""
    return {k: v["calls"] for k, v in collectives.read_counts().items()
            if k != "program"}


def _collective_bytes():
    return {k: v["bytes"] for k, v in collectives.read_counts().items()
            if k != "program"}


def _sharded_rel_l2(local, ref_full, spec) -> float:
    """The relative L2 gap of a whole leaf, from each rank's shard of it
    and the matching slice of the whole reference."""
    return _shards_rel_l2(local, sharding.shard_leaf(ref_full, spec), local)


def _shards_rel_l2(got, want, leaf, den=None) -> float:
    """The relative L2 gap of a whole leaf from each rank's shards of it
    (`got` against `want`, cut as `leaf`; against the norm of `den`, a
    shard cut alike, where given): squared sums weighted by 1 / the
    shard's replica count, all-reduced over the world."""
    want = want.to(got.device, torch.float32)
    den = want if den is None else den.to(got.device, torch.float32)
    w = collectives.replica_weight(leaf)
    sums = torch.stack([(got.float() - want).square().sum() * w,
                        den.square().sum() * w]).to(
                            collectives.active().device)
    num, den = collectives.all_reduce(sums, collectives.WORLD).tolist()
    return math.sqrt(num) / math.sqrt(den) if den else math.sqrt(num)


def _gathered_all(x, dim, axes):
    for a in axes:
        x = collectives.all_gather(x, dim, a)
    return x


# rank 0's collectives, {"op/axis": {"calls", "bytes"}}, of the mesh paths'
# parts on the card, by (path, part): "train" (its first step), "serve"
# (its counted generate call), "attn_seq_leg"; the dry run's program
# traces are held to them (``phase_dryrun``)
COUNTED = {}


def _first_step_counts(r) -> dict:
    """A rank record's first step's collectives, {"op/axis": {"calls",
    "bytes"}}."""
    return {k: {"calls": c, "bytes": r["collective_bytes_per_step"][0][k]}
            for k, c in r["collectives_per_step"][0].items() if c}


def _rank_record(prog, peak, **kw):
    return {"rank": prog.rank, "coords": prog.coords,
            "card": prog.cards[prog.rank], "peak_mem_bytes": peak, **kw}


def _hold_mesh(path, ranks, expected, per="call"):
    """Every rank launched exactly the kernels its code calls and issued
    exactly the collectives derived from its code (``mesh_*_collectives``);
    the ranks' peaks sum under the card's memory."""
    for r in ranks:
        got_k = r["launches_per_" + per]
        got_c = r["collectives_per_" + per]
        if any(c != expected["launches"] for c in got_k):
            raise AssertionError(f"{path} rank {r['rank']}: launches "
                                 f"{got_k}, expected {expected['launches']}")
        if any(c != expected["collectives"] for c in got_c):
            raise AssertionError(f"{path} rank {r['rank']}: collectives "
                                 f"{got_c}, expected "
                                 f"{expected['collectives']}")
    total = sum(r["peak_mem_bytes"] for r in ranks)
    if total >= 80e9:
        raise AssertionError(f"{path}: the ranks' peaks sum to {total} B")
    return total


def _mesh_counts(ranks, per="call"):
    """Each kernel's launches over every rank of the mesh path."""
    out = dict.fromkeys(COUNTERS, 0)
    for r in ranks:
        for c in r["launches_per_" + per]:
            for k, v in c.items():
                out[k] += v
    return out


def _lm_ends(cfg, d, m) -> dict:
    """The collectives of an MPSL step's ends on a (data d, model m) mesh:
    the lookup (the ids all-gathered and the rows reduce-scattered over
    `data` where the table's rows lie there, its columns all-gathered over
    `model`), the lm_head [D, V] (its D gathered over `data` and its
    gradient reduce-scattered; where V lies on `model` the vocab-parallel
    CE: the ranks' lse all-gathered, the gold logit and dh all-reduced),
    the metrics (every client's loss all-gathered; the mask's sum, L_S and
    the participating count all-reduced over `data`) and the global
    norm's squared sums (over the world)."""
    rows = cfg.vocab_size % d == 0
    vp = cfg.vocab_size % m == 0
    return {"all_gather/data": rows + 2,
            "reduce_scatter/data": rows + 1,
            "all_reduce/data": 3,
            "all_gather/model": 1 + vp,
            "all_reduce/model": 2 * vp,
            "all_reduce/world": 1}


def mesh_train_collectives(cfg, spec) -> dict:
    """The collectives of one MPSL train step on a (data d, model m) mesh
    (d, m > 1), from the code, with block remat, L blocks of which T
    trainable: ``_lm_ends`` and, by block family,

      dense (layernorm or rmsnorm; heads, d_ff on `model`, every weight's
      D on `data`): n_w = 4 attention + 2 or 3 MLP weights gathered over
      `data` at use and again in the remat recompute (2 n_w L), the
      trainable ones' gradients reduce-scattered (n_w T); the trainable
      norms' gradients all-reduced over `data` (n_norm T + the final
      norm's); over `model` the attention and MLP outputs (2 L), the
      attention output again in each recompute (L: torch's checkpoint
      stops its recompute at the last saved tensor, before the MLP's
      reduction), the region inputs' gradients (2 L);
      ssm (d_inner on `model`): in_proj and out_proj gathered (n_w 2);
      the gradients of the 7 channel leaves and the norm over `data`
      (8 T + 1); over `model` x_proj's and out_proj's partial sums (2 L),
      x_proj's again in the recompute (L), the gradients of x and of
      (dt_in, B, C) entering the channel-parallel region (2 L): 5 L;
      hybrid (the dboth attention, d_inner and d_ff on `model`): wq, wk,
      wv, wo, in_proj, out_proj and the MLP's 3 gathered (n_w 9); the
      gradients of the 4 norms, 2 betas and 7 channel leaves over `data`
      (13 T + 1); over `model` the q|k|v partial sums, x_proj's and
      out_proj's (each twice: forward and recompute) and the MLP's output
      (7 L), the gradients of x (one copy_to for both branches), of the
      attention output entering wo's columns, of (dt_in, B, C) and of the
      MLP's input (4 L): 11 L; wo's output parts all-gathered over
      `model` (2 L: forward and recompute).
    """
    L = cfg.num_layers
    T = split.resolve_trainable_blocks(cfg, MPSLConfig(
        trainable_blocks=spec["trainable_blocks"]))
    *pods, d, m = spec["mesh"]
    if pods:
        return _over_pods(cfg, mesh_train_collectives(
            cfg, dict(spec, mesh=(d, m))), pods[0], d)
    out = _lm_ends(cfg, d, m)
    fam = cfg.family
    if fam == "ssm":
        n_w, leaves, final, ar_m, ag_m = 2, 8, 1, 5 * L, 0
    elif fam == "hybrid":
        n_w, leaves, final, ar_m, ag_m = 9, 13, 1, 11 * L, 2 * L
    else:
        return _attn_train_collectives(cfg, out, L, T, d, m)
    out["all_gather/data"] += 2 * n_w * L
    out["reduce_scatter/data"] += n_w * T
    out["all_reduce/data"] += leaves * T + final
    out["all_reduce/model"] += ar_m
    out["all_gather/model"] += ag_m
    return out


def _over_pods(cfg, out, pods, d) -> dict:
    """A step's collectives on a (pod, data, model) mesh from `out`, those
    of one pod's (data d, model m) mesh: the client axis is the flattened
    (pod, data) axis, so the metrics' sums and gather, the client
    weights' sum, the router's sums and the gradients of the shared
    leaves off `data` (every all-reduce over `data`, and the per-client
    losses' all-gather) cross it instead; each fsdp gradient, already
    reduce-scattered over `data` within the pod (every reduce-scatter but
    the lookup's rows), is all-reduced over `pod` once."""
    if pods == 1:
        return out
    if d == 1:
        raise ValueError("a pod mesh path runs a data axis above 1")
    out = dict(out)
    flat = collectives.POD_DATA
    out[f"all_reduce/{flat}"] = out.pop("all_reduce/data")
    out["all_gather/data"] -= 1
    out[f"all_gather/{flat}"] = 1
    rows = cfg.vocab_size % d == 0
    out["all_reduce/pod"] = out["reduce_scatter/data"] - rows
    return out


def _attn_layout(cfg, m) -> str:
    """``attention.model_layout``'s layout of cfg's weights on a model
    axis of m (the rule table's: heads where H and K divide it, dboth
    where neither does)."""
    h, k = cfg.num_heads % m == 0, cfg.num_kv_heads % m == 0
    return "heads" if h and k else ("dboth" if not (h or k) else "mixed")


def _attn_train_collectives(cfg, out, L, T, d, m) -> dict:
    """``mesh_train_collectives`` of a dense, VLM or encoder-decoder LM
    (every block's d_ff on `model`; block remat, whose recompute stops
    before the MLP's reduction). Over `model`, a block's attention under
    heads: its output's all-reduce in the forward and the recompute, x's
    gradient entering the region (3); under dboth: the q|k|v partial sums
    in both, x's and the attention output's gradients (4), wo's output
    parts all-gathered in both (2 all-gathers); the MLP's output and its
    input's gradient (2). A decoder block's cross-attention under heads:
    its output in both passes, x's and the encoder output's gradients
    (4); under dboth: q's and k|v's partial sums in both passes, the
    gradients of x, the encoder output and the attention output (7), wo's
    output parts in both (2 all-gathers). The learned positions (the
    decoder's and the encoder's, their D on `model`) are all-gathered
    once each. Over `data` (fsdp): each block's attention (4), cross (4)
    and MLP (2 or 3) weights gathered in both passes, the trainable
    blocks' reduce-scattered; the trainable blocks' norms (1 or 2 leaves
    each) and qkv biases and the final norm all-reduced. The frozen
    encoder's blocks gather likewise and take no weight gradient. The
    collectives over an axis of size 1 are none."""
    lay = _attn_layout(cfg, m)
    if lay == "mixed":
        raise ValueError(f"{cfg.name}: no path trains the mixed layout")
    cross = cfg.family == "audio"
    mlp_w = 3 if layers.gated_activation(cfg.activation) else 2
    norm = 2 if cfg.norm == "layernorm" else 1
    attn_ar, attn_ag = (3, 0) if lay == "heads" else (4, 2)
    cross_ar, cross_ag = (4, 0) if lay == "heads" else (7, 2)
    ffn_ar, ffn_w = 2, mlp_w
    if cfg.moe:
        # the MoE FFN (experts on `model`, or each expert's F): its partial
        # sums leave once, the routed experts' and the shared expert's
        # joined; the gradients of the tokens and the combine weights
        # entering the routed experts, of x entering the shared expert and
        # of its gate enter (5); its weights: the router, the experts' 3,
        # the shared expert's 3, shared_gate (8)
        ffn_ar, ffn_w = 5, 8
    block_ar = attn_ar + ffn_ar + (cross_ar if cross else 0)
    block_ag = attn_ag + (cross_ag if cross else 0)
    n_w = 4 + ffn_w + (4 if cross else 0)
    leaves = norm * (3 if cross else 2) + (3 if cfg.qkv_bias else 0)
    E = cfg.encoder_layers
    out["all_reduce/model"] += block_ar * L + (attn_ar + 2) * E
    out["all_gather/model"] += (block_ag * L + attn_ag * E
                                + (2 if cfg.pos_embed == "learned" else 0))
    out["all_gather/data"] += 2 * n_w * L + 2 * (4 + mlp_w) * E
    out["reduce_scatter/data"] += n_w * T
    # the router's density and mean probability summed over `data`, in
    # the forward and the recompute
    out["all_reduce/data"] += (4 * L if cfg.moe else 0) + leaves * T + norm
    return {k: v for k, v in out.items() if v and (
        k.endswith("/world") or {"data": d, "model": m}[k.split("/")[1]] > 1)}


def mesh_per_client_collectives(cfg, spec) -> dict:
    """The collectives of one ``backward_mode="per_client"`` step of a
    dense LM: N passes of the aggregated step's loss and backward (its
    collectives less ``reduce_grads``' and the global norm's), the mask
    all-gathered over `data` once (the global client weights), one
    ``reduce_grads`` (every trainable leaf off `data`: its norms, with
    qkv biases theirs, and the final norm, all-reduced over `data`) and
    the global norm."""
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"{cfg.name}: the per-client leg runs a dense LM")
    T = split.resolve_trainable_blocks(cfg, MPSLConfig(
        trainable_blocks=spec["trainable_blocks"]))
    norm = 2 if cfg.norm == "layernorm" else 1
    reduce_grads = (2 * norm + 3 * cfg.qkv_bias) * T + norm
    n = spec["n_clients"]
    out = {k: n * v for k, v in mesh_train_collectives(cfg, spec).items()}
    out["all_reduce/data"] -= (n - 1) * reduce_grads
    out["all_reduce/world"] = 1
    out["all_gather/data"] += 1
    return out


def mesh_serve_collectives(cfg, steps_, mesh=(2, 2), cache_len=None) -> dict:
    """The collectives of one serve call (prefill and `steps_` greedy
    steps) on the TP-only layout (weights on `model`, replicated over
    `data`, which only splits the batch): each forward all-gathers the
    lookup's columns (1) and, where the vocab lies on `model`, the greedy
    token's max and index over the vocab shards (2), and all-reduces
    each dense block's attention and MLP outputs (2 L), each Mamba block's
    x_proj and out_proj partial sums (2 L), each hybrid block's q|k|v,
    x_proj, out_proj and MLP partial sums (4 L) and all-gathers its wo
    output parts (L); a decode step over sequence-sharded caches (the KV
    heads divide no model axis) all-gathers each attention layer's o and
    lse (L a step). Nothing moves over `data`."""
    fwd = 1 + steps_
    m = mesh[-1]
    L = cfg.num_layers
    if cfg.family == "audio":
        return _encdec_serve_collectives(cfg, steps_, mesh, cache_len)
    per = {"dense": 2, "moe": 2, "ssm": 2, "hybrid": 4,
           "vlm": 2}[cfg.family]
    ag = 1 + 2 * (cfg.vocab_size % m == 0)
    merged = 0
    if cfg.family == "hybrid":
        ag += L
        merged = L * steps_ if cfg.num_kv_heads % m else 0
    return {"all_gather/model": ag * fwd + merged,
            "all_reduce/model": per * L * fwd}


def _encdec_serve_collectives(cfg, steps_, mesh, cache_len) -> dict:
    """``mesh_serve_collectives`` of whisper (TP-only: weights on `model`;
    the vocabulary divides no axis, so the logits and the greedy token
    are whole on every rank). Each forward all-gathers the token lookup's
    and the learned positions' columns (2); each decoder layer's self- and
    cross-attention leave by one all-reduce each under heads, or enter by
    one (the q|k|v, or q's, partial sums) and leave by an all-gather of
    wo's output parts under dboth, its MLP by one all-reduce. The prefill
    also all-gathers the encoder's positions (1), runs each encoder layer
    (2 all-reduces, and under dboth 1 all-gather) and makes each decoder
    layer's cross K/V (under dboth one all-reduce of the k|v partial sums;
    under heads one all-gather of this rank's heads). A decode step over
    a sequence-sharded self cache (dboth, its `cache_len` slots dividing
    the model axis) all-gathers each layer's o and lse (L a step)."""
    m = mesh[1]
    L, E = cfg.num_layers, cfg.encoder_layers
    dboth = _attn_layout(cfg, m) == "dboth"
    ar_fwd, ag_fwd = 3 * L, 2 + 2 * L * dboth
    merged = L * (dboth and cache_len % m == 0)
    ar = ar_fwd * (1 + steps_) + 2 * E + L * dboth
    ag = (ag_fwd * (1 + steps_) + 1 + E * dboth + L * (not dboth)
          + merged * steps_)
    return {"all_gather/model": ag, "all_reduce/model": ar}


def mesh_decode_collectives(cfg) -> dict:
    """The collectives of one ``steps.build_decode`` step of a hybrid LM
    on a (1, m) mesh whose KV heads do not divide m (the dboth attention,
    sequence-sharded caches): the lookup's columns (1), each layer's wo
    output parts and its merged o and lse (2 L) all-gathered; each layer's
    q|k|v, x_proj, out_proj and MLP partial sums (4 L) all-reduced."""
    L = cfg.num_layers
    return {"all_gather/model": 1 + 2 * L, "all_reduce/model": 4 * L}


def mesh_ep_collectives(cfg) -> dict:
    """The collectives of one prefill of an MoE LM on a (1, m) mesh: the
    lookup's columns (1 all-gather), each block's attention output and its
    experts' partial sums (2 L all-reduces); the logits stay vocab-sharded.
    With a data axis of 1 the router's loss moves nothing."""
    return {"all_gather/model": 1, "all_reduce/model": 2 * cfg.num_layers}


def _train_setup(cfg, spec, device, impls=mpsl.KERNEL_IMPLS):
    mp = MPSLConfig(n_clients=spec["n_clients"],
                    trainable_blocks=spec["trainable_blocks"],
                    compress_uplink=True, compress_downlink=True)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype=spec["compute_dtype"],
                    learning_rate=spec["lr"], seed=spec["seed"],
                    seq_shard_acts=spec.get("seq_shard_acts", False),
                    attn_seq_shard=spec.get("attn_seq_shard", False))
    loader = train.make_lm_loader(cfg, spec["n_clients"],
                                  spec["batch_per_client"], spec["seq"],
                                  spec["seed"])

    def batch(i):
        b = loader.batch(i)
        b["mask"] = b["mask"].copy()
        b["mask"][spec["masked_client"]] = 0.0
        return b

    loss_fn = mpsl.make_lm_loss(cfg, run, impls=impls)
    first = []

    def keep_first(step, grads):
        # the first step's gradients, kept on the host for the comparison
        # after the run (the hook adds no collective; on the card a
        # qwen2-vl rank's copy, 2.1 GB, would not fit beside four ranks'
        # steps)
        if step == 0:
            first.extend(g.detach().to("cpu", copy=True) for g in grads)

    sched = schedules.warmup_cosine(spec["lr"], 10, spec["steps"])
    step_fn = mpsl.make_train_step(loss_fn, run, sched, grad_hook=keep_first)
    return run, batch, step_fn, first, (loss_fn, sched)


def _mesh_train_ref(cfg, spec, device, tmp):
    """The one-rank train path on the card (``_train_setup``'s step on the
    same params and batches): (the file in `tmp` holding its first step's
    gradients by leaf path and, for an MoE arch, its steps' expert choices
    (``_tape``), its ``_run_steps`` record)."""
    run, batch, step_fn, first, _ = _train_setup(cfg, spec, device)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run, device)
    state = mpsl.init_state(params, frozen, spec["seed"])
    batches = [train.to_device(batch(i), device)
               for i in range(spec["steps"])]
    with _tape(cfg) as tape:
        _, one = _run_steps(step_fn, state, batches,
                            train_launches_per_step(cfg))
    ref_file = os.path.join(tmp, "grads.pt")
    torch.save({"grads": dict(zip(tree.paths(state["params"]),
                                  (g.cpu() for g in first))),
                "idx": None if tape is None
                else [i.cpu() for i in tape.idx]}, ref_file)
    return ref_file, one


def _aux_couples_clients(cfg) -> bool:
    """Whether the MPSL loss's router aux loss gives a masked client an
    adapter gradient (``make_lm_loss``: aux is taken over every client's
    tokens)."""
    return bool(cfg.moe and cfg.moe.router_aux_coef)


def _hold_mesh_train(path, spec, cfg, depth, ranks, one, world_s):
    """The train record of a mesh path (emitted): every rank's launches
    and collectives exactly the code's, each step's loss within
    TRAIN_LOSS_TOL of the one-rank path's, every first-step gradient
    within TRAIN_GRAD_TOL in relative L2, the masked client's adapter
    gradient exactly 0 (where the router's aux loss, taken over every
    client's tokens, gives it one: as the one-rank path's, within the
    adapter leaves' TRAIN_GRAD_TOL); an MoE arch's routing flips under
    ROUTING_FLIP_LIMIT of its decisions (each step's calls: every block's
    forward and its remat recompute); the per-client leg
    (``_hold_per_client``)."""
    expected = {"launches": train_launches_per_step(cfg),
                "collectives": mesh_train_collectives(cfg, spec)}
    zero_expected = not _aux_couples_clients(cfg)
    rec = {"phase": path, "part": "train", **depth, "arch": cfg.name,
           "mesh": spec["mesh"], "program": ranks[0]["program"],
           "d_model": cfg.d_model, "compute_dtype": spec["compute_dtype"],
           "n_clients": spec["n_clients"],
           "batch_per_client": spec["batch_per_client"], "seq": spec["seq"],
           "trainable_blocks": spec["trainable_blocks"],
           "masked_client": spec["masked_client"], "steps": spec["steps"],
           "one_rank_losses": one["losses"],
           "one_rank_median_step_ms": one["median_step_ms"],
           "one_rank_peak_mem_bytes": one["peak_mem_bytes"],
           "world_s": world_s, "expected_per_step": expected,
           "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
           "masked_adapter_grad_zero_expected": zero_expected,
           "ranks": ranks}
    rec["ranks_peak_mem_bytes_sum"] = _hold_mesh(path, ranks, expected,
                                                 per="step")
    emit(rec)
    for r in ranks:
        worst = max(r["grad_rel_l2"], key=r["grad_rel_l2"].get)
        errs = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                    one["losses"])]
        if not (max(errs) <= TRAIN_LOSS_TOL
                and r["grad_rel_l2"][worst] <= TRAIN_GRAD_TOL
                and (r["masked_adapter_grad_zero"] or not zero_expected)):
            raise AssertionError(
                f"{path} rank {r['rank']}: losses {r['losses']} vs "
                f"{one['losses']}, gradient {worst} "
                f"{r['grad_rel_l2'][worst]}, masked client's adapter "
                f"gradient zero: {r['masked_adapter_grad_zero']}")
        _hold_flips(f"{path} rank {r['rank']}", r.get("routing"),
                    2 * cfg.num_layers * spec["steps"])
    counts = _mesh_counts(ranks, "step")
    if spec.get("per_client"):
        pc = _hold_per_client(path, spec, cfg, ranks)
        counts = {k: counts[k] + pc[k] for k in counts}
    if spec.get("seq_leg"):
        sl = _hold_seq_leg(path, spec, cfg, ranks)
        counts = {k: counts[k] + sl[k] for k in counts}
    COUNTED[(path, "train")] = _first_step_counts(ranks[0])
    if spec.get("attn_seq_leg"):
        al = _hold_attn_seq_leg(path, spec, cfg, ranks, one)
        counts = {k: counts[k] + al[k] for k in counts}
        COUNTED[(path, "attn_seq_leg")] = _first_step_counts(
            ranks[0]["attn_seq_leg"])
    return counts


def seq_leg_expected(cfg, spec) -> dict:
    """What the seq_model leg changes, from the code: each of the L
    blocks keeps its input's S/m slice (the remat stash falls by (m - 1) /
    m of a block input [B, S, D] f32, B a data rank's rows), and the
    stream's cut adds 3 L + 2 all-gathers over `model` a step, each a
    whole block input's bytes (a block's input gathered in the forward
    and the recompute, its output's gradient in the backward; the cut's
    gradient before the first block; the stream before the final norm).
    Nothing else changes."""
    d, m = spec["mesh"][-2:]
    rows = spec["n_clients"] * spec["batch_per_client"] // d
    block = rows * spec["seq"] * cfg.d_model * 4
    L = cfg.num_layers
    return {"saved_bytes_drop": L * block * (m - 1) // m,
            "all_gather/model": {"calls": 3 * L + 2,
                                 "bytes": (3 * L + 2) * block}}


def _hold_seq_leg(path, spec, cfg, ranks):
    """The seq_model leg's record (emitted): its losses and first-step
    gradients bitwise the leg's without it, its saved bytes fallen by
    exactly ``seq_leg_expected``'s drop, its collectives a step those of
    the leg without it plus exactly the cut's all-gathers, its launches
    the leg's."""
    legs = [r["seq_leg"] for r in ranks]
    want = seq_leg_expected(cfg, spec)
    add = want["all_gather/model"]
    rec = {"phase": path, "part": "seq_leg", "arch": cfg.name,
           "mesh": spec["mesh"], "expected": want,
           "expected_launches_per_step": train_launches_per_step(cfg),
           "ranks": legs}
    emit(rec)
    for r, x in zip(ranks, legs):
        drop = x["saved_bytes"]["whole"] - x["saved_bytes"]["seq"]
        ok = (x["seq_shard_acts"] and x["losses_bitwise"]
              and x["grads_bitwise"] and drop == want["saved_bytes_drop"]
              and x["launches_per_step"] == r["launches_per_step"])
        for seq_c, whole_c, seq_b, whole_b in zip(
                x["collectives_per_step"], x["whole_collectives_per_step"],
                x["collective_bytes_per_step"],
                x["whole_collective_bytes_per_step"]):
            key = "all_gather/model"
            ok &= (seq_c[key] - whole_c.get(key, 0) == add["calls"]
                   and seq_b[key] - whole_b.get(key, 0) == add["bytes"])
            ok &= ({k: v for k, v in seq_c.items() if k != key}
                   == {k: v for k, v in whole_c.items() if k != key})
        if not ok:
            raise AssertionError(
                f"{path} seq_leg rank {x['rank']}: losses bitwise "
                f"{x['losses_bitwise']}, gradients bitwise "
                f"{x['grads_bitwise']} ({x['grads_differing']} differ), "
                f"saved bytes fell {drop} (derived "
                f"{want['saved_bytes_drop']}), collectives "
                f"{x['collectives_per_step']} against "
                f"{x['whole_collectives_per_step']}")
    return _mesh_counts(legs, "step")


def attn_seq_leg_expected(cfg, spec) -> dict:
    """What the attn_seq_shard leg adds to a step, from the code
    (``attention._query_slice`` / ``_query_joined``'s autograd pairs), a
    self-attention of S queries over a data rank's B rows, f32, whole
    heads (q and the output B S H hd 4 bytes, K and V B S K hd), on a
    model axis of m that divides S:

      heads  forward: q, k, v and the output all-gathered over `model`
             (4); backward: dq and the output's heads gathered (2), dk
             and dv all-reduced (2)
      mixed  forward: q and the output (2); backward: dq, the output's
             heads (2); K/V all-reduced by the layout's copy_to already
      dboth  forward: the output (1); backward: dq (1), dk and dv (2)

    Each block's forward runs twice (the remat recompute): 2 x forward +
    backward a layer, over the body's L layers at the path's seq and, with
    an encoder, its layers at its frames. Cross-attention takes none;
    nothing else changes."""
    *_, d, m = spec["mesh"]
    rows = spec["n_clients"] * spec["batch_per_client"] // d
    layout = _attn_layout(cfg, m)
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {"all_gather/model": {"calls": 0, "bytes": 0},
           "all_reduce/model": {"calls": 0, "bytes": 0}}
    stacks = [(spec["seq"], cfg.num_layers)]
    if cfg.encoder_layers:
        stacks.append((cfg.encoder_seq, cfg.encoder_layers))
    for s, n in stacks:
        if s % m:
            continue
        q = o = rows * s * h * hd * 4
        kv = rows * s * k * hd * 4
        fwd = {"heads": [q, kv, kv, o], "mixed": [q, o]}.get(layout, [o])
        bwd = {"heads": [q, o], "mixed": [q, o]}.get(layout, [q])
        red = [] if layout == "mixed" else [kv, kv]
        gathers = 2 * fwd + bwd
        out["all_gather/model"]["calls"] += n * len(gathers)
        out["all_gather/model"]["bytes"] += n * sum(gathers)
        out["all_reduce/model"]["calls"] += n * len(red)
        out["all_reduce/model"]["bytes"] += n * sum(red)
    return {k: v for k, v in out.items() if v["calls"]}


def _hold_attn_seq_leg(path, spec, cfg, ranks, one):
    """The attn_seq_shard leg's record (emitted): its loss within
    TRAIN_LOSS_TOL of the same world's first step without the flag and of
    the one-rank path's, its gradients within TRAIN_GRAD_TOL (relative L2)
    of both, the masked client's adapter gradient exactly 0, its launches
    the first step's (the same calls at the smaller query shape), its
    collectives the first step's plus exactly ``attn_seq_leg_expected``;
    its host ms beside the steps' without the flag (recorded)."""
    legs = [r["attn_seq_leg"] for r in ranks]
    want = attn_seq_leg_expected(cfg, spec)
    emit({"phase": path, "part": "attn_seq_leg", "arch": cfg.name,
          "mesh": spec["mesh"], "layout": _attn_layout(cfg, spec["mesh"][-1]),
          "expected_added": want, "loss_tol": TRAIN_LOSS_TOL,
          "grad_tol": TRAIN_GRAD_TOL, "one_rank_loss": one["losses"][0],
          "ranks": legs})
    for r, x in zip(ranks, legs):
        seq_c, whole_c = x["collectives_per_step"][0], \
            r["collectives_per_step"][0]
        seq_b, whole_b = x["collective_bytes_per_step"][0], \
            r["collective_bytes_per_step"][0]
        added = {k: {"calls": seq_c.get(k, 0) - whole_c.get(k, 0),
                     "bytes": seq_b.get(k, 0) - whole_b.get(k, 0)}
                 for k in set(seq_c) | set(whole_c)}
        added = {k: v for k, v in added.items() if v["calls"] or v["bytes"]}
        errs = {"loss_vs_whole": abs(x["loss"] - r["losses"][0])
                / abs(r["losses"][0]),
                "loss_vs_one_rank": abs(x["loss"] - one["losses"][0])
                / abs(one["losses"][0]),
                "grad_vs_whole": max(x["grad_rel_l2_vs_whole"].values()),
                "grad_vs_one_rank": max(
                    x["grad_rel_l2_vs_one_rank"].values())}
        ok = (x["attn_seq_shard"] and added == want
              and x["masked_adapter_grad_zero"]
              and x["launches_per_step"][0] == r["launches_per_step"][0]
              and errs["loss_vs_whole"] <= TRAIN_LOSS_TOL
              and errs["loss_vs_one_rank"] <= TRAIN_LOSS_TOL
              and errs["grad_vs_whole"] <= TRAIN_GRAD_TOL
              and errs["grad_vs_one_rank"] <= TRAIN_GRAD_TOL)
        if not ok:
            raise AssertionError(
                f"{path} attn_seq_leg rank {x['rank']}: {errs}, masked "
                f"client's adapter gradient zero "
                f"{x['masked_adapter_grad_zero']}, launches "
                f"{x['launches_per_step'][0]} against "
                f"{r['launches_per_step'][0]}, collectives added {added} "
                f"against {want}")
    return _mesh_counts(legs, "step")


def _hold_per_client(path, spec, cfg, ranks):
    """The per-client leg's record (emitted): one ``backward_mode=
    "per_client"`` step (vanilla PSL: a forward and backward a client,
    N = n_clients) from the aggregated path's first state and batch, its
    launches and collectives exactly N passes' (``mesh_per_client_
    collectives``), its loss within TRAIN_LOSS_TOL of the aggregated first
    step's, every gradient within TRAIN_GRAD_TOL in relative L2 of the
    aggregated first step's (the int8 downlink rounds each pass's scaled
    cut-layer cotangent), the masked client's adapter gradient exactly 0.
    Its host time beside the aggregated step's is a count of passes, not
    a speed claim."""
    legs = [r["per_client"] for r in ranks]
    n = spec["n_clients"]
    expected = {"launches": {k: n * v for k, v in
                             train_launches_per_step(cfg).items()},
                "collectives": mesh_per_client_collectives(cfg, spec)}
    rec = {"phase": path, "part": "per_client", "arch": cfg.name,
           "mesh": spec["mesh"], "passes": n,
           "masked_client": spec["masked_client"],
           "expected_per_step": expected, "loss_tol": TRAIN_LOSS_TOL,
           "grad_tol": TRAIN_GRAD_TOL,
           "aggregated_step_ms": [r["median_step_ms"] for r in ranks],
           "per_client_step_ms": [x["step_ms"] for x in legs],
           "ranks": legs}
    _hold_mesh(f"{path} per_client", legs, expected, per="step")
    emit(rec)
    for x in legs:
        worst = max(x["grad_rel_l2"], key=x["grad_rel_l2"].get)
        if not (x["loss_rel_err"] <= TRAIN_LOSS_TOL
                and x["grad_rel_l2"][worst] <= TRAIN_GRAD_TOL
                and x["masked_adapter_grad_zero"]):
            raise AssertionError(
                f"{path} per_client rank {x['rank']}: loss "
                f"{x['loss_rel_err']}, gradient {worst} "
                f"{x['grad_rel_l2'][worst]}, masked client's adapter "
                f"gradient zero: {x['masked_adapter_grad_zero']}")
    return _mesh_counts(legs, "step")


def phase_mesh_train(path, spec):
    """The MPSL train step as the SPMD program on a (2, 2) mesh against
    the one-rank path on the same params, batches (client 1 masked out)
    and int seeds: each step's loss (1e-4 relative), every trainable
    gradient of the first step (1e-3 relative L2, from each rank's
    shard), the masked client's adapter gradient exactly 0."""
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        ref_file, one = _mesh_train_ref(cfg, spec, device, tmp)
        ranks, world_s = yield (_mesh_train_rank, _mesh(spec),
                                (spec, ref_file, one["losses"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _hold_mesh_train(path, spec, cfg, depth, ranks, one, world_s)


def _mesh_train_rank(spec, ref_file, ref_losses):
    """A rank of a mesh train path: its shards of the seed's state, the
    path's steps (an MoE arch replaying the one-rank path's expert
    choices: each step routes in every block's forward, 0 .. L-1, then in
    each block's remat recompute, L-1 .. 0, as torch's non-reentrant
    checkpoint recomputes a block when the backward first unpacks one of
    its saved tensors, on the autograd thread, which reads the same
    module-global tape; a recompute's choices are its forward's, so both
    runs make the same calls in the same order), the first step's
    gradients against the one-rank path's; with ``per_client``, that
    leg (``_per_client_leg``) from the same first state and batch."""
    prog = collectives.active()
    device = prog.device
    cfg, _ = _config(spec)
    mesh = prog.mesh
    run, batch, step_fn, first, (loss_fn, sched) = _train_setup(cfg, spec,
                                                                device)

    def make():
        gen = torch.Generator(device=device).manual_seed(spec["seed"])
        params, frozen, _ = split.init_mpsl_lm(gen, cfg, run, device)
        return (sharding.shard_tree(params,
                                    sharding.param_specs(params, mesh)),
                sharding.shard_tree(frozen,
                                    sharding.param_specs(frozen, mesh)))

    t0 = time.perf_counter()
    lp, lf = _rank_init(make)
    state = mpsl.init_state(lp, lf, spec["seed"])
    batches = [sharding.take_batch(sharding.place_batch(
        batch(i), device, mesh), device) for i in range(spec["steps"])]
    # the first state, for the per-client and seq_model legs after the
    # steps
    start = [p.detach().to("cpu", copy=True)
             for p in tree.leaves(state["params"])] \
        if spec.get("per_client") or spec.get("seq_leg") \
        or spec.get("attn_seq_leg") else None
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ref = torch.load(ref_file, mmap=True)

    # the steps, every counter set to 0 just before
    torch.cuda.reset_peak_memory_stats()
    with _tape(cfg, ref["idx"]) as tape:
        state, steps_rec = _counted_steps(step_fn, state, batches,
                                          spec.get("seq_leg", False))
    losses, times = steps_rec["losses"], steps_rec["times"]
    peak = torch.cuda.max_memory_allocated()

    # the first step's gradients (summed over `data`, before clipping)
    # against the one-rank path's
    names, leaves = tree.paths(state["params"]), tree.leaves(state["params"])
    errs = {n: _sharded_rel_l2(g, ref["grads"][n], collectives.spec_of(p))
            for n, p, g in zip(names, leaves, first)}
    zero = _masked_adapter_zero(spec, prog, names, first, device)
    leg = None
    if spec.get("per_client"):
        for p, x in zip(leaves, start):
            p.data.copy_(x)
        leg = _per_client_leg(spec, run, loss_fn, sched, state,
                              batches[0], first, losses[0])
        peak = max(peak, leg["peak_mem_bytes"])
    attn = None
    if spec.get("attn_seq_leg"):
        attn = _attn_seq_leg(spec, state, batches[0], start, first,
                             steps_rec, ref["grads"])
        peak = max(peak, attn["peak_mem_bytes"])
    seq = None
    if spec.get("seq_leg"):
        seq = _seq_leg(spec, state, batches, start, first, steps_rec)
        seq["whole_peak_mem_bytes"] = peak
        peak = max(peak, seq["peak_mem_bytes"])
    del ref, first[:]
    rec = _rank_record(
        prog, peak, program=prog.record(),
        init_s=init_s, losses=losses,
        step_ms=[x * 1e3 for x in times],
        median_step_ms=statistics.median(times[1:]) * 1e3,
        launches_per_step=steps_rec["launches"],
        collectives_per_step=steps_rec["collectives"],
        collective_bytes_per_step=steps_rec["bytes"], grad_rel_l2=errs,
        masked_adapter_grad_zero=zero, routing=_flips(tape),
        shard_params=sum(p.numel() for p in leaves),
        shard_frozen=sum(p.numel() for p in tree.leaves(state["frozen"])))
    if leg is not None:
        rec["per_client"] = leg
    if seq is not None:
        rec["seq_leg"] = seq
    if attn is not None:
        rec["attn_seq_leg"] = attn
    return rec


def _counted_steps(step_fn, state, batches, count_saved=False):
    """The steps of `batches`, every counter set to 0 just before: (the
    state after them, {"losses", "times" (s), "launches", "collectives",
    "bytes": one entry a step}); with `count_saved`, "saved_bytes": the
    bytes autograd saves for the backward in the first step (its
    forward's: a remat checkpoint's input counted once, its recompute
    saving under the checkpoint's own hooks)."""
    reset_counts()
    collectives.reset_counts()
    out = {k: [] for k in ("losses", "times", "launches", "collectives",
                           "bytes")}
    for i, b in enumerate(batches):
        k0, c0 = read_counts(), _collectives_step()
        b0 = _collective_bytes()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if count_saved and i == 0:
            (state, met), out["saved_bytes"] = _saved_bytes(
                lambda: step_fn(state, b))
        else:
            state, met = step_fn(state, b)
        out["losses"].append(float(met["loss"]))
        torch.cuda.synchronize()
        out["times"].append(time.perf_counter() - t)
        k1, c1 = read_counts(), _collectives_step()
        b1 = _collective_bytes()
        out["launches"].append({k: k1[k] - k0[k] for k in k1})
        out["collectives"].append({k: c1[k] - c0.get(k, 0) for k in c1})
        out["bytes"].append({k: b1[k] - b0.get(k, 0) for k in b1})
    return state, out


def _saved_bytes(fn):
    """(fn(), the bytes of every tensor autograd saves for the backward
    while it runs)."""
    n = [0]

    def pack(t):
        n[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, n[0]


def _back_to_start(state, start) -> None:
    """A train state back to the path's first state in place: its params
    from the host copy `start`, AdamW's moments and count zeroed (a second
    set of moments, 2.5 GB a qwen2-vl rank, would not fit beside four
    ranks' steps), the step counter 0."""
    for p, x in zip(tree.leaves(state["params"]), start):
        p.data.copy_(x)
    for t in tree.leaves(state["opt"]):
        t.zero_()
    state["step"] = 0


def _seq_leg(spec, state, batches, start, whole_first, whole):
    """The train leg again with ``seq_shard_acts`` (the stream cut on the
    sequence over `model` between the blocks, as ``steps.default_run``
    asks for a train_4k cell at d_model >= 8192), from the first state
    (its params restored, AdamW fresh) on the same batches: its losses and
    first-step gradients against the leg without it (`whole`, its first
    step's gradients `whole_first` on the host), bitwise; its launches and
    collectives a step; the bytes autograd saves in each leg's first
    step."""
    prog = collectives.active()
    device = prog.device
    cfg, _ = _config(spec)
    _back_to_start(state, start)
    run, _, step_fn, first, _ = _train_setup(
        cfg, dict(spec, seq_shard_acts=True), device)
    torch.cuda.reset_peak_memory_stats()
    state, rec = _counted_steps(step_fn, state, batches, True)
    peak = torch.cuda.max_memory_allocated()
    same = [torch.equal(a, b) for a, b in zip(first, whole_first)]
    first.clear()
    return {"rank": prog.rank, "seq_shard_acts": run.seq_shard_acts,
            "act_dims": run.impls["act_dims"], "losses": rec["losses"],
            "losses_bitwise": rec["losses"] == whole["losses"],
            "grads_bitwise": all(same) and len(same) == len(whole_first),
            "grads_differing": sum(not x for x in same),
            "step_ms": [x * 1e3 for x in rec["times"]],
            "saved_bytes": {"whole": whole["saved_bytes"],
                            "seq": rec["saved_bytes"]},
            "launches_per_step": rec["launches"],
            "collectives_per_step": rec["collectives"],
            "collective_bytes_per_step": rec["bytes"],
            "whole_collectives_per_step": whole["collectives"],
            "whole_collective_bytes_per_step": whole["bytes"],
            "peak_mem_bytes": peak}


def _attn_seq_leg(spec, state, batch, start, whole_first, whole, ref_grads):
    """One train step with ``attn_seq_shard`` (each model rank's core
    self-attention over its S/m queries against the whole K/V) from the
    first state (its params restored, AdamW fresh) on the first batch,
    every counter set to 0 just before: its loss, its gradients (read by
    the step's hook) against the first step's without the flag
    (`whole_first`, on the host) and the one-rank path's (`ref_grads`),
    each in relative L2 from every rank's shards; the masked client's
    adapter gradient; its launches, collectives, host ms and peak beside
    the steps' without the flag (`whole`)."""
    prog = collectives.active()
    device = prog.device
    cfg, _ = _config(spec)
    names, leaves = tree.paths(state["params"]), tree.leaves(state["params"])
    _back_to_start(state, start)
    run, _, step_fn, first, _ = _train_setup(
        cfg, dict(spec, attn_seq_shard=True), device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, rec = _counted_steps(step_fn, state, [batch])
    peak = torch.cuda.max_memory_allocated()
    vs_whole = {n: _shards_rel_l2(g, w, p) for n, p, g, w in
                zip(names, leaves, first, whole_first)}
    vs_one = {n: _sharded_rel_l2(g, ref_grads[n], collectives.spec_of(p))
              for n, p, g in zip(names, leaves, first)}
    zero = _masked_adapter_zero(spec, prog, names, first, device)
    first.clear()
    return {"rank": prog.rank, "attn_seq_shard": run.attn_seq_shard,
            "loss": rec["losses"][0], "step_ms": rec["times"][0] * 1e3,
            "whole_step_ms": [x * 1e3 for x in whole["times"]],
            "grad_rel_l2_vs_whole": vs_whole,
            "grad_rel_l2_vs_one_rank": vs_one,
            "masked_adapter_grad_zero": zero,
            "launches_per_step": rec["launches"],
            "collectives_per_step": rec["collectives"],
            "collective_bytes_per_step": rec["bytes"],
            "peak_mem_bytes": peak}


def _masked_adapter_zero(spec, prog, names, grads, device) -> bool:
    """Whether the masked client's adapter gradient is exactly 0 on the
    client rank holding it (every rank learns the answer)."""
    axis = collectives.client_axis()
    n_loc = spec["n_clients"] // prog.size(axis)
    c = spec["masked_client"] - prog.index(axis) * n_loc
    zero = True
    for name, g in zip(names, grads):
        if "adapter" in name and 0 <= c < n_loc:
            zero &= bool(g[c].abs().max().item() == 0.0)
    flag = collectives.all_reduce(torch.tensor(
        [0.0 if zero else 1.0], device=device), collectives.WORLD)
    return float(flag) == 0.0


def _per_client_leg(spec, run, loss_fn, sched, state, batch, agg_grads,
                    agg_loss):
    """One ``backward_mode="per_client"`` step (vanilla PSL: a forward and
    backward a client, every rank running all N clients' passes) from the
    aggregated path's first state (the params restored into `state`, the
    AdamW moments fresh, as at the start) and batch, every counter set to
    0 just before: its launches, collectives, host ms and peak, its loss
    against the aggregated first step's `agg_loss`, its gradients (read by
    its grad hook, kept on the card until the step ends) against
    `agg_grads`, the masked client's adapter gradient."""
    prog = collectives.active()
    device = prog.device
    grads = []
    step_fn = mpsl.make_train_step(
        loss_fn, run, sched, backward_mode="per_client",
        grad_hook=lambda _, g: grads.extend(x.detach().clone() for x in g))
    state = dict(state, opt=adamw_init(state["params"]), step=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    collectives.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, met = step_fn(state, batch)
    loss = float(met["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches, colls = read_counts(), _collectives_step()
    nbytes = _collective_bytes()
    peak = torch.cuda.max_memory_allocated()
    grads = [g.cpu() for g in grads]
    names, leaves = tree.paths(state["params"]), tree.leaves(state["params"])
    errs = {n: _shards_rel_l2(g, a, p)
            for n, p, g, a in zip(names, leaves, grads, agg_grads)}
    return {"rank": prog.rank, "step_ms": ms, "loss": loss,
            "aggregated_loss": agg_loss,
            "loss_rel_err": abs(loss - agg_loss) / abs(agg_loss),
            "per_client_losses": met["per_client"].tolist(),
            "launches_per_step": [launches], "collectives_per_step": [colls],
            "collective_bytes_per_step": [nbytes], "peak_mem_bytes": peak,
            "grad_rel_l2": errs,
            "masked_adapter_grad_zero": _masked_adapter_zero(
                spec, prog, names, grads, device)}


def _mesh(spec):
    """(data, model), or with three sizes (pod, data, model)."""
    names = ("pod", "data", "model")[-len(spec["mesh"]):]
    return mesh_lib.Mesh(names, tuple(spec["mesh"]))


def _decode_slots(spec) -> int:
    return spec.get("decode_slots", 512)


def _cross_kvs(cache) -> list:
    """The cross K/V that prefill kept beside each decoder layer's cache."""
    return [layer["cross"] for seg in cache for layer in seg
            if "cross" in layer]


def _mesh_serve_ref(cfg, spec, device, tmp):
    """The one-rank serve path on the card (a warm-up call, then the
    call; an encoder-decoder's prefill once more for its cross K/V): (the
    file in `tmp` holding its logits, tokens and cross K/V, the record's
    one-rank times)."""
    steps_ = spec["decode_steps"]
    params, tokens, stub = _serve_inputs(cfg, spec, device)
    prefill, decode = serve.build_serving_fns(
        cfg, torch.float32, device, decode_slots=_decode_slots(spec))
    serve.generate(prefill, decode, params, tokens, 1, **stub)  # warm-up
    with _tape(cfg) as tape:
        one = serve.generate(prefill, decode, params, tokens, steps_,
                             **stub)
    ref = {"logits": one["logits"].cpu(), "tokens": one["tokens"].cpu(),
           "idx": None if tape is None else [i.cpu() for i in tape.idx]}
    if cfg.encoder_layers:
        _, cache = prefill(params, tokens, **stub)
        ref["cross"] = [{k: c[k].cpu() for k in ("k", "v")}
                        for c in _cross_kvs(cache)]
        del cache
    ref_file = os.path.join(tmp, "ref.pt")
    torch.save(ref, ref_file)
    return ref_file, {"one_rank_prefill_ms": one["prefill_s"] * 1e3,
                      "one_rank_decode_ms_per_token":
                      one["decode_s"] / steps_ * 1e3}


def _hold_mesh_serve(path, spec, cfg, depth, ranks, rec_one, world_s):
    """The serve record of a mesh path (emitted): every rank's launches
    and collectives exactly the code's, every step's logits within
    SERVE_TOL (atol and rtol) of the one-rank path's, every greedy token
    the one-rank token or a near tie; an MoE arch's routing flips under
    ROUTING_FLIP_LIMIT (every layer routes in the prefill and in each
    decode step)."""
    steps_ = spec["decode_steps"]
    expected = {"launches": serve_launches(cfg, steps_),
                "collectives": mesh_serve_collectives(
                    cfg, steps_, spec["mesh"],
                    spec["prompt_len"] + _decode_slots(spec))}
    rec = {"phase": path, "part": "serve", **depth, "arch": cfg.name,
           "mesh": spec["mesh"], "program": ranks[0]["program"],
           "batch": spec["batch"], "prompt_len": spec["prompt_len"],
           "decode_steps": steps_, "dtype": spec["compute_dtype"],
           **rec_one, "world_s": world_s, "expected_per_call": expected,
           "tol": SERVE_TOL, "ranks": ranks}
    rec["ranks_peak_mem_bytes_sum"] = _hold_mesh(path, ranks, expected)
    COUNTED[(path, "serve")] = {
        k: {"calls": c, "bytes": ranks[0]["collective_bytes_per_call"][k]}
        for k, c in ranks[0]["collectives_per_call"][0].items() if c}
    emit(rec)
    for r in ranks:
        if not (r["logits_close"] and r["tokens_ok"]):
            raise AssertionError(
                f"{path} rank {r['rank']}: logits {r['max_logit_diff']} "
                f"off the one-rank path's, or a greedy token off by more "
                f"than a near tie ({r['token_deficit_max']})")
        if "cross_kv_close" in r and not (
                r["cross_kv_close"] and r["cross_kv_same_on_model_ranks"]
                and set(r["cross_kv_heads"]) == {cfg.num_kv_heads}):
            raise AssertionError(
                f"{path} rank {r['rank']}: cross K/V {r['cross_kv_max_diff']}"
                f" off the one-rank prefill's, the same bits on every model "
                f"rank: {r['cross_kv_same_on_model_ranks']}, heads "
                f"{r['cross_kv_heads']}")
        _hold_flips(f"{path} rank {r['rank']}", r.get("routing"),
                    cfg.num_layers * (1 + steps_))
    return _mesh_counts(ranks)


def phase_mesh_serve(path, spec):
    """Serving as the SPMD program on a (2, 2) mesh (the TP-only layout:
    weights on `model`, the batch on `data`) against the one-rank serve
    path on the same params and prompt, each step teacher-forced with the
    one-rank path's tokens: every step's logits within SERVE_TOL (atol
    and rtol), every greedy token the one-rank token or a near tie."""
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        ref_file, rec_one = _mesh_serve_ref(cfg, spec, device, tmp)
        ranks, world_s = yield (_mesh_serve_rank, _mesh(spec),
                                (spec, ref_file))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _hold_mesh_serve(path, spec, cfg, depth, ranks, rec_one, world_s)


def phase_mesh_family(path, spec):
    """A Mamba, hybrid, encoder-decoder, VLM or MoE LM as the SPMD program
    on its mesh, train then serve in one world (its mesh's ranks sharing
    the card over gloo), each part against its one-rank path run first:
    ``phase_mesh_train``'s and ``phase_mesh_serve``'s checks, limits and
    exact counts; an encoder-decoder's cross K/V every KV head on every
    model rank, the same bits on each, within SERVE_TOL of the one-rank
    prefill's. Returns the launches of both parts."""
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        train_ref, one = _mesh_train_ref(cfg, spec, device, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        serve_ref, rec_one = _mesh_serve_ref(cfg, spec, device, tmp)
        ranks, world_s = yield (_mesh_family_rank, _mesh(spec),
                                (spec, train_ref, one["losses"], serve_ref))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = _hold_mesh_train(path, spec, cfg, depth,
                              [r["train"] for r in ranks], one, world_s)
    served = _hold_mesh_serve(path, spec, cfg, depth,
                              [r["serve"] for r in ranks], rec_one, world_s)
    return {k: counts[k] + served[k] for k in counts}


def _mesh_family_rank(spec, train_ref, losses, serve_ref):
    out = {"train": _mesh_train_rank(spec, train_ref, losses)}
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = _mesh_serve_rank(spec, serve_ref)
    return out


def _serve_inputs(cfg, spec, device):
    """serve's params, prompt and stub frames or patches from the seed
    (``phase_serve``'s)."""
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    params = M.init_lm(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab_size,
                           (spec["batch"], spec["prompt_len"]),
                           generator=gen, device=device)
    return params, tokens, serve.stub_inputs(cfg, spec["batch"],
                                             spec["seed"], device)


def _mesh_serve_rank(spec, ref_file):
    prog = collectives.active()
    device = prog.device
    cfg, _ = _config(spec)
    mesh = prog.mesh
    steps_ = spec["decode_steps"]

    def rows(t):
        # this data rank's requests: the rows of the one-rank draw
        return sharding.shard_leaf(t, sharding.resolve_spec(
            mesh, t.shape, ("batch",) + (None,) * (t.dim() - 1)))

    def make():
        params, tokens, stub = _serve_inputs(cfg, spec, device)
        specs = steps._drop_fsdp(sharding.param_specs(params, mesh))
        return sharding.shard_tree(params, specs), rows(tokens), \
            {k: rows(v) for k, v in stub.items()}

    t0 = time.perf_counter()
    params, tokens, stub = _rank_init(make)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ref = torch.load(ref_file)
    b = tokens.shape[0]
    r0 = prog.index(collectives.client_axis()) * b
    forced = ref["tokens"][r0:r0 + b, :steps_].to(device)
    prefill, decode = serve.build_serving_fns(
        cfg, torch.float32, device, decode_slots=_decode_slots(spec))
    cross = {}
    if cfg.encoder_layers:
        # the prefill's cross K/V: every KV head on every model rank, the
        # same bits on each, against the one-rank prefill's
        _, cache = prefill(params, tokens, **stub)
        kvs = _cross_kvs(cache)
        same, diff, close = True, 0.0, True
        for c, want in zip(kvs, ref["cross"]):
            for k in ("k", "v"):
                parts = collectives.all_gather(c[k][None], 0, "model")
                same &= all(torch.equal(x, c[k]) for x in parts.unbind(0))
                got, w = c[k].cpu(), want[k][r0:r0 + b]
                diff = max(diff, (got - w).abs().max().item())
                close &= torch.allclose(got, w, atol=SERVE_TOL,
                                        rtol=SERVE_TOL)
        cross = {"cross_kv_heads": [c["k"].shape[2] for c in kvs],
                 "cross_kv_shape": list(kvs[0]["k"].shape),
                 "cross_kv_same_on_model_ranks": bool(same),
                 "cross_kv_max_diff": diff, "cross_kv_close": bool(close),
                 "self_cache_slots_here": cache[0][0]["k"].shape[1]}
        del cache, kvs, parts
    serve.generate(prefill, decode, params, tokens, 1, **stub)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    collectives.reset_counts()
    with _tape(cfg, ref["idx"]) as tape:
        out = serve.generate(prefill, decode, params, tokens, steps_,
                             forced_tokens=forced, **stub)
    launches, colls = read_counts(), _collectives_step()
    nbytes = _collective_bytes()
    peak = torch.cuda.max_memory_allocated()
    logits = out["logits"]
    if logits.shape[-1] != cfg.vocab_size:           # the vocab shards
        logits = collectives.all_gather(logits, 2, "model")
    logits = logits.cpu()
    want = ref["logits"][r0:r0 + b]
    close = torch.allclose(logits, want, atol=SERVE_TOL, rtol=SERVE_TOL)
    diff = (logits - want).abs().max().item()
    # a greedy token other than the one-rank path's must be a near tie:
    # its one-rank logit within twice the logits' tolerance of the top
    toks = out["tokens"].cpu()
    top = want.max(-1).values
    got = want.gather(-1, toks[..., None])[..., 0]
    deficit = (top - got)
    slack = 2 * (SERVE_TOL + SERVE_TOL * top.abs())
    return _rank_record(
        prog, peak, program=prog.record(), init_s=init_s,
        prefill_ms=out["prefill_s"] * 1e3,
        decode_ms_per_token=out["decode_s"] / steps_ * 1e3,
        launches_per_call=[launches], collectives_per_call=[colls],
        collective_bytes_per_call=nbytes, max_logit_diff=diff,
        logits_close=close,
        tokens_equal=int((toks == ref["tokens"][r0:r0 + b]).sum()),
        tokens=int(toks.numel()),
        token_deficit_max=deficit.max().item(),
        tokens_ok=bool((deficit <= slack).all()), routing=_flips(tape),
        **cross)


def phase_mesh_ep(path, spec):
    """qwen3-moe's prefill through ``steps.build_prefill`` as the SPMD
    program on a (1, 4) mesh (32 of 128 experts, 16 of 64 heads, 1 of 4
    KV heads, a quarter of the vocab a rank) against the one-rank path of
    the same dispatch (the 1 x 1 mesh), whose expert choices it replays:
    ep at capacity 2.0 (each layer's dropped (token, k) slots over every
    rank's experts bitwise the one-rank ``moe.ep_drop_mask``) or, with
    spec["moe"] "ragged", the ragged dispatch over each rank's experts
    (each layer's every slot run by exactly one rank: nothing dropped);
    the last logits within SERVE_TOL_BF16 of the largest |logit|, each
    layer's cache K/V within SERVE_TOL_BF16 in relative L2."""
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    one_mesh = mesh_lib.Mesh(("data", "model"), (1, 1))
    over = {"moe_impl": spec["moe"]} if "moe" in spec else {}
    run, krun = _cell_run(cfg, spec, one_mesh, **over)
    cdt = getattr(torch, run.compute_dtype)
    fn = steps.build_prefill(cfg, krun, one_mesh)[0]
    params, batch = _ep_inputs(cfg, spec, device, cdt)
    with sharding.use_mesh(one_mesh):
        fn(params, batch)                                     # warm-up
        torch.cuda.synchronize()
        with MOE.routing_tape() as tape:
            t = time.perf_counter()
            logits, cache = fn(params, batch)
            torch.cuda.synchronize()
            one_ms = (time.perf_counter() - t) * 1e3
    if run.moe_impl not in ("ep", "ragged"):
        raise ValueError(f"{path}: the ep or ragged dispatch, not "
                         f"{run.moe_impl}")
    ep = run.moe_impl == "ep"
    drops = [MOE.ep_drop_mask(idx, cfg.moe.num_experts, run.moe_capacity)
             for idx in tape.idx] if ep else []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        ref_file = os.path.join(tmp, "ref.pt")
        torch.save({"logits": logits.cpu(), "idx": [i.cpu() for i in tape.idx],
                    "drops": [d.cpu() for d in drops],
                    "cache": [{k: lay[k].cpu() for k in ("k", "v")}
                              for seg in cache for lay in seg]}, ref_file)
        del params, batch, logits, cache, tape
        ranks, world_s = yield (_mesh_ep_rank, _mesh(spec),
                                (spec, ref_file))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention_fwd"] = cfg.num_layers
    expected = {"launches": want, "collectives": mesh_ep_collectives(cfg)}
    rec = {"phase": path, **depth, "arch": cfg.name, "mesh": spec["mesh"],
           "program": ranks[0]["program"],
           "shape": dict(zip(("name", "seq_len", "global_batch", "kind"),
                             spec["shape"])),
           "moe_impl": run.moe_impl, "compute_dtype": run.compute_dtype,
           "one_rank_prefill_ms": one_ms, "world_s": world_s,
           "expected_per_call": expected, "tol": SERVE_TOL_BF16,
           "ranks": ranks}
    if ep:
        rec.update(ep_capacity=run.moe_capacity,
                   ep_dropped_slots_by_layer=[int(d.sum()) for d in drops])
    rec["ranks_peak_mem_bytes_sum"] = _hold_mesh(path, ranks, expected)
    emit(rec)
    for r in ranks:
        slots = (r["drops_equal"] if ep else
                 r["slots_run_once"] and r["hit_calls"] == cfg.num_layers
                 and r["drop_calls"] == 0)
        if not (slots and r["last_logits_rel_err"] <= SERVE_TOL_BF16
                and r["cache_rel_l2_max"] <= SERVE_TOL_BF16):
            raise AssertionError(
                f"{path} rank {r['rank']}: slots {slots} (drops equal "
                f"{r['drops_equal']}, each run once {r['slots_run_once']}), "
                f"logits {r['last_logits_rel_err']}, cache "
                f"{r['cache_rel_l2_max']}")
    return _mesh_counts(ranks)


def _long_inputs(cfg, spec, device, dtype):
    """long_500k's decode inputs from the seed, as ``phase_cell_decode``
    draws them: the params in `dtype`, the whole body cache (every slot,
    whatever program is active) seeded as filled, the first token."""
    params, gen = _serving_params(cfg, device, spec["seed"], dtype)
    b, cache_len = spec["shape"][2], spec["shape"][1]
    with collectives.program(None):
        cache = M.init_body_cache(cfg, b, cache_len, dtype, device)
    _seed_cache(cache, spec["filled"], gen)
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                        device=device)
    return params, cache, tok


def _long_positions(spec, i, device):
    return torch.full((spec["shape"][2], 1), spec["filled"] + i,
                      dtype=torch.int32, device=device)


def phase_mesh_long(path, spec):
    """long_500k's decode (hymba-1.5b, bf16, batch 1: ``phase_cell_decode``'s
    params, seeded caches and first token) through ``steps.build_decode``
    as the SPMD program on (1, 4): the three global layers' 524288 slots
    131072 a rank, the 1024-slot rings 256, the SSM states 800 channels,
    every attention weight's D a quarter (dboth); each rank's split-KV
    partials merged by lse over `model`. Against the one-rank kernel path
    (the 1 x 1 mesh) run first, teacher-forced with its greedy tokens:
    each step's logits within DECODE_CELL_TOL in relative L2, each greedy
    token the one-rank top or a near tie (``_token_deficit``); on every
    rank the seeded cache's shards gathered back bitwise."""
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    one_mesh = mesh_lib.Mesh(("data", "model"), (1, 1))
    run, krun = _cell_run(cfg, spec, one_mesh)
    cdt = getattr(torch, run.compute_dtype)
    fn = steps.build_decode(cfg, krun, one_mesh)[0]
    n_steps = spec["decode_steps"]
    params, cache, tok = _long_inputs(cfg, spec, device, cdt)
    toks, outs, times = [tok], [], []
    with sharding.use_mesh(one_mesh):
        for i in range(n_steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn(params, cache, None, toks[-1],
                               _long_positions(spec, i, device))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            outs.append(logits[:, -1].float().cpu())
            toks.append(logits[:, -1].argmax(-1)[:, None])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        ref_file = os.path.join(tmp, "ref.pt")
        torch.save({"logits": outs, "tokens": [t.cpu() for t in toks]},
                   ref_file)
        del params, cache, logits
        ranks, world_s = yield (_mesh_long_rank, _mesh(spec),
                                (spec, ref_file))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention_fwd"] = _layers(cfg)[0] * n_steps
    per_step = mesh_decode_collectives(cfg)
    expected = {"launches": want, "collectives": {
        k: v * n_steps for k, v in per_step.items()}}
    rec = {**_cell_record(path, spec, cfg, depth, run, one_mesh),
           "mesh": spec["mesh"], "program": ranks[0]["program"],
           "filled": spec["filled"], "decode_steps": n_steps,
           "one_rank_decode_ms_per_token": statistics.median(times) * 1e3,
           "world_s": world_s, "expected_per_call": expected,
           "tol": DECODE_CELL_TOL, "ranks": ranks}
    rec["ranks_peak_mem_bytes_sum"] = _hold_mesh(path, ranks, expected)
    emit(rec)
    for r in ranks:
        if not (r["cache_round_trip_bitwise"]
                and max(r["logits_rel_l2_by_step"]) <= DECODE_CELL_TOL
                and max(r["token_deficit_by_step"]) <= 2 * DECODE_CELL_TOL):
            raise AssertionError(
                f"{path} rank {r['rank']}: round trip "
                f"{r['cache_round_trip_bitwise']}, logits "
                f"{r['logits_rel_l2_by_step']}, token deficits "
                f"{r['token_deficit_by_step']}")
    return _mesh_counts(ranks)


def _mesh_long_rank(spec, ref_file):
    prog = collectives.active()
    device = prog.device
    cfg, _ = _config(spec)
    mesh = prog.mesh
    run, krun = _cell_run(cfg, spec, mesh)
    cdt = getattr(torch, run.compute_dtype)
    fn, _, in_specs, _ = steps.build_decode(cfg, krun, mesh)

    def make():
        params, cache, _ = _long_inputs(cfg, spec, device, cdt)
        lp, lc = steps.shard_inputs((params, cache), in_specs[:2])
        del params
        return lp, lc, cache

    t0 = time.perf_counter()
    params, cache, whole = _rank_init(make)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the seeded cache's shards, gathered back: every leaf bitwise
    t0 = time.perf_counter()
    trip = all((torch.equal(sharding.gather_leaf(a), b) if torch.is_tensor(a)
                else a == b)
               for a, b in zip(tree.leaves(cache), tree.leaves(whole)))
    trip_s = time.perf_counter() - t0
    slots = sorted({tuple(c["kv"]["k"].shape[1:3]) for seg in cache
                    for c in seg})
    channels = cache[0][0]["ssm"]["h"].shape[1]
    del whole
    torch.cuda.empty_cache()
    ref = torch.load(ref_file)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    collectives.reset_counts()
    errs, deficit, agree, times = [], [], [], []
    with sharding.use_mesh(mesh):
        for i in range(spec["decode_steps"]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn(params, cache, None,
                               ref["tokens"][i].to(device),
                               _long_positions(spec, i, device))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            got, want = logits[:, -1].float().cpu(), ref["logits"][i]
            errs.append(_rel_l2(got, want))
            tok = got.argmax(-1)
            agree.append(float((tok == ref["tokens"][i + 1][:, 0]).float()
                               .mean()))
            deficit.append(_token_deficit(want, tok)[0])
    launches, colls = read_counts(), _collectives_step()
    nbytes = _collective_bytes()
    peak = torch.cuda.max_memory_allocated()
    return _rank_record(
        prog, peak, program=prog.record(), init_s=init_s,
        cache_round_trip_bitwise=bool(trip), cache_round_trip_s=trip_s,
        kv_slots_and_heads=slots, ssm_channels=channels,
        decode_ms_per_token=statistics.median(times) * 1e3,
        step_ms=[x * 1e3 for x in times],
        launches_per_call=[launches], collectives_per_call=[colls],
        collective_bytes_per_call=nbytes, logits_rel_l2_by_step=errs,
        greedy_token_agreement_by_step=agree,
        token_deficit_by_step=deficit)


def _ep_inputs(cfg, spec, device, dtype):
    params, gen = _serving_params(cfg, device, spec["seed"], dtype)
    b, s = spec["shape"][2], spec["shape"][1]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=device)}
    return params, batch


def _mesh_ep_rank(spec, ref_file):
    prog = collectives.active()
    device = prog.device
    cfg, _ = _config(spec)
    mesh = prog.mesh
    run, krun = _cell_run(cfg, spec, mesh, **(
        {"moe_impl": spec["moe"]} if "moe" in spec else {}))
    cdt = getattr(torch, run.compute_dtype)
    fn, _, in_specs = steps.build_prefill(cfg, krun, mesh)

    def make():
        return steps.shard_inputs(_ep_inputs(cfg, spec, device, cdt),
                                  in_specs)

    t0 = time.perf_counter()
    params, batch = _rank_init(make)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ref = torch.load(ref_file)
    with MOE.routing_tape(ref["idx"]):
        fn(params, batch)                                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    collectives.reset_counts()
    with MOE.routing_tape(ref["idx"]) as tape:
        t = time.perf_counter()
        logits, cache = fn(params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    launches, colls = read_counts(), _collectives_step()
    nbytes = _collective_bytes()
    peak = torch.cuda.max_memory_allocated()
    # every rank's dropped slots among its own experts, joined (ep); the
    # ranks that ran each slot, added (ragged: exactly one each)
    drops_equal = len(tape.drops) == len(ref["drops"])
    for mine, want in zip(tape.drops, ref["drops"]):
        joined = collectives.all_reduce(mine.int(), "model") > 0
        drops_equal &= torch.equal(joined.cpu(), want)
    run_once = True
    for hit in tape.hits:
        ran = collectives.all_reduce(hit.int(), "model")
        run_once &= bool((ran == 1).all().item())
    logits = collectives.all_gather(logits, 2, "model").float().cpu()
    want = ref["logits"].float()
    errs = {}
    for i, (lay, r) in enumerate(zip((x for seg in cache for x in seg),
                                     ref["cache"])):
        for name in ("k", "v"):
            whole = collectives.all_gather(lay[name], 2, "model").cpu()
            errs[f"layer{i}.{name}"] = _rel_l2(whole, r[name])
    worst = max(errs, key=errs.get)
    return _rank_record(
        prog, peak, program=prog.record(), init_s=init_s, prefill_ms=ms,
        launches_per_call=[launches], collectives_per_call=[colls],
        collective_bytes_per_call=nbytes,
        drops_equal=bool(drops_equal), drop_calls=len(tape.drops),
        slots_run_once=bool(run_once), hit_calls=len(tape.hits),
        routing_flips=int(tape.flips), routing_decisions=tape.decisions,
        last_logits_rel_err=_rel_max(logits, want),
        cache_rel_l2=errs, cache_rel_l2_max=errs[worst],
        cache_rel_l2_worst=worst)


# ---------------------------------------------------------------------------
# mesh_hybrid's beta_ssm gradient at 4 layers (ROADMAP.md Queue 3): not a
# main path; run alone, as README.md says

BETA_DIAG = dict(PATHS["mesh_hybrid"], layers=4, trainable_blocks=2,
                 reduced="depth 32 -> 4 layers, the last 2 trainable: the "
                 "cut at which mesh_hybrid's first trainable beta_ssm "
                 "gradient broke its limit")


@contextlib.contextmanager
def _float_is_double():
    """``Tensor.float()`` gives float64 while open: the model code's f32
    upcasts (norms, softmax, the plain scan's state, the CE) then hold
    f64, and a float64 path computes in f64 throughout."""
    old = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = old


@contextlib.contextmanager
def _links(up=None, capture=None):
    """The uplink's quantised value recorded into `capture` (a list), or
    replaced by `up` (its straight-through gradient kept); with `up` the
    downlink is the identity (its cotangent reaches only the adapters)."""
    act, grads = compression.compress_activations, compression.compress_gradients

    def compress(x, rng, row0=0):
        if up is None:
            y = act(x, rng, row0)
            if capture is not None:
                capture.append(y.detach())
            return y
        return x + (up.to(x.device, x.dtype) - x).detach()

    compression.compress_activations = compress
    if up is not None:
        compression.compress_gradients = lambda x, rng, row0=0: x
    try:
        yield
    finally:
        compression.compress_activations = act
        compression.compress_gradients = grads


def _beta_grads(cfg, run, spec, device, impls, dtype=None, up=None,
                capture=None, terms=()):
    """The first step's gradients (``mpsl.value_and_grad``) of every
    block's beta_attn and beta_ssm on one rank, on the path's seeded
    params and first batch at its step-0 rng; `dtype` float64 casts every
    param and computes in f64 (``_float_is_double``). Each leaf named in
    `terms` is given as a [T, S, D] tensor of its value, whose gradient
    is then the sum's terms 0.5 * s_out * dy one by one. Returns (loss,
    {leaf: gradient}, {leaf: terms})."""
    _, batch, _, _, _ = _train_setup(cfg, spec, device)
    if dtype is not None:
        run = dataclasses.replace(run, compute_dtype="float64")
    loss_fn = mpsl.make_lm_loss(cfg, run, impls=impls)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run, device)
    if dtype is not None:
        params = tree.map_(lambda t: t.to(dtype), params)
        frozen = tree.map_(lambda t: t.to(dtype), frozen)
    b = train.to_device(batch(0), device)
    rows = spec["n_clients"] * spec["batch_per_client"]
    shape = (rows, spec["seq"], cfg.d_model)
    for name in terms:
        node = params
        *path, leaf = name.split("/")
        for k in path:
            node = node[int(k)] if isinstance(node, list) else node[k]
        node[leaf] = node[leaf].detach().expand(shape).clone()
    state = mpsl.init_state(params, frozen, spec["seed"])
    ctx = _float_is_double() if dtype is not None else contextlib.nullcontext()
    with ctx, _links(up, capture):
        loss, _, grads = mpsl.value_and_grad(
            loss_fn, state["params"], state["frozen"], b,
            mpsl.fold_in(spec["seed"], 0))
    out, full = {}, {}
    for n, g in zip(tree.paths(state["params"]), grads):
        if n.endswith(("beta_ssm", "beta_attn")):
            full[n] = g.detach().double()
            out[n] = float(g.sum(dtype=torch.float64))
    return float(loss), out, {n: full[n] for n in terms}


def _beta_rank(spec):
    """A (2, 2) rank's first-step beta gradients (summed over `data` by
    ``reduce_grads``; replicated leaves, the same on every rank)."""
    prog = collectives.active()
    device = prog.device
    cfg, _ = _config(spec)
    run, batch, _, _, _ = _train_setup(cfg, spec, device)
    loss_fn = mpsl.make_lm_loss(cfg, run, impls=mpsl.KERNEL_IMPLS)

    def make():
        gen = torch.Generator(device=device).manual_seed(spec["seed"])
        params, frozen, _ = split.init_mpsl_lm(gen, cfg, run, device)
        return (sharding.shard_tree(params,
                                    sharding.param_specs(params, prog.mesh)),
                sharding.shard_tree(frozen,
                                    sharding.param_specs(frozen, prog.mesh)))

    lp, lf = _rank_init(make)
    state = mpsl.init_state(lp, lf, spec["seed"])
    b = sharding.take_batch(sharding.place_batch(batch(0), device,
                                                 prog.mesh), device)
    loss, _, grads = mpsl.value_and_grad(loss_fn, state["params"],
                                         state["frozen"], b,
                                         mpsl.fold_in(spec["seed"], 0))
    collectives.reduce_grads(tree.leaves(state["params"]), grads)
    return {"loss": float(loss),
            "grads": {n: float(g.sum(dtype=torch.float64))
                      for n, g in zip(tree.paths(state["params"]), grads)
                      if n.endswith(("beta_ssm", "beta_attn"))}}


def diagnose_beta_ssm(spec=None):
    """ROADMAP.md Queue 3's mesh_hybrid item: hymba-1.5b at 4 layers (the
    last 2 trainable), the first step's beta gradients of the one-rank
    plain path in float64 (naive attention, the plain scan, the plain CE;
    its uplink fed the f32 kernel path's quantised value, so that all
    paths' bodies see the same input) as ground truth, beside the f32
    one-rank kernel and plain paths and the (2, 2) mesh path. For each
    trainable block's beta_ssm, the sum's terms 0.5 * s_out * dy: their
    condition sum|t| / |sum t| in f64, and the f32 kernel path's terms'
    own error sum|t32 - t64| over |sum t64|, the gap that an exact sum of
    the f32 terms would leave. Emits one record."""
    spec = spec or BETA_DIAG
    cfg, depth = _config(spec)
    device = serve.resolve_device("cuda")
    run, _, _, _, _ = _train_setup(cfg, spec, device)
    segs = split.make_split_plan(cfg, run.mpsl).segments_train
    terms = [f"server/segments/{i}/{j}/mix/beta_ssm"
             for i, s in enumerate(segs) for j in range(s.count)]
    t0 = time.perf_counter()
    up = []
    l32, g32, _ = _beta_grads(cfg, run, spec, device, mpsl.KERNEL_IMPLS,
                              capture=up)
    _, _, t32 = _beta_grads(cfg, run, spec, device, mpsl.KERNEL_IMPLS,
                            terms=terms)
    lp, gp, _ = _beta_grads(cfg, run, spec, device, PLAIN_IMPLS)
    l64, g64, t64 = _beta_grads(cfg, run, spec, device, PLAIN_IMPLS,
                                dtype=torch.float64, up=up[0], terms=terms)
    del up
    gc.collect()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spmd.spawn(_beta_rank, _mesh(spec), "cuda", MESH_TIMEOUT,
                       args=(spec,))
    mesh_s = time.perf_counter() - t0
    gm = ranks[0]["grads"]
    leaves = {}
    for n in g64:
        rel = lambda g: abs(g - g64[n]) / abs(g64[n])  # noqa: E731
        leaves[n] = {"f64_plain": g64[n], "f32_kernel": g32[n],
                     "f32_plain": gp[n], "f32_mesh": gm[n],
                     "rel_err_f32_kernel": rel(g32[n]),
                     "rel_err_f32_plain": rel(gp[n]),
                     "rel_err_f32_mesh": rel(gm[n]),
                     "mesh_vs_kernel": abs(gm[n] - g32[n]) / abs(g32[n]),
                     "mesh_ranks_agree": len({r["grads"][n]
                                              for r in ranks}) == 1}
        if n in t64:
            a, b = t64[n], t32[n].double()
            total = float(a.sum())
            leaves[n].update(
                terms=a.numel(), terms_abs_sum=float(a.abs().sum()),
                condition=float(a.abs().sum()) / abs(total),
                terms_sum_f64=total,
                f32_terms_err_over_grad=float((b - a).abs().sum())
                / abs(total),
                f32_terms_exact_sum_rel_err=abs(float(b.sum()) - total)
                / abs(total))
    emit({"phase": "beta_ssm_diagnosis", **depth, "arch": cfg.name,
          "mesh": spec["mesh"], "masked_client": spec["masked_client"],
          "losses": {"f64_plain": l64, "f32_kernel": l32, "f32_plain": lp,
                     "f32_mesh": ranks[0]["loss"]},
          "one_rank_s": one_s, "mesh_s": mesh_s, "leaves": leaves})
    return leaves


# ---------------------------------------------------------------------------
# the paper mode on the mesh (mesh_vit, mesh_vit_dboth)

# a mesh vit path's legs: (modalities, task, fusion)
VIT_LEGS = {"early": (("vision", "text"), "classification", "early"),
            "late": (("vision", "audio", "text"), "classification", "late"),
            "retrieval": (("vision", "text"), "retrieval", "early")}


def _vit_leg(spec, leg) -> dict:
    """A leg's spec: the path's, its modalities, task and fusion, and its
    step count."""
    mods, task, fusion = VIT_LEGS[leg]
    return dict(spec, modalities=mods, task=task, fusion=fusion,
                steps=spec["legs"][leg])


def mesh_vit_collectives(cfg, lspec) -> dict:
    """The collectives of one paper-mode train step on a (data d, model m)
    mesh, from the code, with block remat and every block trainable (L
    blocks, P encoder passes: ``_vit_passes``). The tokenizers lie on the
    client axis and move nothing. Each pass runs every block: over `data`
    (fsdp) its 4 attention and 2 MLP weights gathered in the forward and
    the remat recompute (12 L P), their gradients reduce-scattered (6 L
    P); over `model`, under heads, the attention output's all-reduce in
    both passes and x's gradient entering the region (3), under dboth the
    q|k|v partial sums in both, x's and the attention output's gradients
    (4) and wo's output parts all-gathered in both (2 all-gathers); the
    MLP's output and its input's gradient (2). Over `data` once a step:
    the trainable leaves off `data` summed by ``reduce_grads`` (each
    block's 2 norms' scale and bias and its 3 qkv biases, the final
    norm's 2, the task head's 2 or retrieval's proj_a, proj_b and logit
    scale), the mask's sum, L_S and the participating count all-reduced,
    every client's loss all-gathered; retrieval's embeddings all-gathered
    for the global InfoNCE and their gradients reduce-scattered (2 each).
    The global norm's squared sums over the world (1)."""
    *_, d, m = lspec["mesh"]
    L, P = cfg.num_layers, _vit_passes(lspec)
    retrieval = lspec["task"] == "retrieval"
    dboth = _attn_layout(cfg, m) == "dboth"
    norm = 2 if cfg.norm == "layernorm" else 1
    head = 3 if retrieval else 2
    out = {"all_gather/data": 12 * L * P + 1 + 2 * retrieval,
           "reduce_scatter/data": 6 * L * P + 2 * retrieval,
           "all_reduce/data": ((2 * norm + 3 * cfg.qkv_bias) * L + norm
                               + head + 3),
           "all_reduce/model": (6 if dboth else 5) * L * P,
           "all_gather/model": 2 * L * P * dboth,
           "all_reduce/world": 1}
    return {k: v for k, v in out.items() if v and (
        k.endswith("/world") or {"data": d, "model": m}[k.split("/")[1]] > 1)}


def _vit_leg_setup(cfg, lspec, device, impls=mpsl.KERNEL_IMPLS):
    """A leg's run, its batches (client `masked_client` masked out; numpy),
    its kernel-path step (the first step's gradients kept on the host by
    its grad hook), and a function giving its initial trees from the
    seed."""
    mods, retrieval = lspec["modalities"], lspec["task"] == "retrieval"
    mp = MPSLConfig(n_clients=lspec["n_clients"],
                    trainable_blocks=lspec["trainable_blocks"],
                    fusion=lspec["fusion"], compress_uplink=True,
                    compress_downlink=True)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype=lspec["compute_dtype"],
                    learning_rate=lspec["lr"], seed=lspec["seed"])
    loader = _vit_loader(lspec)

    def batch(i):
        b = loader.batch(i)
        b["mask"] = b["mask"].copy()
        b["mask"][lspec["masked_client"]] = 0.0
        return b

    def init(on=device):
        # on "meta" (the dry run's abstract trees) the draw is the CPU's
        gen = torch.Generator(device="cpu" if on == "meta" else on)
        return split.init_mpsl_vit(gen.manual_seed(lspec["seed"]), cfg, run,
                                   mods, lspec["n_classes"], retrieval, on)

    loss_fn = mpsl.make_vit_loss(cfg, run, impls=impls,
                                 modalities=mods, task=lspec["task"],
                                 n_classes=lspec["n_classes"])
    first = []

    def keep_first(step, grads):
        if step == 0:
            first.extend(g.detach().to("cpu", copy=True) for g in grads)

    sched = schedules.warmup_cosine(lspec["lr"], 10, lspec["steps"])
    step_fn = mpsl.make_train_step(loss_fn, run, sched, grad_hook=keep_first)
    return batch, init, step_fn, first


def _is_text_table(name) -> bool:
    return name.endswith("text/embed")


def _mesh_vit_ref(cfg, spec, device, tmp):
    """The one-rank kernel path of each leg on the card, on the same
    params (from the seed), batches and int seeds as the mesh: (the file
    in `tmp` holding each leg's first-step gradients by leaf path (the
    frozen text table's apart: exactly 0, recorded) and its post-training
    outputs, the record's one-rank figures by leg)."""
    ref, one = {}, {}
    for leg in spec["legs"]:
        lspec = _vit_leg(spec, leg)
        batch, init, step_fn, first = _vit_leg_setup(cfg, lspec, device)
        params, frozen, plan = init()
        state = mpsl.init_state(params, frozen, lspec["seed"])
        batches = [_vit_to_device(batch(i), device)
                   for i in range(lspec["steps"])]
        _, rec = _run_steps(step_fn, state, batches,
                            vit_launches_per_step(cfg, lspec))
        _hold_steps(f"{leg} one-rank", rec)
        names = tree.paths(state["params"])
        entry = {"grads": {n: g for n, g in zip(names, first)
                           if not _is_text_table(n)},
                 "text_table_grad_zero": all(
                     not g.any() for n, g in zip(names, first)
                     if _is_text_table(n))}
        if leg in spec["evals"]:
            with torch.no_grad():
                out = _vit_outputs(cfg, lspec, _post_training_model(
                    state["params"], frozen, plan), batches[0])
            entry["eval"] = [t.cpu() for t in out]
            if lspec["task"] == "retrieval":
                entry["recall"] = [float(losses.recall_at_k(*out, k))
                                   for k in (1, 5)]
            del out
        ref[leg] = entry
        one[leg] = {"losses": rec["losses"],
                    "step_ms": rec["step_ms"],
                    "peak_mem_bytes": rec["peak_mem_bytes"],
                    "text_table_grad_zero": entry["text_table_grad_zero"]}
        del state, params, frozen, batches, first[:]
        gc.collect()
        torch.cuda.empty_cache()
    ref_file = os.path.join(tmp, "vit.pt")
    torch.save(ref, ref_file)
    return ref_file, one


def _masked_client(lspec, prog, names, grads, ref, device) -> dict:
    """The masked client's tokenizer gradient on the client rank holding
    it (every rank learns the answer): whether it is exactly 0, whether
    it is non-zero (the frozen text table apart), and its largest gap to
    the one-rank path's, in relative L2 over its slice of each leaf."""
    axis = collectives.client_axis()
    n_loc = lspec["n_clients"] // prog.size(axis)
    c = lspec["masked_client"] - prog.index(axis) * n_loc
    stats = [0.0, 0.0, 0.0]                 # nonzero, zero broken, gap
    if 0 <= c < n_loc:
        for name, g in zip(names, grads):
            if "tokenizers" not in name:
                continue
            mine = g[c].float()
            stats[1] = max(stats[1], float(mine.abs().max().item() > 0))
            if _is_text_table(name):
                continue
            stats[0] = max(stats[0], float(mine.abs().max().item() > 0))
            want = ref[name][lspec["masked_client"]].to(mine.device).float()
            den = want.norm().item()
            gap = (mine - want).norm().item()
            stats[2] = max(stats[2], gap / den if den else gap)
    flag = collectives.all_reduce(torch.tensor(stats, device=device),
                                  collectives.WORLD, op="max").tolist()
    return {"masked_grad_nonzero": flag[0] > 0,
            "masked_grad_zero": flag[1] == 0,
            "masked_grad_rel_l2": flag[2]}


def _digest(tensors) -> str:
    """A digest of every bit of `tensors` (copied to the host)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _mesh_vit_eval(cfg, lspec, prog, state, plan, batch, ref):
    """A rank's post-training checks (the post-training model on its
    samples, every counter set to 0 just before): the FedAvg-ed
    tokenizers against the one-rank mean of the same stacked tokenizers
    (gathered whole) in relative L2 and a digest of their bits (compared
    across ranks by the phase), its launches and collectives, the logits
    or embeddings gathered over the client axis against the one-rank
    path's, recall over the global batch."""
    axis = collectives.client_axis()
    reset_counts()
    collectives.reset_counts()
    with torch.no_grad():
        full = _post_training_model(state["params"], state["frozen"], plan)
        out = _vit_outputs(cfg, lspec, full, batch)
    heads = full["tokenizers"]
    torch.cuda.synchronize()
    launches, colls = read_counts(), _collectives_step()
    out = [collectives.all_gather(t, 0, axis) for t in out]
    gaps = {}
    for name, h, p in zip(tree.paths(heads), tree.leaves(heads),
                          tree.leaves(state["params"]["client"][
                              "tokenizers"])):
        mean = sharding.gather_leaf(p).mean(dim=0)
        gaps[name] = _rel_l2(h, mean)
        del mean
    rec = {"launches_per_call": [launches], "collectives_per_call": [colls],
           "fedavg_rel_l2_vs_one_rank_mean": gaps,
           "fedavg_digest": _digest(tree.leaves(heads)),
           "outputs_shape": [list(t.shape) for t in out],
           "max_abs_diff": max(_max_err(a.cpu(), b)
                               for a, b in zip(out, ref["eval"])),
           "close": all(torch.allclose(a.cpu(), b, atol=SERVE_TOL,
                                       rtol=SERVE_TOL)
                        for a, b in zip(out, ref["eval"])),
           "finite": all(bool(torch.isfinite(t).all()) for t in out)}
    if lspec["task"] == "retrieval":
        rec["recall"] = [float(losses.recall_at_k(*out, k)) for k in (1, 5)]
        rec["one_rank_recall"] = ref["recall"]
    return rec


def _mesh_vit_rank(spec, ref_file):
    """A rank of a mesh vit path: each leg from its shards of the seed's
    trees (each rank's whole trees made in turn), its steps with every
    counter set to 0 just before, the first step's gradients against the
    one-rank path's from each rank's shards (a key bias against its
    layer's query bias's norm), the frozen text table's exactly 0, the
    masked client's; then, where the leg evaluates, the post-training
    model (``_mesh_vit_eval``)."""
    prog = collectives.active()
    device, mesh = prog.device, prog.mesh
    cfg, _ = _config(spec)
    ref = torch.load(ref_file, mmap=True)
    out = {}
    for leg in spec["legs"]:
        lspec = _vit_leg(spec, leg)
        batch, init, step_fn, first = _vit_leg_setup(cfg, lspec, device)

        def make():
            params, frozen, plan = init()
            return (sharding.shard_tree(params,
                                        sharding.param_specs(params, mesh)),
                    sharding.shard_tree(frozen,
                                        sharding.param_specs(frozen, mesh)),
                    plan)

        t0 = time.perf_counter()
        lp, lf, plan = _rank_init(make)
        state = mpsl.init_state(lp, lf, lspec["seed"])
        batches = [sharding.take_batch(sharding.place_batch(
            batch(i), device, mesh), device) for i in range(lspec["steps"])]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        state, steps_rec = _counted_steps(step_fn, state, batches)
        r = ref[leg]
        names = tree.paths(state["params"])
        leaves = tree.leaves(state["params"])
        errs = {}
        for n, p, g in zip(names, leaves, first):
            if _is_text_table(n):
                continue
            spec_p = collectives.spec_of(p)
            den = None
            if n.endswith("attn/bk"):
                den = sharding.shard_leaf(r["grads"][n[:-2] + "bq"], spec_p)
            errs[n] = _shards_rel_l2(g, sharding.shard_leaf(
                r["grads"][n], spec_p), p, den)
        checks = dict(
            grad_rel_l2=errs,
            text_table_grad_zero=all(not g.any() for n, g in zip(
                names, first) if _is_text_table(n)),
            **_masked_client(lspec, prog, names, first, r["grads"], device))
        del first[:]
        if leg in spec["evals"]:
            checks["eval"] = _mesh_vit_eval(cfg, lspec, prog, state, plan,
                                            batches[0], r)
        out[leg] = _rank_record(
            prog, torch.cuda.max_memory_allocated(), program=prog.record(),
            init_s=init_s, losses=steps_rec["losses"],
            step_ms=[x * 1e3 for x in steps_rec["times"]],
            launches_per_step=steps_rec["launches"],
            collectives_per_step=steps_rec["collectives"],
            collective_bytes_per_step=steps_rec["bytes"],
            shard_params=sum(p.numel() for p in leaves), **checks)
        del state, lp, lf, batches
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _hold_mesh_vit(path, spec, cfg, ranks, one, world_s):
    """Each leg's record (emitted): every rank's launches and collectives
    a step exactly the code's, each step's loss within TRAIN_LOSS_TOL of
    the one-rank path's, every first-step gradient within TRAIN_GRAD_TOL
    in relative L2 (a key bias against its layer's query bias's norm),
    the frozen text table's exactly 0, the masked client's tokenizer
    gradient exactly 0 in classification, and in retrieval (its samples
    stay negatives of the global InfoNCE) non-zero and within
    TRAIN_GRAD_TOL of the one-rank path's; the ranks' peaks under 80 GB.
    Where the leg evaluates: the evaluation's launches exactly the code's,
    the FedAvg-ed tokenizers within FEDAVG_MEAN_TOL of the one-rank mean
    of the same clients and the same bits on every rank, the logits or
    embeddings within SERVE_TOL (atol and rtol) of the one-rank path's,
    recall at 1 and 5 equal. Returns the launches of every leg."""
    counts = dict.fromkeys(COUNTERS, 0)
    COUNTED[(path, "train")] = _first_step_counts(ranks[0]["early"])
    for leg in spec["legs"]:
        lspec = _vit_leg(spec, leg)
        legs = [r[leg] for r in ranks]
        expected = {"launches": vit_launches_per_step(cfg, lspec),
                    "collectives": mesh_vit_collectives(cfg, lspec)}
        rec = {"phase": path, "part": leg, "arch": cfg.name,
               "layers": cfg.num_layers, "mesh": spec["mesh"],
               "program": legs[0]["program"],
               "layout": _attn_layout(cfg, spec["mesh"][-1]),
               "modalities": lspec["modalities"], "task": lspec["task"],
               "fusion": lspec["fusion"],
               "encoder_passes": _vit_passes(lspec),
               "n_clients": spec["n_clients"],
               "batch_per_client": spec["batch_per_client"],
               "masked_client": spec["masked_client"],
               "steps": lspec["steps"], "reduced": spec["reduced"],
               "one_rank": one[leg], "world_s": world_s,
               "expected_per_step": expected, "loss_tol": TRAIN_LOSS_TOL,
               "grad_tol": TRAIN_GRAD_TOL, "ranks": legs}
        rec["ranks_peak_mem_bytes_sum"] = _hold_mesh(f"{path} {leg}", legs,
                                                     expected, per="step")
        emit(rec)
        retrieval = lspec["task"] == "retrieval"
        for x in legs:
            worst = max(x["grad_rel_l2"], key=x["grad_rel_l2"].get)
            errs = [abs(a - b) / abs(b) for a, b in zip(
                x["losses"], one[leg]["losses"])]
            masked = (x["masked_grad_nonzero"] and x["masked_grad_rel_l2"]
                      <= TRAIN_GRAD_TOL) if retrieval \
                else x["masked_grad_zero"]
            if not (max(errs) <= TRAIN_LOSS_TOL
                    and x["grad_rel_l2"][worst] <= TRAIN_GRAD_TOL
                    and x["text_table_grad_zero"] and masked):
                raise AssertionError(
                    f"{path} {leg} rank {x['rank']}: losses {x['losses']} "
                    f"vs {one[leg]['losses']}, gradient {worst} "
                    f"{x['grad_rel_l2'][worst]}, text table zero "
                    f"{x['text_table_grad_zero']}, masked client: "
                    f"zero {x['masked_grad_zero']}, non-zero "
                    f"{x['masked_grad_nonzero']}, gap "
                    f"{x['masked_grad_rel_l2']}")
        counts = {k: counts[k] + v for k, v in _mesh_counts(
            legs, "step").items()}
        if leg not in spec["evals"]:
            continue
        evs = [x["eval"] for x in legs]
        want = _vit_eval_launches(cfg, lspec)
        emit({"phase": path, "part": f"{leg}_eval", "mesh": spec["mesh"],
              "expected_launches": want, "tol": SERVE_TOL,
              "fedavg_tol": FEDAVG_MEAN_TOL, "ranks": evs})
        digests = {e["fedavg_digest"] for e in evs}
        for x, e in zip(legs, evs):
            gap = max(e["fedavg_rel_l2_vs_one_rank_mean"].values())
            if not (e["launches_per_call"][0] == want and e["close"]
                    and e["finite"] and gap <= FEDAVG_MEAN_TOL
                    and len(digests) == 1
                    and e.get("recall") == e.get("one_rank_recall")):
                raise AssertionError(
                    f"{path} {leg} evaluation rank {x['rank']}: launches "
                    f"{e['launches_per_call'][0]} (expected {want}), "
                    f"outputs {e['max_abs_diff']} off the one-rank path's, "
                    f"FedAvg {gap} off the one-rank mean, {len(digests)} "
                    f"digests, recall {e.get('recall')} vs "
                    f"{e.get('one_rank_recall')}")
            for k, v in e["launches_per_call"][0].items():
                counts[k] += v
    return counts


def phase_mesh_vit(path, spec):
    """The paper mode (vit-base) as the SPMD program on its mesh, against
    the one-rank kernel path run first on the card on the same params,
    batches and int seeds: each leg's steps (``_hold_mesh_vit``), then
    the post-training FedAvg, assembly and evaluation."""
    cfg, _ = _config(spec)
    device = serve.resolve_device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        ref_file, one = _mesh_vit_ref(cfg, spec, device, tmp)
        ranks, world_s = yield (_mesh_vit_rank, _mesh(spec),
                                (spec, ref_file))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _hold_mesh_vit(path, spec, cfg, ranks, one, world_s)


# each mesh path's phase, and the groups whose paths share one world (its
# meshes of one size), in the order they run: a world's start and the
# warm-up of its first training step (on the H100 10-35 s over the second
# step for a world's first path, ~2 s for a later one) come once a group
MESH_PHASES = {"mesh_train": phase_mesh_train, "mesh_serve": phase_mesh_serve,
               "mesh_ep": phase_mesh_ep, "mesh_ep_ragged": phase_mesh_ep,
               "mesh_ssm": phase_mesh_family,
               "mesh_hybrid": phase_mesh_family,
               "mesh_long_500k": phase_mesh_long,
               "mesh_encdec": phase_mesh_family,
               "mesh_vlm": phase_mesh_family, "mesh_moe": phase_mesh_family,
               "mesh_pod": phase_mesh_family, "mesh_vit": phase_mesh_vit,
               "mesh_vit_dboth": phase_mesh_vit}
MESH_GROUPS = (("mesh_train", "mesh_serve", "mesh_ssm", "mesh_hybrid",
                "mesh_vlm", "mesh_ep", "mesh_ep_ragged", "mesh_long_500k",
                "mesh_encdec", "mesh_vit"),
               ("mesh_moe", "mesh_pod", "mesh_vit_dboth"))
MESH_PATHS = {p for group in MESH_GROUPS for p in group}


# the mesh paths whose parts the dry run traces as rank 0's program
# (``dryrun.trace_program`` on a fake process group, in the CPU process
# beside the card's phases), each held to what rank 0 counted on the card
# (``COUNTED``); the traces run the kernels' plain versions, the scan's
# associative form and the dense MoE dispatch (fake tensors hold no data
# for a stepped scan's loop or a ragged dispatch's group sizes): no
# collective depends on them
DRY_MESH_PATHS = ("mesh_train", "mesh_hybrid", "mesh_encdec", "mesh_moe",
                  "mesh_pod", "mesh_vit")
DRY_IMPLS = {"attn": "kernel", "ce": "kernel", "ssm": "assoc",
             "moe": "dense"}


def _meta_batch(host):
    """A host batch's abstract tensors, as ``sharding.place_batch``
    places them (token ids and labels int64)."""
    return {k: steps._meta(v.shape, torch.int64 if k in sharding.INDEX_KEYS
                           else torch.as_tensor(v).dtype)
            for k, v in host.items()}


def _dry_train(spec):
    """(fn, abstract whole arguments, in_specs) of a mesh path's first
    train step as its ranks run it (``_train_setup``'s step, or a vit
    path's early leg's, on the seed's state layout and the first
    batch)."""
    cfg, _ = _config(spec)
    mesh = _mesh(spec)
    if "legs" in spec:
        batch, init, step_fn, _ = _vit_leg_setup(
            cfg, _vit_leg(spec, "early"), "cpu", impls=DRY_IMPLS)
        params, frozen, _ = init("meta")
    else:
        run, batch, step_fn, _, _ = _train_setup(cfg, spec, "cpu",
                                                 impls=DRY_IMPLS)
        params, frozen, _ = split.init_mpsl_lm(
            torch.Generator().manual_seed(0), cfg, run, device="meta")
    state = {"params": params, "frozen": frozen, "opt": adamw_init(params),
             "step": 0, "rng": spec["seed"]}
    a_batch = _meta_batch(batch(0))
    return step_fn, (state, a_batch), (mpsl.state_shardings(state, mesh),
                                       sharding.batch_specs(a_batch, mesh))


def _dry_serve(spec):
    """(fn, abstract whole arguments, in_specs) of a mesh path's counted
    serving call as its ranks run it (``serve.generate``: the prefill and
    the decode steps, teacher-forced), on the TP-only serving layout."""
    cfg, _ = _config(spec)
    mesh = _mesh(spec)
    steps_ = spec["decode_steps"]
    prefill, decode = serve.build_serving_fns(
        cfg, torch.float32, "cpu", ssm_impl=DRY_IMPLS["ssm"],
        moe_impl=DRY_IMPLS["moe"], decode_slots=_decode_slots(spec))

    def fn(params, tokens, forced, stub):
        return serve.generate(prefill, decode, params, tokens, steps_,
                              forced_tokens=forced, **stub)

    def rows(t):
        return sharding.resolve_spec(mesh, t.shape,
                                     ("batch",) + (None,) * (t.dim() - 1))

    params = M.init_lm(cfg, torch.Generator().manual_seed(0), device="meta")
    b = spec["batch"]
    tokens = steps._meta((b, spec["prompt_len"]), torch.int64)
    forced = steps._meta((b, steps_), torch.int64)
    stub = {k: steps._meta(v.shape, v.dtype) for k, v in
            serve.stub_inputs(cfg, b, spec["seed"], "cpu").items()}
    return fn, (params, tokens, forced, stub), (
        steps._drop_fsdp(sharding.param_specs(params, mesh)), rows(tokens),
        rows(forced), {k: rows(v) for k, v in stub.items()})


def dryrun_mesh() -> list:
    """Rank 0's program of each part of ``DRY_MESH_PATHS`` traced by
    ``dryrun.trace_program`` at the path's cut size and mesh (no card
    touched): its first train step, its serving call where it serves, its
    attn_seq_shard leg where it has one. Each record: the collectives
    {"op/axis": {"calls", "bytes"}}, the flops, the live peak, the
    seconds."""
    out = []
    for path in DRY_MESH_PATHS:
        spec = PATHS[path]
        parts = [("train", _dry_train, spec)]
        if MESH_PHASES[path] is phase_mesh_family:
            parts.append(("serve", _dry_serve, spec))
        if spec.get("attn_seq_leg"):
            parts.append(("attn_seq_leg", _dry_train,
                          dict(spec, attn_seq_shard=True)))
        for part, build_fn, pspec in parts:
            fn, a_args, specs = build_fn(pspec)
            flops, peak, counts, secs = dryrun.trace_program(
                fn, a_args, _mesh(spec), specs)
            out.append({"path": path, "part": part, "mesh": spec["mesh"],
                        "collectives": counts, "flops": flops,
                        "temp_bytes": peak, "s": secs})
    return out


def dryrun_cells() -> list:
    """``dryrun.run_cell`` on the host mesh for each cell path, at its cut
    size: argument and temp bytes, flops (no card touched)."""
    out = []
    mesh = mesh_lib.make_host_mesh()
    for path, spec in PATHS.items():
        if not path.startswith("cell_"):
            continue
        cfg, _ = _config(spec)
        over = {}
        if "n_clients" in spec:
            over = dict(n_clients=spec["n_clients"],
                        trainable_blocks=spec["trainable_blocks"],
                        compress_uplink=True, compress_downlink=True,
                        microbatches=steps.choose_microbatches(
                            cfg, _cell_shape(spec), steps.n_data_shards(mesh),
                            spec["batch_per_client"]))
        rec = dryrun.run_cell(spec["arch"], spec["shape"][0], host_mesh=True,
                              cfg=cfg, shape=_cell_shape(spec),
                              overrides=dict(over, seed=spec["seed"]),
                              verbose=False)
        out.append(dict(rec, path=path))
    return out


def start_dryrun(out_path):
    """The dry run of the cells in a process of its own (CPU only), beside
    the card's phases."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[2]); "
            "import chip_smoke; "
            "json.dump({'cells': chip_smoke.dryrun_cells(), "
            "'mesh': chip_smoke.dryrun_mesh()}, open(sys.argv[1], 'w'))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code, out_path, ROOT],
                            env=env, cwd=ROOT)


def phase_dryrun(proc, out_path, peaks, timeout=900):
    """The dry run's predicted bytes beside each cell's measured peak
    (``torch.cuda.max_memory_allocated``; the ratio recorded, not held),
    and its program traces of the mesh paths' parts (``dryrun_mesh``)
    held exactly to what rank 0 counted on the card (``COUNTED``): every
    op and axis, calls and bytes."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc:
        raise AssertionError(f"the cells' dry run exited {rc}")
    with open(out_path) as f:
        dry = json.load(f)
    recs = dry["cells"]
    for r in dry["mesh"]:
        card = COUNTED.get((r["path"], r["part"]))
        emit({"phase": "dryrun", "trace": "mesh", **r,
              "card_rank0": card, "equal": card == r["collectives"]})
        if card != r["collectives"]:
            raise AssertionError(
                f"dry run {r['path']} {r['part']}: traced "
                f"{r['collectives']}, rank 0 on the card {card}")
    for r in recs:
        if r.get("status") != "ok":
            raise AssertionError(f"dry run {r['path']}: {r.get('status')}")
        mem = r["memory"]
        predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        peak = peaks.get(r["path"])
        emit({"phase": "dryrun", **r, "predicted_peak_bytes": predicted,
              "measured_peak_bytes": peak,
              "measured_over_predicted": (None if not peak
                                          else peak / predicted)})


def phase_examples(timeout=600):
    """The port's three examples on the card at their defaults, each in a
    process of its own, the three at once (each holds a few GB); each must
    exit 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    runs = []
    try:
        for name in ("quickstart", "train_lm_mpsl", "serve_batched"):
            out = open(os.path.join(tmp, name + ".log"), "w+")
            proc = subprocess.Popen([sys.executable, "-m",
                                     f"repro_torch.examples.{name}"],
                                    env=env, cwd=ROOT, stdout=out,
                                    stderr=subprocess.STDOUT, text=True)
            runs.append((name, proc, out, time.perf_counter()))
        deadline = time.perf_counter() + timeout
        for name, proc, out, t in runs:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            s = time.perf_counter() - t
            out.seek(0)
            text = out.read()
            emit({"phase": "examples", "example": name, "rc": rc, "s": s,
                  "tail": text.strip().splitlines()[-3:]})
            if rc:
                raise AssertionError(f"example {name} exited {rc}: "
                                     f"{text[-2000:]}")
    finally:
        for _, proc, out, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    dry_out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"),
                           "cells.json")
    dry = start_dryrun(dry_out)
    try:
        return _main(smi, dry, dry_out)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        shutil.rmtree(os.path.dirname(dry_out), ignore_errors=True)


def _main(smi, dry, dry_out) -> int:
    phase_build()
    kernels = phase_kernels()
    phase_moe_layer()
    counts, recs, peaks = {}, {}, {}
    for path, spec in PATHS.items():
        driven = None
        if path == "cell_train_4k":
            counts[path], driven = phase_cell_train(path, spec)
            peaks[path] = driven[-1]["peak_mem_bytes"]
            phase_train_profile(*driven)
        elif path.startswith("cell_") and "prefill" in path:
            counts[path], driven = phase_cell_prefill(path, spec)
            peaks[path] = driven[-1]["peak_mem_bytes"]
            phase_cell_profile(*driven)
        elif path in MESH_PATHS:
            continue
        elif path.startswith("cell_"):
            counts[path], driven = phase_cell_decode(path, spec)
            peaks[path] = driven[-1]["peak_mem_bytes"]
            phase_cell_decode_profile(*driven)
        elif "serve" in path:
            counts[path], driven = phase_serve(path, spec)
            phase_profile(*driven)
        elif path == "trainer":
            counts[path] = phase_trainer(path, spec, recs["train"][0])
        elif path == "trainer_resume":
            counts[path] = phase_trainer_resume(path, spec,
                                                *recs["encdec_train"])
        elif path == "vit_fedavg":
            counts[path], driven = phase_vit_fedavg(path, spec)
            phase_train_profile(*driven, per="round")
        elif path.startswith("vit"):
            counts[path], driven = phase_vit_train(path, spec)
            phase_train_profile(*driven)
        else:
            counts[path], driven = phase_train(path, spec)
            recs[path] = (driven[-1], phase_train_profile(*driven))
        del driven
        torch.cuda.empty_cache()
    for group in MESH_GROUPS:
        counts.update(phase_mesh_group(group))
        torch.cuda.empty_cache()
    for name, entry in kernels.items():
        entry["launches_by_path"] = {p: c[name] for p, c in counts.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if not entry["launches"]:
            raise AssertionError(f"{name} never launched on a main path")
    phase_examples()
    phase_dryrun(dry, dry_out, peaks)
    emit({"kernels": list(kernels.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
