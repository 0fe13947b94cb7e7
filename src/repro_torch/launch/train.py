"""MPSL training entry point.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \
      --full --trainable-blocks 4 --seq 512 --compress --steps 3

The port of the JAX package's ``launch/train.py``: the same flags and
defaults, and ``--device`` (``cuda`` unless ``--device cpu`` is given,
which runs the kernels' plain versions; without a card it raises rather
than carry on on the CPU). The MPSL LM train step runs with the
kernels: flash attention in every attention block, the selective scan
forward and backward in every Mamba block (``--arch falcon-mamba-7b``,
``--arch hymba-1.5b``), the fused LM-head cross-entropy, and quant8 on
both links under ``--compress``; MoE blocks (``--arch qwen2-moe-a2.7b``)
run the ragged dispatch and add the router's load-balance loss. A plain
loop steps it over the ported loader; the trainer, prefetching,
checkpoints, telemetry and fault plans come with a later slice.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import time

import numpy as np
import torch

from repro_torch.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro_torch.core import mpsl, split
from repro_torch.data import ClientLoader, SyntheticLM, dirichlet_partition
from repro_torch.launch.serve import resolve_device
from repro_torch.optim import schedules

log = logging.getLogger("repro_torch.train")


def make_lm_loader(cfg, n_clients: int, bn: int, seq: int, seed: int = 0,
                   drop_prob: float = 0.0):
    """step -> numpy batch {tokens, labels [N, Bn, seq] int32, mask [N]}."""
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, size=4096,
                     seed=seed)
    shards = dirichlet_partition(ds.labels, n_clients, alpha=0.1, seed=seed,
                                 min_per_client=bn)
    base = ClientLoader(ds, shards, bn, seed=seed, drop_prob=drop_prob)

    def batch(step):
        b = base.batch(step)
        return {"tokens": b["tokens"].astype(np.int32),
                "labels": b["labels"].astype(np.int32),
                "mask": b["mask"]}

    return batch


def to_device(batch, device):
    """A numpy batch as tensors on `device` (token ids as int64 indices)."""
    return {"tokens": torch.from_numpy(batch["tokens"]).long().to(device),
            "labels": torch.from_numpy(batch["labels"]).long().to(device),
            "mask": torch.from_numpy(batch["mask"]).to(device)}


def build(args, device):
    """(cfg, run, state, step_fn, loader) of a training run."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mp = MPSLConfig(n_clients=args.n_clients,
                    trainable_blocks=args.trainable_blocks,
                    compress_uplink=args.compress,
                    compress_downlink=args.compress)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype="float32", learning_rate=args.lr,
                    seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run, device)
    state = mpsl.init_state(params, frozen, args.seed)
    loss_fn = mpsl.make_lm_loss(cfg, run)
    sched = schedules.warmup_cosine(args.lr, 10, args.steps)
    step_fn = mpsl.make_train_step(loss_fn, run, sched)
    loader = make_lm_loader(cfg, args.n_clients, args.batch_per_client,
                            args.seq, args.seed, args.drop_prob)
    return cfg, run, state, step_fn, loader


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="minitron-4b")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false",
                   help="train the published widths and depth")
    p.add_argument("--n-clients", type=int, default=4)
    p.add_argument("--batch-per-client", type=int, default=2)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--trainable-blocks", type=int, default=-1)
    p.add_argument("--drop-prob", type=float, default=0.0)
    p.add_argument("--compress", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    device = resolve_device(args.device)
    cfg, run, state, step_fn, loader = build(args, device)
    losses, times = [], []
    for step in range(args.steps):
        batch = to_device(loader(step), device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])           # waits for the step
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log.info(f"step {step}: loss {loss:.4f} aux "
                 f"{float(metrics['aux']):.4f} grad_norm "
                 f"{float(metrics['grad_norm']):.4f} lr "
                 f"{float(metrics['lr']):.2e} ({times[-1] * 1e3:.1f} ms)")
    summary = {"arch": cfg.name, "device": str(device), "steps": args.steps,
               "n_clients": args.n_clients,
               "batch_per_client": args.batch_per_client, "seq": args.seq,
               "compress": args.compress, "losses": losses,
               "step_ms": [t * 1e3 for t in times]}
    print(json.dumps(summary), flush=True)
    if not all(math.isfinite(x) for x in losses):
        log.error("non-finite loss")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
