"""MPSL training entry point.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \
      --full --trainable-blocks 4 --seq 512 --compress --steps 3 \
      --ckpt-dir /tmp/ckpt --obs-log /tmp/run.jsonl

The port of the JAX package's ``launch/train.py``: the same flags and
defaults, wired the same way (a step-indexed loader behind
``data.PrefetchLoader``, whose producer thread also places each batch on
the device, the ``train.Trainer`` loop with its checkpoints, auto-resume,
run log and fault plans), and ``--device`` (``cuda`` unless ``--device
cpu`` is given, which runs the kernels' plain versions; without a card it
raises rather than carry on on the CPU). The MPSL LM train step runs
with the kernels: flash attention in every attention block, the
selective scan forward and backward in every Mamba block (``--arch
falcon-mamba-7b``, ``--arch hymba-1.5b``), the fused LM-head
cross-entropy, and quant8 on both links under ``--compress``; MoE blocks
(``--arch qwen2-moe-a2.7b``) run the ragged dispatch and add the router's
load-balance loss. whisper (``--arch whisper-tiny``) and qwen2-vl
(``--arch qwen2-vl-72b``) train on seeded stub frame and patch embeddings
(their frontends are stubs in the configs); for qwen2-vl ``--seq`` counts
the patches too.

The step updates params and AdamW moments in place, which is the
reference's buffer donation. ``--no-donate`` gives the reference's
undonated semantics instead: each step first clones params and moments,
so the caller's old state stays valid and unchanged, at twice the param
and optimizer memory.

The last line of standard output is one JSON summary: ``final_loss``,
``steps_per_sec``, ``host_stall_frac``, ``skipped_steps`` and the losses
of the steps run (the last ``metrics_ring`` of them), read back after
the loop.

Several ranks (the SPMD program of ``parallel.collectives``):

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
      --steps 3 --seq 24

runs one process a rank on the host mesh (N, 1), as the JAX CLI puts its
clients on the host devices: each rank initializes the same whole state
from the seed and keeps its shards (``mpsl.place_state``), places its
clients of each batch (``sharding.place_batch(mesh=...)``), and the
step's collectives join them (NCCL where each rank has a card of its
own, gloo otherwise). Rank 0 alone writes the run log, the checkpoints
(gathered from every rank) and the summary; the losses are the global
L_S. A world already started by ``launch.spmd.spawn`` is used as it is,
on its mesh, a multi-pod (pod, data, model) mesh included: the clients
then lie on the client axis, (pod, data) flattened
(``collectives.client_axis``), and ``--n-clients`` must divide over it.
"""
from __future__ import annotations

import argparse
import functools
import json
import math

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro_torch.core import mpsl, split
from repro_torch.data import (ClientLoader, PrefetchLoader, SyntheticLM,
                              dirichlet_partition)
from repro_torch.launch import spmd
from repro_torch.launch.serve import resolve_device, stub_embeds
from repro_torch.optim import schedules
from repro_torch.parallel import collectives, sharding
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.trainer import to_host


def make_lm_loader(cfg, n_clients: int, bn: int, seq: int, seed: int = 0,
                   drop_prob: float = 0.0):
    """A step-indexed loader: ``.batch(step)`` -> numpy batch {tokens,
    labels [N, Bn, S] int32, mask [N]}, as the JAX package's
    ``LMWrapper``.

    The stub frontends' inputs join it after the loader's fault hook (so
    a NaN poison hits the mask, as it does in the JAX package), laid out
    as the JAX package's ``launch/steps.py: train_batch_specs`` lays them
    out and drawn from (seed, step) by ``serve.stub_embeds``: for audio
    frame_embeds [N, Bn, encoder_seq, D] beside S = seq text tokens; for
    vlm patch_embeds [N, Bn, frontend_tokens, D], with S = seq -
    frontend_tokens."""
    n_text = seq - cfg.frontend_tokens if cfg.family == "vlm" else seq
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=n_text, size=4096,
                     seed=seed)
    shards = dirichlet_partition(ds.labels, n_clients, alpha=0.1, seed=seed,
                                 min_per_client=bn)
    base = ClientLoader(ds, shards, bn, seed=seed, drop_prob=drop_prob)

    class LMWrapper:
        def batch(self, step):
            b = base.batch(step)
            rng = np.random.default_rng((seed, step, 0x57AB))
            return {"tokens": b["tokens"].astype(np.int32),
                    "labels": b["labels"].astype(np.int32),
                    "mask": b["mask"],
                    **stub_embeds(cfg, (n_clients, bn), rng)}

    return LMWrapper()


def to_device(batch, device):
    """A numpy batch as tensors on `device` (token ids as int64 indices),
    copied in the caller's stream (``sharding.place_batch`` is the
    pipelined placement)."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    for k in sharding.INDEX_KEYS:
        out[k] = out[k].long()
    return out


def build(args, device, guard_nonfinite: bool = False):
    """(cfg, run, state, step_fn, loader) of a training run: the step
    updates the state in place unless ``args.donate`` is false."""
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
    prog = collectives.active()
    ranks = collectives.size(collectives.client_axis())
    if prog is not None and args.n_clients % ranks:
        raise ValueError(f"{args.n_clients} clients do not split over "
                         f"{ranks} ranks of the client axis "
                         f"({collectives.client_axis()})")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run, device)
    # every rank draws the whole state; the program keeps its shards
    state = mpsl.place_state(mpsl.init_state(params, frozen, args.seed))
    loss_fn = mpsl.make_lm_loss(cfg, run, impls=mpsl.KERNEL_IMPLS)
    sched = schedules.warmup_cosine(args.lr, 10, args.steps)
    step_fn = mpsl.make_train_step(loss_fn, run, sched,
                                   guard_nonfinite=guard_nonfinite)
    if not args.donate:
        step_fn = mpsl.undonated(step_fn)
    loader = make_lm_loader(cfg, args.n_clients, args.batch_per_client,
                            args.seq, args.seed, args.drop_prob)
    return cfg, run, state, step_fn, loader


def parser():
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
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prefetch", type=int, default=2,
                   help="prefetch depth (0 = synchronous loader)")
    p.add_argument("--no-donate", dest="donate", action="store_false",
                   default=True,
                   help="the reference's undonated step: clone params and "
                        "AdamW moments before each step, so the old state "
                        "stays valid and unchanged (twice the param and "
                        "optimizer memory); by default the step updates "
                        "them in place, which is donation")
    p.add_argument("--obs-log", default=None,
                   help="write a JSONL telemetry run log to this path "
                        "(render with `python -m repro_torch.obs.report`)")
    p.add_argument("--obs-log-max-bytes", type=int, default=None,
                   help="rotate the run log to <path>.1 past this size "
                        "(bounds long chaos/soak runs to ~2x the cap)")
    p.add_argument("--fault-plan", default=None,
                   help="chaos mode: a FaultPlan JSON file or inline "
                        "spec, e.g. 'producer_crash@3,nan_batch@13,"
                        "straggler@11:1:0.2,ckpt_fail@20'. Activates "
                        "injection plus the recovery machinery "
                        "(non-finite step guard, producer/checkpoint "
                        "retries)")
    p.add_argument("--profile-dir", default=None,
                   help="opt-in torch.profiler trace window directory "
                        "(a Chrome trace of steps 5-7)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    with spmd.world(resolve_device(args.device)) as (prog, device):
        return _main(args, device, prog)


def _main(args, device, prog):
    writer = prog is None or prog.rank == 0     # the run log, the summary
    log = obs.get_logger("train")
    if args.obs_log and writer:
        obs.configure(args.obs_log,
                      meta={"driver": "train", "arch": args.arch,
                            "steps": args.steps,
                            "n_clients": args.n_clients,
                            "batch_per_client": args.batch_per_client,
                            "seq": args.seq, "compress": args.compress,
                            "prefetch": args.prefetch, "seed": args.seed,
                            "fault_plan": args.fault_plan,
                            "device": str(device)},
                      max_bytes=args.obs_log_max_bytes)

    fault_plan = (faults.FaultPlan.from_spec(args.fault_plan)
                  if args.fault_plan else None)
    if fault_plan is not None:
        faults.activate(fault_plan)
        log.info(f"fault plan active: {len(fault_plan.events)} events "
                 f"({', '.join(fault_plan.kinds_present())}), "
                 f"deadline {fault_plan.deadline_s}s",
                 n_events=len(fault_plan.events),
                 kinds=fault_plan.kinds_present())

    cfg, run, state, step_fn, inner = build(
        args, device, guard_nonfinite=fault_plan is not None)
    loader = PrefetchLoader(
        inner, depth=args.prefetch,
        place_fn=functools.partial(sharding.place_batch, device=device,
                                   mesh=None if prog is None else prog.mesh))
    trainer = Trainer(step_fn, state, loader,
                      TrainerConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every,
                                    ckpt_dir=args.ckpt_dir,
                                    profile_dir=args.profile_dir),
                      log_fn=print if writer else (lambda *_: None))
    start = int(trainer.state["step"])
    result = trainer.run()
    loader.close()
    # every step's metrics still in the ring, read after the loop
    ran = {step: to_host(m) for step, m in trainer.ring.entries_after(start)}
    losses = [float(m["loss"]) for m in ran.values()]
    log.info(f"done: final loss {result['final_loss']:.4f} "
             f"({result['steps_per_sec']:.2f} steps/s, "
             f"host stall {100 * result['host_stall_frac']:.0f}%)",
             final_loss=result["final_loss"],
             steps_per_sec=round(result["steps_per_sec"], 4),
             host_stall_frac=round(result["host_stall_frac"], 4))
    if fault_plan is not None:
        log.info(f"chaos: {len(trainer.skipped_steps)} step(s) skipped by "
                 f"the non-finite guard, "
                 f"{loader.retries} producer retr"
                 f"{'y' if loader.retries == 1 else 'ies'}",
                 skipped_steps=result["skipped_steps"],
                 producer_retries=loader.retries)
        faults.deactivate()
    if args.obs_log and writer:
        obs.shutdown()
        log.info(f"run log -> {args.obs_log} "
                 f"(python -m repro_torch.obs.report {args.obs_log})")
    summary = {"arch": cfg.name, "device": str(device), "steps": args.steps,
               "start_step": start, "n_clients": args.n_clients,
               "batch_per_client": args.batch_per_client, "seq": args.seq,
               "compress": args.compress,
               "final_loss": result["final_loss"],
               "steps_per_sec": result["steps_per_sec"],
               "host_stall_frac": result["host_stall_frac"],
               "skipped_steps": result["skipped_steps"], "losses": losses}
    if prog is not None:
        summary["mesh"] = prog.record()
    if writer:
        print(json.dumps(summary), flush=True)
    kept = [x for step, x in zip(ran, losses)
            if step - 1 not in result["skipped_steps"]]
    if not all(math.isfinite(x) for x in kept):
        log.error("non-finite loss")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
