"""Quickstart: fine-tune a Meta-Transformer-style unified encoder across 4
edge clients with MPSL on a synthetic (vision, text) classification task.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of the JAX package's ``examples/quickstart.py``. What happens
(paper Sec. 3):
  * each client owns a lightweight modality tokenizer (the ONLY thing it
    trains);
  * clients tokenize locally, smashed data goes to the server;
  * the server encodes the concatenated global batch ONCE and takes ONE
    backward pass of the aggregated loss L_S = sum w_n L_n;
  * labels never leave the clients; client heads never sync during
    training, and are FedAvg-ed into one model after it (Sec. 3.3).
Reduced VIT_TINY, 4 clients on Dirichlet(0.1) shards, 30 steps; the run's
impls are RunConfig's defaults, as in the JAX example.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import MPSLConfig, RunConfig, SHAPES, reduced
from repro_torch.configs.meta_transformer import VIT_TINY
from repro_torch.core import aggregation, baselines, mpsl, split
from repro_torch.data import ClientLoader, SyntheticMultimodal, dirichlet_partition
from repro_torch.launch.serve import resolve_device
from repro_torch.optim import schedules

N_CLIENTS, BN, N_CLASSES, STEPS = 4, 4, 4, 30
MODALITIES = ("vision", "text")


def setup():
    """(cfg, run, loader, dataset) of the example."""
    cfg = reduced(VIT_TINY)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                    mpsl=MPSLConfig(n_clients=N_CLIENTS, trainable_blocks=2,
                                    fusion="early"),
                    compute_dtype="float32", learning_rate=1e-3)
    # Dirichlet(0.1) non-IID shards, exactly like the paper
    ds = SyntheticMultimodal(modalities=MODALITIES, n_classes=N_CLASSES,
                             size=512, noise=0.35)
    shards = dirichlet_partition(ds.labels, N_CLIENTS, alpha=0.1,
                                 min_per_client=BN)
    return cfg, run, ClientLoader(ds, shards, BN), ds


def to_device(b, device) -> dict:
    return {"vision": torch.from_numpy(b["vision"]).to(device),
            "text": torch.from_numpy(b["text"].astype(np.int64)).to(device),
            "labels": torch.from_numpy(b["labels"].astype(np.int64)).to(device),
            "mask": torch.from_numpy(b["mask"]).to(device)}


def train(cfg, run, loader, params, frozen, steps, device, log=print):
    """MPSL steps from (params, frozen); returns (state, losses)."""
    loss_fn = mpsl.make_vit_loss(cfg, run, modalities=MODALITIES,
                                 n_classes=N_CLASSES)
    step = mpsl.make_train_step(loss_fn, run, schedules.constant(1e-3))
    state = mpsl.init_state(params, frozen)
    losses = []
    for i in range(steps):
        state, metrics = step(state, to_device(loader.batch(i), device))
        losses.append(float(metrics["loss"]))
        if (i + 1) % 10 == 0 or i == 0:
            per = [round(float(x), 3) for x in metrics["per_client"]]
            log(f"step {i + 1:3d}  L_S={losses[-1]:.4f}  per-client={per}")
    return state, losses


@torch.no_grad()
def assembled_accuracy(cfg, state, plan, ds, device) -> float:
    """Post-training construction (paper Sec. 3.3): FedAvg the client
    heads into one model with the server's body and task head, and score
    it on 64 samples."""
    full = split.assemble_full_params(state["params"], state["frozen"], plan)
    full["tokenizers"] = aggregation.fedavg_heads(
        state["params"]["client"]["tokenizers"])
    full["task_head"] = state["params"]["server"]["task_head"]
    b = ds.sample(np.arange(64))
    x = {"vision": torch.from_numpy(b["vision"]).to(device),
         "text": torch.from_numpy(b["text"].astype(np.int64)).to(device)}
    logits = baselines.full_vit_logits(full, x, cfg, modalities=MODALITIES)
    labels = torch.from_numpy(b["labels"].astype(np.int64)).to(device)
    return float((logits.argmax(-1) == labels).float().mean())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg, run, loader, ds = setup()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, frozen, plan = split.init_mpsl_vit(
        gen, cfg, run, modalities=MODALITIES, n_classes=N_CLASSES,
        device=device)
    n_client = sum(x.numel() for x in
                   tree.leaves(params["client"])) // N_CLIENTS
    n_server = sum(x.numel() for x in tree.leaves(params["server"]))
    print(f"client-side params: {n_client / 1e3:.0f}k per client "
          f"(server trains {n_server / 1e6:.2f}M)")
    state, losses = train(cfg, run, loader, params, frozen, args.steps,
                          device)
    acc = assembled_accuracy(cfg, state, plan, ds, device)
    print(f"assembled [F_C_agg ; F_S] accuracy: {acc:.2f} "
          f"(chance {1 / N_CLASSES:.2f})")
    return 0 if all(np.isfinite(losses)) else 1


if __name__ == "__main__":
    raise SystemExit(main())
