"""Learning-rate schedules: step -> lr, a 0-d f32 CPU tensor, computed in
f32 as the JAX package's ``optim/schedules.py`` does."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def sched(step):
        step = torch.tensor(float(step), dtype=torch.float32)
        warm = base_lr * step / max(1.0, warmup_steps)
        t = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        t = t.clamp(0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def constant(base_lr: float):
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)
