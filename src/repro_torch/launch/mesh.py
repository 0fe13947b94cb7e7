"""Meshes: named device axes, and the card's published figures.

Counterpart of the JAX package's ``launch/mesh.py``. A ``Mesh`` is a
record of axis names and sizes; the sharding rules
(``parallel.sharding``) resolve against it and the dry run
(``launch.dryrun``) counts per-device bytes and flops by it. No device
is touched by making one.

  make_production_mesh()               16 x 16 (data, model): 256 devices
  make_production_mesh(multi_pod=True) 2 x 16 x 16 (pod, data, model)
  make_host_mesh()                     (the CUDA device count, 1), or
                                       (1, 1) without a card

The production meshes are the JAX dry run's; they serve the parity of
its records (their per-device counts), not a layout any code here runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """The local devices as a (data, model) mesh with model = 1: the CUDA
    device count, or one device where there is no card."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return Mesh(("data", "model"), (max(1, n), 1))


# NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, the card's nvidia-smi
# name and power limit: the published data-sheet figures, dense (no
# sparsity), per device / per NVLink direction.
DEVICE = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, CUDA cores
HBM_BW = 3.35e12                  # B/s, HBM3
NVLINK_BW = 450e9                 # B/s a direction
HBM_BYTES = 80e9                  # device memory (80 GB)
