"""Meshes: named device axes, and the card's published figures.

Counterpart of the JAX package's ``launch/mesh.py``. A ``Mesh`` is a
record of axis names and sizes; the sharding rules
(``parallel.sharding``) resolve against it and the dry run
(``launch.dryrun``) counts per-device bytes and flops by it. No device
is touched by making one.

  make_production_mesh()               16 x 16 (data, model): 256 devices
  make_production_mesh(multi_pod=True) 2 x 16 x 16 (pod, data, model)
  make_host_mesh()                     (world, 1) under a process group
                                       (the ranks of ``torchrun`` or
                                       ``launch.spmd``), else (1, 1)

The production meshes are the JAX dry run's; they serve the parity of
its records (their per-device counts). A mesh whose size is the world's
is run by ``init_device_mesh`` (the SPMD program of
``parallel.collectives``): rank r sits at ``coords(r)``, row-major over
the axes, as ``jax.sharding.Mesh`` lays out its device array. On a
(pod, data, model) mesh the program adds the flattened (pod, data) axis
the clients and the batch lie on (``collectives.client_axis``);
``launch.spmd.spawn`` starts a world on any such mesh, ``torchrun`` on
the host mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch.distributed as dist


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

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank `rank`'s coordinate on each axis, row-major (the last axis
        fastest)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on a {self.name} mesh")
        out = {}
        for a, n in zip(reversed(self.axis_names), reversed(self.axis_sizes)):
            out[a] = rank % n
            rank //= n
        return {a: out[a] for a in self.axis_names}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """The ranks as a (data, model) mesh with model = 1: the world of the
    initialized process group (the JAX package's ``len(jax.devices())``:
    one rank a device), or (1, 1) without one."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh(("data", "model"), (n, 1))


def init_device_mesh(mesh: Mesh, device="cuda"):
    """The SPMD program of this rank on `mesh` (``parallel.collectives.
    Program``): a ``torch.distributed.device_mesh.DeviceMesh`` over the
    initialized process group, its dims named by ``mesh.axis_names``,
    one process group an axis. Activate it with ``collectives.program``."""
    from repro_torch.parallel import collectives
    return collectives.start(mesh, device)


# NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, the card's nvidia-smi
# name and power limit: the published data-sheet figures, dense (no
# sparsity), per device / per NVLink direction.
DEVICE = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, CUDA cores
HBM_BW = 3.35e12                  # B/s, HBM3
NVLINK_BW = 450e9                 # B/s a direction
HBM_BYTES = 80e9                  # device memory (80 GB)
