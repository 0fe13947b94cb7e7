"""Smashed-data / cut-layer-gradient compression of the MPSL links.

Counterpart of the JAX package's ``core/compression.py``: per-token
symmetric int8 on both links, through the quant8 kernel (its plain
version on the CPU), with stochastic rounding:

  * compress_activations — quant-dequant on the FORWARD value with a
    straight-through gradient (the server sees int8-precision smashed
    data);
  * compress_gradients   — identity on forward, quant-dequant applied to
    the COTANGENT (an int8 gradient downlink).

``rng`` is a ``torch.Generator`` (a seed drawn from it keys quant8's
Philox stream: the kernel draws it in registers, the plain version with
torch integer ops, to the same bits) or a tensor of uniforms of x's shape
(used as given, so a test can feed ``jax.random.uniform``'s draws).
``row0`` is the global index of x's first token row: a data rank of the
SPMD program passes its clients' offset, so that its draws are the ones
the whole stacked tensor's call gives those rows.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.obs import comm as obs_comm

# scale payload: one f32 per token row (per-row symmetric quantization)
SCALE_BYTES = 4


def _note_quant(x, bits: int = 8):
    # accounting hook: marks the matching compressed link(s) as actually
    # quantized in the executed step (vs merely configured); host-side
    obs_comm.note_quant(x.shape, bits=bits, impl="kernel")


def compress_activations(x, rng, row0: int = 0):
    _note_quant(x)
    return kops.quant_dequant(x, rng, row0=row0)      # straight-through


def compress_gradients(x, rng, row0: int = 0):
    return _CompressGradients.apply(x, rng, int(row0))


class _CompressGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rng, row0):
        ctx.rng, ctx.row0 = rng, row0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _note_quant(g)
        return kops.quant_dequant_value(g.contiguous(), ctx.rng,
                                        row0=ctx.row0), None, None


def compressed_bytes(shape, bits: int = 8) -> int:
    """Wire size of a compressed tensor: ceil(bits/8 * n) payload plus one
    f32 scale per token row."""
    n = math.prod(shape)
    tokens = n // shape[-1]
    return math.ceil(n * bits / 8) + tokens * SCALE_BYTES
