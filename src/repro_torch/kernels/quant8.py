"""Per-row int-k quant-dequant: the CUDA kernel's wrapper and its plain
version.

Replaces the TPU kernel ``repro/kernels/quant8.py: quant_dequant_fwd``
(Pallas bodies ``_kernel``, ``_kernel_sr_threaded``, ``_kernel_sr_tpu``)
with the hand-written Hopper kernel ``csrc/quant8.cu``; the source says
what bounds it on an H100 and what its design does about that.

Per row of the last axis of x (f32 or bf16):

  scale = max(max|x| * (1 / qmax), 1e-12),  qmax = 2^(bits-1) - 1
  q = clip(round(x / scale))            when no randomness is given
  q = clip(floor(x / scale + u))        stochastic rounding (unbiased)
  y = q * scale in x's dtype

The scale multiplies by the f32 reciprocal of qmax, as the JAX package
computes it wherever it runs under ``jit`` (XLA rewrites the division by
the constant qmax so); its eager ``compression._quant_dequant_jnp``
divides instead, which moves the scale of some rows by one ulp.

``rng`` picks the rounding: None rounds to nearest (half to even); a
tensor of uniforms u (x's shape, f32, in [0, 1)) is used as given, and
kernel and plain version then agree bitwise; a ``torch.Generator`` draws
the uniforms — in the kernel from a Philox stream keyed by a seed drawn
from the generator, in the plain version with ``torch.rand``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quant_dequant_plain(x, rng=None, bits: int = 8):
    """The kernel's function in plain PyTorch (``compression.
    _quant_dequant_jnp`` of the JAX package, and its Pallas kernel)."""
    qmax = 2.0 ** (bits - 1) - 1
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1, keepdim=True)
             * (1.0 / qmax)).clamp_min(1e-12)
    y = x32 / scale
    if rng is None:
        y = torch.round(y)
    else:
        if isinstance(rng, torch.Generator):
            rng = torch.rand(x.shape, generator=rng, dtype=torch.float32,
                             device=x.device)
        y = torch.floor(y + rng)
    return (y.clamp(-qmax, qmax) * scale).to(x.dtype)


@functools.cache
def _lib():
    lib = build.load("quant8")
    lib.quant_dequant.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                  + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
    lib.quant_dequant.restype = ctypes.c_int
    return lib


def quant_dequant(x, rng=None, bits: int = 8):
    """Launch the CUDA kernel on the current stream (no synchronisation).

    With a generator, its seed is drawn into device memory (on the
    generator's device, which must be x's), so nothing waits on the host."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("x must be contiguous and non-empty")
    lib = _lib()
    d = x.shape[-1]
    u = seed = None
    mode = 0
    if isinstance(rng, torch.Generator):
        mode = 2
        seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64,
                             device=x.device, generator=rng)
    elif rng is not None:
        mode = 1
        u = rng
        if (u.shape != x.shape or u.dtype != torch.float32
                or u.device != x.device or not u.is_contiguous()):
            raise ValueError("uniforms must be contiguous f32 of x's shape "
                             "on x's device")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.quant_dequant(
            _DTYPE_CODES[x.dtype], x.data_ptr(),
            None if u is None else u.data_ptr(),
            None if seed is None else seed.data_ptr(), y.data_ptr(),
            x.numel() // d, d, 2.0 ** (bits - 1) - 1, mode,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "quant_dequant")
    quant_dequant.launches += 1
    return y


quant_dequant.launches = 0
