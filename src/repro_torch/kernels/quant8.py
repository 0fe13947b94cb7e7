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
tensor of uniforms u (x's shape, f32, in [0, 1)) is used as given; a
``torch.Generator`` gives one int64 seed (``torch.randint`` on it, into
the tensor's device memory: no host sync) and the uniforms come from the
Philox stream of that seed:

  element (r, c) of x viewed as [rows, d] takes word c mod 4 of
  Philox4x32-10 (Salmon et al., SC'11) at counter (g_lo, g_hi, 0, 0),
  g = (row0 + r) * ceil(d / 4) + floor(c / 4), under the key (seed_lo,
  seed_hi), the seed's two 32-bit words; u = (word >> 8) * 2^-24, in
  [0, 1).

``row0`` (0 by default) is the global index of x's first row: the rows
r0 .. r0 + n of a tensor, quantised alone with row0 = r0 under a
generator in the same state, take the bits that one call over the whole
tensor gives them (a data rank quantising its own clients' rows of the
stacked link activations).

One draw serves four neighbouring elements of a row and no draw straddles
two rows. The kernel draws it in registers; the plain version computes it
with torch integer ops (``philox_uniforms``). Kernel and plain version,
given the same uniforms or generators in the same state, give the same
bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF
# Philox4x32's round multipliers and Weyl key increments (Random123)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def mulhilo32(a, b):
    """(hi, lo) 32-bit words of the exact 64-bit product of 32-bit
    unsigned a and b (int64 tensors or ints holding values in [0, 2^32)).
    Formed from 16-bit halves, so no intermediate passes 2^34 and nothing
    relies on int64 wrapping."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    mid = a_hi * b_lo + a_lo * b_hi                 # < 2^33
    low = a_lo * b_lo + ((mid & 0xFFFF) << 16)      # < 2^33
    return a_hi * b_hi + (mid >> 16) + (low >> 32), low & _M32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1): four
    int64 tensors of 32-bit words (broadcast together)."""
    for _ in range(10):
        hi0, lo0 = mulhilo32(c0, _PHILOX_M[0])
        hi1, lo1 = mulhilo32(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def philox_uniforms(seed, rows: int, d: int, row0: int = 0):
    """The kernel's uniforms for x viewed as [rows, d] whose first row is
    row `row0` of the whole: f32 [rows, d] in [0, 1), on seed's device.
    ``seed``: an int64 tensor of one element in [0, 2^63) (as the wrapper
    draws it) or an int."""
    seed = torch.as_tensor(seed, dtype=torch.int64).reshape(())
    n4 = -(-d // 4)
    g = torch.arange(row0 * n4, (row0 + rows) * n4, dtype=torch.int64,
                     device=seed.device)
    zero = torch.zeros((), dtype=torch.int64, device=seed.device)
    words = philox4x32(g & _M32, g >> 32, zero, zero, seed & _M32,
                       seed >> 32)
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    w = w.reshape(rows, 4 * n4)[:, :d]
    return (w >> 8).to(torch.float32) * 2.0 ** -24


def _draw_seed(gen, device):
    """The one seed a call draws from its generator, in device memory."""
    return torch.randint(0, 2 ** 62, (1,), dtype=torch.int64, device=device,
                         generator=gen)


def quant_dequant_plain(x, rng=None, bits: int = 8, row0: int = 0):
    """The kernel's function in plain PyTorch (``compression.
    _quant_dequant_jnp`` of the JAX package, and its Pallas kernel);
    `row0` as the kernel's."""
    qmax = 2.0 ** (bits - 1) - 1
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1, keepdim=True)
             * (1.0 / qmax)).clamp_min(1e-12)
    y = x32 / scale
    if rng is None:
        y = torch.round(y)
    else:
        if isinstance(rng, torch.Generator):
            d = x.shape[-1]
            rng = philox_uniforms(_draw_seed(rng, x.device), x.numel() // d,
                                  d, row0).reshape(x.shape)
        y = torch.floor(y + rng)
    return (y.clamp(-qmax, qmax) * scale).to(x.dtype)


@functools.cache
def _lib():
    lib = build.load("quant8")
    lib.quant_dequant.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                  + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p])
    lib.quant_dequant.restype = ctypes.c_int
    return lib


# elements of a 16-byte access, by dtype
_VECTOR = {torch.float32: 4, torch.bfloat16: 8}


def vector_route(x, *others) -> bool:
    """Whether the kernel takes 16-byte accesses: x's rows a whole number
    of vectors (4 f32, 8 bf16), and x and the other tensors it reads or
    writes (u, y; None for none) 16-byte aligned. Otherwise it takes the
    scalar route, with the same arithmetic and the same stream."""
    return (x.shape[-1] % _VECTOR[x.dtype] == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, *others)
                    if t is not None))


def quant_dequant(x, rng=None, bits: int = 8, row0: int = 0):
    """Launch the CUDA kernel on the current stream (no synchronisation).

    With a generator, its seed is drawn into device memory (on the
    generator's device, which must be x's), so nothing waits on the host.
    `row0`: the global index of x's first row in the Philox counter."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("x must be contiguous and non-empty")
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    lib = _lib()
    d = x.shape[-1]
    u = seed = None
    mode = 0
    if isinstance(rng, torch.Generator):
        mode = 2
        seed = _draw_seed(rng, x.device)
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
            int(vector_route(x, u, y)), int(row0),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "quant_dequant")
    quant_dequant.launches += 1
    return y


quant_dequant.launches = 0
