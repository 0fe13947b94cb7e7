"""bf16 pieces of f32 operands: the tensor-core route of the f32 kernels.

The CE kernels (``csrc/softmax_xent.cu``) and the flash kernels' f32 route
(``csrc/flash_attention_fwd.cu``, ``_bwd.cu``) run every product on the
tensor cores from bf16 pieces: an f32 x is hi + lo (``split_bf16``), and a
product of two split operands is the sum of three bf16 products (hi.hi +
hi.lo + lo.hi; lo.lo dropped), each exact in f32 and accumulated in f32.
``product`` is that sum in plain PyTorch, for the kernels' plain models.
"""
from __future__ import annotations

import torch

# The pieces' error in a product, relative to sum |a_i| |b_i|: each split
# operand misses x by at most 2^-16 |x| (``split_bf16``), and the dropped
# lo.lo term is at most 2^-18 |a| |b|.
PRODUCT_ERROR = 2 * 2.0 ** -16 + 2.0 ** -18


def split_bf16(x):
    """(hi, lo): bf16 pieces with x ~ hi + lo, each rounded to nearest even
    (as ``__float2bfloat16_rn`` on the card), so |x - hi - lo| <= 2^-16 |x|
    for x in f32's normal range. A bf16 x is exact as it stands: (x, None).
    A |x| that rounds to bf16's inf (within 2^-9 of f32's largest value)
    gives hi = inf and lo = -inf, so every product it enters is NaN."""
    if x.dtype == torch.bfloat16:
        return x, None
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def n_pieces(dtype) -> int:
    """bf16 pieces of an operand of this dtype: 2 for f32, 1 for bf16."""
    return 2 if dtype == torch.float32 else 1


def n_products(pa: int, pb: int) -> int:
    """bf16 products of one product of operands in pa and pb pieces: two
    split operands give hi.hi + hi.lo + lo.hi (lo.lo dropped)."""
    return pa * pb - (pa == pb == 2)


def product(a, b, mul=torch.matmul):
    """mul(a, b) as the kernels form it: the sum of the bf16 pieces'
    products (lo . lo dropped), the small terms first, each exact in f32
    and summed in f32. `mul` is any bilinear product of two f32 tensors
    (``torch.matmul``, or an einsum)."""
    pa = [p for p in split_bf16(a) if p is not None]
    pb = [p for p in split_bf16(b) if p is not None]
    terms = sorted(((i, j) for i in range(len(pa)) for j in range(len(pb))
                    if i + j <= 1), key=lambda ij: -sum(ij))
    out = None
    for i, j in terms:
        t = mul(pa[i].float(), pb[j].float())
        out = t if out is None else out + t
    return out
