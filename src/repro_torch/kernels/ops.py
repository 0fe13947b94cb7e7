"""Public entry points of the kernels, by device, with their gradients.

Counterpart of the JAX package's ``kernels/ops.py``: one
``torch.autograd.Function`` in the place of each ``jax.custom_vjp``, with
the same residual sets. Flash attention and the LM-head cross-entropy run
kernels in BOTH directions (the backward rebuilds probabilities from the
forward's lse residual, so nothing [Sq, Sk]- or [T, V]-shaped is kept);
the selective scan's backward recomputes each chunk's states from the
forward's chunk-entry checkpoints (or, with ``bwd="recompute"``, runs
autograd through the sequential oracle); quant-dequant is
straight-through. A CPU tensor goes to each kernel's
plain PyTorch version; a CUDA tensor goes to the hand-written kernel, or
the call raises. Nothing falls back from one to the other.

The key-validity mask is resolved once at the entry (None -> all ones)
and carried in the residuals, so forward and backward see the same mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quant8 as _q8
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import softmax_xent as _sx
from repro_torch.parallel import collectives as _C


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


# ---------------------------------------------------------------------------
# flash attention


def flash_attention(q, k, v, q_pos, k_pos, causal=True, window=0,
                    k_valid=None):
    """q [B,Sq,H,hd], k/v [B,Sk,K,hd] -> [B,Sq,H,hd] (see `_fa`)."""
    kv = k_valid if k_valid is not None else torch.ones(
        k_pos.shape, dtype=torch.bool, device=k_pos.device)
    return _FlashAttention.apply(q, k, v, q_pos, k_pos, kv, bool(causal),
                                 int(window))


def flash_attention_partial(q, k, v, q_pos, k_pos, causal=True, window=0,
                            k_valid=None):
    """(o [B,Sq,H,hd], lse [B,H,Sq] f32) of attention over these keys alone,
    no gradient: a rank's partial over its shard of a sequence-sharded KV
    cache, which the caller merges by lse with the other ranks'. A row
    with no valid key gives o = 0 and lse = 0 (see `_fa`)."""
    kv = k_valid if k_valid is not None else torch.ones(
        k_pos.shape, dtype=torch.bool, device=k_pos.device)
    if _on_cpu(q):
        return _fa.flash_attention_plain(q, k, v, q_pos, k_pos, causal=causal,
                                         window=window, k_valid=kv)
    return _fa.flash_attention_fwd(
        *(t.contiguous() for t in (q, k, v, q_pos, k_pos)), causal=causal,
        window=window, k_valid=kv.contiguous(), return_lse=True)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, k_valid, causal, window):
        if _on_cpu(q):
            o, lse = _fa.flash_attention_plain(q, k, v, q_pos, k_pos,
                                               causal=causal, window=window,
                                               k_valid=k_valid)
        else:
            q, k, v, q_pos, k_pos, k_valid = (
                t.contiguous() for t in (q, k, v, q_pos, k_pos, k_valid))
            o, lse = _fa.flash_attention_fwd(q, k, v, q_pos, k_pos,
                                             causal=causal, window=window,
                                             k_valid=k_valid, return_lse=True)
        # residuals carry the RESOLVED mask: forward and backward agree
        ctx.save_for_backward(q, k, v, q_pos, k_pos, k_valid, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, k_valid, o, lse = ctx.saved_tensors
        fn = (_fa.flash_attention_bwd_plain if _on_cpu(q)
              else _fa.flash_attention_bwd)
        dq, dk, dv = fn(q, k, v, q_pos, k_pos, k_valid, o, lse,
                        do.contiguous(), causal=ctx.causal,
                        window=ctx.window)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------------------
# fused per-token softmax cross-entropy (LM head)


def softmax_xent_tokens(h, w, labels):
    """Per-token CE loss [T] (f32) from h [T,D], w [D,V], labels [T];
    logits are never materialized at [T, V] on the card."""
    return _SoftmaxXent.apply(h, w, labels.to(torch.int32))


class _SoftmaxXent(torch.autograd.Function):
    """h and w may differ in dtype (a bf16 hidden state against an f32
    trainable head): the kernels take each as it comes, every product from
    its bf16 pieces with f32 sums, as the TPU kernel upcasts both tiles;
    dh returns in h's dtype, dw in w's."""

    @staticmethod
    def forward(ctx, h, w, labels):
        if _on_cpu(h):
            loss, lse = _sx.softmax_xent_fwd_plain(h, w, labels)
        else:
            h, w, labels = h.contiguous(), w.contiguous(), labels.contiguous()
            loss, lse = _sx.softmax_xent_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        fn = (_sx.softmax_xent_bwd_plain if _on_cpu(h)
              else _sx.softmax_xent_bwd)
        return (*fn(h, w, labels, lse, g), None)


def softmax_xent_vocab_parallel(h, w, labels, axis: str = "model",
                                plain: bool = False):
    """The per-token CE [T] (f32) of h [T, D] against a head whose vocab
    lies on `axis` (the rule table puts lm_head's V on `model`): `w` is
    this rank's columns v0 .. v0 + V/m, and h and labels [T] are the same
    on every rank of the axis.

    Each rank runs the CE kernel (``plain``: the plain version, the
    logits [T, V/m] materialized) on its shard with labels - v0, which
    lie outside [0, V/m) where another rank holds the label. The global
    lse is the logsumexp of the ranks' lse (all-gathered), the gold logit
    the sum of the ranks' lse - loss (0 where the label is elsewhere).
    The backward hands the kernel the global lse, so its ds is the
    shard's columns of the global softmax; dh is all-reduced over the
    axis, dw stays local. No [T, V] tensor exists."""
    return _VocabParallelXent.apply(h, w, labels.to(torch.int32), axis,
                                    bool(plain))


class _VocabParallelXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, axis, plain):
        labels = labels - _C.index(axis) * w.shape[1]
        on_cpu = _on_cpu(h)
        if not on_cpu:
            h, w, labels = h.contiguous(), w.contiguous(), labels.contiguous()
        if plain or on_cpu:
            loss, lse = _sx.softmax_xent_fwd_plain(h, w, labels)
        else:
            loss, lse = _sx.softmax_xent_fwd(h, w, labels)
        lse_all = torch.logsumexp(_C.all_gather(lse[None], 0, axis), dim=0)
        gold = _C.all_reduce(lse - loss, axis)
        ctx.save_for_backward(h, w, labels, lse_all)
        ctx.axis, ctx.plain = axis, plain or on_cpu
        return lse_all - gold

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        fn = _sx.softmax_xent_bwd_plain if ctx.plain else _sx.softmax_xent_bwd
        dh, dw = fn(h, w, labels, lse, g)
        return _C.all_reduce(dh, ctx.axis), dw, None, None, None


# ---------------------------------------------------------------------------
# selective scan


def selective_scan(x, dt, b_in, c_in, a_log, h0=None, chunk=256,
                   bwd="fused"):
    """The Mamba-1 scan: (y [B,S,di], h_final [B,di,ds] f32) from x, dt
    [B,S,di], b_in, c_in [B,S,ds], a_log [di,ds] and an optional h0 (see
    `_ss`). a_log enters in f32 (a frozen bf16 one is upcast here, as the
    TPU kernel does in VMEM; autograd casts its gradient back).

    ``bwd``: "fused" runs the backward kernel (its plain version on the
    CPU), recomputing states from the chunk checkpoints; "recompute" is
    autograd through ``ref.selective_scan_ref`` (the JAX package's
    ``ssm_bwd="recompute"``). The gradient for h0 is None when h0 is."""
    if bwd not in ("fused", "recompute"):
        raise ValueError(f"unknown scan backward {bwd!r} (fused | recompute)")
    return _SelectiveScan.apply(x, dt, b_in, c_in, a_log.float(), h0,
                                int(chunk), bwd)


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, b_in, c_in, a_log, h0, chunk, bwd):
        if _on_cpu(x):
            y, h_final, h_ckpt = _ss.selective_scan_fwd_plain(
                x, dt, b_in, c_in, a_log, h0, chunk=chunk)
        else:
            x, dt, b_in, c_in, a_log = (
                t.contiguous() for t in (x, dt, b_in, c_in, a_log))
            if h0 is not None:
                h0 = h0.float().contiguous()
            chunk = _ss.kernel_chunk(chunk)    # checkpoints a piece apart
            y, h_final, h_ckpt = _ss.selective_scan_fwd(
                x, dt, b_in, c_in, a_log, h0, chunk=chunk)
        ctx.save_for_backward(x, dt, b_in, c_in, a_log, h0, h_ckpt)
        ctx.chunk, ctx.bwd = chunk, bwd
        return y, h_final

    @staticmethod
    def backward(ctx, gy, gh):
        x, dt, b_in, c_in, a_log, h0, h_ckpt = ctx.saved_tensors
        if ctx.bwd == "recompute":
            ins = [t.detach().requires_grad_() for t in
                   (x, dt, b_in, c_in, a_log)
                   + (() if h0 is None else (h0,))]
            with torch.enable_grad():
                y, h = _ref.selective_scan_ref(*ins)
                grads = torch.autograd.grad((y, h), ins, (gy, gh))
            return (*grads, *(() if h0 is not None else (None,)), None, None)
        gy, gh = gy.to(x.dtype).contiguous(), gh.float().contiguous()
        fn = (_ss.selective_scan_bwd_plain if _on_cpu(x)
              else _ss.selective_scan_bwd)
        dx, ddt, db, dc, da_log, dh0 = fn(x, dt, b_in, c_in, a_log, h_ckpt,
                                          gy, gh, chunk=ctx.chunk)
        return (dx, ddt, db.to(b_in.dtype), dc.to(c_in.dtype), da_log,
                None if h0 is None else dh0.to(h0.dtype), None, None)


# ---------------------------------------------------------------------------
# quant-dequant (straight-through)


def quant_dequant_value(x, rng=None, bits: int = 8, row0: int = 0):
    """The quant-dequant value of x (no gradient): the kernel on CUDA, the
    plain version on the CPU. ``rng``: None, uniforms or a Generator;
    ``row0``: the global index of x's first row (the Philox counter)."""
    if _on_cpu(x):
        return _q8.quant_dequant_plain(x, rng, bits, row0)
    return _q8.quant_dequant(x.contiguous(), rng, bits, row0)


def quant_dequant(x, rng=None, bits: int = 8, row0: int = 0):
    """Fused quant-dequant; the cotangent is straight-through (identity)."""
    return _QuantDequant.apply(x, rng, int(bits), int(row0))


class _QuantDequant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rng, bits, row0):
        return quant_dequant_value(x, rng, bits, row0)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None
