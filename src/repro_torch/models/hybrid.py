"""Hymba-style hybrid block: attention and Mamba heads run in PARALLEL over
the same normed input; each branch's output is RMS-normed, and the two
are averaged with the learnable per-branch beta scalars (Hymba Sec. 2).
Sliding-window attention on local layers, full attention on
``cfg.global_layers``.

Counterpart of the JAX package's ``models/hybrid.py``. The one difference:
the SSM branch takes the scan chunk from the caller (``impls["ssm_chunk"]``),
where the JAX package leaves it at the scan's default of 256; the chunk
sets only where the backward's checkpoints fall, not the result.

Under the SPMD program both branches run their own layouts
(``attention``: heads or dboth; ``mamba``: d_inner on `model`). Where
both are model-parallel, x enters the region once (one ``copy_to``, one
all-reduce of its gradient for the two branches); the SSM branch's
out_proj partial sums are reduced over `model` before ``ssm_norm``'s RMS
over D, and the attention branch's output is whole on every rank. The
norms and the betas are replicated and computed alike on every rank, so
their gradients are whole there and are not summed over `model`.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, layers, mamba
from repro_torch.parallel import collectives as C


def init_hybrid(generator, cfg, device=None):
    return {
        "attn": attention.init_attention(generator, cfg, device),
        "ssm": mamba.init_mamba(generator, cfg, device),
        "attn_norm": {"scale": torch.zeros((cfg.d_model,), device=device)},
        "ssm_norm": {"scale": torch.zeros((cfg.d_model,), device=device)},
        "beta_attn": torch.ones((), device=device),
        "beta_ssm": torch.ones((), device=device),
    }


def init_hybrid_cache(cfg, batch: int, cache_len: int, is_global: bool,
                      dtype=torch.bfloat16, device=None):
    """{"kv": the KV cache (the window's length on a local layer),
    "ssm": the SSM cache} of one layer."""
    win = cache_len if is_global else min(cfg.sliding_window, cache_len)
    return {"kv": attention.init_cache(cfg, batch, win, dtype, device),
            "ssm": mamba.init_mamba_cache(cfg, batch, dtype, device)}


def apply_hybrid(params, x, cfg, *, positions, is_global, cache=None,
                 impl="kernel", block=1024, ssm_impl="kernel", ssm_chunk=256,
                 ssm_bwd="fused", seq_shard=False):
    """x [B, S, D] -> (y, cache); a given cache {"kv", "ssm"} is updated
    in place. seq_shard: the attention branch's (``apply_attention``)."""
    window = 0 if is_global else cfg.sliding_window
    entered = (attention.model_layout(params["attn"]) != "replicated"
               and mamba.model_parallel(params["ssm"]))
    if entered:
        x = C.copy_to(x, "model")
    a_out, kv = attention.apply_attention(
        params["attn"], x, cfg, positions=positions, causal=True,
        window=window, cache=None if cache is None else cache["kv"],
        impl=impl, block=block, x_entered=entered, seq_shard=seq_shard)
    s_out, ssm = mamba.apply_mamba(
        params["ssm"], x, cfg, cache=None if cache is None else cache["ssm"],
        impl=ssm_impl, chunk=ssm_chunk, bwd_impl=ssm_bwd, x_entered=entered)
    a_out = layers.rms_norm(a_out, params["attn_norm"]["scale"])
    s_out = layers.rms_norm(s_out, params["ssm_norm"]["scale"])
    y = 0.5 * (a_out * params["beta_attn"].to(a_out.dtype)
               + s_out * params["beta_ssm"].to(s_out.dtype))
    return y, cache
