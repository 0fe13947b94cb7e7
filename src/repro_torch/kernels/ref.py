"""Plain-torch oracles for the kernels (the allclose ground truth).

Counterparts of the JAX package's ``kernels/ref.py``; each lands with
the slice that ports its kernel."""
from __future__ import annotations

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def flash_attention_ref(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                        k_valid=None):
    """q [B,Sq,H,hd], k/v [B,Sk,K,hd] (GQA), absolute-position masking.

    Plain materialized-scores attention in f32. A row with no valid key
    softmaxes its NEG_INF scores into a uniform average (the kernel gives
    0 there instead)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) \
        * (hd ** -0.5)
    ok = torch.ones((b, sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        ok &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    s = torch.where(ok[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def selective_scan_ref(x, dt, b_in, c_in, a_log, h0=None):
    """Sequential reference of the Mamba recurrence, f32.

    x, dt [B,S,di]; b_in, c_in [B,S,ds]; a_log [di,ds].
    Returns (y [B,S,di] in x's dtype, h_final [B,di,ds] f32)."""
    bsz, s, di = x.shape
    ds = b_in.shape[-1]
    a_neg = -torch.exp(a_log.float())
    h = torch.zeros((bsz, di, ds), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()
        a = torch.exp(dtt[..., None] * a_neg)
        h = a * h + (dtt * x[:, t].float())[..., None] \
            * b_in[:, t].float()[:, None, :]
        ys.append(torch.einsum("bns,bs->bn", h, c_in[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), h


def gold_logits(logits, labels):
    """logits [T, V] at each row's label [T]; 0 where the label lies outside
    [0, V) (a vocab shard that does not hold it)."""
    labels = labels.long()
    inside = (labels >= 0) & (labels < logits.shape[1])
    gold = logits.gather(1, torch.where(inside, labels, 0)[:, None])[:, 0]
    return torch.where(inside, gold, 0.0)


def softmax_xent_ref(h, w, labels):
    """Materialized-logits per-token CE (and LSE), f32.

    h [T, D], w [D, V], labels [T] -> (loss [T], lse [T]). A label outside
    [0, V) has no gold logit: its loss is the lse."""
    logits = h.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - gold_logits(logits, labels), lse


def quant_dequant_ref(x, bits: int = 8):
    """Deterministic symmetric per-row (last-axis) int quant-dequant (the
    scale through the reciprocal of qmax, as the jitted JAX oracle)."""
    qmax = 2.0 ** (bits - 1) - 1
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1, keepdim=True)
             * (1.0 / qmax)).clamp_min(1e-12)
    q = torch.round(x32 / scale).clamp(-qmax, qmax)
    return (q * scale).to(x.dtype)
