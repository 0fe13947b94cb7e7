"""Mamba-1 (selective SSM) block: the falcon-mamba block and Hymba's SSM
branch.

Counterpart of the JAX package's ``models/mamba.py``. The prefill and
train path runs the selective scan over the whole sequence, by one of
two implementations:

  * kernel — ``kernels.ops.selective_scan``: the hand-written CUDA scan,
             forward and backward, on a CUDA tensor; its plain version on
             a CPU tensor (the JAX package's ``pallas``).
  * plain  — ``chunked_selective_scan`` under autograd: the JAX package's
             ``jnp`` path, the oracle.

Decode is the O(1)-per-token recurrence on the cached state
(``selective_scan_step``), outside any kernel, as in the JAX package.
The cache ``{"h": [B, di, ds] f32, "conv": [B, d_conv - 1, di]}`` is
updated IN PLACE, as the port's KV cache is.

Numerics kept from the JAX package:
  * softplus: ``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus``
    returns x itself above 20, where log1p(exp(-x)) < 2e-9 is below half
    an f32 ulp of x, so the two agree in f32;
  * dt is softplus'd in f32 and then cast to the compute dtype;
  * the causal depthwise conv is the sum of d_conv shifted products, in
    the JAX package's order, not ``F.conv1d`` (cuDNN would run it in TF32
    unless ``cudnn.allow_tf32`` were off);
  * the conv cache is in the compute dtype, the state h always f32.

Under the SPMD program (``parallel.collectives``) d_inner lies on
`model`, as the rule table lays it: in_proj [D, 2 di] is column-parallel,
cut section by section (``sharding.Paired``: rank r holds x's and z's
channel slice r, so the block's split of xz is local); the conv, conv_b,
dt_bias, D, A_log and the scan run on the rank's di/m channels, the scan
kernels at that width; x_proj [di, dtr + 2 ds] is row-parallel, its
partial sums leaving by one all-reduce, and dt_in, B and C re-enter the
channel-parallel region by ``copy_to`` (each rank's dt_proj columns and
scan give their gradients for its own channels only, summed over
`model` in the backward); dt_proj is column-parallel; out_proj [di, D] is
row-parallel and leaves by one all-reduce. The decode caches hold the
rank's channels of h and conv. Each weight's fsdp dim is gathered at use.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.parallel import collectives as C


def init_mamba(generator, cfg, device=None):
    """S4D-real A_log, D ones, dt_bias = softplus^-1 of dt drawn
    log-uniformly in [1e-3, 1e-1], conv_b zeros; f32."""
    d, di, dtr = cfg.d_model, cfg.d_inner, cfg.dt_rank
    ds, dc = cfg.ssm.d_state, cfg.ssm.d_conv
    dt_std = dtr ** -0.5

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return lo + (hi - lo) * u

    dt = torch.exp(uniform((di,), math.log(1e-3), math.log(1e-1)))
    a_init = torch.arange(1, ds + 1, dtype=torch.float32,
                          device=device)[None, :].expand(di, ds)
    return {
        "in_proj": layers.dense_init(generator, (d, 2 * di), device=device),
        "conv_w": layers.dense_init(generator, (dc, di), in_axis_size=dc,
                                    device=device),
        "conv_b": torch.zeros((di,), device=device),
        "x_proj": layers.dense_init(generator, (di, dtr + 2 * ds),
                                    device=device),
        "dt_proj": uniform((dtr, di), -dt_std, dt_std),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(a_init),
        "D": torch.ones((di,), device=device),
        "out_proj": layers.dense_init(generator, (di, d), in_axis_size=di,
                                      device=device),
    }


# ---------------------------------------------------------------------------
# The plain scan (the JAX package's jnp path)


def chunked_selective_scan(x, dt, b_in, c_in, a_log, h0=None, chunk=256):
    """y_t = C_t . h_t,  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, in f32.

    x, dt [B, S, di]; b_in, c_in [B, S, ds]; a_log [di, ds]. Returns
    (y [B, S, di] in x's dtype, h_final [B, di, ds] f32). As in the JAX
    package, the sequence is padded to whole chunks and the discretized
    a and dt*B*x are materialized one chunk at a time; within a chunk the
    recurrence is stepped (the JAX package combines it with an associative
    scan: the same sums, in another order). Differentiable by autograd."""
    bsz, s, di = x.shape
    ds = b_in.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x, dt, b_in, c_in = (F.pad(t, (0, 0, 0, pad))
                             for t in (x, dt, b_in, c_in))
    a_neg = -torch.exp(a_log.float())
    h = (torch.zeros((bsz, di, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xc, dtc, bc, cc = (t[:, sl].float() for t in (x, dt, b_in, c_in))
        a = torch.exp(dtc[..., None] * a_neg)               # [B, c, di, ds]
        bx = (dtc * xc)[..., None] * bc[:, :, None, :]      # [B, c, di, ds]
        for i in range(chunk):
            h = a[:, i] * h + bx[:, i]
            ys.append(torch.einsum("bns,bs->bn", h, cc[:, i]))
    y = torch.stack(ys, dim=1)[:, :s]
    return y.to(x.dtype), h


def assoc_selective_scan(x, dt, b_in, c_in, a_log, h0=None, chunk=256):
    """``chunked_selective_scan``'s function in the JAX package's own
    form: within each chunk the recurrence is combined by a log-depth
    associative scan ((a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), doubling
    the reach each level) instead of stepped, so a chunk is ~6 log2(chunk)
    ops rather than ~3 a step. The dry run traces it: a stepped trace of a
    32k-token prefill over 64 layers is millions of fake-tensor ops. Each
    level keeps its [B, chunk, di, ds] operands for the backward, so the
    plain path keeps the stepped form."""
    bsz, s, di = x.shape
    ds = b_in.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x, dt, b_in, c_in = (F.pad(t, (0, 0, 0, pad))
                             for t in (x, dt, b_in, c_in))
    a_neg = -torch.exp(a_log.float())
    h = (torch.zeros((bsz, di, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xc, dtc, bc, cc = (t[:, sl].float() for t in (x, dt, b_in, c_in))
        a = torch.exp(dtc[..., None] * a_neg)               # [B, c, di, ds]
        b = (dtc * xc)[..., None] * bc[:, :, None, :]       # [B, c, di, ds]
        reach = 1
        while reach < chunk:
            a_prev = F.pad(a[:, :-reach], (0, 0, 0, 0, reach, 0), value=1.0)
            b_prev = F.pad(b[:, :-reach], (0, 0, 0, 0, reach, 0))
            a, b = a * a_prev, a * b_prev + b
            reach *= 2
        h_all = a * h[:, None] + b
        ys.append(torch.einsum("bcns,bcs->bcn", h_all, cc))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), h


def selective_scan_step(x, dt, b_in, c_in, a_log, h):
    """One decode step. x, dt [B, di]; b_in, c_in [B, ds]; h [B, di, ds].
    Returns (y [B, di] in x's dtype, h_new f32)."""
    x32, dt32 = x.float(), dt.float()
    a = torch.exp(dt32[..., None] * -torch.exp(a_log.float()))
    bx = (dt32 * x32)[..., None] * b_in.float()[:, None, :]
    h_new = a * h.float() + bx
    y = torch.einsum("bns,bs->bn", h_new, c_in.float())
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# Cache


def init_mamba_cache(cfg, batch: int, dtype=torch.bfloat16, device=None):
    """The SSM cache of one layer: the state h (f32) and the last
    d_conv - 1 conv inputs (compute dtype). Under the SPMD program, this
    rank's batch rows and channels (``sharding.cache_dims``), marked with
    that spec."""
    di = C.local(cfg.d_inner, "model")
    cache = {
        "h": torch.zeros((batch, di, cfg.ssm.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di),
                            dtype=dtype, device=device),
    }
    if C.active() is not None:
        rows = C.client_entry()
        ch = "model" if di != cfg.d_inner else None
        C.set_spec(cache["h"], (rows, ch, None))
        C.set_spec(cache["conv"], (rows, None, ch))
    return cache


def model_parallel(params) -> bool:
    """Whether the block's d_inner lies on `model` (raises where in_proj
    and the channel leaves are laid out apart)."""
    tp = C.model_parallel(params["x_proj"])
    if tp != C.model_parallel(params["in_proj"]):
        raise NotImplementedError(
            "a Mamba block whose in_proj and channel leaves lie apart on "
            "the model axis (a d_inner that does not divide it): ROADMAP.md "
            "Queue 1 item 7")
    return tp


# ---------------------------------------------------------------------------
# Block application


def _causal_depthwise_conv(x, w, b):
    """x [B, S, di], w [dc, di]: depthwise causal conv along S, as the sum
    of dc shifted products (the JAX package's order)."""
    dc = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    out = 0
    for i in range(dc):
        out = out + xp[:, i:i + s, :] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def apply_mamba(params, x, cfg, cache=None, impl="kernel", chunk=256,
                bwd_impl="fused", x_entered=False):
    """x [B, S, D] -> (y [B, S, D], cache). A given cache is updated in
    place and returned.

    impl: "kernel" | "plain" | "assoc" (the scan of the prefill / train
    path; ``assoc_selective_scan`` is the dry run's);
    bwd_impl: the kernel path's backward, "fused" | "recompute";
    x_entered: x has entered the model-parallel region already (the
    hybrid block's shared ``copy_to``)."""
    ds = cfg.ssm.d_state
    di = params["D"].shape[0]                 # this rank's channels
    dtr = params["dt_proj"].shape[0]
    dtype = x.dtype
    tp = model_parallel(params)
    if tp and not x_entered:
        x = C.copy_to(x, "model")

    xz = x @ C.gather_param(params["in_proj"]).to(dtype)
    xin, z = xz[..., :di], xz[..., di:]

    if cache is None:
        xc = _causal_depthwise_conv(xin, params["conv_w"], params["conv_b"])
        new_conv = None
    else:
        hist = cache["conv"].to(dtype)                     # [B, dc-1, di]
        full = torch.cat([hist, xin], dim=1)
        xc = _causal_depthwise_conv(full, params["conv_w"],
                                    params["conv_b"])[:, hist.shape[1]:]
        new_conv = full[:, -(cfg.ssm.d_conv - 1):]

    xc = F.silu(xc)

    proj = xc @ C.gather_param(params["x_proj"]).to(dtype)
    if tp:
        proj = C.copy_to(C.reduce_from(proj, "model"), "model")
    dt_in, b_in, c_in = (proj[..., :dtr], proj[..., dtr:dtr + ds],
                         proj[..., dtr + ds:])
    dt = dt_in @ C.gather_param(params["dt_proj"]).to(dtype)
    dt = F.softplus(dt.float() + params["dt_bias"]).to(dtype)

    if cache is None or xc.shape[1] > 1:
        # train / prefill: the scan over the sequence, seeded with the
        # cached state when there is one
        h0 = cache["h"] if cache is not None else None
        if impl == "kernel":
            y, h_new = kops.selective_scan(
                xc.contiguous(), dt.contiguous(), b_in.contiguous(),
                c_in.contiguous(), params["A_log"], h0=h0, chunk=chunk,
                bwd=bwd_impl)
        elif impl == "plain":
            y, h_new = chunked_selective_scan(xc, dt, b_in, c_in,
                                              params["A_log"], h0=h0,
                                              chunk=chunk)
        elif impl == "assoc":
            y, h_new = assoc_selective_scan(xc, dt, b_in, c_in,
                                            params["A_log"], h0=h0,
                                            chunk=chunk)
        else:
            raise ValueError(f"unknown ssm impl {impl!r} "
                             f"(kernel | plain | assoc)")
    else:
        y1, h_new = selective_scan_step(xc[:, 0], dt[:, 0], b_in[:, 0],
                                        c_in[:, 0], params["A_log"],
                                        cache["h"])
        y = y1[:, None]
    if cache is not None:
        cache["h"].copy_(h_new)
        cache["conv"].copy_(new_conv)

    y = y + xc * params["D"].to(dtype)
    y = y * F.silu(z)
    y = y @ C.gather_param(params["out_proj"]).to(dtype)
    return (C.reduce_from(y, "model") if tp else y), cache
