"""Shared low-level layers: norms, activations, RoPE, init helpers."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Init helpers


def dense_init(generator, shape, in_axis_size=None, device=None):
    """Truncated-normal fan-in init: N(0, 1/fan_in) cut at +-2 sigma, f32.

    Draws from `generator` (on `device`); it cannot reproduce
    ``jax.random``, so parity tests share params through the bridge."""
    if in_axis_size is None:
        in_axis_size = shape[0]
    std = 1.0 / math.sqrt(max(1, in_axis_size))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


# ---------------------------------------------------------------------------
# Embedding lookup


def embed_lookup(table, ids):
    """table[ids] (ids [B, ...] int; [B, ..., D] in the table's dtype).

    Under the SPMD program (``parallel.collectives``) the table [V, D] is
    a shard laid out (fsdp, model) by the rule table: rows on `data`,
    columns on `model`, while the ids (batch on `data`) differ from one
    data rank to the next. The ids are all-gathered over `data`; each rank
    looks them up in its own rows, zeros elsewhere; a reduce-scatter over
    `data` on the batch dim gives each rank its own ids' rows (a sum in
    which one rank holds each row: exact, the one-rank lookup's bits); an
    all-gather over `model` joins the columns. The ids move, not the
    table, which takes no gradient here (frozen in MPSL, and in
    serving)."""
    from repro_torch.parallel import collectives as C
    spec = C.spec_of(table)
    if spec is None or C.active() is None:
        return table[ids]
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("a trainable embedding under the SPMD "
                                  "program (ROADMAP.md Queue 1 item 7)")
    rows, cols = spec
    if rows is not None and rows != "data" or cols not in (None, "model"):
        raise NotImplementedError(
            f"an embedding laid out {spec} (ROADMAP.md Queue 1 item 7)")
    if rows == "data":
        n = table.shape[0]
        ids = C.all_gather(ids, 0, "data")
        local = ids - C.index("data") * n
        hit = (local >= 0) & (local < n)
        e = table[torch.where(hit, local, 0)]
        e = torch.where(hit[..., None], e, torch.zeros((), dtype=e.dtype,
                                                        device=e.device))
        e = C.reduce_scatter(e, 0, "data")
    else:
        e = table[ids]
    if cols == "model":
        e = C.all_gather(e, e.dim() - 1, "model")
    return e


def learned_positions(table, n=None):
    """The first `n` rows (every row by default) of a learned position
    table [S, D], whole. Under the SPMD program the rule table lays its D
    on `model` ((None, "model")): the ranks' columns are all-gathered
    (``collectives.gather_to``: a rank's gradient of the whole is its
    columns')."""
    from repro_torch.parallel import collectives as C
    rows = table if n is None else table[:n]
    if C.model_parallel(table):
        rows = C.gather_to(rows, rows.dim() - 1, "model")
    return rows


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back to input dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """scale is stored as the deviation from 1 (zeros init => identity)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(dtype)


def apply_norm(x, params, kind: str, eps: float = 1e-6):
    # eps=1e-6 reaches layer_norm too (not its own 1e-5 default), as in
    # the JAX package.
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"], eps)
    if kind == "layernorm":
        return layer_norm(x, params["scale"], params["bias"], eps)
    raise ValueError(f"unknown norm {kind!r}")


def init_norm(kind: str, d: int, device=None):
    if kind == "rmsnorm":
        # stored as (scale - 1) so a zeros-init is identity-ish; see rms_norm
        return {"scale": torch.zeros((d,), device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    raise ValueError(f"unknown norm {kind!r}")


# ---------------------------------------------------------------------------
# Activations


def sq_relu(x):
    r = torch.relu(x)
    return r * r


def gelu(x):
    """jax.nn.gelu's default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": gelu,
    "sq_relu": sq_relu,
    "relu": torch.relu,
}


def act_fn(name: str):
    return ACTIVATIONS[name]


def gated_activation(name: str) -> bool:
    """silu family uses a gated (SwiGLU) MLP; gelu / sq_relu are plain."""
    return name == "silu"


# ---------------------------------------------------------------------------
# Rotary position embeddings


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions [..., S] (int) -> cos, sin [..., S, head_dim/2] (f32)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def mrope_cos_sin(positions3, head_dim: int, theta: float, sections):
    """M-RoPE (Qwen2-VL): positions3 [B, 3, S] (t, h, w grids).

    The head_dim/2 rotary frequencies are split into `sections`
    (sum(sections) == head_dim/2); section i takes its angle from
    positions3[:, i]. Returns cos/sin [B, S, head_dim/2]. Where the three
    rows agree it is ``rope_cos_sin`` of that row."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim/2 = {half}")
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions3.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions3.float()[..., None] * freqs            # [B, 3, S, half]
    bounds = [0]
    for sec in sections:
        bounds.append(bounds[-1] + sec)
    angles = torch.cat([ang[:, i, :, lo:hi] for i, (lo, hi)
                        in enumerate(zip(bounds, bounds[1:]))], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x [..., S, H, hd]; cos/sin [..., S, hd/2] broadcast over heads.

    Rotates the two halves of the head dim (not interleaved pairs); cos
    and sin are cast to x's dtype before the rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def positions_from_shape(batch, seq, offset=0, device=None):
    """[batch, seq] int32 absolute positions offset, offset+1, ..."""
    pos = torch.arange(seq, dtype=torch.int32, device=device) + offset
    return pos[None, :].expand(batch, seq).contiguous()


def _patch_grid(n_patches: int) -> int:
    """Width of the square grid the JAX package lays `n_patches` on."""
    return int(n_patches ** 0.5) or 1


def text_start(n_patches: int) -> int:
    """The first text position after `n_patches` image patches under
    M-RoPE: one past the patch grid's last row (0 with no patches)."""
    return (n_patches - 1) // _patch_grid(n_patches) + 1 if n_patches else 0


def build_positions(cfg, b: int, seq: int, n_patches=None, device=None):
    """Positions of `b` sequences of `seq` tokens, the JAX package's
    ``_build_positions``: under M-RoPE with `n_patches` image patches in
    front, [b, 3, seq] rows (t, h, w): a patch i on a sqrt(P)-wide grid
    has (0, i // grid, i % grid) and the text continues from
    ``text_start`` in all three rows; else 0..seq-1, [b, seq]."""
    if cfg.pos_embed != "mrope" or n_patches is None:
        return positions_from_shape(b, seq, device=device)
    p = n_patches
    grid = _patch_grid(p)
    idx = torch.arange(p, dtype=torch.int32, device=device)
    img = torch.stack([torch.zeros_like(idx), idx // grid, idx % grid])
    tpos = torch.arange(seq - p, dtype=torch.int32, device=device) \
        + text_start(p)
    pos3 = torch.cat([img, tpos.expand(3, -1)], dim=1)          # [3, seq]
    return pos3[None].expand(b, -1, -1).contiguous()
