"""Feed-forward blocks: gated (SwiGLU) for silu-family, plain for
gelu / squared-ReLU (Nemotron) families."""
from __future__ import annotations

import torch

from repro_torch.models import layers


def init_mlp(generator, d_model: int, d_ff: int, activation: str,
             device=None):
    p = {
        "wi": layers.dense_init(generator, (d_model, d_ff), device=device),
        "wo": layers.dense_init(generator, (d_ff, d_model), device=device),
    }
    if layers.gated_activation(activation):
        p["wg"] = layers.dense_init(generator, (d_model, d_ff),
                                    device=device)
    return p


def apply_mlp(params, x, activation: str):
    act = layers.act_fn(activation)
    h = torch.matmul(x, params["wi"].to(x.dtype))
    if "wg" in params:
        g = torch.matmul(x, params["wg"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    return torch.matmul(h, params["wo"].to(x.dtype))
