"""Feed-forward blocks: gated (SwiGLU) for silu-family, plain for
gelu / squared-ReLU (Nemotron) families.

Under the SPMD program (``parallel.collectives``) wi / wg [D, F] are
column-parallel (F on `model`) and wo [F, D] row-parallel: the input
enters the model-parallel region by ``copy_to``, the partial products of
wo leave it by ``reduce_from`` (one all-reduce over `model`); each
weight's fsdp dim (D on `data`) is gathered at use. Where F does not
divide the model axis the weights are replicated over it and every model
rank computes the whole block."""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.parallel import collectives as C


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


def apply_mlp(params, x, activation: str, reduce: bool = True):
    """x [..., D] -> [..., D]. `reduce`: False leaves the model ranks'
    partial sums unreduced (a caller that adds them to others first)."""
    act = layers.act_fn(activation)
    tp = C.model_parallel(params["wi"])
    if tp:
        x = C.copy_to(x, "model")
    h = torch.matmul(x, C.gather_param(params["wi"]).to(x.dtype))
    if "wg" in params:
        g = torch.matmul(x, C.gather_param(params["wg"]).to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    y = torch.matmul(h, C.gather_param(params["wo"]).to(x.dtype))
    return C.reduce_from(y, "model") if tp and reduce else y
