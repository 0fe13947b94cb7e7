"""Analytic client-side cost models (paper Tables 1-2, Figure 3). A copy of
the JAX package's ``core/costs.py``, on the port's configs and tokenizers.

The paper evaluates three client-side criteria:
  * computation  — GFLOPs per input sample on the client;
  * trainable parameters on the client;
  * communication — MB transmitted per client per epoch.

These are closed-form in the architecture and protocol, so we compute them
exactly (the paper does the same via profiler readouts):

  FedAvg/FedCLIP client fwd+bwd runs the WHOLE model on-device;
  MPSL clients run only the tokenizers (+ adapter).

  FedAvg comm/epoch  = 2 x trainable_bytes x rounds_per_epoch
  FedCLIP comm/epoch = 2 x adapter_bytes x rounds_per_epoch
  MPSL comm/epoch    = (uplink activations + downlink cut-layer grads
                        + prediction downlink + loss uplink) per sample
                       x local samples
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models import model as M, tokenizers as tok

BYTES_F32 = 4
BYTES_BF16 = 2


def vit_tokens(modalities) -> int:
    return sum(tok.MODALITIES[m].num_tokens for m in modalities)


def tokenizer_params(cfg, modalities) -> int:
    """TRAINABLE client-tokenizer params: the pretrained text table is
    frozen (stop-gradient in models.tokenizers), so text contributes its
    positional table only."""
    total = 0
    for m in modalities:
        spec = tok.MODALITIES[m]
        n = tok.tokenizer_param_count(spec, cfg.d_model)
        if spec.name == "text":
            n -= spec.vocab_size * cfg.d_model
        total += n
    return total


def tokenizer_flops_per_sample(cfg, modalities) -> float:
    """Client fwd+bwd FLOPs for the tokenizers (2ND fwd, x3 for bwd)."""
    total = 0.0
    for m in modalities:
        spec = tok.MODALITIES[m]
        if spec.name == "text":
            total += 2.0 * spec.num_tokens * cfg.d_model       # lookup+pos
        else:
            n_patch = spec.num_tokens - 1
            total += 2.0 * n_patch * spec.patch_dim() * cfg.d_model
    return 3.0 * total


def encoder_flops_per_sample(cfg, n_tokens: int,
                             trainable_blocks=None) -> float:
    """Full fwd+bwd FLOPs of the unified encoder on one sample.

    6*N*T for trained blocks (fwd+bwd), 2*N*T for frozen ones (fwd only),
    plus the quadratic attention term."""
    per_block = M._block_params(cfg, M.body_segments(cfg)[0].kind)
    l_total = cfg.num_layers
    l_train = l_total if trainable_blocks is None else trainable_blocks
    l_frozen = l_total - l_train
    flops = (6.0 * l_train + 2.0 * l_frozen) * per_block * n_tokens
    # attention scores+values: 2 * 2 * T^2 * D per layer (x3 when trained)
    attn = 4.0 * n_tokens * n_tokens * cfg.d_model
    flops += (3.0 * l_train + 1.0 * l_frozen) * attn
    return flops


@dataclasses.dataclass(frozen=True)
class ClientCost:
    gflops_per_sample: float
    trainable_params_m: float
    comm_mb_per_epoch: float


def mpsl_client_cost(cfg, mpsl, modalities, samples_per_client: int,
                     batch_size: int, n_classes: int = 10,
                     compressed: bool = False) -> ClientCost:
    n_tok = vit_tokens(modalities)
    flops = tokenizer_flops_per_sample(cfg, modalities)
    params = tokenizer_params(cfg, modalities)
    act_bytes = BYTES_BF16 if not compressed else 1
    per_sample = n_tok * cfg.d_model * act_bytes        # uplink a_n
    per_sample += n_tok * cfg.d_model * act_bytes       # downlink cut grads
    per_sample += n_classes * BYTES_F32                 # prediction downlink
    steps = max(1, samples_per_client // batch_size)
    comm = per_sample * samples_per_client + steps * BYTES_F32  # loss uplink
    return ClientCost(flops / 1e9, params / 1e6, comm / 1e6)


def fedavg_client_cost(cfg, modalities, samples_per_client: int,
                       rounds_per_epoch: int = 1,
                       trainable_blocks=None) -> ClientCost:
    n_tok = vit_tokens(modalities)
    flops = (tokenizer_flops_per_sample(cfg, modalities)
             + encoder_flops_per_sample(cfg, n_tok, trainable_blocks))
    train_params = M.count_params_analytic(cfg, trainable_blocks) \
        + tokenizer_params(cfg, modalities)
    comm = 2.0 * train_params * BYTES_F32 * rounds_per_epoch
    return ClientCost(flops / 1e9, train_params / 1e6, comm / 1e6)


def fedclip_client_cost(cfg, modalities, samples_per_client: int,
                        rounds_per_epoch: int = 1) -> ClientCost:
    n_tok = vit_tokens(modalities)
    # frozen backbone still executes fwd on-client (+ adapter bwd)
    flops = (tokenizer_flops_per_sample(cfg, modalities) / 3.0
             + encoder_flops_per_sample(cfg, n_tok, trainable_blocks=0))
    adapter = cfg.d_model * (cfg.d_model // 4) * 2
    comm = 2.0 * adapter * BYTES_F32 * rounds_per_epoch
    return ClientCost(flops / 1e9, adapter / 1e6, comm / 1e6)


def sequential_sl_latency_factor(n_clients: int) -> float:
    """Vanilla SL processes clients one at a time: N x MPSL wall-clock."""
    return float(n_clients)


def mpsl_lm_client_cost(cfg, mpsl, shape, compressed=False) -> ClientCost:
    """LM-arch variant: frozen embed lookup + low-rank adapter on client."""
    r = mpsl.head_adapter_rank
    flops = 3.0 * 2.0 * shape.seq_len * cfg.d_model * r * 2
    params = 2 * cfg.d_model * r
    act_bytes = 1 if compressed else BYTES_BF16
    per_step = 2 * shape.seq_len * cfg.d_model * act_bytes
    return ClientCost(flops / 1e9, params / 1e6, per_step / 1e6)
