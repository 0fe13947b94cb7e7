"""minitron-4b — pruned Nemotron dense LM [arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
Nemotron family: squared-ReLU MLP, LayerNorm, RoPE, no bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256_000,
    head_dim=128,
    activation="sq_relu",
    norm="layernorm",
    qkv_bias=False,
    rope_theta=10_000.0,
)
