"""nemotron-4-15b — dense GQA LM, squared-ReLU [arXiv:2402.16819; unverified].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=256_000,
    head_dim=128,
    activation="sq_relu",
    norm="layernorm",
    qkv_bias=False,
    rope_theta=10_000.0,
)
