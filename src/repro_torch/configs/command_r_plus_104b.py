"""command-r-plus-104b — dense GQA, no bias [hf:CohereForAI/c4ai-command-r-v01; unverified].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
Cohere family: LayerNorm, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33_792,
    vocab_size=256_000,
    head_dim=128,
    activation="silu",
    norm="layernorm",
    qkv_bias=False,
    tie_embeddings=True,
    rope_theta=75_000_000.0,
)
