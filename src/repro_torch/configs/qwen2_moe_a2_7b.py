"""qwen2-moe-a2.7b — MoE 60 routed top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) d_ff=1408(per expert) vocab=151936.
Shared-expert hidden = 4 x 1408 = 5632 (always-on).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    head_dim=128,
    activation="silu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        d_ff_expert=1408,
        num_shared_experts=4,
        d_ff_shared=5632,
    ),
)
