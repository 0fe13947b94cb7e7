"""qwen3-moe-235b-a22b — MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) d_ff=1536(per expert) vocab=151936.
Qwen3 family: no QKV bias, per-head q/k RMSNorm, head_dim=128
(q projection 4096 -> 64*128 = 8192).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151_936,
    head_dim=128,
    activation="silu",
    norm="rmsnorm",
    qkv_bias=False,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        num_experts=128,
        top_k=8,
        d_ff_expert=1536,
        num_shared_experts=0,
        d_ff_shared=0,
    ),
)
