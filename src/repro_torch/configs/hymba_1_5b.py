"""hymba-1.5b — hybrid: parallel attention + mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each block runs an attention branch and an SSM branch in parallel over the
same input; outputs are per-branch-normed and averaged (Hymba Section 2).
Sliding-window attention everywhere except 3 global layers -> bounded KV
at 500k context => sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    head_dim=64,
    activation="silu",
    norm="rmsnorm",
    hybrid=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    sliding_window=1024,
    global_layers=(0, 15, 31),
    rope_theta=10_000.0,
    max_seq=1_048_576,
)
