"""qwen2-vl-72b — VLM backbone with M-RoPE [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (dynamic-resolution ViT output), per the assignment note.
M-RoPE: head_dim/2 = 64 rotary dims split into (temporal, height, width)
sections (16, 24, 24).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    head_dim=128,
    activation="silu",
    norm="rmsnorm",
    qkv_bias=True,
    pos_embed="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend_stub=True,
    frontend_tokens=256,    # patch embeddings per image (stub)
)
