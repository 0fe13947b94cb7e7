"""falcon-mamba-7b — attention-free Mamba1 LM [arXiv:2410.05355; unverified].

64L d_model=4096, ssm_state=16, vocab=65024. d_ff=0 (Mamba block has its
own gated d_inner = 2*d_model path). Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,            # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    head_dim=64,
    activation="silu",
    norm="rmsnorm",
    pos_embed="none",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    max_seq=1_048_576,
)
