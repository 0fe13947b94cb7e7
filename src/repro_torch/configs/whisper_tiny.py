"""whisper-tiny — encoder-decoder audio transformer [arXiv:2212.04356; unverified].

4L (enc) + 4L (dec), d_model=384, 6H (MHA kv=6), d_ff=1536, vocab=51865.
The conv audio frontend is a STUB: input_specs() provides precomputed
frame embeddings (1500 frames, the model's native encoder length).
Shape seq_len applies to the DECODER text sequence. Encoder-only side has
no decode step; decode shapes exercise the decoder with self- + cross-
attention KV caches.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,               # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    head_dim=64,
    activation="gelu",
    norm="layernorm",
    pos_embed="learned",
    encoder_layers=4,
    encoder_seq=1500,
    frontend_stub=True,
    frontend_tokens=1500,
    max_seq=32_768,             # framework allows longer-than-pretrained dec seq
)
