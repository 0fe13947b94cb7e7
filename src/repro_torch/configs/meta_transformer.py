"""The paper's own models: Meta-Transformer unified encoders (ViT backbones).

MPSL fine-tunes Meta-Transformer [Zhang et al., 2023] built on ViT-B/16
[Dosovitskiy et al., 2020]; Fig. 3/6 sweep ViT-{Ti,S,B,L,H} (6/22/85/303/
630 M params). These are encoder-only `vit` family models driven through
multimodal tokenizers (vision patchify, CLIP-style text embed, AST-style
audio spectrogram patchify), which the port gains in its paper-mode slice.
"""
from repro_torch.configs.base import ModelConfig


def _vit(name, layers, d_model, heads, d_ff):
    return ModelConfig(
        name=name,
        family="vit",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=heads,
        d_ff=d_ff,
        vocab_size=49_408,          # CLIP BPE vocab for the text tokenizer
        activation="gelu",
        norm="layernorm",
        qkv_bias=True,
        pos_embed="learned",
        max_seq=1024,
    )


VIT_TINY = _vit("vit-tiny", 12, 192, 3, 768)
VIT_SMALL = _vit("vit-small", 12, 384, 6, 1536)
VIT_BASE = _vit("vit-base", 12, 768, 12, 3072)
VIT_LARGE = _vit("vit-large", 24, 1024, 16, 4096)
VIT_HUGE = _vit("vit-huge", 32, 1280, 16, 5120)

# The paper's default backbone (Meta-Transformer ViT-B/16).
CONFIG = VIT_BASE

VIT_VARIANTS = {
    "vit-tiny": VIT_TINY,
    "vit-small": VIT_SMALL,
    "vit-base": VIT_BASE,
    "vit-large": VIT_LARGE,
    "vit-huge": VIT_HUGE,
}
