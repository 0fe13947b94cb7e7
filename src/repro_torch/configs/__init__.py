"""Architecture config registry.

``get_config(arch_id)`` resolves every assigned architecture plus the
paper's own Meta-Transformer / ViT variants. Arch ids use the assignment
spelling (e.g. ``qwen1.5-110b``); module names are pythonized.
"""
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    MPSLConfig,
    RunConfig,
    ShapeConfig,
    SHAPES,
    SSMConfig,
    cell_supported,
    port_impls,
    reduced,
)

from repro_torch.configs import (
    command_r_plus_104b,
    falcon_mamba_7b,
    hymba_1_5b,
    meta_transformer,
    minitron_4b,
    nemotron_4_15b,
    qwen1_5_110b,
    qwen2_moe_a2_7b,
    qwen2_vl_72b,
    qwen3_moe_235b_a22b,
    whisper_tiny,
)

ASSIGNED_ARCHS = {
    "minitron-4b": minitron_4b.CONFIG,
    "nemotron-4-15b": nemotron_4_15b.CONFIG,
    "qwen1.5-110b": qwen1_5_110b.CONFIG,
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "falcon-mamba-7b": falcon_mamba_7b.CONFIG,
    "qwen2-vl-72b": qwen2_vl_72b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.CONFIG,
    "whisper-tiny": whisper_tiny.CONFIG,
}

PAPER_ARCHS = dict(meta_transformer.VIT_VARIANTS)
PAPER_ARCHS["meta-transformer-b16"] = meta_transformer.CONFIG

ARCHS = {**ASSIGNED_ARCHS, **PAPER_ARCHS}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}") from None


def list_archs():
    return sorted(ASSIGNED_ARCHS)


__all__ = [
    "ARCHS", "ASSIGNED_ARCHS", "PAPER_ARCHS", "SHAPES",
    "ModelConfig", "MoEConfig", "MPSLConfig", "RunConfig", "ShapeConfig",
    "SSMConfig", "cell_supported", "get_config", "list_archs", "port_impls",
    "reduced",
]
