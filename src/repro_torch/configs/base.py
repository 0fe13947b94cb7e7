"""Config dataclasses for the MPSL framework.

Three layers of config:
  * ModelConfig  — architecture hyperparameters (one per assigned arch).
  * ShapeConfig  — input-shape cell (seq_len x global_batch x kind).
  * MPSLConfig   — the paper's technique: split point, client population,
                   fusion, compression, fine-tuned-block count.
  * RunConfig    — bundles the three + mesh/runtime knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    top_k: int = 0
    d_ff_expert: int = 0            # per-expert FFN hidden
    num_shared_experts: int = 0     # always-on shared experts
    d_ff_shared: int = 0            # shared-expert FFN hidden (total)
    router_aux_coef: float = 0.001  # load-balance aux loss


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                 # d_inner = expand * d_model
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm | hybrid | moe | vlm | audio | vit
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    activation: str = "silu"        # silu | gelu | sq_relu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    qkv_bias: bool = False
    qk_norm: bool = False           # qwen3-style per-head q/k RMSNorm
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"         # rope | mrope | learned | none
    mrope_sections: Tuple[int, ...] = ()   # M-RoPE split of head_dim/2
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Hymba): parallel attention + SSM heads inside each block
    hybrid: bool = False
    # sliding-window size for local-attention layers (0 = all global)
    sliding_window: int = 0
    # indices of global-attention layers when sliding_window > 0
    global_layers: Tuple[int, ...] = ()
    # encoder-decoder (Whisper): number of encoder layers (0 = decoder-only)
    encoder_layers: int = 0
    encoder_seq: int = 0            # fixed encoder seq (stub frontend frames)
    # modality frontend stub: inputs are precomputed embeddings, not ids
    frontend_stub: bool = False
    frontend_tokens: int = 0        # tokens produced by the stub per sample
    max_seq: int = 131_072

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def dt_rank(self) -> int:
        if not self.ssm:
            return 0
        return self.ssm.dt_rank or -(-self.d_model // 16)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Supports O(1)-state or bounded-window decode at 500k context."""
        return self.family in ("ssm", "hybrid")

    def param_count(self, trainable_blocks: Optional[int] = None) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, trainable_blocks)


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape cells)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_training(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_supported(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, "SKIP(full-attention: 524k context needs sub-quadratic attention)"
    return True, ""


# ---------------------------------------------------------------------------
# MPSL (the paper's technique)


@dataclasses.dataclass(frozen=True)
class MPSLConfig:
    """Multimodal Parallel Split Learning settings (paper Section 3)."""
    n_clients: int = 32                 # N — total parallel clients
    head_adapter_rank: int = 16         # lightweight trainable client tokenizer
    fusion: str = "early"               # early | late (Section 3.2)
    trainable_blocks: int = -1          # server blocks fine-tuned (-1 = all)
    label_sharing: bool = False         # paper: False (loss computed on client)
    compress_uplink: bool = False       # beyond-paper int8 smashed-data link
    compress_downlink: bool = False     # beyond-paper int8 cut-layer grads
    # paper baseline mode: 'aggregated' single backward (Lyu et al.)
    # vs 'per_client' backward passes (vanilla PSL baseline)
    backward_mode: str = "aggregated"
    loss: str = "ce"                    # ce | contrastive (retrieval tasks)

    def client_weights(self, batch_sizes) -> list:
        total = float(sum(batch_sizes))
        return [b / total for b in batch_sizes]


# ---------------------------------------------------------------------------
# Run


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mpsl: MPSLConfig = dataclasses.field(default_factory=MPSLConfig)
    # mesh
    multi_pod: bool = False
    # numerics
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"        # trainable params / master copies
    frozen_dtype: str = "bfloat16"      # frozen (non-fine-tuned) params
    # training
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    microbatches: int = 1               # grad accumulation
    remat: str = "block"                # none | block | full
    seed: int = 0
    # implementation selection. The fields take the JAX package's names
    # or the port's own; ``port_impls`` translates the first into the
    # second (pallas -> kernel, jnp -> plain), and make_lm_loss /
    # make_vit_loss read them through it.
    attn_impl: str = "auto"             # auto | naive | blockwise | pallas (kernel)
    attn_block: int = 1024              # blockwise attention KV block
    moe_impl: str = "dense"             # dense | ragged | ep
    moe_capacity: float = 2.0           # ep per-expert capacity slack
    ssm_impl: str = "jnp"               # jnp (plain) | pallas (kernel)
    ssm_chunk: int = 256                # selective-scan chunk length
    # selective-scan backward (kernel path only): 'fused' runs the
    # checkpointed-recompute adjoint kernel; 'recompute' differentiates
    # through the plain scan instead
    ssm_bwd_impl: str = "fused"
    ce_impl: str = "jnp"                # jnp (plain) | pallas (kernel): the LM-head CE
    ce_chunk: int = 512                 # chunked-CE token block
    # sequence-parallel residual activations (the JAX package shards the
    # per-layer carry on seq over the TP axis); on one card a no-op, kept
    # so that a cell's RunConfig equals the JAX package's
    seq_shard_acts: bool = False
    # the JAX package's roofline probes unroll its layer scans; the port
    # runs layers in a Python loop, so this changes nothing here
    unroll_layers: bool = False
    # the core self-attention over each model rank's S/m queries against
    # the whole K/V (models.attention._query_slice); a no-op on one rank
    attn_seq_shard: bool = False
    # serving: weights FSDP-sharded over data (True) or replicated over it
    # (False); read by launch.steps' shardings
    serve_weights_fsdp: bool = True

    @property
    def impls(self):
        return {"attn": self.attn_impl, "attn_block": self.attn_block,
                "moe": self.moe_impl, "moe_capacity": self.moe_capacity,
                "ssm": self.ssm_impl,
                "ssm_chunk": self.ssm_chunk,
                "ssm_bwd": self.ssm_bwd_impl,
                "ce": self.ce_impl,
                "unroll_layers": self.unroll_layers,
                "attn_seq_shard": self.attn_seq_shard,
                "act_dims": (("batch", "seq_model", None)
                             if self.seq_shard_acts
                             else ("batch", None, None))}


# The JAX package's impl names, by the port's: a name not listed passes
# through (naive, blockwise, auto, kernel, plain, dense, ragged, ep, and
# the non-name knobs). "auto" stays "auto": apply_attention resolves it by
# the JAX rule at each call, blockwise where Sk > 2048 and Sq > 1, else
# naive.
_PORT_NAMES = {"attn": {"pallas": "kernel"},
               "ssm": {"pallas": "kernel", "jnp": "plain"},
               "ce": {"pallas": "kernel", "jnp": "plain"}}


def port_impls(impls) -> dict:
    """An impls dict with the JAX package's names translated into the
    port's (the one place that does it)."""
    return {k: _PORT_NAMES.get(k, {}).get(v, v) for k, v in impls.items()}


def reduced(model: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, round(4 * model.num_kv_heads / model.num_heads)),
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        max_seq=512,
    )
    if model.moe:
        kw["moe"] = MoEConfig(
            num_experts=4,
            top_k=2,
            d_ff_expert=32,
            num_shared_experts=min(1, model.moe.num_shared_experts),
            d_ff_shared=32 if model.moe.num_shared_experts else 0,
        )
    if model.ssm:
        kw["ssm"] = SSMConfig(d_state=4, d_conv=4, expand=2)
    if model.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 16
    if model.frontend_stub:
        kw["frontend_tokens"] = min(model.frontend_tokens, 16) or 16
    if model.global_layers:
        kw["global_layers"] = (0,)
        kw["sliding_window"] = 64 if model.sliding_window else 0
    if model.mrope_sections:
        kw["mrope_sections"] = (4, 2, 2)
    name = f"{model.name}-reduced"
    kw.update(overrides)
    return dataclasses.replace(model, name=name, **kw)
