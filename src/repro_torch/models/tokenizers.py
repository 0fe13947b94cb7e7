"""Meta-Transformer modality-specific tokenizers — the MPSL CLIENT head W_h.

Counterpart of the JAX package's ``models/tokenizers.py``. These are the
paper's lightweight client-side models (~1M trainable params for ViT-B):
they turn raw modality inputs into token embeddings that are sent to the
server as smashed data.

  * vision — ViT patchify: [B, H, W, 3] -> 16x16 patches -> linear -> +cls +pos
  * text   — CLIP-style BPE ids -> embedding table -> +pos
  * audio  — AST: log-mel spectrogram [B, T, n_mels] -> 16x16 patches ->
             linear -> +cls +pos

A cls token is prepended for vision/audio (paper Sec. 4: only cls tokens are
concatenated in late fusion).

Where the JAX package vmaps one tokenizer over the clients' stacked
[N, ...] params, ``apply_stacked`` applies them as one batched product
over the client axis; ``apply_tokenizer`` is its one-client case.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers

PATCH = 16


@dataclasses.dataclass(frozen=True)
class ModalitySpec:
    name: str            # vision | text | audio
    # vision: (H, W); audio: (T_frames, n_mels); text: max_len
    input_shape: tuple
    vocab_size: int = 0  # text only

    @property
    def num_tokens(self) -> int:
        if self.name == "text":
            return self.input_shape[0]
        h, w = self.input_shape[:2]
        return (h // PATCH) * (w // PATCH) + 1          # +cls

    def patch_dim(self) -> int:
        if self.name == "vision":
            return PATCH * PATCH * 3
        if self.name == "audio":
            return PATCH * PATCH                         # single-channel mel
        raise ValueError(self.name)


VISION_224 = ModalitySpec("vision", (224, 224))
AUDIO_128x1024 = ModalitySpec("audio", (1024, 128))
TEXT_77 = ModalitySpec("text", (77,), vocab_size=49_408)

MODALITIES = {"vision": VISION_224, "audio": AUDIO_128x1024, "text": TEXT_77}


def init_tokenizer(generator, spec: ModalitySpec, d_model: int, device=None):
    """One tokenizer's params (f32), drawn from `generator`."""
    init = lambda shape, fan=None: layers.dense_init(
        generator, shape, in_axis_size=fan, device=device)
    if spec.name == "text":
        return {"embed": init((spec.vocab_size, d_model), d_model),
                "pos": init((spec.num_tokens, d_model), d_model)}
    return {
        "proj": init((spec.patch_dim(), d_model)),
        "proj_b": torch.zeros((d_model,), device=device),
        "cls": init((1, d_model), d_model),
        "pos": init((spec.num_tokens, d_model), d_model),
    }


def _patchify(x, patch=PATCH):
    """[B, H, W, C] (or [B, H, W], one channel) -> [B, (H/p)*(W/p), p*p*C],
    each patch flattened as (p, p, C), channel last."""
    b, h, w = x.shape[:3]
    c = x.shape[3] if x.dim() == 4 else 1
    x = x.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def apply_stacked(params, x, spec: ModalitySpec, dtype=torch.float32):
    """Each client's tokenizer on its own inputs: params stacked [N, ...],
    x [N, B, ...] raw inputs -> token embeddings [N, B, T, D].

    The text table is the frozen pretrained CLIP vocabulary (paper:
    clients train ~1M params, not the 38M table): it is read detached, so
    it stays a leaf of the trainable tree with a zero gradient, as under
    the JAX package's stop_gradient."""
    n, b = x.shape[:2]
    if spec.name == "text":
        client = torch.arange(n, device=x.device)[:, None, None]
        emb = params["embed"].detach()[client, x.long()].to(dtype)
        return emb + params["pos"].to(dtype)[:, None, : x.shape[2]]
    patches = _patchify(x.to(dtype).reshape(n * b, *x.shape[2:]))
    patches = patches.reshape(n, b, *patches.shape[1:])
    tok = torch.einsum("nbtp,npd->nbtd", patches, params["proj"].to(dtype))
    tok = tok + params["proj_b"].to(dtype)[:, None, None]
    cls = params["cls"].to(dtype)[:, None].expand(n, b, 1, tok.shape[-1])
    tok = torch.cat([cls, tok], dim=2)
    return tok + params["pos"].to(dtype)[:, None, : tok.shape[2]]


def apply_tokenizer(params, x, spec: ModalitySpec, dtype=torch.float32):
    """Raw modality input [B, ...] -> token embeddings [B, N_tokens, D]."""
    one = {k: v[None] for k, v in params.items()}
    return apply_stacked(one, x[None], spec, dtype)[0]


def tokenizer_param_count(spec: ModalitySpec, d_model: int) -> int:
    if spec.name == "text":
        return (spec.vocab_size + spec.num_tokens) * d_model
    return (spec.patch_dim() + 1 + 1 + spec.num_tokens) * d_model
