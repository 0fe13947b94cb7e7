"""The port's serving caches at their capacity.

``build_serving_fns`` sizes every KV cache to prompt + ``decode_slots``
(a local layer's to at most its window) and writes at index % length. A
global layer that wrapped would overwrite its oldest keys and from then on
attend over a window it was not built with, so ``generate`` raises
before a decode step would. Reduced configs, f32, the kernels' plain versions on the CPU:
decoding to exactly the capacity matches the full forward (no cache) of
the same tokens, and one step more raises. hymba-1.5b with a window of 8
past a 7-slot cache is the same fault in a local layer whose cache is
shorter than its window."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import layers, model as M

# tests/test_smoke_archs.py::test_decode_matches_full_forward
DECODE_VS_FULL = 5e-5
B, S, SLOTS = 2, 6, 5


def _setup(arch, window):
    cfg = reduced(get_config(arch),
                  **({"sliding_window": window} if window else {}))
    params = M.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S + SLOTS + 1),
                           generator=torch.Generator().manual_seed(1))
    fns = serve.build_serving_fns(cfg, device="cpu", decode_slots=SLOTS)
    return cfg, params, tokens, fns


CASES = [("minitron-4b", 0), ("hymba-1.5b", 8)]


@pytest.mark.parametrize("arch,window", CASES)
def test_decode_to_the_cache_capacity_matches_full_forward(arch, window):
    cfg, params, tokens, (prefill, decode) = _setup(arch, window)
    out = serve.generate(prefill, decode, params, tokens[:, :S], SLOTS,
                         forced_tokens=tokens[:, S:S + SLOTS])
    n = S + SLOTS
    impls = {"attn": "kernel", "ssm": "kernel"}
    h = M.embed_tokens(params, tokens[:, :n], cfg, dtype=torch.float32)
    with torch.no_grad():
        h, _ = M.forward_body(params, h, cfg, impls=impls,
                              positions=layers.positions_from_shape(B, n))
        full = M.lm_logits(params, h, cfg)[:, S - 1:n]
    assert out["logits"].shape == full.shape
    torch.testing.assert_close(out["logits"], full, atol=DECODE_VS_FULL,
                               rtol=DECODE_VS_FULL)


@pytest.mark.parametrize("arch,window", CASES)
def test_one_step_past_the_cache_raises(arch, window):
    cfg, params, tokens, (prefill, decode) = _setup(arch, window)
    with pytest.raises(ValueError, match="KV cache holds"):
        serve.generate(prefill, decode, params, tokens[:, :S], SLOTS + 1,
                       forced_tokens=tokens[:, S:])


def test_a_window_no_longer_than_its_cache_may_wrap():
    """A local layer whose cache holds its whole window evicts only keys
    outside it: the guard lets it wrap (hymba-1.5b's window of 4 under a
    prompt of 6 and 5 decode steps; its global layers have room)."""
    cfg = reduced(get_config("hymba-1.5b"), sliding_window=4)
    cache = M.init_body_cache(cfg, B, S + SLOTS, torch.float32, "cpu")
    for seg_cache in cache:
        for layer in seg_cache:
            layer["kv"]["index"] = S + SLOTS - 1
    serve.check_cache_room(cfg, cache, 1)
    with pytest.raises(ValueError):
        serve.check_cache_room(cfg, cache, 2)
