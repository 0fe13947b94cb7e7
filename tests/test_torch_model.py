"""The port's dense-model modules against the JAX package on the CPU:
layers, MLP, attention (naive and kernel, with and without a KV cache)
and the whole body, on the same params (through the bridge) and the same
numpy inputs. The JAX kernel path runs its Pallas kernel in interpret
mode."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS, get_config, reduced
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import mlp as JMLP
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mlp as TMLP
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

F32 = dict(atol=2e-5, rtol=2e-5)
BODY = dict(atol=5e-5, rtol=5e-5)
JAX_IMPL = {"naive": "naive", "kernel": "pallas"}
DENSE_ARCHS = ["minitron-4b", "qwen1.5-110b", "command-r-plus-104b"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=F32):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# layers


def test_layer_norm_uses_apply_norms_eps():
    """apply_norm hands eps=1e-6 to LayerNorm, not its 1e-5 default; at a
    variance near eps the two differ far beyond the tolerance."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 1e-3).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = JL.apply_norm(jnp.asarray(x), {"scale": scale, "bias": bias},
                         "layernorm")
    got = TL.apply_norm(_t(x), {"scale": _t(scale), "bias": _t(bias)},
                        "layernorm")
    _close(got, want, dict(atol=1e-4, rtol=1e-4))
    wrong = TL.layer_norm(_t(x), _t(scale), _t(bias))      # eps=1e-5
    assert np.abs(wrong.numpy() - np.asarray(want)).max() > 1e-2


def test_rms_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    _close(TL.apply_norm(_t(x), {"scale": _t(scale)}, "rmsnorm"),
           JL.apply_norm(jnp.asarray(x), {"scale": scale}, "rmsnorm"))


@pytest.mark.parametrize("name", ["sq_relu", "silu", "gelu", "relu"])
def test_activations(name):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    _close(TL.act_fn(name)(_t(x)), JL.act_fn(name)(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_rotates_halves(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    cos, sin = TL.rope_cos_sin(_t(pos), 16, 10_000.0)
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(pos), 16, 10_000.0)
    _close(cos, jcos, dict(atol=1e-5, rtol=1e-5))
    _close(sin, jsin, dict(atol=1e-5, rtol=1e-5))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = TL.apply_rope(_t(x).to(tdt), cos, sin)
    want = JL.apply_rope(jnp.asarray(x, getattr(jnp, dtype)), jcos, jsin)
    assert got.dtype == tdt
    tol = F32 if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    _close(got, want.astype(jnp.float32), tol)


def test_positions_from_shape():
    got = TL.positions_from_shape(3, 5, offset=7)
    want = JL.positions_from_shape(3, 5, offset=7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# MLP


@pytest.mark.parametrize("activation", ["sq_relu", "silu", "gelu"])
def test_mlp(activation):
    params = _np_tree(JMLP.init_mlp(jax.random.PRNGKey(0), 32, 64,
                                    activation))
    assert ("wg" in params) == (activation == "silu")
    x = np.random.default_rng(3).standard_normal((2, 5, 32)).astype(
        np.float32)
    got = TMLP.apply_mlp(jax.tree_util.tree_map(_t, params), _t(x),
                         activation)
    _close(got, JMLP.apply_mlp(params, jnp.asarray(x), activation))


# ---------------------------------------------------------------------------
# attention


def _attn_setup(arch="minitron-4b", seed=0):
    cfg = reduced(get_config(arch))
    params = _np_tree(JA.init_attention(jax.random.PRNGKey(seed), cfg))
    if cfg.qkv_bias:   # non-zero biases, so the test sees them
        rng = np.random.default_rng(seed)
        for n in ("bq", "bk", "bv"):
            params[n] = rng.standard_normal(params[n].shape).astype(
                np.float32) * 0.1
    return cfg, params, jax.tree_util.tree_map(_t, params)


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen1.5-110b"])
@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_attention_without_cache(arch, impl):
    cfg, jp, tp = _attn_setup(arch)
    x = np.random.default_rng(4).standard_normal((2, 12, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want, _ = JA.apply_attention(jp, jnp.asarray(x), cfg,
                                 positions=jnp.asarray(pos),
                                 impl=JAX_IMPL[impl])
    got, cache = TA.apply_attention(tp, _t(x), cfg, positions=_t(pos),
                                    impl=impl)
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_attention_prefill_then_decode_with_cache(impl):
    cfg, jp, tp = _attn_setup()
    b, s, cache_len = 2, 12, 20
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s + 2, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + 2, dtype=np.int32), (b, s + 2)).copy()
    jc = JA.init_cache(cfg, b, cache_len, jnp.float32)
    tc = TA.init_cache(cfg, b, cache_len, torch.float32)
    for lo, hi in ((0, s), (s, s + 1), (s + 1, s + 2)):   # prefill, 2 decodes
        want, jc = JA.apply_attention(
            jp, jnp.asarray(x[:, lo:hi]), cfg,
            positions=jnp.asarray(pos[:, lo:hi]), cache=jc,
            impl=JAX_IMPL[impl])
        got, tc = TA.apply_attention(tp, _t(x[:, lo:hi]), cfg,
                                     positions=_t(pos[:, lo:hi]), cache=tc,
                                     impl=impl)
        _close(got, want)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        assert tc["index"] == int(jc["index"]) == hi


def test_cache_insert_keeps_the_tail_of_a_long_prefill():
    """Both keep the last 4 of 9 entries; the port rotates them so that
    position p lies at slot p % 4 and the next write (index 9 % 4 = 1)
    replaces the oldest, position 5 (ROADMAP.md Queue 3)."""
    cfg = reduced(get_config("minitron-4b"))
    rng = np.random.default_rng(6)
    k = rng.standard_normal((1, 9, 1, 16)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)[None]
    jc = JA._cache_insert(JA.init_cache(cfg, 1, 4, jnp.float32),
                          jnp.asarray(k), jnp.asarray(k), jnp.asarray(pos))
    tc = TA._cache_insert(TA.init_cache(cfg, 1, 4, torch.float32), _t(k),
                          _t(k), _t(pos))
    _close(tc["k"], np.roll(np.asarray(jc["k"]), 1, axis=1))
    np.testing.assert_array_equal(tc["pos"].numpy(),
                                  np.roll(np.asarray(jc["pos"]), 1, axis=1))
    np.testing.assert_array_equal(tc["pos"].numpy()[0] % 4, np.arange(4))
    assert tc["index"] == int(jc["index"]) == 9


def test_mask_bias():
    rng = np.random.default_rng(7)
    qp = rng.integers(0, 30, (2, 6)).astype(np.int32)
    kp = rng.integers(-1, 30, (2, 9)).astype(np.int32)
    kv = kp >= 0
    want = JA._mask_bias(jnp.asarray(qp), jnp.asarray(kp), True, 7,
                         jnp.asarray(kv))
    got = TA._mask_bias(_t(qp), _t(kp), True, 7, _t(kv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# whole body


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_forward_body_hidden_states(arch, impl):
    cfg = reduced(get_config(arch))
    tree = _np_tree(JM.init_lm(jax.random.PRNGKey(1), cfg))
    params = bridge.from_repro(tree)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 12))
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    jh = JM.embed_tokens(tree, jnp.asarray(tokens), cfg, dtype=jnp.float32)
    want, _, _ = JM.forward_body(tree, jh, cfg, positions=jnp.asarray(pos),
                                 impls={"attn": JAX_IMPL[impl]}, remat=False)
    th = TM.embed_tokens(params, _t(tokens), cfg, dtype=torch.float32)
    _close(th, jh)
    got, cache, aux = TM.forward_body(params, th, cfg, positions=_t(pos),
                                      impls={"attn": impl})
    assert cache is None and aux == 0.0
    _close(got, want, BODY)
    _close(TM.lm_logits(params, got, cfg), JM.lm_logits(tree, want, cfg),
           BODY)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_matches_jax(arch):
    assert t_get_config(arch).param_count() == get_config(arch).param_count()
    assert t_reduced(t_get_config(arch)).param_count(2) == \
        reduced(get_config(arch)).param_count(2)


@pytest.mark.parametrize("arch", ["whisper-tiny", "vit-tiny"])
def test_other_families_name_their_slice(arch):
    cfg = t_reduced(t_get_config(arch))
    with pytest.raises(NotImplementedError, match="slice"):
        TM.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "qwen2-moe-a2.7b"])
def test_moe_archs_init_and_name_the_ep_slice(arch):
    """The MoE family is ported: a reduced model initialises with an MoE
    FFN in every block; only the expert-parallel dispatch is left, to the
    multi-GPU slice."""
    cfg = t_reduced(t_get_config(arch))
    params = TM.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    layer = params["segments"][0][0]
    assert "moe" in layer and "mlp" not in layer
    x = torch.zeros((1, 3, cfg.d_model))
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        TMOE.apply_moe(layer["moe"], x, cfg, impl="ep")
