"""The port's encoder-decoder (whisper) and VLM (qwen2-vl, M-RoPE) inputs
against the JAX package, on the CPU.

Reduced whisper-tiny (2 encoder + 2 decoder layers, d_model 64,
encoder_seq 16) and qwen2-vl-72b (2 layers, M-RoPE sections (4, 2, 2),
4 patch tokens as in ``tests/test_smoke_archs.py``), text seq 12. The
JAX package builds the params; the bridge carries them over bitwise; both
compute on the same numpy inputs, JAX through its Pallas kernels in
interpret mode, the port through its kernels' plain versions: M-RoPE,
``build_positions``, attention over [B, 3, S] positions, over an encoder
output and over precomputed cross K/V, the encoder, the body, serving
(prefill and decode logits and greedy tokens), and the MPSL loss, every
gradient and one train step of both families; then the MPSL properties
for whisper, microbatching of the new batch keys, the bridge, the
assembled model, the loader and the CLIs. Frame and patch embeddings are
0.02 x N(0, 1), as ``tests/test_smoke_archs.py: _batch_for`` draws them.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro.core import mpsl as jmpsl
from repro.core import split as jsplit
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import schedules as jsched
from repro_torch import bridge, tree
from repro_torch.configs import MPSLConfig as TMPSLConfig
from repro_torch.configs import RunConfig as TRunConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.core import mpsl, split
from repro_torch.launch import serve, train
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import schedules

ARCHS = ["whisper-tiny", "qwen2-vl-72b"]
N, BN, S, P = 3, 2, 12, 4
# the same f32 products summed in other orders (tests/test_torch_model.py)
TOL = dict(atol=1e-5, rtol=1e-5)
# loss and gradients: tests/test_torch_mpsl.py's limits and reasons
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAPTER_L2_TOL = 1e-3
# served logits: tests/test_torch_serve.py's limit
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
# decode through the cache against the full forward:
# tests/test_torch_serve_cache.py's limit
DECODE_VS_FULL = 5e-5
STEPS, SLOTS = 3, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _stub(cfg, lead, seed):
    """frame_embeds for whisper (encoder_seq frames), patch_embeds for
    qwen2-vl (P patches), 0.02 x N(0, 1), f32 numpy."""
    rng = np.random.default_rng(seed)
    n = cfg.encoder_seq if cfg.family == "audio" else P
    x = 0.02 * rng.standard_normal((*lead, n, cfg.d_model))
    key = "frame_embeds" if cfg.family == "audio" else "patch_embeds"
    return {key: x.astype(np.float32)}


def _perturb(tree_np, seed, scale=0.05):
    """Every zero-initialised leaf (biases, norm deviations) made nonzero,
    so that each enters the comparison."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
        if not np.any(a) else a, tree_np)


# ---------------------------------------------------------------------------
# M-RoPE and positions


def test_mrope_cos_sin_matches_jax_and_rope_on_equal_rows():
    rng = np.random.default_rng(0)
    pos3 = rng.integers(0, 300, (2, 3, 7)).astype(np.int32)
    sections, hd, theta = (4, 2, 2), 16, 1e6
    want = JL.mrope_cos_sin(jnp.asarray(pos3), hd, theta, sections)
    got = TL.mrope_cos_sin(_t(pos3), hd, theta, sections)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    flat = pos3[:, 0]
    same = np.repeat(flat[:, None], 3, axis=1)
    got = TL.mrope_cos_sin(_t(same), hd, theta, sections)
    for g, r in zip(got, TL.rope_cos_sin(_t(flat), hd, theta)):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="sections"):
        TL.mrope_cos_sin(_t(same), hd, theta, (4, 2, 1))


@pytest.mark.parametrize("p", [None, 0, 4, 9, 256])
def test_build_positions_matches_jax(p):
    cfg = reduced(get_config("qwen2-vl-72b"))
    tcfg = treduced(tget_config("qwen2-vl-72b"))
    seq = (p or 0) + 12
    batch = {} if p is None else {"patch_embeds": np.zeros((1, 1, p, 1))}
    want = np.asarray(jmpsl._build_positions(cfg, batch, 2, seq))
    got = TL.build_positions(tcfg, 2, seq, p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if p:
        assert TL.text_start(p) == int(want[0, 0, p])


def test_jax_build_prefill_reads_the_patch_count_off_the_wrong_axis():
    """The JAX package's ``launch/steps.py: build_prefill`` hands
    _build_positions a serving batch's [B, P, D] patch embeddings, whose
    axis 2 is D, not P: the positions it builds are not the prompt's. The
    port's build_positions takes the count itself; its serving test
    (``_jax_serve``) hands JAX the patches on axis 2, as training does.
    Here D (64) > the prompt (16), so the reference cannot even broadcast
    its rows to the prompt's length."""
    cfg = reduced(get_config("qwen2-vl-72b"))
    batch = {"patch_embeds": np.zeros((2, P, cfg.d_model), np.float32)}
    with pytest.raises(ValueError, match="broadcast"):
        jmpsl._build_positions(cfg, batch, 2, P + S)


# ---------------------------------------------------------------------------
# attention: M-RoPE positions, cross-attention, precomputed K/V


def _attn_setup(arch, seed):
    cfg = reduced(get_config(arch))
    tcfg = treduced(tget_config(arch))
    jp = _perturb(_np_tree(JA.init_attention(jax.random.PRNGKey(seed), cfg)),
                  seed)
    return cfg, tcfg, jp, bridge.from_repro(jp)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_attention_with_mrope_positions_matches_jax(impl):
    """qwen2-vl's self-attention (qkv bias, G 4) under _build_positions'
    rows: 4 patches on a 2-wide grid, all at temporal position 0, then the
    text from position 2."""
    cfg, tcfg, jp, tp = _attn_setup("qwen2-vl-72b", 1)
    x = np.random.default_rng(2).standard_normal(
        (2, P + S, cfg.d_model)).astype(np.float32)
    pos = np.asarray(jmpsl._build_positions(
        cfg, {"patch_embeds": np.zeros((1, 1, P, 1))}, 2, P + S))
    want, _ = JA.apply_attention(jp, jnp.asarray(x), cfg,
                                 positions=jnp.asarray(pos),
                                 impl={"naive": "naive",
                                       "kernel": "pallas"}[impl])
    got, _ = TA.apply_attention(tp, _t(x), tcfg, positions=_t(pos),
                                impl=impl)
    _close(got, want)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
@pytest.mark.parametrize("route", ["kv_x", "precomputed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_matches_jax(impl, route, arch):
    """Cross-attention: 12 decoder queries over 16 encoder outputs,
    non-causal; from the encoder output or from its precomputed K/V. The
    port rotates neither q nor k over outside keys, as the JAX package
    does when its cross block passes use_rope=False; qwen2-vl (M-RoPE)
    shows it for a rotary config."""
    cfg, tcfg, jp, tp = _attn_setup(arch, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.asarray(JL.positions_from_shape(2, S))
    jimpl = {"naive": "naive", "kernel": "pallas"}[impl]
    jkw = dict(causal=False, use_rope=False)
    kw = dict(causal=False)
    if route == "kv_x":
        want, _ = JA.apply_attention(jp, jnp.asarray(x), cfg,
                                     positions=jnp.asarray(pos),
                                     kv_x=jnp.asarray(enc), impl=jimpl, **jkw)
        got, _ = TA.apply_attention(tp, _t(x), tcfg, positions=_t(pos),
                                    kv_x=_t(enc), impl=impl, **kw)
    else:
        jkv = JA.compute_cross_kv(jp, jnp.asarray(enc), cfg)
        tkv = TA.compute_cross_kv(tp, _t(enc), tcfg)
        for k in ("k", "v", "pos"):
            _close(tkv[k], jkv[k])
        want, _ = JA.apply_attention(jp, jnp.asarray(x), cfg,
                                     positions=jnp.asarray(pos),
                                     precomputed_kv=jkv, impl=jimpl, **jkw)
        got, _ = TA.apply_attention(tp, _t(x), tcfg, positions=_t(pos),
                                    precomputed_kv=tkv, impl=impl, **kw)
    _close(got, want)


# ---------------------------------------------------------------------------
# encoder and body


@pytest.fixture(scope="module")
def lm_trees():
    """{arch: JAX init_lm tree (numpy), zero leaves perturbed}."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = reduced(get_config(arch))
        out[arch] = _perturb(_np_tree(JM.init_lm(jax.random.PRNGKey(i), cfg)),
                             10 + i, scale=0.02)
    return out


def test_encoder_and_cross_kv_match_jax(lm_trees):
    cfg = reduced(get_config("whisper-tiny"))
    tcfg = treduced(tget_config("whisper-tiny"))
    jp, tp = lm_trees["whisper-tiny"], bridge.from_repro(lm_trees["whisper-tiny"])
    fe = _stub(cfg, (2,), 5)["frame_embeds"]
    want = JM.run_encoder(jp, jnp.asarray(fe), cfg, impls={"attn": "pallas"},
                          remat=False)
    got = TM.run_encoder(tp, _t(fe), tcfg, impls={"attn": "kernel"})
    _close(got, want)
    jkv = JM.compute_cross_kv_stacked(jp, want, cfg)
    tkv = TM.compute_cross_kv_stacked(tp, got, tcfg)
    assert len(tkv) == len(jkv) == 1 and len(tkv[0]) == cfg.num_layers
    for i, layer in enumerate(tkv[0]):
        for k in ("k", "v", "pos"):
            _close(layer[k], np.asarray(jkv[0][k])[i])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_body_matches_jax(lm_trees, arch):
    """The train form: whisper's decoder over the encoder output (under
    remat, and its gradient into the encoder output against JAX's), the
    VLM's patches and text under M-RoPE positions."""
    cfg, tcfg = reduced(get_config(arch)), treduced(tget_config(arch))
    jp, tp = lm_trees[arch], bridge.from_repro(lm_trees[arch])
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, S))
    stub = _stub(cfg, (2,), 7)
    h = np.asarray(JM.embed_tokens(jp, jnp.asarray(tokens), cfg,
                                   dtype=jnp.float32))
    if arch == "qwen2-vl-72b":
        h = np.concatenate([stub["patch_embeds"], h], axis=1)
        pos = np.asarray(jmpsl._build_positions(cfg, {"patch_embeds": np.zeros(
            (1, 1, P, 1))}, 2, h.shape[1]))
        enc = None
    else:
        pos = np.asarray(JL.positions_from_shape(2, S))
        enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    r = rng.standard_normal(h.shape).astype(np.float32)

    def jf(h_, enc_):
        out, _, _ = JM.forward_body(jp, h_, cfg, positions=jnp.asarray(pos),
                                    enc_out=enc_, impls={"attn": "pallas"})
        return jnp.sum(out * r), out

    if enc is None:
        (_, want), g_enc = jf(jnp.asarray(h), None), None
    else:
        (_, want), g_enc = jax.value_and_grad(jf, argnums=1, has_aux=True)(
            jnp.asarray(h), jnp.asarray(enc))
    t_enc = None if enc is None else _t(enc).requires_grad_()
    got, _, _ = TM.forward_body(tp, _t(h), tcfg, positions=_t(pos),
                                enc_out=t_enc, impls={"attn": "kernel"},
                                remat=True)
    _close(got, want)
    if enc is not None:
        (g,) = torch.autograd.grad((got * _t(r)).sum(), t_enc)
        _close(g, g_enc, dict(atol=1e-5 * float(np.abs(g_enc).max()),
                              rtol=0))


# ---------------------------------------------------------------------------
# serving


def _jax_serve(cfg, params, tokens, stub, fed):
    """The composition the JAX package's ``launch/steps.py: build_prefill``
    and ``build_decode`` perform (encoder, cross K/V, ``forward_body`` with
    the cache, ``lm_logits``; ``_build_positions`` for the VLM), its
    Pallas attention in interpret mode; decode fed the port's tokens.
    Returns the logits [B, STEPS + 1, V]."""
    impls = {"attn": "pallas"}
    b, s = tokens.shape
    h = JM.embed_tokens(params, jnp.asarray(tokens), cfg, dtype=jnp.float32)
    ckv = None
    if cfg.family == "vlm":
        pe = jnp.asarray(stub["patch_embeds"])
        h = jnp.concatenate([pe, h], axis=1)
        s = h.shape[1]
        # _build_positions counts the patches on a batch's axis 2, as the
        # MPSL batch [N, Bn, P, D] has them
        positions = jmpsl._build_positions(cfg, {"patch_embeds": pe[:, None]},
                                           b, s)
    else:
        positions = JL.positions_from_shape(b, s)
        enc = JM.run_encoder(params, jnp.asarray(stub["frame_embeds"]), cfg,
                             impls=impls, remat=False)
        ckv = JM.compute_cross_kv_stacked(params, enc, cfg)
    cache = JM.init_body_cache(cfg, b, s + 512, jnp.float32)
    h, cache, _ = JM.forward_body(params, h, cfg, positions=positions,
                                  cache=cache, cross_kv=ckv, impls=impls,
                                  remat=False)
    out = [np.asarray(JM.lm_logits(params, h[:, -1:], cfg))[:, -1]]
    start = (int(positions[0, 0, -1]) + 1 if cfg.family == "vlm" else s)
    for i in range(STEPS):
        p = jnp.full((b, 1), start + i, jnp.int32)
        if cfg.family == "vlm":
            p = jnp.broadcast_to(p[:, None], (b, 3, 1))
        flat = p[:, 0] if p.ndim == 3 else p
        h = JM.embed_tokens(params, jnp.asarray(fed[:, i:i + 1], jnp.int32),
                            cfg, positions=flat, dtype=jnp.float32)
        h, cache, _ = JM.forward_body(params, h, cfg, positions=p,
                                      cache=cache, cross_kv=ckv, impls=impls,
                                      remat=False)
        out.append(np.asarray(JM.lm_logits(params, h, cfg))[:, -1])
    return np.stack(out, axis=1)


def _port_inputs(stub):
    """generate's keyword arguments of a _stub batch."""
    return {k: _t(v) for k, v in stub.items()}


@pytest.fixture(scope="module")
def served(lm_trees):
    out = {}
    for arch in ARCHS:
        cfg, tcfg = reduced(get_config(arch)), treduced(tget_config(arch))
        tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, S))
        stub = _stub(cfg, (2,), 9)
        prefill, decode = serve.build_serving_fns(tcfg, device="cpu")
        got = serve.generate(prefill, decode, bridge.from_repro(lm_trees[arch]),
                             _t(tokens), STEPS, **_port_inputs(stub))
        want = _jax_serve(cfg, lm_trees[arch], tokens, stub,
                          got["tokens"].numpy())
        out[arch] = got, want
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_served_logits_match_jax(served, arch):
    got, want = served[arch]
    assert got["logits"].shape == want.shape == (2, STEPS + 1, 256)
    for step in range(STEPS + 1):      # 0 = prefill, then each decode step
        np.testing.assert_allclose(got["logits"][:, step].numpy(),
                                   want[:, step], **SERVE_TOL,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(served, arch):
    got, want = served[arch]
    np.testing.assert_array_equal(got["tokens"].numpy(), want.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_to_the_cache_capacity_matches_full_forward(arch):
    """The port's decode (self-attention through the cache, cross K/V kept
    from prefill, M-RoPE text rows continued) against its own full forward
    over the same tokens; the cache counts entries (patches included), and
    one step past it raises."""
    cfg = treduced(tget_config(arch))
    params = TM.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, S + SLOTS),
                           generator=torch.Generator().manual_seed(1))
    stub = _port_inputs(_stub(cfg, (2,), 2))
    prefill, decode = serve.build_serving_fns(cfg, device="cpu",
                                              decode_slots=SLOTS)
    out = serve.generate(prefill, decode, params, tokens[:, :S], SLOTS,
                         forced_tokens=tokens[:, S:], **stub)
    impls = {"attn": "kernel"}
    with torch.no_grad():
        h = TM.embed_tokens(params, tokens, cfg, dtype=torch.float32)
        enc = None
        if "patch_embeds" in stub:
            h = torch.cat([stub["patch_embeds"], h], dim=1)
        else:
            enc = TM.run_encoder(params, stub["frame_embeds"], cfg,
                                 impls=impls)
        n = h.shape[1]
        pos = TL.build_positions(cfg, 2, n, P if "patch_embeds" in stub
                                   else None)
        h, _, _ = TM.forward_body(params, h, cfg, positions=pos,
                                  enc_out=enc, impls=impls)
        full = TM.lm_logits(params, h, cfg)[:, n - SLOTS - 1:]
    torch.testing.assert_close(out["logits"], full, atol=DECODE_VS_FULL,
                               rtol=DECODE_VS_FULL)
    with pytest.raises(ValueError, match="KV cache holds"):
        serve.generate(prefill, decode, params, tokens[:, :S], SLOTS + 1,
                       **stub)


def test_serving_refuses_missing_or_foreign_frontend_inputs(lm_trees):
    tcfg = treduced(tget_config("whisper-tiny"))
    params = bridge.from_repro(lm_trees["whisper-tiny"])
    prefill, _ = serve.build_serving_fns(tcfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="frame embeddings"):
        prefill(params, tokens)
    mcfg = treduced(tget_config("minitron-4b"))
    mparams = TM.init_lm(mcfg, torch.Generator().manual_seed(0), "cpu")
    prefill, _ = serve.build_serving_fns(mcfg, device="cpu")
    with pytest.raises(ValueError, match="vlm input"):
        prefill(mparams, tokens,
                patch_embeds=torch.zeros((1, 2, mcfg.d_model)))


# ---------------------------------------------------------------------------
# the MPSL loss, its gradients and one train step


def _jax_run(arch, compress):
    cfg = reduced(get_config(arch))
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=compress, compress_downlink=compress)
    return cfg, RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                          compute_dtype="float32", attn_impl="pallas",
                          ce_impl="pallas")


def _port_run(arch, compress):
    cfg = treduced(tget_config(arch))
    mp = TMPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                     compress_uplink=compress, compress_downlink=compress)
    return cfg, TRunConfig(model=cfg, shape=None, mpsl=mp,
                           compute_dtype="float32", attn_impl="kernel",
                           ce_impl="kernel")


def _np_batch(cfg, seed, bn=BN, mask=None):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (N, bn, S)),
         "labels": rng.integers(0, cfg.vocab_size, (N, bn, S)),
         "mask": (np.ones(N, np.float32) if mask is None
                  else np.asarray(mask, np.float32))}
    return dict(b, **_stub(cfg, (N, bn), seed + 100))


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32) if k in ("tokens", "labels")
            else jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def mpsl_trees():
    """{arch: (params, frozen)} of the JAX package's init_mpsl_lm (numpy;
    frozen bf16), the adapter's b nonzero so that a gets a gradient."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg, run = _jax_run(arch, False)
        params, frozen, _ = jsplit.init_mpsl_lm(jax.random.PRNGKey(20 + i),
                                                cfg, run)
        params["client"]["adapter"]["b"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(30 + i), params["client"]["adapter"]["b"].shape)
        out[arch] = _np_tree(params), _np_tree(frozen)
    return out


def _draws(key, shape):
    """The uniforms the JAX loss draws for its links from `key`."""
    r_up, r_down = jax.random.split(jax.random.fold_in(key, 1))
    return {"uplink": _t(jax.random.uniform(r_up, shape)),
            "downlink": _t(jax.random.uniform(r_down, shape))}


def _assert_trees_close(got, want, tol, l2_paths=()):
    got, want = bridge.to_repro(got), _np_tree(want)
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten_with_path(want)
    assert gdef == jax.tree_util.tree_structure(want)
    for g, (path, w) in zip(gl, wl):
        name = jax.tree_util.keystr(path)
        if any(p in name for p in l2_paths):
            err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            assert err <= ADAPTER_L2_TOL, (name, err)
        else:
            scale = float(np.abs(w).max()) + 1e-12
            assert float(np.abs(g - w).max()) <= tol * scale, name


def _port_grads(loss_fn, params, frozen, batch, rng):
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, frozen, batch, rng)
    grads = iter(torch.autograd.grad(loss, tree.leaves(params)))
    return loss.detach(), metrics, tree.map_(lambda _: next(grads), params)


def _seq(cfg):
    return S + (P if cfg.family == "vlm" else 0)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(mpsl_trees, arch, compress):
    jcfg, jrun = _jax_run(arch, compress)
    tcfg, trun = _port_run(arch, compress)
    b = _np_batch(jcfg, seed=3)
    key = jax.random.PRNGKey(5)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        jmpsl.make_lm_loss(jcfg, jrun), has_aux=True))(
        *mpsl_trees[arch], _jax_batch(b), key)
    rng = _draws(key, (N, BN, _seq(tcfg), tcfg.d_model)) if compress else 0
    params, frozen = (bridge.from_repro(t) for t in mpsl_trees[arch])
    loss, met, grads = _port_grads(mpsl.make_lm_loss(tcfg, trun), params,
                                   frozen, _torch_batch(b), rng)
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    np.testing.assert_allclose(met["per_client"].numpy(),
                               np.asarray(jmet["per_client"]), rtol=LOSS_TOL)
    _assert_trees_close(grads, jg, GRAD_TOL,
                        l2_paths=("'adapter'",) if compress else ())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(mpsl_trees, arch):
    """One make_train_step each (links on, the port fed JAX's uniforms):
    loss, grad norm, both Adam moments, the count, and params within the
    2 lr that AdamW's first ~sign(g) step allows where |g| is float
    noise (tests/test_torch_mpsl.py)."""
    jcfg, jrun = _jax_run(arch, True)
    tcfg, trun = _port_run(arch, True)
    b = _np_batch(jcfg, seed=4)
    params, frozen = mpsl_trees[arch]
    jstep = jmpsl.make_train_step(jmpsl.make_lm_loss(jcfg, jrun), jrun,
                                  jsched.constant(1e-3))
    jnew, jmet = jax.jit(jstep)(jmpsl.init_state(params, frozen, seed=9),
                                _jax_batch(b))
    key = jax.random.fold_in(jax.random.PRNGKey(9), 0)
    draws = _draws(key, (N, BN, _seq(tcfg), tcfg.d_model))
    loss_fn = mpsl.make_lm_loss(tcfg, trun)
    state = mpsl.init_state(*(bridge.from_repro(t) for t in
                              mpsl_trees[arch]), seed=9)
    step = mpsl.make_train_step(lambda p, f, bb, _r: loss_fn(p, f, bb, draws),
                                trun, schedules.constant(1e-3))
    state, met = step(state, _torch_batch(b))
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
        LOSS_TOL * abs(float(jmet["loss"]))
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= \
        GRAD_TOL * float(jmet["grad_norm"])
    for k in ("mu", "nu"):
        _assert_trees_close(state["opt"][k], jnew["opt"][k], 2 * GRAD_TOL,
                            l2_paths=("'adapter'",))
    assert int(state["opt"]["count"]) == int(jnew["opt"]["count"]) == 1
    moved = [float(np.abs(a - np.asarray(w)).max()) for a, w in zip(
        jax.tree_util.tree_leaves(bridge.to_repro(state["params"])),
        jax.tree_util.tree_leaves(jnew["params"]))]
    assert max(moved) <= 2 * 1e-3 * 1.01


def test_whisper_without_frames_sees_later_tokens_in_jax_and_raises_here(
        mpsl_trees):
    """The JAX package's own entry points feed whisper no frames; each
    cross block then attends over the decoder's own tokens, both ways, so
    a change to the last token (whose own prediction the loss drops) moves
    the loss. With the frames it does not. The port refuses the batch."""
    jcfg, jrun = _jax_run("whisper-tiny", False)
    loss_fn = jax.jit(jmpsl.make_lm_loss(jcfg, jrun))
    b = _np_batch(jcfg, seed=6)
    b2 = {k: v.copy() for k, v in b.items()}
    b2["tokens"][:, :, -1] = (b2["tokens"][:, :, -1] + 1) % jcfg.vocab_size
    key = jax.random.PRNGKey(0)

    def loss(batch, frames):
        batch = {k: v for k, v in batch.items()
                 if frames or k != "frame_embeds"}
        return float(loss_fn(*mpsl_trees["whisper-tiny"], _jax_batch(batch),
                             key)[0])

    assert loss(b, True) == loss(b2, True)
    assert abs(loss(b, False) - loss(b2, False)) > 1e-4
    tcfg, trun = _port_run("whisper-tiny", False)
    params, frozen = (bridge.from_repro(t) for t in mpsl_trees["whisper-tiny"])
    tb = _torch_batch(b)
    del tb["frame_embeds"]
    with pytest.raises(ValueError, match="frame_embeds"):
        mpsl.make_lm_loss(tcfg, trun)(params, frozen, tb, 0)


# ---------------------------------------------------------------------------
# the MPSL properties for whisper, and microbatching of the new keys


@pytest.fixture(scope="module")
def whisper_setup(mpsl_trees):
    cfg, run = _port_run("whisper-tiny", False)
    params, frozen = (bridge.from_repro(t) for t in mpsl_trees["whisper-tiny"])
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return cfg, params, frozen, mpsl.make_lm_loss(cfg, run)


@pytest.mark.parametrize("mask", [[1, 1, 1], [1, 0, 1]])
def test_whisper_aggregated_equals_per_client(whisper_setup, mask):
    cfg, params, frozen, loss_fn = whisper_setup
    batch = _torch_batch(_np_batch(cfg, seed=11, mask=mask))
    _, _, g_agg = mpsl.value_and_grad(loss_fn, params, frozen, batch, 0)
    g_pc, _, _ = mpsl._per_client_grads(loss_fn, params, frozen, batch, 0)
    for a, b in zip(g_agg, g_pc):
        scale = float(a.abs().max()) + 1e-8
        assert float((a - b).abs().max()) / scale < 1e-4


@pytest.mark.parametrize("key", ["tokens", "frame_embeds"])
def test_whisper_client_isolation_is_bitwise(whisper_setup, key):
    """Neither the encoder nor cross-attention mixes samples: changing
    client 1's tokens or frames leaves clients 0 and 2's adapter gradients
    bitwise unchanged."""
    cfg, params, frozen, loss_fn = whisper_setup
    b1 = _np_batch(cfg, seed=12)
    b2 = {k: v.copy() for k, v in b1.items()}
    b2[key][1] = ((b2[key][1] + 7) % cfg.vocab_size if key == "tokens"
                  else b2[key][1] * 1.5)
    grads = []
    for b in (b1, b2):
        _, _, g = _port_grads(loss_fn, params, frozen, _torch_batch(b), 0)
        grads.append(g["client"]["adapter"]["b"])
    assert float((grads[0][1] - grads[1][1]).abs().max()) > 0
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][2], grads[1][2])


def test_whisper_dropped_client_gets_zero_grad(whisper_setup):
    cfg, params, frozen, loss_fn = whisper_setup
    batch = _torch_batch(_np_batch(cfg, seed=13, mask=[1, 0, 1]))
    _, _, g = _port_grads(loss_fn, params, frozen, batch, 0)
    for k in ("a", "b"):
        assert float(g["client"]["adapter"][k][1].abs().max()) == 0.0
        assert float(g["client"]["adapter"][k][0].abs().max()) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatching_splits_the_frontend_inputs(mpsl_trees, arch):
    """_split_microbatches slices frame_embeds / patch_embeds on the Bn axis
    with the tokens, and two microbatches keep the loss and gradients."""
    cfg, run = _port_run(arch, False)
    params, frozen = (bridge.from_repro(t) for t in mpsl_trees[arch])
    for p in tree.leaves(params):
        p.requires_grad_(True)
    b = _np_batch(cfg, seed=15, bn=4)
    key = "frame_embeds" if arch == "whisper-tiny" else "patch_embeds"
    parts = mpsl._split_microbatches(_torch_batch(b), 2)
    for j, mb in enumerate(parts):
        assert torch.equal(mb[key], _t(b[key][:, 2 * j:2 * j + 2]))
        assert mb["tokens"].shape[1] == mb[key].shape[1] == 2
    loss_fn = mpsl.make_lm_loss(cfg, run)
    l1, _, g1 = mpsl._grad_agg(loss_fn, params, frozen, _torch_batch(b), 0, 1)
    l2, _, g2 = mpsl._grad_agg(loss_fn, params, frozen, _torch_batch(b), 0, 2)
    assert abs(float(l1) - float(l2)) < 1e-4
    for a, c in zip(g1, g2):
        assert float((a - c).abs().max()) <= 1e-4 * (float(a.abs().max())
                                                     + 1e-8)


# ---------------------------------------------------------------------------
# bridge, assembled model, loader and CLIs


def _bitwise(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_bridge_round_trips_the_encoder_tree(lm_trees, mpsl_trees):
    tree_ = lm_trees["whisper-tiny"]
    port = bridge.from_repro(tree_)
    enc = port["encoder"]
    assert len(enc["segments"]) == 1 and len(enc["segments"][0]) == 2
    assert enc["pos"].shape == (16, 64)
    _bitwise(bridge.to_repro(port), tree_)
    params, frozen = mpsl_trees["whisper-tiny"]
    tfrozen = bridge.from_repro(frozen)
    assert tfrozen["encoder"]["segments"][0][0]["attn"]["wq"].dtype == \
        torch.bfloat16
    _bitwise(bridge.to_repro(tfrozen), frozen)
    _bitwise(bridge.to_repro(bridge.from_repro(params)), params)


def test_port_init_matches_jax_layout(mpsl_trees):
    """init_mpsl_lm puts whisper's encoder in the frozen tree, in bf16,
    with the JAX package's leaves and shapes."""
    tcfg, trun = _port_run("whisper-tiny", False)
    params, frozen, _ = split.init_mpsl_lm(torch.Generator().manual_seed(0),
                                           tcfg, trun)
    for got, want in zip((params, frozen), mpsl_trees["whisper-tiny"]):
        gl, gdef = jax.tree_util.tree_flatten(bridge.to_repro(got))
        wl, wdef = jax.tree_util.tree_flatten(want)
        assert gdef == wdef
        assert [(x.shape, x.dtype) for x in gl] == \
            [(x.shape, x.dtype) for x in wl]


def test_assembled_params_match_jax_and_serve(mpsl_trees):
    jcfg, jrun = _jax_run("whisper-tiny", False)
    want = jsplit.assemble_full_params(
        *mpsl_trees["whisper-tiny"], jsplit.make_split_plan(jcfg, jrun.mpsl))
    tcfg, trun = _port_run("whisper-tiny", False)
    got = split.assemble_full_params(
        *(bridge.from_repro(t) for t in mpsl_trees["whisper-tiny"]),
        split.make_split_plan(tcfg, trun.mpsl))
    assert got["encoder"]["pos"].dtype == torch.float32
    _bitwise(bridge.to_repro(got), _np_tree(want))
    prefill, _ = serve.build_serving_fns(tcfg, device="cpu")
    logits, _ = prefill(got, torch.zeros((1, 4), dtype=torch.long),
                        **_port_inputs(_stub(tcfg, (1,), 0)))
    assert logits.shape == (1, 1, tcfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_loader_adds_seeded_stub_embeddings(arch):
    """train_batch_specs' layout (repro/launch/steps.py): whisper's frames
    beside seq text tokens, qwen2-vl's frontend_tokens patches before
    seq - frontend_tokens; f32, 0.02 x N(0, 1), a pure function of (seed,
    step)."""
    cfg = treduced(tget_config(arch))
    loader = train.make_lm_loader(cfg, 2, 3, 24, seed=1)
    b, again, other = loader.batch(0), loader.batch(0), loader.batch(1)
    if arch == "whisper-tiny":
        key, shape, n_text = "frame_embeds", (2, 3, 16, 64), 24
    else:
        key, shape, n_text = "patch_embeds", (2, 3, 16, 64), 24 - 16
    assert b[key].shape == shape and b[key].dtype == np.float32
    assert b["tokens"].shape == (2, 3, n_text)
    assert 0.015 < float(b[key].std()) < 0.025
    np.testing.assert_array_equal(b[key], again[key])
    assert not np.array_equal(b[key], other[key])
    tb = train.to_device(b, "cpu")
    assert tb["tokens"].dtype == torch.int64 and tb[key].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_train_and_serve_on_cpu(arch, capsys):
    assert train.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                       "--seq", "20", "--compress",
                       "--trainable-blocks", "1"]) == 0
    assert serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                       "--prompt-len", "6", "--decode-steps", "2"]) == 0
