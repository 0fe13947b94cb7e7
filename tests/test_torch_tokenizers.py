"""The port's paper-mode pieces against the JAX package, on the CPU: the
Meta-Transformer tokenizers, fusion, the retrieval loss and metric, the
FedAvg of the client heads, the synthetic multimodal data, the analytic
cost model and the FL baselines (the full ViT and one FedAvg round).

Params are made by the JAX package and carried over by the bridge;
inputs are numpy with a seed. The model is reduced ViT-Tiny (2 layers,
d_model 64, 4 heads of 16) at the modalities' published input shapes
(vision 224 x 224 x 3: 197 tokens; audio 1024 x 128: 513; text 77)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config, reduced
from repro.configs.meta_transformer import VIT_TINY
from repro.core import aggregation as jagg
from repro.core import baselines as jbase
from repro.core import costs as jcosts
from repro.core import fusion as jfusion
from repro.core import losses as jlosses
from repro.data import synthetic as jsyn
from repro.models import tokenizers as jtok
from repro_torch import bridge, tree
from repro_torch.configs import MPSLConfig as TMPSLConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.configs.meta_transformer import VIT_TINY as T_VIT_TINY
from repro_torch.core import aggregation, baselines, costs, fusion, losses
from repro_torch.data import synthetic
from repro_torch.models import tokenizers as tok

CFG, TCFG = reduced(VIT_TINY), treduced(T_VIT_TINY)
# f32 on both sides, the same products summed in other orders (the patch
# projection sums 768 products): 1e-6 of the output's largest element
TOK_TOL = 1e-6
# a loss or an output of the 2-layer encoder (JAX: naive attention; the
# port: the flash kernel's plain version): 1e-5 relative
OUT_TOL = 1e-5


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, tol, name=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max()) + 1e-30
    assert float(np.abs(got - want).max()) <= tol * scale, name


def _raw(m, lead, seed):
    """Raw inputs of modality `m` with leading dims `lead`."""
    rng = np.random.default_rng(seed)
    spec = jtok.MODALITIES[m]
    if m == "text":
        return rng.integers(0, spec.vocab_size, lead + spec.input_shape)
    return rng.standard_normal(lead + jsyn._raw_shape(spec)).astype(
        np.float32)


def _to_jax(x):
    return jnp.asarray(x.astype(np.int32) if x.dtype.kind == "i" else x)


# ---------------------------------------------------------------------------
# tokenizers


@pytest.mark.parametrize("m", ["vision", "audio", "text"])
@pytest.mark.parametrize("stacked", [False, True])
def test_tokenizer_matches_jax(m, stacked):
    """One tokenizer on a batch, and (stacked) three clients' tokenizers,
    each on its own inputs, as the JAX package vmaps them."""
    spec = jtok.MODALITIES[m]
    n, b = 3, 2
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    if stacked:
        params = jax.vmap(lambda k: jtok.init_tokenizer(k, spec,
                                                        CFG.d_model))(keys)
        x = _raw(m, (n, b), seed=1)
        want = jax.vmap(lambda p, xx: jtok.apply_tokenizer(p, xx, spec))(
            params, _to_jax(x))
        got = tok.apply_stacked(bridge.from_repro(_np_tree(params)),
                                torch.from_numpy(x), tok.MODALITIES[m])
    else:
        params = jtok.init_tokenizer(keys[0], spec, CFG.d_model)
        x = _raw(m, (b,), seed=2)
        want = jtok.apply_tokenizer(params, _to_jax(x), spec)
        got = tok.apply_tokenizer(bridge.from_repro(_np_tree(params)),
                                  torch.from_numpy(x), tok.MODALITIES[m])
    assert got.shape[-2] == spec.num_tokens
    _close(got, want, TOK_TOL, m)


@pytest.mark.parametrize("shape", [(2, 32, 48, 3), (2, 64, 32)])
def test_patchify_layout_bitwise(shape):
    """(h, p, w, p, c) -> (h, w, p, p, c): patches row-major over the grid,
    each flattened channel last; a 3-d input is one channel."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jtok._patchify(jnp.asarray(x)))
    got = tok._patchify(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cls_comes_before_positions_and_table_is_frozen():
    """The cls token is token 0, with pos[0] added to it; the text table
    gets no gradient through the tokenizer (it is read detached)."""
    spec = tok.MODALITIES["vision"]
    g = torch.Generator().manual_seed(0)
    p = tok.init_tokenizer(g, spec, 8)
    x = torch.zeros((1, 224, 224, 3))
    out = tok.apply_tokenizer(p, x, spec)
    torch.testing.assert_close(out[0, 0], p["cls"][0] + p["pos"][0],
                               rtol=0, atol=0)
    tp = tok.init_tokenizer(g, tok.MODALITIES["text"], 8)
    for v in tp.values():
        v.requires_grad_(True)
    y = tok.apply_tokenizer(tp, torch.arange(77)[None],
                            tok.MODALITIES["text"]).sum()
    ge, gp = torch.autograd.grad(y, [tp["embed"], tp["pos"]],
                                 allow_unused=True)
    assert ge is None and gp is not None


@pytest.mark.parametrize("m", ["vision", "audio", "text"])
def test_tokenizer_shapes_and_counts_match_jax(m):
    a, b = jtok.MODALITIES[m], tok.MODALITIES[m]
    assert (a.name, a.input_shape, a.vocab_size, a.num_tokens) == \
        (b.name, b.input_shape, b.vocab_size, b.num_tokens)
    assert tok.tokenizer_param_count(b, 768) == \
        jtok.tokenizer_param_count(a, 768)
    p = tok.init_tokenizer(torch.Generator().manual_seed(0), b, 32)
    want = jtok.init_tokenizer(jax.random.PRNGKey(0), a, 32)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert sum(v.numel() for v in p.values()) == \
        jtok.tokenizer_param_count(a, 32)


# ---------------------------------------------------------------------------
# fusion, the retrieval loss and metric


def _encoded(seed, lead=(3,)):
    rng = np.random.default_rng(seed)
    return {m: rng.standard_normal(lead + (t, 16)).astype(np.float32)
            for m, t in (("vision", 5), ("text", 7), ("audio", 4))}


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_fusion_matches_jax(lead):
    """fuse_early (sorted: audio, text, vision), fuse_late (cls of vision
    and audio, mean of text), gap, on [B, T, D] and stacked [N, B, T, D]."""
    enc = _encoded(0, lead)
    j = {k: jnp.asarray(v) for k, v in enc.items()}
    t = {k: torch.from_numpy(v) for k, v in enc.items()}
    np.testing.assert_array_equal(fusion.fuse_early(t).numpy(),
                                  np.asarray(jfusion.fuse_early(j)))
    _close(fusion.fuse_late(t), jfusion.fuse_late(j), 1e-6, "late")
    _close(fusion.gap(fusion.fuse_late(t)),
           jfusion.gap(jfusion.fuse_late(j)), 1e-6, "gap")
    for m in enc:
        _close(fusion.summarize_modality(m, t[m]),
               jfusion.summarize_modality(m, j[m]), 1e-6, m)


@pytest.mark.parametrize("temp", [0.07, "learned"])
def test_contrastive_loss_and_grads_match_jax(temp):
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((6, 12)).astype(np.float32) for _ in "ab")
    scale = np.float32(2.659)

    def jloss(a, b, s):
        t = 1.0 / jnp.exp(s) if temp == "learned" else temp
        return jnp.mean(jlosses.contrastive_loss(a, b, t))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale))
    ta, tb, ts = (torch.tensor(x, requires_grad=True) for x in (a, b, scale))
    t = 1.0 / torch.exp(ts) if temp == "learned" else temp
    per = losses.contrastive_loss(ta, tb, t)
    assert per.shape == (6,) and per.dtype == torch.float32
    tl = per.mean()
    tg = torch.autograd.grad(tl, (ta, tb, ts), allow_unused=True)
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= OUT_TOL * abs(float(jl))
    for name, x, y in zip("abs", tg, jg):
        if x is None:                   # a fixed temperature: no gradient
            assert name == "s" and float(y) == 0.0
        else:
            _close(x, y, OUT_TOL, name)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_recall_at_k_matches_jax(k):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((16, 8)).astype(np.float32)
    b = a + 0.8 * rng.standard_normal((16, 8)).astype(np.float32)
    want = float(jlosses.recall_at_k(jnp.asarray(a), jnp.asarray(b), k))
    got = float(losses.recall_at_k(torch.from_numpy(a), torch.from_numpy(b),
                                   k))
    assert got == want and 0.0 < want <= 1.0


# ---------------------------------------------------------------------------
# aggregation of the client heads


@pytest.mark.parametrize("weighted", [False, True])
def test_fedavg_heads_match_jax(weighted):
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    bank = _np_tree(jax.vmap(lambda k: {
        m: jtok.init_tokenizer(k, jtok.MODALITIES[m], CFG.d_model)
        for m in ("vision", "text")})(keys))
    w = np.asarray([1.0, 3.0, 2.0], np.float32) if weighted else None
    want = jagg.fedavg_heads(bank, None if w is None else jnp.asarray(w))
    got = aggregation.fedavg_heads(bridge.from_repro(bank),
                                   None if w is None else torch.from_numpy(w))
    for x, y in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        _close(x, y, 1e-6)


def test_select_and_broadcast_head():
    bank = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(3)}}
    one = aggregation.select_client_head(bank, 1)
    assert torch.equal(one["a"], bank["a"][1])
    again = aggregation.broadcast_head(one, 3)
    assert again["a"].shape == (3, 4) and torch.equal(again["a"][2],
                                                      bank["a"][1])
    again["a"][0] += 1          # rows are copies, not views of one head
    assert torch.equal(again["a"][2], bank["a"][1])


# ---------------------------------------------------------------------------
# synthetic multimodal data


@pytest.mark.parametrize("mods", [("vision", "text"), ("vision", "audio"),
                                  ("audio", "text")])
def test_synthetic_multimodal_bitwise_equal_to_jax(mods):
    kw = dict(modalities=mods, n_classes=5, size=64, seed=3)
    a, b = synthetic.SyntheticMultimodal(**kw), jsyn.SyntheticMultimodal(**kw)
    idx = np.array([0, 7, 63, 7])
    got, want = a.sample(idx), b.sample(idx)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(a.labels, b.labels)


def test_synthetic_retrieval_bitwise_equal_to_jax():
    a = synthetic.SyntheticRetrieval(size=32, n_latents=4, seed=5)
    b = jsyn.SyntheticRetrieval(size=32, n_latents=4, seed=5)
    idx = np.array([3, 31, 0])
    got, want = a.sample(idx), b.sample(idx)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the analytic cost model


@pytest.mark.parametrize("arch", ["vit-tiny", "vit-base", "vit-huge"])
@pytest.mark.parametrize("mods", [("vision", "text"),
                                  ("audio", "text", "vision")])
def test_costs_match_jax(arch, mods):
    jc, tc = get_config(arch), tget_config(arch)
    assert costs.vit_tokens(mods) == jcosts.vit_tokens(mods)
    assert costs.tokenizer_params(tc, mods) == jcosts.tokenizer_params(jc,
                                                                       mods)
    for k in (None, 0, 4):
        assert costs.encoder_flops_per_sample(tc, 274, k) == \
            jcosts.encoder_flops_per_sample(jc, 274, k)
    same = lambda a, b: dataclasses.astuple(a) == dataclasses.astuple(b)
    for comp in (False, True):
        assert same(costs.mpsl_client_cost(tc, TMPSLConfig(), mods, 512, 32,
                                           compressed=comp),
                    jcosts.mpsl_client_cost(jc, None, mods, 512, 32,
                                            compressed=comp))
    assert same(costs.fedavg_client_cost(tc, mods, 512, 2, 4),
                jcosts.fedavg_client_cost(jc, mods, 512, 2, 4))
    assert same(costs.fedclip_client_cost(tc, mods, 512),
                jcosts.fedclip_client_cost(jc, mods, 512))


# ---------------------------------------------------------------------------
# the FL baselines: the full ViT and a FedAvg round


def _full_batch(lead, seed, n_classes=4, mods=("vision", "text")):
    rng = np.random.default_rng(seed)
    b = {m: _raw(m, lead, seed + i) for i, m in enumerate(mods)}
    b["labels"] = rng.integers(0, n_classes, lead)
    return b


def _j(batch):
    return {k: _to_jax(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("fusion_mode", ["early", "late"])
def test_full_vit_logits_and_loss_match_jax(fusion_mode):
    mods = ("audio", "text", "vision") if fusion_mode == "late" else \
        ("vision", "text")
    params = _np_tree(jbase.init_full_vit(jax.random.PRNGKey(4), CFG, mods,
                                          4, with_adapter=True))
    b = _full_batch((2,), seed=5, mods=mods)
    kw = dict(modalities=mods, fusion_mode=fusion_mode)
    tp = bridge.from_repro(params)
    _close(baselines.full_vit_logits(tp, _t(b), TCFG, **kw),
           jbase.full_vit_logits(params, _j(b), CFG, **kw), OUT_TOL)
    want = float(jbase.full_vit_loss(params, _j(b), CFG, **kw))
    got = float(baselines.full_vit_loss(tp, _t(b), TCFG, **kw))
    assert abs(got - want) <= OUT_TOL * abs(want)


def test_retrieval_embeddings_and_loss_match_jax():
    mods = ("text", "vision")
    params = _np_tree(jbase.init_full_vit(jax.random.PRNGKey(6), CFG, mods,
                                          retrieval=True))
    b = _full_batch((3,), seed=6, mods=mods)
    tp = bridge.from_repro(params)
    for x, y in zip(baselines.retrieval_embeddings(tp, _t(b), TCFG, mods),
                    jbase.retrieval_embeddings(params, _j(b), CFG, mods)):
        _close(x, y, OUT_TOL)
    kw = dict(modalities=mods, task="retrieval")
    want = float(jbase.full_vit_loss(params, _j(b), CFG, **kw))
    got = float(baselines.full_vit_loss(tp, _t(b), TCFG, **kw))
    assert abs(got - want) <= OUT_TOL * abs(want)


def test_init_full_vit_tree_matches_jax():
    for kw in (dict(), dict(retrieval=True, with_adapter=True)):
        got = bridge.to_repro(baselines.init_full_vit(
            torch.Generator().manual_seed(0), TCFG, **kw))
        want = _np_tree(jbase.init_full_vit(jax.random.PRNGKey(0), CFG,
                                            **kw))
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for x, y in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert x.shape == y.shape and x.dtype == y.dtype


LR, STEPS = 1e-3, 2
# AdamW's first steps are ~lr * sign(g); a leaf whose gradient is zero in
# exact arithmetic (the key bias: softmax is invariant to a shift along a
# row) gets float noise of either sign on each side, so its update is noise
# on both and is not compared
NOISE_LEAVES = ("attn/bk",)
# the averaged update of every other leaf, in relative L2 norm: a few
# elements whose gradient lies within float noise of 0 may take the other
# sign (2 lr each)
UPDATE_L2_TOL = 1e-3


def _fl_setup(filt=None):
    n, mods = 2, ("vision", "text")
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    stack = _np_tree(jax.vmap(lambda k: jbase.init_full_vit(
        k, CFG, mods, 4, with_adapter=filt is not None))(keys))
    batches = [[_full_batch((2,), seed=10 * c + s) for s in range(STEPS)]
               for c in range(n)]
    batches = {k: np.stack([np.stack([b[k] for b in cb]) for cb in batches])
               for k in batches[0][0]}
    jrnd = jbase.make_fl_round(
        lambda p, b: jbase.full_vit_loss(p, b, CFG, modalities=mods),
        lr=LR, local_steps=STEPS, trainable_filter=filt)
    trnd = baselines.make_fl_round(
        lambda p, b: baselines.full_vit_loss(p, b, TCFG, modalities=mods),
        lr=LR, local_steps=STEPS, trainable_filter=filt)
    want = jrnd(stack, _j(batches))
    got = trnd(bridge.from_repro(stack, client_axis=True), _t(batches))
    return stack, got, want


@pytest.mark.slow
@pytest.mark.parametrize("fedclip", [False, True])
def test_fl_round_matches_jax(fedclip):
    """One FedAvg round (FedCLIP: only its adapter and head train) of 2
    clients x 2 local AdamW steps: the mean loss, the averaged params
    (held by their update from the clients' mean start; the key biases,
    whose updates are float noise, not compared), the bank (every row the
    average)."""
    filt = baselines.fedclip_filter if fedclip else None
    stack, (bank, avg, loss), (jbank, javg, jloss) = _fl_setup(
        jbase.fedclip_filter if fedclip else None)
    assert abs(float(loss) - float(jloss)) <= OUT_TOL * abs(float(jloss))
    start = bridge.from_repro(jax.tree_util.tree_map(
        lambda a: a.mean(axis=0), stack))
    want = bridge.from_repro(_np_tree(javg))
    for path, g, w, s in zip(tree.paths(avg), tree.leaves(avg),
                             tree.leaves(want), tree.leaves(start)):
        g, w, s = g.numpy(), w.numpy(), s.numpy()
        if filt is not None and not filt(path):
            np.testing.assert_array_equal(g, s, err_msg=path)
            np.testing.assert_array_equal(w, s, err_msg=path)
        elif not any(k in path for k in NOISE_LEAVES):
            du, dw = g - s, w - s
            err = np.linalg.norm(du - dw) / (np.linalg.norm(dw) + 1e-30)
            assert err <= UPDATE_L2_TOL, (path, err)
    for r, a in zip(tree.leaves(bank), tree.leaves(avg)):
        assert r.shape[0] == 2
        assert torch.equal(r[0], a) and torch.equal(r[1], a)
    np.testing.assert_array_equal(
        jax.tree_util.tree_leaves(_np_tree(jbank))[0][1],
        jax.tree_util.tree_leaves(_np_tree(javg))[0])


def test_bridge_carries_a_client_bank_both_ways():
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    stack = _np_tree(jax.vmap(lambda k: jbase.init_full_vit(k, CFG))(keys))
    port = bridge.from_repro(stack, client_axis=True)
    assert len(port["segments"][0]) == CFG.num_layers
    assert port["segments"][0][1]["attn"]["wq"].shape[0] == 3
    back = bridge.to_repro(port, client_axis=True)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(stack)):
        np.testing.assert_array_equal(x, y)
