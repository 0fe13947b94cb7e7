"""The port's paper-mode MPSL loss and train step against the JAX package,
on the CPU.

Reduced ViT-Tiny (2 layers, d_model 64, 4 heads of 16, LayerNorm, tanh
GELU, qkv bias, learned positions), the last block trainable, 2 clients x
2 samples at the modalities' published input shapes (vision 224 x 224 x 3,
audio 1024 x 128, text 77 ids). The JAX package builds the
``init_mpsl_vit`` trees; the bridge carries them over bitwise; both
compute ``make_vit_loss`` and every gradient on the same bits (JAX with
its default attention, materialized scores, and its Pallas quant8 in
interpret mode; the port through its kernels' plain versions), for early
and late fusion and retrieval, with the links' compression off and on
(the port fed ``jax.random.uniform``'s draws, one pair a link). Then one
train step, the frozen text table's zero gradient and its decay, the MPSL
properties of ``tests/test_mpsl_equivalence.py`` on the ViT loss, and the
post-training model (FedAvg of the tokenizers, ``assemble_full_params``,
``full_vit_logits``)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import MPSLConfig, RunConfig, SHAPES, reduced
from repro.configs.meta_transformer import VIT_TINY
from repro.core import aggregation as jagg
from repro.core import baselines as jbase
from repro.core import mpsl as jmpsl
from repro.core import split as jsplit
from repro.data import synthetic as jsyn
from repro.models import tokenizers as jtok
from repro.optim import schedules as jsched
from repro_torch import bridge, tree
from repro_torch.configs import MPSLConfig as TMPSLConfig
from repro_torch.configs import RunConfig as TRunConfig
from repro_torch.configs import reduced as treduced
from repro_torch.configs.meta_transformer import VIT_TINY as T_VIT_TINY
from repro_torch.core import aggregation, baselines, mpsl, split
from repro_torch.optim import schedules

N, BN, N_CLASSES = 2, 2, 4
CFG, TCFG = reduced(VIT_TINY), treduced(T_VIT_TINY)
# JAX (materialized scores) and the port (the flash kernel's plain version)
# sum the same f32 products in other orders through 2 layers: loss to
# 1e-5; each gradient leaf to 1e-4 of its largest element
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# Under int8 links the smashed data (uplink) and the cut-layer cotangent
# (downlink), which differ by float noise, are quantized: a few elements
# round to the neighbouring int8 level, which moves the server's gradients
# (its input) and the tokenizers' (their cotangent) by more than float
# noise, so every gradient leaf is then held in relative L2 norm
ADAPTER_L2_TOL = 1e-3
# The key bias's gradient is 0 in exact arithmetic (softmax is invariant
# to a shift along a row), so each side's is float noise: it is held to
# GRAD_TOL of the largest element of the same layer's query-bias gradient
ZERO_GRAD_LEAVES = {"attn/bk": "attn/bq"}
# (task, fusion, modalities): late fusion runs three encoder passes
CASES = {"early": ("classification", "early", ("vision", "text")),
         "late": ("classification", "late", ("vision", "audio", "text")),
         "retrieval": ("retrieval", "early", ("vision", "text"))}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_run(fusion="early", compress=False):
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, fusion=fusion,
                    compress_uplink=compress, compress_downlink=compress)
    return RunConfig(model=CFG, shape=SHAPES["train_4k"], mpsl=mp,
                     compute_dtype="float32")


def _port_run(fusion="early", compress=False, n=N):
    mp = TMPSLConfig(n_clients=n, trainable_blocks=1, fusion=fusion,
                     compress_uplink=compress, compress_downlink=compress)
    return TRunConfig(model=TCFG, shape=None, mpsl=mp,
                      compute_dtype="float32")


def _jax_trees(case, seed=0):
    task, fusion, mods = CASES[case]
    params, frozen, _ = jsplit.init_mpsl_vit(
        jax.random.PRNGKey(seed), CFG, _jax_run(fusion), modalities=mods,
        n_classes=N_CLASSES, retrieval=task == "retrieval")
    return _np_tree(params), _np_tree(frozen)


def _np_batch(mods, seed, n=N, bn=BN, mask=None):
    rng = np.random.default_rng(seed)
    b = {}
    for m in mods:
        spec = jtok.MODALITIES[m]
        if m == "text":
            b[m] = rng.integers(0, spec.vocab_size, (n, bn) + spec.input_shape)
        else:
            b[m] = rng.standard_normal(
                (n, bn) + jsyn._raw_shape(spec)).astype(np.float32)
    b["labels"] = rng.integers(0, N_CLASSES, (n, bn))
    b["mask"] = (np.ones(n, np.float32) if mask is None
                 else np.asarray(mask, np.float32))
    return b


def _jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
            for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _links(case, mods):
    task, fusion, _ = CASES[case]
    return ["joint"] if task == "classification" and fusion == "early" \
        else list(mods)


def _draws(key, case, mods, d_model=CFG.d_model):
    """The uniforms the JAX loss draws for each link from `key`: every link
    from the same (r_up, r_down), at its own shape."""
    r_up, r_down = jax.random.split(jax.random.fold_in(key, 2))
    tokens = {m: jtok.MODALITIES[m].num_tokens for m in mods}
    tokens["joint"] = sum(tokens.values())
    u = lambda k, t: torch.from_numpy(np.array(jax.random.uniform(
        k, (N, BN, t, d_model))))
    return {link: {"uplink": u(r_up, tokens[link]),
                   "downlink": u(r_down, tokens[link])}
            for link in _links(case, mods)}


def _port_loss(case, compress=False, n=N, **kw):
    task, fusion, mods = CASES[case]
    return mpsl.make_vit_loss(TCFG, _port_run(fusion, compress, n),
                              modalities=mods, task=task,
                              n_classes=N_CLASSES, **kw)


def _port_grads(loss_fn, params, frozen, batch, rng):
    """(loss, metrics, gradients as a tree shaped as `params`)."""
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, metrics, grads = mpsl.value_and_grad(loss_fn, params, frozen,
                                               batch, rng)
    it = iter(grads)
    return loss, metrics, tree.map_(lambda _: next(it), params)


def _scale(path, by_path):
    """The largest element a leaf is held against: its own, or for
    ZERO_GRAD_LEAVES their sibling's."""
    for leaf, sib in ZERO_GRAD_LEAVES.items():
        if path.endswith(leaf):
            path = path[:-len(leaf)] + sib
    return float(by_path[path].abs().max())


def _assert_grads_close(got, want, l2_paths=()):
    """`got` a port tree, `want` the JAX package's: each leaf within tol of
    its largest element (ZERO_GRAD_LEAVES of their sibling's); leaves whose
    path names one of `l2_paths` within ADAPTER_L2_TOL in relative L2."""
    want = bridge.from_repro(_np_tree(want))
    paths = tree.paths(got)
    assert paths == tree.paths(want)
    by_path = dict(zip(paths, tree.leaves(want)))
    for path, g, w in zip(paths, tree.leaves(got), tree.leaves(want)):
        scale = _scale(path, by_path)
        g, w = g.detach().numpy(), w.numpy()
        assert g.shape == w.shape, path
        if any(p in path for p in l2_paths) and not any(
                path.endswith(z) for z in ZERO_GRAD_LEAVES):
            err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            assert err <= ADAPTER_L2_TOL, (path, err)
        else:
            assert np.abs(g - w).max() <= GRAD_TOL * (scale + 1e-30), path


# ---------------------------------------------------------------------------
# the loss and its gradients against the JAX package


@pytest.mark.slow
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_vit_loss_and_grads_match_jax(case, compress):
    task, fusion, mods = CASES[case]
    params, frozen = _jax_trees(case)
    b = _np_batch(mods, seed=3)
    key = jax.random.PRNGKey(5)
    jloss_fn = jmpsl.make_vit_loss(CFG, _jax_run(fusion, compress),
                                   modalities=mods, task=task,
                                   n_classes=N_CLASSES)
    (jl, jmet), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        params, frozen, _jax_batch(b), key)

    rng = _draws(key, case, mods) if compress else 0
    tp, tf = bridge.from_repro(params), bridge.from_repro(frozen)
    loss, met, grads = _port_grads(_port_loss(case, compress), tp, tf,
                                   _torch_batch(b), rng)
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    np.testing.assert_allclose(met["per_client"].numpy(),
                               np.asarray(jmet["per_client"]), rtol=LOSS_TOL)
    _assert_grads_close(grads, jg, l2_paths=("",) if compress else ())
    if "text" in mods:   # the frozen table: exactly zero on both sides
        assert not grads["client"]["tokenizers"]["text"]["embed"].any()
        assert not np.asarray(jg["client"]["tokenizers"]["text"]["embed"]).any()


def test_vit_train_step_matches_jax():
    """One make_train_step each (early fusion, both links int8, the port fed
    JAX's uniforms): loss, grad norm, both Adam moments and the count; the
    frozen text table's moments stay exactly 0 and its update is AdamW's
    decoupled decay alone, as in the reference. Params are held through
    the moments: AdamW's first step is ~sign(g), so where |g| is float
    noise the params differ by 2 lr."""
    params, frozen = _jax_trees("early")
    b = _np_batch(CASES["early"][2], seed=4)
    jrun, trun = _jax_run("early", True), _port_run("early", True)
    jstate = jmpsl.init_state(params, frozen, seed=9)
    jstep = jmpsl.make_train_step(
        jmpsl.make_vit_loss(CFG, jrun, n_classes=N_CLASSES), jrun,
        jsched.constant(1e-3))
    jnew, jmet = jstep(jstate, _jax_batch(b))

    key = jax.random.fold_in(jax.random.PRNGKey(9), 0)
    draws = _draws(key, "early", CASES["early"][2])
    loss_fn = _port_loss("early", compress=True)
    tp, tf = bridge.from_repro(params), bridge.from_repro(frozen)
    state = mpsl.init_state(tp, tf, seed=9)
    step = mpsl.make_train_step(
        lambda p, f, bb, _rng: loss_fn(p, f, bb, draws), trun,
        schedules.constant(1e-3))
    state, met = step(state, _torch_batch(b))
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
        LOSS_TOL * abs(float(jmet["loss"]))
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= \
        GRAD_TOL * float(jmet["grad_norm"])
    for k in ("mu", "nu"):
        want = dict(jnew["opt"][k])
        _assert_grads_close(state["opt"][k], want, l2_paths=("",))
        t = state["opt"][k]["client"]["tokenizers"]["text"]["embed"]
        assert not t.any()
        assert not np.asarray(want["client"]["tokenizers"]["text"]["embed"]
                              ).any()
    assert int(state["opt"]["count"]) == int(jnew["opt"]["count"]) == 1
    table = state["params"]["client"]["tokenizers"]["text"]["embed"]
    jtable = np.asarray(jnew["params"]["client"]["tokenizers"]["text"]["embed"])
    p0 = params["client"]["tokenizers"]["text"]["embed"]
    assert np.abs(jtable - p0).max() > 0         # the decay moved it
    np.testing.assert_array_equal(table.detach().numpy(), jtable)
    moved = [float(np.abs(a - np.asarray(b_)).max()) for a, b_ in zip(
        jax.tree_util.tree_leaves(bridge.to_repro(state["params"])),
        jax.tree_util.tree_leaves(jnew["params"]))]
    assert max(moved) <= 2 * 1e-3 * 1.01


def test_value_and_grad_gives_unused_leaves_zeros():
    """A leaf with no path to the loss gets zeros (not None, not an error):
    the repaired ``value_and_grad``."""
    w = torch.ones(3, requires_grad=True)
    unused = torch.full((2,), 5.0, requires_grad=True)
    params = {"a": w, "b": unused}
    loss, _, grads = mpsl.value_and_grad(
        lambda p, f, b, r: ((p["a"] * 2).sum(), {}), params, None, None, 0)
    assert float(loss) == 6.0
    assert torch.equal(grads[0], torch.full((3,), 2.0))
    assert torch.equal(grads[1], torch.zeros(2))


# ---------------------------------------------------------------------------
# the MPSL properties, on the ViT loss


@pytest.fixture(scope="module")
def port_trees():
    """Three clients' trees for each case, from the port's own init."""
    out = {}
    for case, (task, fusion, mods) in CASES.items():
        g = torch.Generator().manual_seed(1)
        params, frozen, _ = split.init_mpsl_vit(
            g, TCFG, _port_run(fusion, n=3), modalities=mods,
            n_classes=N_CLASSES, retrieval=task == "retrieval")
        out[case] = (params, frozen)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_vit_aggregated_equals_per_client(port_trees, case):
    params, frozen = port_trees[case]
    b = _torch_batch(_np_batch(CASES[case][2], seed=6, n=3, bn=1,
                               mask=[1.0, 0.0, 1.0]))
    loss_fn = _port_loss(case, n=3)
    _, _, g_agg = _port_grads(loss_fn, params, frozen, b, 0)
    g_pc, _, _ = mpsl._per_client_grads(loss_fn, params, frozen, b, 0)
    paths = tree.paths(g_agg)
    by_path = dict(zip(paths, tree.leaves(g_agg)))
    for path, a, c in zip(paths, tree.leaves(g_agg), g_pc):
        scale = _scale(path, by_path) + 1e-8
        assert float((a - c).abs().max()) / scale < 1e-4, path


def test_vit_client_isolation(port_trees):
    """Perturbing client 1's image must not change client 0's or 2's
    tokenizer gradients, bit for bit."""
    params, frozen = port_trees["early"]
    nb = _np_batch(CASES["early"][2], seed=7, n=3, bn=1)
    b1 = _torch_batch(nb)
    b2 = dict(b1, vision=b1["vision"].clone())
    b2["vision"][1] += 0.5
    loss_fn = _port_loss("early", n=3)
    _, _, g1 = _port_grads(loss_fn, params, frozen, b1, 0)
    _, _, g2 = _port_grads(loss_fn, params, frozen, b2, 0)
    for m in ("vision", "text"):
        for k in ("pos", "proj", "cls"):
            if k not in g1["client"]["tokenizers"][m]:
                continue
            a1 = g1["client"]["tokenizers"][m][k]
            a2 = g2["client"]["tokenizers"][m][k]
            assert float((a1[1] - a2[1]).abs().max()) > 0
            assert torch.equal(a1[0], a2[0]) and torch.equal(a1[2], a2[2])


@pytest.mark.parametrize("case", ["early", "late"])
def test_vit_dropped_client_gets_zero_grad(port_trees, case):
    params, frozen = port_trees[case]
    b = _torch_batch(_np_batch(CASES[case][2], seed=8, n=3, bn=1,
                               mask=[1.0, 0.0, 1.0]))
    _, _, g = _port_grads(_port_loss(case, n=3), params, frozen, b, 0)
    for m, tp in g["client"]["tokenizers"].items():
        for k, v in tp.items():
            assert not v[1].any(), (m, k)
            if k != "embed":
                assert v[0].any(), (m, k)


@pytest.mark.slow
def test_retrieval_couples_a_dropped_client_as_jax_does():
    """The contrastive loss is over the GLOBAL batch: a dropped client's
    embeddings still stand in the other clients' denominators, so (as in
    the JAX package) its tokenizers get a gradient; the port's equals the
    reference's."""
    task, fusion, mods = CASES["retrieval"]
    params, frozen = _jax_trees("retrieval")
    b = _np_batch(mods, seed=10, mask=[1.0, 0.0])
    jloss_fn = jmpsl.make_vit_loss(CFG, _jax_run(fusion), modalities=mods,
                                   task=task, n_classes=N_CLASSES)
    jg = jax.grad(lambda p: jloss_fn(p, frozen, _jax_batch(b),
                                     jax.random.PRNGKey(0))[0])(params)
    _, _, grads = _port_grads(_port_loss("retrieval"),
                              bridge.from_repro(params),
                              bridge.from_repro(frozen), _torch_batch(b), 0)
    _assert_grads_close(grads, jg)
    assert grads["client"]["tokenizers"]["vision"]["proj"][1].any()
    assert np.asarray(jg["client"]["tokenizers"]["vision"]["proj"])[1].any()


# ---------------------------------------------------------------------------
# trees and the post-training model


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_mpsl_vit_trees_match_jax(case):
    task, fusion, mods = CASES[case]
    want = _jax_trees(case)
    params, frozen, plan = split.init_mpsl_vit(
        torch.Generator().manual_seed(0), TCFG, _port_run(fusion),
        modalities=mods, n_classes=N_CLASSES, retrieval=task == "retrieval")
    assert plan.boundary == 1
    for got, w in zip((params, frozen), want):
        got = bridge.to_repro(got)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(w)
        for x, y in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(w)):
            assert x.shape == y.shape and x.dtype == y.dtype
    back = bridge.to_repro(bridge.from_repro(want[0]))
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want[0])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.slow
def test_post_training_model_matches_jax():
    """FedAvg the client tokenizers, assemble [F_C_agg ; F_S] and evaluate
    it as a centralized model (paper Sec. 3.3), on both sides."""
    params, frozen = _jax_trees("early", seed=1)
    jplan = jsplit.make_split_plan(CFG, _jax_run().mpsl)
    jfull = jsplit.assemble_full_params(params, frozen, jplan)
    jfull.update(tokenizers=jagg.fedavg_heads(params["client"]["tokenizers"]),
                 task_head=params["server"]["task_head"])
    tp, tf = bridge.from_repro(params), bridge.from_repro(frozen)
    tplan = split.make_split_plan(TCFG, _port_run().mpsl)
    full = split.assemble_full_params(tp, tf, tplan, client_head=None)
    assert sorted(full) == ["final_norm", "segments"]
    body = bridge.to_repro(full)
    for x, y in zip(jax.tree_util.tree_leaves(body["segments"]),
                    jax.tree_util.tree_leaves(_np_tree(jfull["segments"]))):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    full.update(tokenizers=aggregation.fedavg_heads(
                    tp["client"]["tokenizers"]),
                task_head=tp["server"]["task_head"])
    b = _np_batch(("vision", "text"), seed=9, n=1, bn=3)
    batch = {m: b[m][0] for m in ("vision", "text")}
    want = jbase.full_vit_logits(
        jfull, {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i"
                               else v) for k, v in batch.items()}, CFG)
    got = baselines.full_vit_logits(
        full, {k: torch.from_numpy(v) for k, v in batch.items()}, TCFG)
    assert got.shape == (3, N_CLASSES)
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(got.detach().numpy() - np.asarray(want)).max()) <= \
        LOSS_TOL * scale
