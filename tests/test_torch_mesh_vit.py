"""The paper's ViT mode (Meta-Transformer) as an SPMD program on the CPU
(gloo), against the JAX package.

Reduced ViT-Tiny (2 layers, d 64, 4 heads of 16, LayerNorm, tanh GELU,
qkv bias), the last block trainable, at the modalities' published input
shapes (vision 224 x 224 x 3, audio 1024 x 128, text 77 ids), 4 clients x
2 samples, client 1 masked out. One world of 4 ranks runs three meshes:

  * (2, 2) with 4 heads: the attention under ``heads`` (2 a rank), d_ff
    on `model`, every weight's D on `data` (fsdp), the clients on `data`;
  * (2, 2) with 3 heads (d 48): no model axis divides them, so every
    attention weight's D lies on (data, model) (``dboth``) and each rank
    computes every head;
  * (2, 1, 2), (pod, data, model): the clients on (pod, data) flattened,
    4 heads on `model`.

On the two (2, 2) meshes, for early fusion (vision + text, one pass of
274 tokens), late fusion (vision + audio + text: passes of 197, 513 and
77 tokens) and retrieval (vision + text, the symmetric InfoNCE over the
GLOBAL batch), with both links off and on (int8, the port fed the JAX
loss's ``jax.random.uniform`` draws, each rank its clients' rows): the
loss, every gradient (gathered) and, with the links on, one
``make_train_step`` against the JAX ``make_vit_loss`` /
``make_train_step``; on the pod mesh the early case with the links on.
The MPSL properties across ranks: the masked client's tokenizer gradient
is exactly 0 in classification, and in retrieval (its samples stay
negatives of every other sample) non-zero and the JAX coupled gradient;
a client's gradient keeps every bit when a client on the other data rank
changes its image. Each placed leaf's spec is the JAX
``repro.parallel.sharding.param_specs``' on the same mesh record, and
``place_batch`` puts every input on the client axis. Post-training: the
tokenizers FedAvg-ed over the global client axis (the same bits on every
rank), the body assembled from each rank's shards (a cast frozen shard
keeps its spec), and the model's logits, retrieval embeddings and recall
on the batch with its samples on the client axis, against the JAX
``fedavg_heads`` / ``assemble_full_params`` / ``full_vit_logits`` /
``retrieval_embeddings`` / ``recall_at_k``.

The port runs its kernels' plain versions (the kernel route on CPU
tensors); the JAX side runs unsharded (its default attention, its Pallas
quant8 in interpret mode), jitted while the world runs.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import _mesh_workers as W
from repro.configs import MPSLConfig, RunConfig, SHAPES, reduced
from repro.configs.meta_transformer import VIT_TINY
from repro.core import aggregation as jagg
from repro.core import baselines as jbase
from repro.core import losses as jlosses
from repro.core import mpsl as jmpsl
from repro.core import split as jsplit
from repro.data import synthetic as jsyn
from repro.models import tokenizers as jtok
from repro.optim import schedules as jsched
from repro.parallel import sharding as jsharding
from repro_torch.core import split
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh

N, BN, N_CLASSES = 4, 2, 4
MASK = [1.0, 0.0, 1.0, 1.0]
LR = 1e-3
CASES = W.VIT_CASES
# tests/test_torch_vit_mpsl.py's limits: the loss to 1e-5 (relative);
# each gradient leaf to 1e-4 of its largest element, a key bias of its
# layer's query bias's (its gradient is 0 in exact arithmetic: softmax
# is invariant to a shift along a row); under int8 links every leaf in
# relative L2 to 1e-3 (a few elements of the smashed data or the cut-layer
# cotangent, which differ by float noise, round to the neighbouring level)
LOSS_TOL, GRAD_TOL, L2_TOL = 1e-5, 1e-4, 1e-3
ZERO_GRAD_LEAVES = {"attn/bk": "attn/bq"}
# Retrieval's InfoNCE divides its logits by t = 1 / exp(logit_scale), 1 /
# 14.3 at init: an element of the smashed data that rounds to the
# neighbouring level moves the cotangent of every token of its sample
# (the text summary is their mean) ~14x as far as the classification
# head would. Measured at these inputs, in one process against the JAX
# package as on the meshes: text pos 1.12e-3 (3 heads), vision cls
# 1.23e-3 (4 heads: one element of its cls-row cotangent at the
# neighbouring level). So 2e-3 for retrieval under int8.
RETRIEVAL_L2_TOL = 2e-3
# the post-training model: logits and embeddings to 1e-5 of the largest
# |output|; the FedAvg-ed tokenizers to 1e-6 in relative L2 (a mean of 4
# f32 values summed in another order)
POST_TOL, FEDAVG_L2 = 1e-5, 1e-6
# 4 heads: "heads" on a model axis of 2; 3 heads of 16 (d 48): "dboth"
CONFIGS = {"heads": {"arch": "vit-tiny"},
           "dboth": {"arch": "vit-tiny", "d_model": 48, "num_heads": 3,
                     "num_kv_heads": 3}}
MESHES = {"heads": Mesh(("data", "model"), (2, 2)),
          "dboth": Mesh(("data", "model"), (2, 2)),
          "pod": Mesh(("pod", "data", "model"), (2, 1, 2))}
# each mesh's config, and its (case, links on) steps: one AdamW step a
# mesh, early fusion's with the links on
CONFIG_OF = {"heads": "heads", "dboth": "dboth", "pod": "heads"}
STEPS = {"heads": [(c, on) for c in CASES for on in (False, True)],
         "dboth": [(c, on) for c in CASES for on in (False, True)],
         "pod": [("early", True)]}
ADAMW = ("early", True)
POSTS = {"heads": ["early", "retrieval"], "dboth": ["early", "retrieval"],
         "pod": ["early"]}
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def _jcfg(kw):
    kw = {k: v for k, v in kw.items() if k != "arch"}
    return reduced(VIT_TINY, **kw)


def _jrun(cfg, fusion="early", compress=False):
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, fusion=fusion,
                    compress_uplink=compress, compress_downlink=compress)
    return RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                     compute_dtype="float32")


def _init(config, retrieval):
    """The port's init of a config's trees (numpy, the JAX layout): the
    three modalities' tokenizers and the task head, or vision's and
    text's and the retrieval head."""
    cfg = W._config(CONFIGS[config])
    mods = ("vision", "text") if retrieval else ("vision", "audio", "text")
    params, frozen, _ = split.init_mpsl_vit(
        torch.Generator().manual_seed(1), cfg, W._vit_run(cfg, N, "early",
                                                          False),
        modalities=mods, n_classes=N_CLASSES, retrieval=retrieval)
    return W.bridge.to_repro(params), W.bridge.to_repro(frozen)


def _all_trees():
    """{(config, case): (params, frozen)}: early fusion's the late trees
    without the audio tokenizer."""
    out = {}
    for c in CONFIGS:
        late, ret = _init(c, False), _init(c, True)
        toks = late[0]["client"]["tokenizers"]
        early = dict(late[0], client={"tokenizers": {
            m: toks[m] for m in CASES["early"][2]}})
        out.update({(c, "early"): (early, late[1]), (c, "late"): late,
                    (c, "retrieval"): ret})
    return out


def _batch(mods, seed):
    rng = np.random.default_rng(seed)
    b = {}
    for m in mods:
        spec = jtok.MODALITIES[m]
        if m == "text":
            b[m] = rng.integers(0, spec.vocab_size, (N, BN) + spec.input_shape)
        else:
            b[m] = rng.standard_normal(
                (N, BN) + jsyn._raw_shape(spec)).astype(np.float32)
    b["labels"] = rng.integers(0, N_CLASSES, (N, BN))
    b["mask"] = np.asarray(MASK, np.float32)
    return b


def _key():
    """The rng of the JAX step at step 0 of a state seeded 9, which the
    JAX loss is given too."""
    return jax.random.fold_in(jax.random.PRNGKey(9), 0)


def _draws(case, d_model):
    """The uniforms the JAX loss draws from `_key()` for each link (every
    link from the same (r_up, r_down), at its own shape)."""
    task, fusion, mods = CASES[case]
    r_up, r_down = jax.random.split(jax.random.fold_in(_key(), 2))
    tokens = {m: jtok.MODALITIES[m].num_tokens for m in mods}
    tokens["joint"] = sum(tokens.values())
    links = ["joint"] if (task, fusion) == ("classification", "early") \
        else list(mods)
    u = lambda k, t: np.array(jax.random.uniform(k, (N, BN, t, d_model)))
    return {link: {"uplink": u(r_up, tokens[link]),
                   "downlink": u(r_down, tokens[link])} for link in links}


def _inputs():
    trees = _all_trees()
    batches = {k: _batch(CASES[k][2], 3) for k in CASES}
    d = {c: W._config(kw).d_model for c, kw in CONFIGS.items()}
    draws = {(c, k): _draws(k, d[c]) for c in CONFIGS for k in CASES}
    # client 3 (on data rank 1, or pod 1) changes its image
    b1 = _batch(CASES["early"][2], 7)
    b2 = {k: v.copy() for k, v in b1.items()}
    b2["vision"][3] += 0.5
    return trees, batches, draws, (b1, b2)


def _world_args(inputs):
    trees, batches, draws, iso = inputs
    out = []
    for label, mesh in MESHES.items():
        c = CONFIG_OF[label]
        kw = CONFIGS[c]
        steps_ = [(kw, case, N_CLASSES, *trees[(c, case)], batches[case],
                   draws[(c, case)] if on else None,
                   LR if (case, on) == ADAMW else None)
                  for case, on in STEPS[label]]
        props = [] if label == "dboth" else [
            (kw, N_CLASSES, *trees[(c, "early")], list(iso))]
        posts = [(kw, case, N_CLASSES, *trees[(c, case)], batches[case])
                 for case in POSTS[label]]
        out.append((label, mesh, steps_, props, posts))
    return out


def _flat(t, text_rows=True):
    """The leaves of a JAX tree in the port's order (numpy), the text
    table cut as the ranks return it."""
    ptree = W.bridge.from_repro(jax.tree_util.tree_map(np.asarray, t))
    return [np.asarray(x)[:, :W.TEXT_ROWS]
            if text_rows and p.endswith("text/embed") else np.asarray(x)
            for p, x in zip(W.tree.paths(ptree), W.tree.leaves(ptree))]


def _jax_step(config, case, on, trees, batch, draws):
    task, fusion, mods = CASES[case]
    cfg = _jcfg(CONFIGS[config])
    run = _jrun(cfg, fusion, on)
    params, frozen = trees
    loss_fn = jmpsl.make_vit_loss(cfg, run, modalities=mods, task=task,
                                  n_classes=N_CLASSES)
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
          for k, v in batch.items()}
    vg = jax.value_and_grad(loss_fn, has_aux=True)
    if (case, on) != ADAMW:
        (loss, met), grads = jax.jit(vg, compiler_options=FAST_XLA)(
            params, frozen, jb, _key())
        return {"loss": float(loss), "per_client":
                np.asarray(met["per_client"]), "grads": _flat(grads)}
    step = jmpsl.make_train_step(loss_fn, run, jsched.constant(LR))

    def both(state, batch, rng):
        return (vg(state["params"], state["frozen"], batch, rng),
                step(state, batch))

    ((loss, met), grads), (new, smet) = jax.jit(
        both, compiler_options=FAST_XLA)(
            jmpsl.init_state(params, frozen, seed=9), jb, _key())
    return {"loss": float(loss), "per_client": np.asarray(met["per_client"]),
            "grads": _flat(grads), "step_loss": float(smet["loss"]),
            "grad_norm": float(smet["grad_norm"]),
            "params": _flat(new["params"]), "mu": _flat(new["opt"]["mu"]),
            "nu": _flat(new["opt"]["nu"]), "count": int(new["opt"]["count"])}


def _jax_post(config, case, trees, batch):
    task, fusion, mods = CASES[case]
    cfg = _jcfg(CONFIGS[config])
    params, frozen = trees
    plan = jsplit.make_split_plan(cfg, _jrun(cfg, fusion).mpsl)
    full = jsplit.assemble_full_params(params, frozen, plan)
    heads = jagg.fedavg_heads(params["client"]["tokenizers"])
    weighted = jagg.fedavg_heads(params["client"]["tokenizers"],
                                 weights=jnp.asarray(batch["mask"]))
    full["tokenizers"] = heads
    full.update({k: v for k, v in params["server"].items()
                 if k not in ("segments", "final_norm")})
    x = {m: jnp.asarray(batch[m].reshape((N * BN,) + batch[m].shape[2:])
                        .astype(np.int32 if m == "text" else np.float32))
         for m in mods}
    def cut(t):
        return [x[:W.TEXT_ROWS] if p.endswith("text/embed") else x
                for p, x in zip(W.tree.paths(W.bridge.from_repro(t)),
                                _flat(t, text_rows=False))]

    out = {"heads": cut(heads), "weighted": cut(weighted)}
    if task == "retrieval":
        pa, pb = jax.jit(lambda f, x: jbase.retrieval_embeddings(
            f, x, cfg, modalities=mods), compiler_options=FAST_XLA)(full, x)
        out.update(pa=np.asarray(pa), pb=np.asarray(pb),
                   recall_at_1=float(jlosses.recall_at_k(pa, pb, 1)),
                   recall_at_5=float(jlosses.recall_at_k(pa, pb, 5)))
    else:
        out["logits"] = np.asarray(jax.jit(lambda f, x: jbase.full_vit_logits(
            f, x, cfg, modalities=mods, fusion_mode=fusion),
            compiler_options=FAST_XLA)(full, x))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The world's results (spawned on a thread) and the JAX side's,
    computed while the world runs."""
    inputs = _inputs()
    trees, batches, draws, _ = inputs
    port = {}

    def run_world():
        try:
            port["res"] = spmd.spawn(
                W.vit_cases, MESHES["heads"], "cpu", 400,
                args=(_world_args(inputs),),
                workdir=tmp_path_factory.mktemp("vit"))
        except BaseException as e:        # re-raised on the test's thread
            port["err"] = e

    world = threading.Thread(target=run_world)
    world.start()
    try:
        ref = {(c, k, on): _jax_step(c, k, on, trees[(c, k)], batches[k],
                                     draws[(c, k)])
               for c in CONFIGS for k, on in STEPS["heads"]}
        post = {(c, k): _jax_post(c, k, trees[(c, k)], batches[k])
                for c in CONFIGS for k in POSTS["heads"]}
    finally:
        world.join()
    if "err" in port:
        raise port["err"]
    return inputs, port["res"], ref, post


def _paths(results, config, case):
    return W.tree.paths(W.bridge.from_repro(results[0][0][(config, case)][0]))


def _scale(path, by_path):
    for leaf, sib in ZERO_GRAD_LEAVES.items():
        if path.endswith(leaf):
            path = path[:-len(leaf)] + sib
    return float(np.abs(by_path[path]).max())


def _rel_l2(got, want):
    den = float(np.linalg.norm(want)) or 1.0
    return float(np.linalg.norm(np.asarray(got) - want)) / den


def _l2(case, on):
    """The relative L2 limit of a case's gradients: none with the links
    off (held elementwise)."""
    if not on:
        return None
    return RETRIEVAL_L2_TOL if CASES[case][0] == "retrieval" else L2_TOL


def _assert_grads_close(paths, got, want, l2=None):
    """Each leaf of `got` within GRAD_TOL of the largest element of its
    `want` (ZERO_GRAD_LEAVES of their sibling's); with `l2`, each (but
    those) within `l2` in relative L2."""
    by_path = dict(zip(paths, want))
    assert len(got) == len(want) == len(paths)
    for path, g, w in zip(paths, got, want):
        assert g.shape == w.shape, path
        if l2 and not any(path.endswith(z) for z in ZERO_GRAD_LEAVES):
            assert _rel_l2(g, w) <= l2, (path, _rel_l2(g, w))
        else:
            scale = _scale(path, by_path)
            assert np.abs(g - w).max() <= GRAD_TOL * (scale + 1e-30), path


def _steps(results, label):
    """[(case, links on, [each rank's result], the JAX result)]."""
    res, ref = results[1], results[2]
    c = CONFIG_OF[label]
    return [(case, on, [r[label]["steps"][i] for r in res],
             ref[(c, case, on)]) for i, (case, on) in enumerate(STEPS[label])]


@pytest.mark.parametrize("label", list(MESHES))
def test_loss_and_grads_match_jax(results, label):
    for case, on, ranks, want in _steps(results, label):
        paths = _paths(results, CONFIG_OF[label], case)
        for r in ranks:
            assert abs(r["loss"] - want["loss"]) <= \
                LOSS_TOL * abs(want["loss"]), (case, on)
            np.testing.assert_allclose(r["per_client"], want["per_client"],
                                       rtol=LOSS_TOL)
            assert r["participating"] == sum(MASK)
            _assert_grads_close(paths, r["grads"], want["grads"],
                                _l2(case, on))
            # the frozen text table: exactly 0, on every rank's shard
            assert r["text_grad_max"] == 0.0


@pytest.mark.parametrize("label", list(MESHES))
def test_train_step_matches_jax(results, label):
    """One AdamW update (early fusion, links on): the loss, the grad norm
    (each shard
    counted once), both moments, the count; the params within AdamW's
    first step (~sign(g) lr: where |g| is float noise they may step the
    other way); the text table's moments exactly 0."""
    for case, on, ranks, want in _steps(results, label):
        if (case, on) != ADAMW:
            continue
        paths = _paths(results, CONFIG_OF[label], case)
        for r in ranks:
            assert abs(r["step_loss"] - want["step_loss"]) <= \
                LOSS_TOL * abs(want["step_loss"])
            assert abs(r["grad_norm"] - want["grad_norm"]) <= \
                GRAD_TOL * want["grad_norm"]
            assert r["count"] == want["count"] == 1
            for k in ("mu", "nu"):
                _assert_grads_close(paths, r[k], want[k], L2_TOL)
            assert r["text_moments_max"] == 0.0
            moved = max(float(np.abs(a - b).max())
                        for a, b in zip(r["params"], want["params"]))
            assert moved <= 2 * LR * 1.01


@pytest.mark.parametrize("label", list(MESHES))
def test_masked_client_gradient(results, label):
    """Classification: client 1 (masked) gets exactly 0 in every tokenizer
    leaf, the others do not. Retrieval: its samples stay negatives of the
    global InfoNCE, so its gradient is non-zero (and the JAX one, held in
    ``test_loss_and_grads_match_jax``): a per-rank InfoNCE over local
    negatives would give it another."""
    for case, on, ranks, want in _steps(results, label):
        paths = _paths(results, CONFIG_OF[label], case)
        for r in ranks:
            for path, g in zip(paths, r["grads"]):
                if "tokenizers" not in path or path.endswith("text/embed"):
                    continue
                if CASES[case][0] == "classification":
                    assert float(np.abs(g[1]).max()) == 0.0, (case, path)
                else:
                    assert float(np.abs(g[1]).max()) > 0.0, (case, path)
                assert float(np.abs(g[0]).max()) > 0.0, (case, path)


def test_retrieval_loss_is_the_global_infonce(results):
    """The per-client losses of the retrieval case are the global
    batch's: a rank's InfoNCE over its own samples alone (4 of 8) gives
    another loss, by more than the tolerance."""
    trees, batches = results[0][:2]
    _, _, ranks, want = [s for s in _steps(results, "heads")
                         if s[0] == "retrieval" and not s[1]][0]
    for r in ranks:
        np.testing.assert_allclose(r["per_client"], want["per_client"],
                                   rtol=LOSS_TOL)
    # the loss over each data rank's samples alone, in one process
    cfg = W._config(CONFIGS["heads"])
    params, frozen = (W.bridge.from_repro(t) for t in trees[("heads",
                                                             "retrieval")])
    loss_fn = W.mpsl.make_vit_loss(cfg, W._vit_run(cfg, 2, "early", False),
                                   task="retrieval", n_classes=N_CLASSES)
    b = {k: torch.from_numpy(v) for k, v in batches["retrieval"].items()}
    local = []
    for c0 in (0, 2):
        part = {k: v[c0:c0 + 2] for k, v in b.items()}
        mine = dict(params, client={"tokenizers": W.tree.map_(
            lambda p: p[c0:c0 + 2], params["client"]["tokenizers"])})
        _, met = loss_fn(mine, frozen, part, 0)
        local.append(met["per_client"].numpy())
    local = np.concatenate(local)
    assert np.abs(local - want["per_client"]).max() > \
        100 * LOSS_TOL * np.abs(want["per_client"]).max()


@pytest.mark.parametrize("label", ["heads", "pod"])
def test_client_isolation_across_ranks(results, label):
    """Client 3 (on the other data rank, or the other pod) changes its
    image: its tokenizer gradient moves, clients 0, 1 and 2 keep every
    bit."""
    for r in results[1]:
        g1, g2 = r[label]["props"][0]
        assert set(g1) == set(g2) and g1
        for path in g1:
            assert float(np.abs(g1[path][3] - g2[path][3]).max()) > 0, path
            for c in (0, 1, 2):
                np.testing.assert_array_equal(g1[path][c], g2[path][c],
                                              err_msg=path)


@pytest.mark.parametrize("label", list(MESHES))
def test_specs_are_the_rule_tables(results, label):
    """Each placed leaf's spec (params and the frozen tree) is the JAX
    rule table's on the same mesh record (a segment leaf's past its
    stacked layer dim): every tokenizer leaf on the client axis, the text
    table included, the body by the attention and MLP rules, the task
    head, projections and logit scale replicated; ``place_batch`` lays
    every input on the client axis."""
    trees = results[0][0]
    mesh = MESHES[label]
    c = CONFIG_OF[label]
    for i, (case, on) in enumerate(STEPS[label]):
        for which, t in (("specs", trees[(c, case)][0]),
                         ("frozen_specs", trees[(c, case)][1])):
            jspecs = jsharding.param_specs(t, mesh)
            flat = jax.tree_util.tree_flatten_with_path(t)[0]
            sp = jax.tree_util.tree_leaves(
                jspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))
            want = {"/".join(jsharding._path_names(p)): tuple(s)
                    for (p, _), s in zip(flat, sp)}
            paths = W.tree.paths(W.bridge.from_repro(t))
            for r in results[1]:
                got = r[label]["steps"][i][which]
                assert len(got) == len(paths)
                for path, spec in zip(paths, got):
                    parts = path.split("/")
                    if "segments" in parts:
                        j = parts.index("segments")
                        jp = "/".join(parts[:j + 2] + parts[j + 3:])
                        w = want[jp][1:]
                    else:
                        w = want[path]
                    w = tuple(w) + (None,) * (len(spec) - len(w))
                    assert tuple(spec) == w, (label, path, spec, w)
                    if "tokenizers" in parts:
                        assert spec[0] == ("data" if label != "pod"
                                           else ("pod", "data")), path
                    if parts[0] == "server" and parts[1] in (
                            "task_head", "proj_a", "proj_b", "logit_scale"):
                        assert not any(spec), path
                for k, (shape, equal) in r[label]["steps"][i][
                        "placed"].items():
                    assert equal and shape[0] == N // 2, (k, shape)


def test_layouts(results):
    """The attention layouts the meshes give: heads (wq's heads on
    `model`, D on `data`), dboth (wq's D on (data, model)); the pod
    mesh's clients on (pod, data)."""
    paths = _paths(results, "heads", "early")
    i = paths.index("server/segments/0/0/attn/wq")
    for r in results[1]:
        assert r["heads"]["steps"][0]["specs"][i] == ("data", "model", None)
        assert r["dboth"]["steps"][0]["specs"][i] == (("data", "model"),
                                                      None, None)
        assert r["pod"]["steps"][0]["specs"][i] == (None, "model", None)


@pytest.mark.parametrize("label", list(MESHES))
def test_post_training_model_matches_jax(results, label):
    """The FedAvg-ed tokenizers (each leaf within FEDAVG_L2 of the JAX
    mean, and of its mean weighted by the mask; the same bits on every
    rank), the assembled body (each cast
    frozen shard keeps its spec, which a plain ``Tensor.to`` drops), the
    logits, the retrieval embeddings and recall over the global batch."""
    res, post = results[1], results[3]
    c = CONFIG_OF[label]
    for i, case in enumerate(POSTS[label]):
        want = post[(c, case)]
        ranks = [r[label]["posts"][i] for r in res]
        assert len({r["heads_digest"] for r in ranks}) == 1
        for r in ranks:
            assert r["body_specs_kept"]
            assert r["frozen_spec"] is not None
            assert r["plain_cast_spec"] is None
            for k in ("heads", "weighted"):
                assert len(r[k]) == len(want[k])
                for g, w in zip(r[k], want[k]):
                    assert _rel_l2(g, w) <= FEDAVG_L2, k
            for k in ("logits", "pa", "pb"):
                if k in want:
                    assert r[k].shape == want[k].shape
                    scale = float(np.abs(want[k]).max())
                    assert float(np.abs(r[k] - want[k]).max()) <= \
                        POST_TOL * scale, k
            for k in ("recall_at_1", "recall_at_5"):
                if k in want:
                    assert r[k] == want[k], k
            # one all-reduce a tokenizer leaf over the client axis
            axis = "pod+data" if label == "pod" else "data"
            n_leaves = len(r["heads"])
            assert r["fedavg_counts"][f"all_reduce/{axis}"]["calls"] == \
                n_leaves


def test_cast_keeps_a_shards_spec():
    """``Tensor.to`` makes a new tensor without the spec a shard was cut
    by, which the program would then take for a whole weight; the split's
    cast (the frozen tree back to f32 in ``assemble_full_params``) keeps
    it."""
    shard = torch.ones(4, 3, dtype=torch.bfloat16)
    W.C.set_spec(shard, (("data", "model"), None))
    assert W.C.spec_of(shard.to(torch.float32)) is None
    cast = split._cast(shard, torch.float32)
    assert cast.dtype == torch.float32
    assert W.C.spec_of(cast) == (("data", "model"), None)
    ids = torch.ones(3, dtype=torch.int64)
    assert split._cast(ids, torch.float32) is ids
