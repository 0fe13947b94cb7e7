"""The port's MPSL train step against the JAX package, on the CPU.

Reduced minitron-4b (2 layers, d_model 64, vocab 256), 3 clients x 2
sequences x 12 tokens, the last block trainable. The JAX package builds
the ``init_mpsl_lm`` trees; the bridge carries them over bitwise; both
compute the loss and every gradient on the same bits (JAX through its
Pallas kernels in interpret mode, the port through its kernels' plain
versions), with the links' compression off and on (the port fed
``jax.random.uniform``'s draws). Then the optimizer, the schedule, the
loader, the bridge of the MPSL and AdamW trees, the five MPSL properties
of ``tests/test_mpsl_equivalence.py`` in the port, and the train CLI."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import optim as joptim
from repro.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro.core import mpsl as jmpsl
from repro.core import split as jsplit
from repro.data import ClientLoader as JClientLoader
from repro.data import dirichlet_partition as jpartition
from repro.launch import train as jtrain
from repro.optim import schedules as jsched
from repro_torch import bridge, tree
from repro_torch.configs import MPSLConfig as TMPSLConfig
from repro_torch.configs import RunConfig as TRunConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.core import mpsl, split
from repro_torch.data import ClientLoader, dirichlet_partition
from repro_torch.launch import serve, train
from repro_torch.optim import adamw, schedules

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, BN, S = 3, 2, 12
# JAX (Pallas, interpret mode) and the port (plain versions) sum the same
# f32 products in other orders through 2 layers: loss to 1e-5; each
# gradient leaf to 1e-4 of its largest element
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# Under downlink compression the cut-layer cotangent, which differs by
# float noise, is quantized: a few elements round to the neighbouring int8
# level, so the adapter gradients are held in relative L2 norm
ADAPTER_L2_TOL = 1e-3


def _jax_run(compress, arch="minitron-4b", **kw):
    cfg = reduced(get_config(arch))
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=compress, compress_downlink=compress)
    return cfg, RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                          compute_dtype="float32", attn_impl="pallas",
                          ce_impl="pallas", **kw)


def _port_run(compress, arch="minitron-4b", **kw):
    cfg = treduced(tget_config(arch))
    mp = TMPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                     compress_uplink=compress, compress_downlink=compress)
    return cfg, TRunConfig(model=cfg, shape=None, mpsl=mp,
                           compute_dtype="float32", attn_impl="kernel",
                           ce_impl="kernel", **kw)


def _np_batch(cfg, seed, n=N, bn=BN, s=S, mask=None):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (n, bn, s)),
            "labels": rng.integers(0, cfg.vocab_size, (n, bn, s)),
            "mask": (np.ones(n, np.float32) if mask is None
                     else np.asarray(mask, np.float32))}


def _jax_batch(b):
    return {"tokens": jnp.asarray(b["tokens"], jnp.int32),
            "labels": jnp.asarray(b["labels"], jnp.int32),
            "mask": jnp.asarray(b["mask"])}


def _torch_batch(b):
    return {"tokens": torch.from_numpy(b["tokens"]),
            "labels": torch.from_numpy(b["labels"]),
            "mask": torch.from_numpy(b["mask"])}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def jax_trees():
    cfg, run = _jax_run(False)
    params, frozen, _ = jsplit.init_mpsl_lm(jax.random.PRNGKey(0), cfg, run)
    # a nonzero adapter b, so the adapter's 'a' gets a gradient too
    params["client"]["adapter"]["b"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(1), params["client"]["adapter"]["b"].shape)
    return _np_tree(params), _np_tree(frozen)


def _port_trees(jax_trees):
    params, frozen = jax_trees
    return bridge.from_repro(params), bridge.from_repro(frozen)


def _port_grads(loss_fn, params, frozen, batch, rng):
    """(loss, metrics, gradients as a tree shaped as `params`)."""
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, frozen, batch, rng)
    grads = iter(torch.autograd.grad(loss, tree.leaves(params)))
    return loss.detach(), metrics, tree.map_(lambda _: next(grads), params)


def _assert_trees_close(got, want, tol, l2_paths=()):
    """Each leaf within tol of its largest element; leaves whose path
    names one of `l2_paths` within ADAPTER_L2_TOL in relative L2 norm."""
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


# ---------------------------------------------------------------------------
# the loss and its gradients against the JAX package


@pytest.mark.parametrize("compress", [False, True])
def test_loss_and_grads_match_jax(jax_trees, compress):
    jcfg, jrun = _jax_run(compress)
    tcfg, trun = _port_run(compress)
    b = _np_batch(jcfg, seed=3)
    key = jax.random.PRNGKey(5)
    jloss_fn = jmpsl.make_lm_loss(jcfg, jrun)
    (jl, jmet), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        *jax_trees, _jax_batch(b), key)

    rng = 0
    if compress:        # the draws the JAX loss makes from `key`
        r_up, r_down = jax.random.split(jax.random.fold_in(key, 1))
        shape = (N, BN, S, tcfg.d_model)
        rng = {"uplink": torch.from_numpy(np.array(
                   jax.random.uniform(r_up, shape))),
               "downlink": torch.from_numpy(np.array(
                   jax.random.uniform(r_down, shape)))}
    params, frozen = _port_trees(jax_trees)
    loss, met, grads = _port_grads(mpsl.make_lm_loss(tcfg, trun), params,
                                   frozen, _torch_batch(b), rng)
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    np.testing.assert_allclose(met["per_client"].numpy(),
                               np.asarray(jmet["per_client"]), rtol=LOSS_TOL)
    _assert_trees_close(grads, jg, GRAD_TOL,
                        l2_paths=("'adapter'",) if compress else ())


def test_train_step_matches_jax(jax_trees):
    """One make_train_step each (compression on, the port fed JAX's
    uniforms): loss, grad norm, both Adam moments and the count. Params
    are held through the moments: AdamW's first step is ~sign(g), so
    where |g| is float noise the params differ by 2 lr."""
    jcfg, jrun = _jax_run(True)
    tcfg, trun = _port_run(True)
    b = _np_batch(jcfg, seed=4)
    params, frozen = jax_trees
    jstate = jmpsl.init_state(params, frozen, seed=9)
    jstep = jmpsl.make_train_step(jmpsl.make_lm_loss(jcfg, jrun), jrun,
                                  jsched.constant(1e-3))
    jnew, jmet = jstep(jstate, _jax_batch(b))

    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 0), 1)
    r_up, r_down = jax.random.split(key)
    shape = (N, BN, S, tcfg.d_model)
    draws = {"uplink": torch.from_numpy(np.array(
                 jax.random.uniform(r_up, shape))),
             "downlink": torch.from_numpy(np.array(
                 jax.random.uniform(r_down, shape)))}
    loss_fn = mpsl.make_lm_loss(tcfg, trun)
    tparams, tfrozen = _port_trees(jax_trees)
    state = mpsl.init_state(tparams, tfrozen, seed=9)
    step = mpsl.make_train_step(
        lambda p, f, bb, _rng: loss_fn(p, f, bb, draws), trun,
        schedules.constant(1e-3))
    state, met = step(state, _torch_batch(b))
    assert state["step"] == 1
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
        LOSS_TOL * abs(float(jmet["loss"]))
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= \
        GRAD_TOL * float(jmet["grad_norm"])
    for k in ("mu", "nu"):
        _assert_trees_close(state["opt"][k], jnew["opt"][k], 2 * GRAD_TOL,
                            l2_paths=("'adapter'",))
    assert int(state["opt"]["count"]) == int(jnew["opt"]["count"]) == 1
    moved = [float((a - np.asarray(b_)).__abs__().max()) for a, b_ in zip(
        jax.tree_util.tree_leaves(bridge.to_repro(state["params"])),
        jax.tree_util.tree_leaves(jnew["params"]))]
    assert max(moved) <= 2 * 1e-3 * 1.01


# ---------------------------------------------------------------------------
# optimizer and schedule against the JAX package


def _grad_like(tree_np, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.1,
        tree_np)


def test_adamw_and_clip_match_jax(jax_trees):
    params = jax_trees[0]
    jparams, jopt = params, joptim.adamw_init(params)
    tparams = bridge.from_repro(params)
    topt = adamw.adamw_init(tparams)
    for step in range(2):
        g = _grad_like(params, step)
        jg, jnorm = joptim.clip_by_global_norm(g, 1.0)
        upd, jopt = joptim.adamw_update(jg, jopt, jparams, lr=1e-3,
                                        weight_decay=0.01)
        jparams = joptim.apply_updates(jparams, upd)

        tg = bridge.from_repro(g)
        leaves = tree.leaves(tg)
        _, tnorm = adamw.clip_by_global_norm(leaves, 1.0)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        _assert_trees_close(tg, jg, 1e-6)
        adamw.adamw_update(leaves, topt, tree.leaves(tparams),
                           lr=torch.tensor(1e-3), weight_decay=0.01)
        _assert_trees_close(tg, upd, 1e-5)
        adamw.apply_updates(tree.leaves(tparams), leaves)
    for k in ("mu", "nu"):
        _assert_trees_close(topt[k], jopt[k], 1e-6)
    assert int(topt["count"]) == int(jopt["count"]) == 2
    _assert_trees_close(tparams, jparams, 1e-6)


def test_clip_leaves_small_grads_alone():
    g = [torch.full((3,), 0.1), torch.full((2, 2), -0.2)]
    want = [x.clone() for x in g]
    _, norm = adamw.clip_by_global_norm(g, 10.0)
    assert all(torch.equal(a, b) for a, b in zip(g, want))
    assert abs(float(norm) - float(np.sqrt(3 * 0.01 + 4 * 0.04))) < 1e-6


@pytest.mark.parametrize("step", [0, 5, 10, 49, 50])
def test_schedules_match_jax(step):
    want = float(jsched.warmup_cosine(3e-4, 10, 50)(step))
    got = float(schedules.warmup_cosine(3e-4, 10, 50)(step))
    assert got == pytest.approx(want, rel=1e-6, abs=0.0)
    assert float(schedules.constant(3e-4)(step)) == \
        float(jsched.constant(3e-4)(step))


# ---------------------------------------------------------------------------
# data and bridge


def test_loader_batches_bitwise_equal_to_jax():
    cfg = reduced(get_config("minitron-4b"))
    want = jtrain.make_lm_loader(cfg, 4, 2, 24, seed=3, drop_prob=0.3)
    got = train.make_lm_loader(cfg, 4, 2, 24, seed=3, drop_prob=0.3)
    for step in range(3):
        a, b = got.batch(step), want.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    labels = np.random.default_rng(0).integers(0, 5, 200)
    for x, y in zip(dirichlet_partition(labels, 4, seed=1, min_per_client=3),
                    jpartition(labels, 4, seed=1, min_per_client=3)):
        np.testing.assert_array_equal(x, y)
    ds = jtrain.SyntheticLM(vocab_size=64, seq_len=8, seed=2)
    a = ClientLoader(train.SyntheticLM(vocab_size=64, seq_len=8, seed=2),
                     [np.arange(10), np.arange(10, 30)], 3, seed=1)
    b = JClientLoader(ds, [np.arange(10), np.arange(10, 30)], 3, seed=1)
    for k, v in a.batch(7).items():
        np.testing.assert_array_equal(v, b.batch(7)[k])


def _bitwise(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_bridge_round_trips_mpsl_and_adamw_trees(jax_trees):
    params, frozen = jax_trees
    g = _grad_like(params, 0)
    _, opt = joptim.adamw_update(g, joptim.adamw_init(params), params,
                                 lr=1e-3)
    opt = _np_tree(opt)
    port = [bridge.from_repro(t) for t in (params, frozen, opt)]
    assert port[0]["client"]["adapter"]["a"].shape[0] == N      # stacked
    assert port[1]["segments"][0][0]["attn"]["wq"].dtype == torch.bfloat16
    assert len(port[0]["server"]["segments"][0]) == 1
    for t, p in zip((params, frozen, opt), port):
        _bitwise(bridge.to_repro(p), t)


def test_port_init_matches_jax_layout(jax_trees):
    tcfg, trun = _port_run(False)
    params, frozen, plan = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), tcfg, trun)
    assert plan.boundary == 1
    for got, want in zip((params, frozen), jax_trees):
        gl, gdef = jax.tree_util.tree_flatten(bridge.to_repro(got))
        wl, wdef = jax.tree_util.tree_flatten(want)
        assert gdef == wdef
        assert [(x.shape, x.dtype) for x in gl] == \
            [(x.shape, x.dtype) for x in wl]


def test_assembled_params_match_jax_and_serve(jax_trees):
    jcfg, jrun = _jax_run(False)
    plan = jsplit.make_split_plan(jcfg, jrun.mpsl)
    want = jsplit.assemble_full_params(*jax_trees, plan)
    tcfg, trun = _port_run(False)
    tplan = split.make_split_plan(tcfg, trun.mpsl)
    got = split.assemble_full_params(*_port_trees(jax_trees), tplan)
    _bitwise(bridge.to_repro(got), _np_tree(want))
    prefill, _ = serve.build_serving_fns(tcfg, device="cpu")
    logits, _ = prefill(got, torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 1, tcfg.vocab_size)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the MPSL properties in the port (tests/test_mpsl_equivalence.py)


@pytest.fixture(scope="module")
def port_setup():
    cfg, run = _port_run(False)
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), cfg, run)
    params["client"]["adapter"]["b"] = 0.05 * torch.randn(
        params["client"]["adapter"]["b"].shape,
        generator=torch.Generator().manual_seed(1))
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return cfg, run, params, frozen, mpsl.make_lm_loss(cfg, run)


@pytest.mark.parametrize("mask", [[1, 1, 1], [1, 0, 1]])
def test_aggregated_equals_per_client(port_setup, mask):
    cfg, run, params, frozen, loss_fn = port_setup
    batch = _torch_batch(_np_batch(cfg, seed=11, mask=mask))
    _, _, g_agg = mpsl.value_and_grad(loss_fn, params, frozen, batch, 0)
    g_pc, _, _ = mpsl._per_client_grads(loss_fn, params, frozen, batch, 0)
    for a, b in zip(g_agg, g_pc):
        scale = float(a.abs().max()) + 1e-8
        assert float((a - b).abs().max()) / scale < 1e-4


def test_client_isolation_is_bitwise(port_setup):
    cfg, run, params, frozen, loss_fn = port_setup
    b1 = _np_batch(cfg, seed=12)
    b2 = {k: v.copy() for k, v in b1.items()}
    b2["tokens"][1] = (b2["tokens"][1] + 7) % cfg.vocab_size
    grads = []
    for b in (b1, b2):
        _, _, g = _port_grads(loss_fn, params, frozen, _torch_batch(b), 0)
        grads.append(g["client"]["adapter"]["b"])
    assert float((grads[0][1] - grads[1][1]).abs().max()) > 0
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][2], grads[1][2])


def test_dropped_client_gets_zero_grad(port_setup):
    cfg, run, params, frozen, loss_fn = port_setup
    batch = _torch_batch(_np_batch(cfg, seed=13, mask=[1, 0, 1]))
    _, _, g = _port_grads(loss_fn, params, frozen, batch, 0)
    for k in ("a", "b"):
        assert float(g["client"]["adapter"][k][1].abs().max()) == 0.0
        assert float(g["client"]["adapter"][k][0].abs().max()) > 0.0


def test_weight_renormalization_on_dropout(port_setup):
    """With the same data and the same (identity, as at init) adapter for
    every client, dropping one renormalizes w_n = 1/(N-1): the loss is the
    mean over the participants, not scaled down."""
    cfg, run, params, frozen, loss_fn = port_setup
    params = dict(params, client={"adapter": dict(
        params["client"]["adapter"],
        b=torch.zeros_like(params["client"]["adapter"]["b"]))})
    b = _np_batch(cfg, seed=14)
    for k in ("tokens", "labels"):
        b[k] = np.broadcast_to(b[k][:1], b[k].shape).copy()
    with torch.no_grad():
        full, _ = loss_fn(params, frozen, _torch_batch(b), 0)
        b["mask"] = np.array([1, 0, 1], np.float32)
        drop, _ = loss_fn(params, frozen, _torch_batch(b), 0)
    assert abs(float(full) - float(drop)) < 1e-5


@pytest.mark.parametrize("mu", [2, 4])
def test_microbatching_preserves_loss_and_grads(port_setup, mu):
    cfg, run, params, frozen, loss_fn = port_setup
    batch = _torch_batch(_np_batch(cfg, seed=15, bn=4))
    l1, _, g1 = mpsl._grad_agg(loss_fn, params, frozen, batch, 0, 1)
    lm, met, gm = mpsl._grad_agg(loss_fn, params, frozen, batch, 0, mu)
    assert abs(float(l1) - float(lm)) < 1e-4
    assert abs(float(met["loss"]) - float(lm)) < 1e-6
    for a, b in zip(g1, gm):
        assert float((a - b).abs().max()) <= 1e-4 * (float(a.abs().max())
                                                     + 1e-8)


def test_guard_nonfinite_keeps_state_bitwise(port_setup):
    cfg, run, params, frozen, loss_fn = port_setup
    p = tree.map_(lambda t: t.detach().clone(), params)
    state = mpsl.init_state(p, frozen)
    step = mpsl.make_train_step(loss_fn, run, schedules.constant(1e-2),
                                guard_nonfinite=True)
    state, met = step(state, _torch_batch(_np_batch(cfg, seed=16)))
    assert float(met["skipped"]) == 0.0
    before = [t.clone() for t in tree.leaves(state["params"])
              + tree.leaves(state["opt"])]
    bad = _np_batch(cfg, seed=17, mask=[1, np.nan, 1])
    state, met = step(state, _torch_batch(bad))
    assert float(met["skipped"]) == 1.0 and float(met["participating"]) == 0
    assert state["step"] == 2 and int(state["opt"]["count"]) == 1
    after = tree.leaves(state["params"]) + tree.leaves(state["opt"])
    assert all(torch.equal(a, b) for a, b in zip(before, after))


# ---------------------------------------------------------------------------
# the train CLI


def test_train_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--seq", "24"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    losses = summary["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
