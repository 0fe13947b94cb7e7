"""The per-client backward baseline (vanilla PSL: one backward pass a
client) as an SPMD program on the CPU (gloo), against the JAX package and
against the aggregated step on the same mesh.

Reduced minitron-4b (2 layers, 4 heads on 2 KV heads, vocab 256), 4
clients x 2 sequences x 12 tokens, client 1 masked out, the last block
trainable, links off and both links int8 (the port fed the JAX loss's
``jax.random.uniform`` draws, each data rank its clients'). Two worlds,
started once for the module: 4 ranks on (2, 2) (clients over `data`;
heads, d_ff and vocab over `model`) and 2 on (1, 2). On each, from the
same state:

  * one ``make_train_step(backward_mode="per_client")`` step against the
    JAX one: the loss, every pass's loss (``per_client``), every gradient
    and the params after the AdamW update;
  * its gradients against the aggregated mode's (one backward of L_S) on
    the same mesh: below 1e-4 of each leaf's largest element with the
    links off (``tests/test_mpsl_equivalence.py``'s limit), 1e-3 in
    relative L2 with int8 links (the downlink rounds each pass's scaled
    cut-layer cotangent);
  * the masked client's adapter gradient exactly 0;
  * the pass count: the step's collectives are N times one aggregated
    forward and backward's, one ``reduce_grads``, the mask's all-gather
    over `data` (the global weights) and the global norm's all-reduce.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import _mesh_workers as W
from repro.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro.core import mpsl as jmpsl
from repro.optim import schedules as jsched
from repro_torch.core import split
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh

CFG_KW = {"num_kv_heads": 2}
N, BN, S = 4, 2, 12
MASK = [1.0, 0.0, 1.0, 1.0]
LR = 1e-3
COMPRESS = (False, True)
MESHES = [Mesh(("data", "model"), (2, 2)), Mesh(("data", "model"), (1, 2))]
# against JAX (tests/test_torch_mesh_step.py): the loss 1e-4 relative,
# every gradient leaf 1e-3 in relative L2
LOSS_TOL, GRAD_L2_TOL = 1e-4, 1e-3
# per-client against aggregated on one mesh, links off: the same sums in
# another order (tests/test_mpsl_equivalence.py)
EQUAL_TOL = 1e-4


def _jrun(compress):
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=compress, compress_downlink=compress)
    return RunConfig(model=reduced(get_config("minitron-4b"), **CFG_KW),
                     shape=SHAPES["train_4k"], mpsl=mp,
                     compute_dtype="float32", attn_impl="naive",
                     ce_impl="jnp")


def _trees():
    """The MPSL trees (the port's init, a nonzero adapter b so that its
    'a' gets a gradient), as the JAX package lays them out."""
    cfg = W.port_config("minitron-4b", **CFG_KW)
    run = W._port_run(cfg, N, True)
    gen = torch.Generator().manual_seed(0)
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run)
    params["client"]["adapter"]["b"].normal_(0.0, 0.05, generator=gen)
    return W.bridge.to_repro(params), W.bridge.to_repro(frozen)


def _batch():
    rng = np.random.default_rng(4)
    return {"tokens": rng.integers(0, 256, (N, BN, S)),
            "labels": rng.integers(0, 256, (N, BN, S)),
            "mask": np.asarray(MASK, np.float32)}


def _jbatch(b):
    return {"tokens": jnp.asarray(b["tokens"], jnp.int32),
            "labels": jnp.asarray(b["labels"], jnp.int32),
            "mask": jnp.asarray(b["mask"])}


def _rng():
    """The rng the JAX step's loss gets at step 0 of a state seeded 9."""
    return jax.random.fold_in(jax.random.PRNGKey(9), 0)


def _draws(d_model):
    """The uniforms the JAX loss draws from ``_rng()``."""
    r_up, r_down = jax.random.split(jax.random.fold_in(_rng(), 1))
    shape = (N, BN, S, d_model)
    return {"uplink": np.array(jax.random.uniform(r_up, shape)),
            "downlink": np.array(jax.random.uniform(r_down, shape))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    params, frozen = _trees()
    batch = _batch()
    cases = [(CFG_KW, params, frozen, batch, _draws(64) if c else None, LR)
             for c in COMPRESS]
    out = {}
    for mesh in MESHES:
        res = spmd.spawn(W.psl_cases, mesh, "cpu", 300, args=([mesh], cases),
                         workdir=tmp_path_factory.mktemp(mesh.name))
        out[mesh.name] = [r[mesh.name] for r in res]
    return (params, frozen, batch), out


def _flat(t):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        W.bridge.from_repro(jax.tree_util.tree_map(np.asarray, t)))]


@pytest.fixture(scope="module")
def jax_steps(worlds):
    params, frozen, batch = worlds[0]
    out = {}
    for compress in COMPRESS:
        run = _jrun(compress)
        loss_fn = jmpsl.make_lm_loss(run.model, run)
        grads, _, _ = jax.jit(lambda p, f, b, r: jmpsl._per_client_grads(
            loss_fn, p, f, b, r))(params, frozen, _jbatch(batch), _rng())
        step = jmpsl.make_train_step(loss_fn, run, jsched.constant(LR),
                                     backward_mode="per_client")
        new, met = jax.jit(step)(jmpsl.init_state(params, frozen, seed=9),
                                 _jbatch(batch))
        out[compress] = {"loss": float(met["loss"]),
                         "per_client": np.asarray(met["per_client"]),
                         "participating": float(met["participating"]),
                         "grads": _flat(grads), "params": _flat(new["params"])}
    return out


def _rel_l2(got, want):
    den = float(np.linalg.norm(want)) or 1.0
    return float(np.linalg.norm(np.asarray(got) - want)) / den


@pytest.mark.parametrize("compress", COMPRESS, ids=["links_off", "int8"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_per_client_step_matches_jax(worlds, jax_steps, mesh, compress):
    """The loss, each pass's loss, every gradient and the params after
    one AdamW update (~lr sign(g): where g is float noise the params may
    differ by 2 lr)."""
    want = jax_steps[compress]
    for rank in worlds[1][mesh.name]:
        r = rank[COMPRESS.index(compress)]
        assert abs(r["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        assert r["per_client"].shape == (N,)
        np.testing.assert_allclose(r["per_client"], want["per_client"],
                                   rtol=LOSS_TOL, atol=0)
        assert r["participating"] == want["participating"] == sum(MASK)
        assert len(r["grads"]) == len(want["grads"])
        for i, (g, w) in enumerate(zip(r["grads"], want["grads"])):
            assert _rel_l2(g, w) <= GRAD_L2_TOL, f"gradient leaf {i}"
        moved = max(float(np.abs(a - b).max())
                    for a, b in zip(r["params"], want["params"]))
        assert moved <= 2 * LR * 1.01


@pytest.mark.parametrize("compress", COMPRESS, ids=["links_off", "int8"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_per_client_equals_aggregated(worlds, mesh, compress):
    for rank in worlds[1][mesh.name]:
        r = rank[COMPRESS.index(compress)]
        for i, (a, b) in enumerate(zip(r["agg_grads"], r["grads"])):
            if compress:
                assert _rel_l2(b, a) <= GRAD_L2_TOL, f"gradient leaf {i}"
            else:
                scale = float(np.abs(a).max()) + 1e-8
                assert float(np.abs(a - b).max()) / scale < EQUAL_TOL, \
                    f"gradient leaf {i}"


@pytest.mark.parametrize("compress", COMPRESS, ids=["links_off", "int8"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_masked_client_adapter_gradient_is_zero(worlds, mesh, compress):
    paths = W.tree.paths(W.bridge.from_repro(worlds[0][0]))
    for rank in worlds[1][mesh.name]:
        grads = dict(zip(paths, rank[COMPRESS.index(compress)]["grads"]))
        for k in ("a", "b"):
            g = grads[f"client/adapter/{k}"]
            assert float(np.abs(g[1]).max()) == 0.0
            assert float(np.abs(g[0]).max()) > 0.0


@pytest.mark.parametrize("compress", COMPRESS, ids=["links_off", "int8"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: m.name)
def test_pass_count(worlds, mesh, compress):
    """N forward and backward passes: the step's collectives are N times
    one aggregated ``value_and_grad``'s, plus one ``reduce_grads``, the
    mask's all-gather over `data` and the global norm's all-reduce."""
    d = mesh.shape["data"]
    for rank in worlds[1][mesh.name]:
        c = rank[COMPRESS.index(compress)]["counts"]
        want = {k: N * v for k, v in c["value_and_grad"].items()}
        for k, v in c["reduce_grads"].items():
            want[k] = want.get(k, 0) + v
        if d > 1:
            want["all_gather/data"] += 1
        want["all_reduce/world"] = 1
        assert c["step"] == want
        assert c["value_and_grad"]          # the mesh moves data each pass
