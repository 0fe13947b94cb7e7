"""The SPMD program's layouts and layers on the CPU (gloo), against the
rule table, the one-process results and the JAX package.

Two worlds, started once for the module (``launch.spmd.spawn``, a
``file://`` rendezvous under the test's tmp directory): 2 ranks on the
meshes (2, 1) and (1, 2), 4 ranks on (2, 2) and (1, 4). Each case reads
their results:

  * ``sharding.shard_tree`` / ``gather_tree`` of every leaf of reduced
    minitron-4b, qwen2-moe-a2.7b and hymba-1.5b: each shard's shape is
    ``sharding.shard_shape`` of its spec, and the gathered tree is the
    whole one, bitwise;
  * the autograd pairs of ``parallel.collectives`` (``copy_to``,
    ``reduce_from``, ``gather_from``): values and gradients;
  * a dense block (heads, d_ff on `model`) forward and backward against
    the JAX ``apply_block`` (its Pallas flash in interpret mode);
  * the vocab-parallel CE (the plain versions on each rank's V/m
    columns, labels in and out of the shard) against the JAX
    ``ops.softmax_xent_tokens`` in interpret mode;
  * quant8 with ``row0``: each data rank's clients of the stacked link
    activations through both links, bitwise the one call over all rows.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import _mesh_workers as W
from repro.configs import get_config, reduced
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.core import compression
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM
from repro_torch.parallel import sharding

MESHES = {2: [Mesh(("data", "model"), (2, 1)), Mesh(("data", "model"), (1, 2))],
          4: [Mesh(("data", "model"), (2, 2)), Mesh(("data", "model"), (1, 4))]}
# the dense block's reduced minitron-4b: 4 heads on 2 KV heads (G 2), so
# both divide the model axis of 2
CFG_KW = {"num_kv_heads": 2}
# JAX (Pallas, interpret mode) and the port (plain versions, its sums over
# `model` in another order) through one block: 1e-5 of the largest element
BLOCK_TOL = 1e-5
# the CE: tests/test_kernel_grads.py's limits (loss 1e-5, gradients 2e-4)
CE_TOL, CE_GRAD_TOL = 1e-5, 2e-4
B, S = 2, 8
T, D, V = 24, 32, 96


def _trees():
    """The JAX package's layout of each arch's params (the port's init,
    through the bridge: eager JAX inits of three models take ~20 s)."""
    return {arch: W.bridge.to_repro(TM.init_lm(
                W.port_config(arch), torch.Generator().manual_seed(0)))
            for arch in ("minitron-4b", "qwen2-moe-a2.7b", "hymba-1.5b")}


def _block_inputs():
    cfg = reduced(get_config("minitron-4b"), **CFG_KW)
    gen = torch.Generator().manual_seed(3)
    params = TM.init_block(gen, W.port_config("minitron-4b", **CFG_KW),
                           TM.BlockKind("dense"))
    # nonzero norm scales and biases: their gradients are checked too
    for k in ("norm1", "norm2"):
        for leaf in params[k].values():
            leaf.normal_(0.0, 0.1, generator=gen)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    cot = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    pos = np.asarray(JL.positions_from_shape(B, S))
    return cfg, W.bridge.to_repro(params), x, pos, cot


def _ce_inputs():
    rng = np.random.default_rng(7)
    h = rng.standard_normal((T, D), dtype=np.float32) * 0.5
    w = rng.standard_normal((D, V), dtype=np.float32) * 0.1
    labels = rng.integers(0, V, T).astype(np.int32)
    g = rng.standard_normal(T, dtype=np.float32)
    return h, w, labels, g


def _quant_inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 2, 6, 20), dtype=np.float32)
    g = rng.standard_normal((4, 2, 6, 20), dtype=np.float32)
    return x, g, 1234


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{mesh name: [each rank's results]}."""
    trees = _trees()
    _, block_np, x, pos, cot = _block_inputs()
    args = ((CFG_KW, block_np, x, pos, cot), _ce_inputs(), _quant_inputs())
    out = {}
    for world, meshes in MESHES.items():
        res = spmd.spawn(W.layer_cases, meshes[0], "cpu", 120,
                         args=(meshes, trees, *args),
                         workdir=tmp_path_factory.mktemp(f"world{world}"))
        for m in meshes:
            out[m.name] = [r[m.name] for r in res]
    return trees, out


ALL = [m for ms in MESHES.values() for m in ms]


@pytest.mark.parametrize("mesh", ALL, ids=lambda m: m.name)
@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2-moe-a2.7b",
                                  "hymba-1.5b"])
def test_shard_gather_round_trip(worlds, mesh, arch):
    trees, out = worlds
    leaves = jax.tree_util.tree_leaves(W.bridge.from_repro(trees[arch]))
    specs = None
    for rank in out[mesh.name]:
        trip = rank["trip"][arch]
        assert trip["equal"], "gather_tree(shard_tree(t)) != t"
        specs = specs or trip["specs"]
        assert trip["specs"] == specs          # every rank, one layout
        for leaf, shape, spec in zip(leaves, trip["shapes"], trip["specs"]):
            assert shape == sharding.shard_shape(leaf.shape, spec, mesh)
    # something lies on each axis of size > 1
    on = {a for sp in specs for e in sp if e
          for a in ((e,) if isinstance(e, str) else e)}
    assert {a for a, n in mesh.shape.items() if n > 1} <= on


@pytest.mark.parametrize("mesh", ALL, ids=lambda m: m.name)
def test_autograd_pairs(worlds, mesh):
    _, out = worlds
    for rank in out[mesh.name]:
        for axis, r in rank["pairs"].items():
            n, i = r["n"], r["i"]
            # copy_to: identity forward, its gradient summed over the axis
            np.testing.assert_array_equal(r["copy_grad"],
                                          np.full(3, n * (n + 1) / 2))
            # reduce_from: the sum forward, the identity backward
            np.testing.assert_array_equal(r["reduce"],
                                          np.full(3, n * (n + 1) / 2))
            np.testing.assert_array_equal(r["reduce_grad"], np.ones(3))
            # gather_from: the ranks' parts in coordinate order; the
            # gradient reduce-scattered (every rank holds the same w)
            want = np.concatenate([np.arange(6.).reshape(2, 3) + 10 * j
                                   for j in range(n)])
            np.testing.assert_array_equal(r["gather"], want)
            w = np.arange(2. * n * 3).reshape(2 * n, 3)
            np.testing.assert_array_equal(r["gather_grad"],
                                          n * w[2 * i:2 * i + 2])


def _close(got, want, tol, what):
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of the largest element"


@pytest.mark.parametrize("mesh", [m for m in ALL if m.shape["data"] == 1
                                  and m.shape["model"] == 2],
                         ids=lambda m: m.name)
def test_dense_block_matches_jax(worlds, mesh):
    cfg, params, x, pos, cot = _block_inputs()

    def f(p, x):
        y, _, _ = JM.apply_block(p, x, cfg, JM.BlockKind("dense"),
                                 positions=jnp.asarray(pos),
                                 impls={"attn": "pallas"})
        return y

    y, vjp = jax.vjp(f, params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    want = jax.tree_util.tree_leaves(W.bridge.from_repro(
        jax.tree_util.tree_map(np.asarray, gp)))
    for rank in out_ranks(worlds, mesh):
        b = rank["block"]
        _close(b["y"], y, BLOCK_TOL, "y")
        _close(b["dx"], gx, BLOCK_TOL, "dx")
        assert len(b["grads"]) == len(want)
        for i, (g, w) in enumerate(zip(b["grads"], want)):
            _close(g, w.numpy(), BLOCK_TOL, f"param grad {i}")


def out_ranks(worlds, mesh):
    return worlds[1][mesh.name]


@pytest.mark.parametrize("mesh", [m for m in ALL if m.shape["data"] == 1
                                  and m.shape["model"] > 1],
                         ids=lambda m: m.name)
def test_vocab_parallel_ce_matches_jax(worlds, mesh):
    h, w, labels, g = _ce_inputs()

    def f(h, w):
        return jops.softmax_xent_tokens(h, w, jnp.asarray(labels),
                                        block_t=8, block_v=32)

    loss, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(w))
    dh, dw = vjp(jnp.asarray(g))
    v_loc = V // mesh.shape["model"]
    # every rank's shard holds some labels and misses others
    assert ((labels < v_loc).any() and (labels >= v_loc).any())
    for rank in out_ranks(worlds, mesh):
        ce = rank["ce"]
        assert ce["spec"] == (None, "model")
        np.testing.assert_allclose(ce["loss"], np.asarray(loss),
                                   atol=CE_TOL, rtol=CE_TOL)
        for name, got, ref in (("dh", ce["dh"], dh), ("dw", ce["dw"], dw)):
            np.testing.assert_allclose(got, np.asarray(ref),
                                       atol=CE_GRAD_TOL, rtol=CE_GRAD_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("mesh", [m for m in ALL if m.shape["data"] > 1],
                         ids=lambda m: m.name)
def test_quant8_row0_is_the_stacked_call(worlds, mesh):
    x, g, seed = _quant_inputs()
    tx = torch.from_numpy(x).requires_grad_()
    up = compression.compress_activations(
        tx, torch.Generator().manual_seed(seed))
    down = compression.compress_gradients(
        tx, torch.Generator().manual_seed(seed + 1))
    down.backward(torch.from_numpy(g))
    for rank in out_ranks(worlds, mesh):
        np.testing.assert_array_equal(rank["quant"]["up"],
                                      up.detach().numpy())
        np.testing.assert_array_equal(rank["quant"]["down"],
                                      tx.grad.numpy())
    # and the rows do depend on row0: a data rank's rows drawn at row0 0
    # are other bits
    half = torch.from_numpy(x[2:])
    alone = compression.compress_activations(
        half, torch.Generator().manual_seed(seed))
    assert not torch.equal(alone, up.detach()[2:])
