"""The expert-parallel MoE dispatch as an SPMD program on the CPU (gloo),
against the JAX package's ``shard_map`` ep and the port's one-process ep.

A qwen3-moe-style layer (d_model 64, 8 experts top 2, no shared expert)
over x [2, 16, 64] at capacities 1.0 (experts overflow: slots are
dropped) and 2.0. The port runs ``apply_moe(impl="ep")`` as a program on
the meshes (1, 2) (a world of 2), (1, 4) and (2, 2) (a world of 4): each
rank its tokens (`data`) and its E/m experts (`model`), their partial sums
all-reduced over `model`. Held against:

  * the JAX ``_apply_ep`` under ``shard_map`` on the same meshes of 4
    forced host devices (``--xla_force_host_platform_device_count=4``,
    in a subprocess: this process's JAX has one device);
  * the port in one process: the same mesh as a record
    (``sharding.use_mesh``: every device's share computed and added), and
    the one-device ep where the data axis is 1 (the same capacity, so the
    same drops);
  * ``moe.ep_drop_mask``: each rank's dropped slots are the one-process
    mask's, bitwise.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import _mesh_workers as W
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe
from repro_torch.parallel import sharding

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE_KW = dict(num_experts=8, top_k=2, d_ff_expert=16, num_shared_experts=0,
              d_ff_shared=0)
CAPACITIES = (1.0, 2.0)
MESHES = {2: [Mesh(("data", "model"), (1, 2))],
          4: [Mesh(("data", "model"), (1, 4)), Mesh(("data", "model"), (2, 2))]}
ALL = [m for ms in MESHES.values() for m in ms]
# f32 sums of the same products in other orders (JAX's psum, the port's
# all-reduce, the scatter-add): 2e-5 of the largest element, the JAX
# suite's ep-vs-dense limit
TOL = 2e-5

JAX_EP = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import MoEConfig, get_config, reduced
from repro.models import moe
from repro.parallel import sharding as sh
spec = json.loads(sys.argv[1])
data = dict(np.load(spec["inputs"]))
cfg = reduced(get_config("qwen3-moe-235b-a22b"), moe=MoEConfig(**spec["moe"]))
p = {k: jnp.asarray(data[k]) for k in ("router", "wi", "wg", "wo")}
x = jnp.asarray(data["x"])
out = {}
for d, m in spec["meshes"]:
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))
    for c in spec["capacities"]:
        with sh.use_mesh(mesh):
            y, _ = jax.jit(lambda p, x: moe.apply_moe(
                p, x, cfg, impl="ep", capacity=c))(p, x)
        out[f"{d}x{m}/{c}"] = np.asarray(y)
np.savez(spec["out"], **out)
"""


def _inputs():
    cfg = W.moe_config(MOE_KW)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = np.random.default_rng(0).standard_normal((2, 16, cfg.d_model),
                                                 dtype=np.float32)
    return cfg, W.bridge.to_repro(params), x


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg, params, x = _inputs()
    tmp = tmp_path_factory.mktemp("ep")
    np.savez(tmp / "inputs.npz", x=x, **params)
    spec = {"inputs": str(tmp / "inputs.npz"), "out": str(tmp / "jax.npz"),
            "moe": MOE_KW, "capacities": list(CAPACITIES),
            "meshes": [list(m.axis_sizes) for m in ALL]}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_EP,
                                 json.dumps(spec)], env=env,
                                stderr=subprocess.PIPE, text=True)
    cases = [(MOE_KW, params, x, c) for c in CAPACITIES]
    port = {}
    for world, meshes in MESHES.items():
        res = spmd.spawn(W.ep_cases, meshes[0], "cpu", 120,
                         args=(meshes, cases),
                         workdir=tmp_path_factory.mktemp(f"world{world}"))
        for m in meshes:
            port[m.name] = [r[m.name] for r in res]
    _, err = jax_proc.communicate(timeout=120)
    assert jax_proc.returncode == 0, err[-3000:]
    return cfg, params, x, port, dict(np.load(tmp / "jax.npz"))


def _one_process(cfg, params, x, capacity, mesh=None):
    """The port's ep in one process (under `mesh` as a record), and the
    routing's choices."""
    p = W.bridge.from_repro(params)
    with moe.routing_tape() as tape, torch.no_grad(), \
            sharding.use_mesh(mesh):
        y, _ = moe.apply_moe(p, torch.from_numpy(x), cfg, impl="ep",
                             capacity=capacity)
    return y.numpy(), tape.idx[0]


def _close(got, want, what):
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= TOL, f"{what}: {err:.3g} of the largest element"


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("mesh", ALL, ids=lambda m: m.name)
def test_ep_matches_jax_shard_map(results, mesh, capacity):
    *_, port, jax_out = results
    i = CAPACITIES.index(capacity)
    for rank in port[mesh.name]:
        _close(rank[i]["y"].reshape(jax_out[f"{mesh.name}/{capacity}"].shape),
               jax_out[f"{mesh.name}/{capacity}"], "y vs JAX")


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("mesh", ALL, ids=lambda m: m.name)
def test_ep_matches_one_process(results, mesh, capacity):
    cfg, params, x, port, _ = results
    i = CAPACITIES.index(capacity)
    want, idx = _one_process(cfg, params, x, capacity, mesh)
    shards = mesh.shape["data"]
    drop = moe.ep_drop_mask(idx, cfg.moe.num_experts, capacity, shards)
    if capacity == 1.0:
        assert bool(drop.any()), "capacity 1.0 should drop slots"
    for rank in port[mesh.name]:
        r = rank[i]
        _close(r["y"], want, "y vs the mesh record")
        np.testing.assert_array_equal(r["drop"], drop.numpy())
        # experts on `model`, each rank E / m of them
        assert r["specs"]["wi"][0] == "model"
    if shards == 1:      # the one-device ep: the same capacity and drops
        one, idx1 = _one_process(cfg, params, x, capacity,
                                 Mesh(("data", "model"), (1, 1)))
        assert torch.equal(idx1, idx)
        for rank in port[mesh.name]:
            _close(rank[i]["y"], one, "y vs the one-device ep")
