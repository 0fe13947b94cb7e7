"""Parameter bridge between the JAX package and the PyTorch port: round
trips are bitwise, in f32 and bf16, and the port's own init builds the
same tree (structure, shapes, dtypes) as the JAX package's."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config, reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

DENSE_ARCHS = ["minitron-4b", "qwen1.5-110b", "command-r-plus-104b"]


def _flat(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return [np.asarray(x) for x in leaves], treedef


def _assert_bitwise(a, b):
    la, ta = _flat(a)
    lb, tb = _flat(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_bitwise(arch, dtype):
    cfg = reduced(get_config(arch))
    params = JM.init_lm(jax.random.PRNGKey(0), cfg)
    if dtype == "bfloat16":
        params = JL.cast_tree(params, jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = bridge.from_repro(tree)
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert len(port["segments"][0]) == cfg.num_layers
    assert port["segments"][0][0]["attn"]["wq"].dtype == want
    _assert_bitwise(bridge.to_repro(port), tree)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_port_init_matches_tree_layout(arch):
    cfg = reduced(get_config(arch))
    ref, ref_def = _flat(JM.init_lm(jax.random.PRNGKey(0), cfg))
    port = TM.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    got, got_def = _flat(bridge.to_repro(port))
    assert got_def == ref_def
    assert [(x.shape, x.dtype) for x in got] == \
        [(x.shape, x.dtype) for x in ref]


def test_port_init_is_truncated_fan_in_normal():
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init(g, (256, 512))
    std = 1 / 16
    assert w.abs().max().item() <= 2 * std
    # a normal cut at +-2 sigma keeps 0.774 of its variance
    assert abs(w.std().item() / std - 0.8796) < 0.02
