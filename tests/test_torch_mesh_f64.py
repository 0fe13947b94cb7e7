"""The SPMD program's sums in float64, on the CPU (gloo).

A scalar's gradient can be a sum that cancels: hymba's first trainable
``beta_ssm`` at 4 of 32 layers sums 6.5 M terms to 1e-6 of their
absolute sum, so two f32 paths that add them in other orders part by
1e-2 with no fault (ROADMAP.md Queue 3, decisions). In float64 the
rounding falls away and a missing or doubled sum would stand out. Reduced
hymba-1.5b at that cut (4 layers, the last 2 trainable; 5 heads on 1 KV
head: the ``dboth`` attention, d_inner on `model`; vocab 257: the head on
`data` alone, the CE whole on each model rank), 4 clients x 2 x 24
tokens, client 1 masked, links off, the plain impls: every gradient of
the (2, 2) mesh within 1e-12 in relative L2 of one rank's.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

import _mesh_workers as W
from repro_torch.core import split
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh

CFG_KW = {"arch": "hymba-1.5b", "num_layers": 4, "num_heads": 5,
          "num_kv_heads": 1, "vocab_size": 257}
N, BN, S = 4, 2, 24
MESH = Mesh(("data", "model"), (2, 2))
# float64 sums of the same terms in other orders
F64_L2_TOL = 1e-12


def _inputs():
    cfg = W._config(CFG_KW)
    run = W._port_run(cfg, N, False)
    run = W.dataclasses.replace(run, mpsl=W.dataclasses.replace(
        run.mpsl, trainable_blocks=2))
    gen = torch.Generator().manual_seed(0)
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run)
    params["client"]["adapter"]["b"].normal_(0.0, 0.05, generator=gen)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 257, (N, BN, S)),
             "labels": rng.integers(0, 257, (N, BN, S)),
             "mask": np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)}
    return W.bridge.to_repro(params), W.bridge.to_repro(frozen), batch


def test_mesh_gradients_match_one_rank_in_float64(tmp_path):
    params, frozen, batch = _inputs()
    one = W.f64_grads(CFG_KW, params, frozen, batch)
    ranks = spmd.spawn(W.f64_grads, MESH, "cpu", 240,
                       args=(CFG_KW, params, frozen, batch),
                       workdir=tmp_path)
    betas = [k for k in one if k.endswith("beta_ssm")]
    assert len(betas) == 2
    for got in ranks:
        assert set(got) == set(one)
        for k, want in one.items():
            den = float(np.linalg.norm(want)) or 1.0
            assert float(np.linalg.norm(got[k] - want)) / den <= \
                F64_L2_TOL, k
