"""The train CLI on several ranks (the SPMD program, gloo on the CPU), and
its checkpoints across world sizes.

  * ``torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train
    --device cpu ...`` (the host mesh (2, 1): 2 clients a rank), against
    the same command in one process: every step's loss (the global L_S)
    within 1e-4; rank 0 alone prints the summary, which records the mesh;
  * a checkpoint written by that 2-rank run (gathered to rank 0) and
    restored into the CLI's state at world 1 (one process) and world 2
    (``launch.spmd``, each rank its shards, gathered back): every leaf
    bitwise the stored array.
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGV = ["--device", "cpu", "--steps", "3", "--seq", "24", "--compress",
        "--prefetch", "0"]
# the same f32 sums, split over ranks and added in another order
LOSS_TOL = 1e-4


def _torchrun(argv, n, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", "-m", "repro_torch.launch.train", *argv]
    proc = subprocess.run(cmd, env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    ckpt = str(tmp / "ckpt")
    two = _torchrun(ARGV + ["--ckpt-dir", ckpt, "--ckpt-every", "2"], 2,
                    tmp)
    rc, one = W.cli(ARGV)
    assert rc == 0
    return one, two, ckpt


def test_two_ranks_match_one(runs):
    one, two, _ = runs
    assert len(two) == 1, "rank 0 alone prints the summary"
    two = two[0]
    assert two["mesh"]["mesh"] == {"data": 2, "model": 1}
    assert two["mesh"]["backend"] == "gloo"
    assert len(two["losses"]) == len(one["losses"]) == 3
    for a, b in zip(two["losses"], one["losses"]):
        assert abs(a - b) <= LOSS_TOL * abs(b)
    assert two["losses"][-1] < two["losses"][0]


def _stored(ckpt, step):
    data = np.load(os.path.join(ckpt, f"step_{step:08d}", "arrays.npz"))
    return {k: data[k] for k in data.files}


@pytest.mark.parametrize("world", [1, 2])
def test_checkpoint_restores_at_any_world(runs, world, tmp_path):
    _, _, ckpt = runs
    argv = ARGV + ["--ckpt-dir", ckpt]
    stored = _stored(ckpt, 3)
    if world == 1:
        got = [W.restore(argv, ckpt, 3)]
    else:
        got = spmd.spawn(W.restore, Mesh(("data", "model"), (2, 1)), "cpu",
                         120, args=(argv, ckpt, 3), workdir=tmp_path)
    for leaves in got:
        assert set(leaves) <= set(stored)
        assert len(leaves) > 10
        for k, v in leaves.items():
            want = stored[k]
            if want.dtype == np.uint16:           # bf16 bits
                want = (want.astype(np.uint32) << 16).view(np.float32)
            np.testing.assert_array_equal(v, want, err_msg=k)
