"""The train and serve CLIs on the SSM and hybrid families across ranks (the
SPMD program, gloo on the CPU), and their checkpoints across world sizes.

  * the serve CLI under ``torchrun`` on 2 ranks (the host mesh (2, 1))
    for falcon-mamba-7b and hymba-1.5b: the one-process greedy tokens;
  * ``torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train
    --device cpu --arch hymba-1.5b ...`` (the host mesh (2, 1)) against
    the same command in one process: every step's loss within 1e-4;
  * the non-finite guard on (2, 2): a poisoned batch skipped as in one
    process;
  * a hymba-1.5b train state written by the CLI on (2, 2) (in a world of
    ``launch.spmd.spawn``: reduced hymba-1.5b's 4 query heads on `model`,
    its 1 KV head's weights' D on (data, model), d_inner and d_ff on
    `model`, Mamba's in_proj cut section by section) restored into the
    CLI's state at world 1 and on (1, 4), and a falcon-mamba-7b state
    written on (2, 2) restored on (4, 1): every leaf bitwise the stored
    array.
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
HYMBA = ARGV + ["--arch", "hymba-1.5b"]
FALCON = ARGV + ["--arch", "falcon-mamba-7b"]
# the same f32 sums, split over ranks and added in another order
LOSS_TOL = 1e-4


def _run(argv, n, cwd, module="repro_torch.launch.train"):
    """`module`'s CLI in n processes under torchrun (n > 1) or in one:
    its standard output and error."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    launch = (["-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={n}"] if n > 1 else [])
    proc = subprocess.run([sys.executable, *launch, "-m", module, *argv],
                          env=env, cwd=cwd, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout + proc.stderr


def _torchrun(argv, n, cwd):
    return [json.loads(x) for x in _run(argv, n, cwd).splitlines()
            if x.startswith("{")]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_torchrun_serve_matches_one_process(arch, tmp_path):
    """The serve CLI on 2 ranks (the host mesh (2, 1): the requests over
    `data`) generates the one-process tokens; rank 0 alone logs."""
    argv = ["--device", "cpu", "--arch", arch, "--decode-steps", "4",
            "--prompt-len", "12"]
    sample = lambda out: [x for x in out.splitlines()
                          if "sample generations" in x]
    two = sample(_run(argv, 2, tmp_path, "repro_torch.launch.serve"))
    one = sample(_run(argv, 1, tmp_path, "repro_torch.launch.serve"))
    assert len(two) == len(one) == 1
    assert two[0].split("sample")[1] == one[0].split("sample")[1]


def test_torchrun_hymba_two_ranks_match_one(tmp_path):
    two = _torchrun(HYMBA, 2, tmp_path)
    rc, one = W.cli(HYMBA)
    assert rc == 0
    assert len(two) == 1, "rank 0 alone prints the summary"
    two = two[0]
    assert two["mesh"]["mesh"] == {"data": 2, "model": 1}
    assert len(two["losses"]) == len(one["losses"]) == 3
    for a, b in zip(two["losses"], one["losses"]):
        assert abs(a - b) <= LOSS_TOL * abs(b)


def test_guarded_nan_step_across_ranks(tmp_path):
    """The non-finite guard on (2, 2): a poisoned batch (the plan's
    nan_batch@1) is skipped on every rank, as in one process, and the
    other steps' losses match the one-process run's."""
    argv = HYMBA + ["--fault-plan", "nan_batch@1"]
    res = spmd.spawn(W.cli, Mesh(("data", "model"), (2, 2)), "cpu", 240,
                     args=(argv,), workdir=tmp_path)
    rc, one = W.cli(argv)
    assert rc == 0 and [r for r, _ in res] == [0] * 4
    four = res[0][1]
    assert four["skipped_steps"] == one["skipped_steps"] == [1]
    for step, (a, b) in enumerate(zip(four["losses"], one["losses"])):
        if step != 1:
            assert abs(a - b) <= LOSS_TOL * abs(b)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{arch argv: checkpoint dir} of a 3-step run on (2, 2), checkpoints
    every 2 steps."""
    out = {}
    for argv in (HYMBA, FALCON):
        tmp = tmp_path_factory.mktemp("ckpt")
        ckpt = str(tmp / "ckpt")
        res = spmd.spawn(W.cli, Mesh(("data", "model"), (2, 2)), "cpu", 240,
                         args=(argv + ["--ckpt-dir", ckpt, "--ckpt-every",
                                       "2"],), workdir=tmp)
        assert [rc for rc, _ in res] == [0] * 4
        assert res[0][1]["mesh"]["mesh"] == {"data": 2, "model": 2}
        out[argv[-1]] = ckpt
    return out


def _stored(ckpt, step):
    data = np.load(os.path.join(ckpt, f"step_{step:08d}", "arrays.npz"))
    return {k: data[k] for k in data.files}


@pytest.mark.parametrize("arch,mesh", [
    ("hymba-1.5b", None), ("hymba-1.5b", (1, 4)),
    ("falcon-mamba-7b", (4, 1))], ids=["hymba-1x1", "hymba-1x4",
                                       "falcon-4x1"])
def test_checkpoint_restores_at_another_world(saved, arch, mesh, tmp_path):
    ckpt = saved[arch]
    argv = ARGV + ["--arch", arch, "--ckpt-dir", ckpt]
    stored = _stored(ckpt, 3)
    if mesh is None:
        got = [W.restore(argv, ckpt, 3)]
    else:
        got = spmd.spawn(W.restore, Mesh(("data", "model"), mesh), "cpu",
                         120, args=(argv, ckpt, 3), workdir=tmp_path)
    for leaves in got:
        assert set(leaves) <= set(stored)
        assert any(k.endswith("in_proj") for k in leaves)
        for k, v in leaves.items():
            want = stored[k]
            if want.dtype == np.uint16:           # bf16 bits
                want = (want.astype(np.uint32) << 16).view(np.float32)
            np.testing.assert_array_equal(v, want, err_msg=k)
