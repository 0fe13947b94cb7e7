"""The train and serve CLIs on the encoder-decoder (whisper) and VLM
(qwen2-vl) stacks across ranks (the SPMD program, gloo on the CPU), and
their checkpoints across world sizes.

  * ``torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train
    --device cpu --arch whisper-tiny ...`` (the host mesh (2, 1): each
    rank its clients' seeded stub frames, the rows the one-process draw
    gives them) against the same command in one process: every step's
    loss within 1e-4;
  * the serve CLI under ``torchrun`` on 2 ranks for qwen2-vl-72b (each
    rank its requests' rows of the one-process stub patches): the
    one-process greedy tokens;
  * a whisper-tiny train state written by the CLI on (1, 4) (in a world
    of ``launch.spmd.spawn``; the encoder's leaves and the learned
    ``pos`` leaves' D on `model`) restored into the CLI's state at world
    1 and on (2, 2), and a qwen2-vl-72b state written on (2, 2) restored
    on (4, 1): every leaf bitwise the stored array.
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
        "--prefetch", "0", "--trainable-blocks", "1"]
WHISPER = ARGV + ["--arch", "whisper-tiny"]
QWEN = ARGV + ["--arch", "qwen2-vl-72b"]
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


def test_torchrun_whisper_two_ranks_match_one(tmp_path):
    two = [json.loads(x) for x in _run(WHISPER, 2, tmp_path).splitlines()
           if x.startswith("{")]
    rc, one = W.cli(WHISPER)
    assert rc == 0
    assert len(two) == 1, "rank 0 alone prints the summary"
    two = two[0]
    assert two["mesh"]["mesh"] == {"data": 2, "model": 1}
    assert len(two["losses"]) == len(one["losses"]) == 3
    for a, b in zip(two["losses"], one["losses"]):
        assert abs(a - b) <= LOSS_TOL * abs(b)


def test_torchrun_serve_qwen2_vl_matches_one_process(tmp_path):
    """The serve CLI on 2 ranks (the host mesh (2, 1): the requests and
    their patches over `data`) generates the one-process tokens; rank 0
    alone logs."""
    argv = ["--device", "cpu", "--arch", "qwen2-vl-72b", "--decode-steps",
            "4", "--prompt-len", "12"]
    sample = lambda out: [x for x in out.splitlines()
                          if "sample generations" in x]
    two = sample(_run(argv, 2, tmp_path, "repro_torch.launch.serve"))
    one = sample(_run(argv, 1, tmp_path, "repro_torch.launch.serve"))
    assert len(two) == len(one) == 1
    assert two[0].split("sample")[1] == one[0].split("sample")[1]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{arch: checkpoint dir} of a 3-step run (checkpoints every 2
    steps): whisper-tiny on (1, 4), qwen2-vl-72b on (2, 2)."""
    out = {}
    for argv, mesh in ((WHISPER, (1, 4)), (QWEN, (2, 2))):
        tmp = tmp_path_factory.mktemp("ckpt")
        ckpt = str(tmp / "ckpt")
        res = spmd.spawn(W.cli, Mesh(("data", "model"), mesh), "cpu", 240,
                         args=(argv + ["--ckpt-dir", ckpt, "--ckpt-every",
                                       "2"],), workdir=tmp)
        assert [rc for rc, _ in res] == [0] * 4
        assert res[0][1]["mesh"]["mesh"] == dict(zip(("data", "model"),
                                                     mesh))
        out[argv[-1]] = ckpt
    return out


def _stored(ckpt, step):
    data = np.load(os.path.join(ckpt, f"step_{step:08d}", "arrays.npz"))
    return {k: data[k] for k in data.files}


@pytest.mark.parametrize("arch,mesh", [
    ("whisper-tiny", None), ("whisper-tiny", (2, 2)),
    ("qwen2-vl-72b", (4, 1))], ids=["whisper-1x1", "whisper-2x2",
                                    "qwen2-vl-4x1"])
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
        if arch == "whisper-tiny":
            assert any(k.endswith("encoder/pos") for k in leaves)
            assert any(k.endswith("embed/pos") for k in leaves)
        for k, v in leaves.items():
            want = stored[k]
            if want.dtype == np.uint16:           # bf16 bits
                want = (want.astype(np.uint32) << 16).view(np.float32)
            np.testing.assert_array_equal(v, want, err_msg=k)
