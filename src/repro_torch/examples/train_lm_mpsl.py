"""End to end: MPSL-fine-tune an assigned LM architecture with the
fault-tolerant trainer (checkpoints, straggler masking), then resume after
a simulated failure.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_mpsl \
        [--arch minitron-4b] [--device cpu]

The port of the JAX package's ``examples/train_lm_mpsl.py``: the train
CLI (``repro_torch.launch.train``, reduced same-family configs by
default) runs twice through one checkpoint directory, with 10% simulated
client dropout; the second run resumes from the first's last checkpoint.
The directory is a fresh temporary one, removed at the end.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch import train as train_cli


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="minitron-4b")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    common = ["--arch", args.arch, "--ckpt-every", "10", "--drop-prob",
              "0.1", "--device", args.device]
    with tempfile.TemporaryDirectory(prefix="mpsl_example_ckpt_") as ckpt:
        print(f"=== phase 1: train {args.arch} for {args.steps // 2} steps, "
              f"with 10% simulated client dropout ===")
        rc = train_cli.main(["--steps", str(args.steps // 2), "--ckpt-dir",
                             ckpt, *common])
        if rc:
            return rc
        print("=== simulated failure: process 'dies'; restarting from the "
              "latest checkpoint ===")
        rc = train_cli.main(["--steps", str(args.steps), "--ckpt-dir", ckpt,
                             *common])
    if rc == 0:
        print("=== resumed run completed — loss continued from the "
              "checkpoint ===")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
