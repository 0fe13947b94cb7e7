"""Serve a (post-training-assembled) model with batched requests: one
prefill and a greedy decode loop with a KV cache, the inference side that
the decode_32k / long_500k dry-run cells exercise at production scale.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        [--arch minitron-4b] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        --arch falcon-mamba-7b      (attention-free: O(1) state, no KV cache)

The port of the JAX package's ``examples/serve_batched.py``: the serve
CLI (``repro_torch.launch.serve``, reduced configs) at batch 4, a
32-token prompt and 16 decode steps.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve as serve_cli


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="minitron-4b")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return serve_cli.main(["--arch", args.arch, "--batch", "4",
                           "--prompt-len", "32", "--decode-steps", "16",
                           "--device", args.device])


if __name__ == "__main__":
    raise SystemExit(main())
