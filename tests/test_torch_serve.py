"""The port's serving path against the JAX package's, and the port's
import boundary.

Reduced minitron-4b, batch 2, prompt 12, 4 greedy decode steps: prefill
and every decode step's logits of the port (attention through the kernel
entry point, i.e. its plain version on the CPU) against JAX
``forward_body(..., impls={"attn": "pallas"})`` (its Pallas kernel in
interpret mode) on the same bridged params, teacher-forced with the
port's tokens; and the greedy tokens of both."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config, reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
# two frameworks sum the same f32 products in different orders
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, STEPS = 2, 12, 4


def _jax_serving_fns(cfg):
    """repro.launch.serve.build_serving_fns with the Pallas attention."""
    impls = {"attn": "pallas"}

    def prefill(params, tokens):
        b, s = tokens.shape
        cache = JM.init_body_cache(cfg, b, s + 512, jnp.float32)
        h = JM.embed_tokens(params, tokens, cfg, dtype=jnp.float32)
        positions = JL.positions_from_shape(b, s)
        h, cache, _ = JM.forward_body(params, h, cfg, positions=positions,
                                      cache=cache, impls=impls, remat=False)
        return JM.lm_logits(params, h[:, -1:], cfg), cache

    def decode(params, cache, tokens, positions):
        h = JM.embed_tokens(params, tokens, cfg, positions=positions,
                            dtype=jnp.float32)
        h, cache, _ = JM.forward_body(params, h, cfg, positions=positions,
                                      cache=cache, impls=impls, remat=False)
        return JM.lm_logits(params, h, cfg), cache

    return jax.jit(prefill), jax.jit(decode)


@pytest.fixture(scope="module")
def served():
    cfg = reduced(get_config("minitron-4b"))
    tree = jax.tree_util.tree_map(
        np.asarray, JM.init_lm(jax.random.PRNGKey(0), cfg))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))

    prefill, decode = serve.build_serving_fns(cfg, device="cpu")
    out = serve.generate(prefill, decode, bridge.from_repro(tree),
                         torch.from_numpy(tokens), STEPS)

    j_prefill, j_decode = _jax_serving_fns(cfg)
    logits, cache = j_prefill(tree, jnp.asarray(tokens, jnp.int32))
    ref = [np.asarray(logits[:, -1])]
    fed = out["tokens"].numpy()
    for i in range(STEPS):
        pos = jnp.full((B, 1), S + i, jnp.int32)
        logits, cache = j_decode(tree, cache,
                                 jnp.asarray(fed[:, i:i + 1], jnp.int32), pos)
        ref.append(np.asarray(logits[:, -1]))
    return out, np.stack(ref, axis=1)


def test_logits_match_jax_pallas_path(served):
    out, ref = served
    assert out["logits"].shape == (B, STEPS + 1, 256)
    for step in range(STEPS + 1):      # 0 = prefill, then each decode step
        np.testing.assert_allclose(out["logits"][:, step].numpy(),
                                   ref[:, step], **TOL,
                                   err_msg=f"step {step}")


def test_greedy_tokens_match_jax(served):
    out, ref = served
    np.testing.assert_array_equal(out["tokens"].numpy(), ref.argmax(-1))


def test_main_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--batch", "2", "--prompt-len", "8"])
    log = tmp_path / "serve.jsonl"
    assert serve.main(["--device", "cpu", "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--decode-steps", "3",
                       "--obs-log", str(log)]) == 0
    assert '"device": "cpu"' in log.read_text()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# the paper-mode modules, which copy what they need of JAX-free modules
# of the JAX package (tokenizers, fusion, aggregation, costs, synthetic
# data) instead of importing them
PAPER_MODE = ("models/tokenizers.py", "core/fusion.py", "core/aggregation.py",
              "core/baselines.py", "core/costs.py", "core/losses.py",
              "core/mpsl.py", "core/split.py", "data/synthetic.py",
              "bridge.py")


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in files}
    assert set(PAPER_MODE) <= scanned, set(PAPER_MODE) - scanned
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
