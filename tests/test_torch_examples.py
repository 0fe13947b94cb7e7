"""The port's three examples (``repro_torch.examples``) on the CPU, with
fewer steps; quickstart's losses against the same flow through the JAX
package from the same params (the port's init, bridged) and the same
batches."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import MPSLConfig as JMPSLConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import SHAPES as JSHAPES
from repro.configs import reduced as jreduced
from repro.configs.meta_transformer import VIT_TINY as JVIT_TINY
from repro.core import mpsl as jmpsl
from repro.optim import schedules as jsched
from repro_torch import bridge
from repro_torch.core import split
from repro_torch.examples import quickstart, serve_batched, train_lm_mpsl

# the first steps' losses, f32, reduced ViT-Tiny (2 layers): the same sums
# in other orders, carried through AdamW steps
LOSS_TOL = 1e-4
# XLA's CPU backend without its costly LLVM passes: the same f32 math,
# compiled faster
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def test_quickstart_runs(capsys):
    assert quickstart.main(["--steps", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "assembled [F_C_agg ; F_S] accuracy" in out


def test_train_lm_mpsl_runs_and_resumes(capsys):
    assert train_lm_mpsl.main(["--steps", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"start_step": 2' in out
    assert "resumed run completed" in out


def test_serve_batched_runs():
    assert serve_batched.main(["--device", "cpu"]) == 0


def test_quickstart_losses_match_jax():
    cfg, run, loader, _ = quickstart.setup()
    jcfg = jreduced(JVIT_TINY)
    jrun = JRunConfig(model=jcfg, shape=JSHAPES["train_4k"],
                      mpsl=JMPSLConfig(n_clients=quickstart.N_CLIENTS,
                                       trainable_blocks=2, fusion="early"),
                      compute_dtype="float32", learning_rate=1e-3)
    # the port's init (the JAX one is eager and slow), bridged to both
    tparams, tfrozen, _ = split.init_mpsl_vit(
        torch.Generator().manual_seed(0), cfg, run,
        modalities=quickstart.MODALITIES, n_classes=quickstart.N_CLASSES)
    params, frozen = bridge.to_repro(tparams), bridge.to_repro(tfrozen)
    loss_fn = jmpsl.make_vit_loss(jcfg, jrun,
                                  modalities=quickstart.MODALITIES,
                                  n_classes=quickstart.N_CLASSES)
    step = jax.jit(jmpsl.make_train_step(loss_fn, jrun,
                                         jsched.constant(1e-3)),
                   compiler_options=FAST_XLA)
    state = jmpsl.init_state(params, frozen)
    want = []
    for i in range(3):
        b = loader.batch(i)
        state, met = step(state, {
            "vision": jnp.asarray(b["vision"]),
            "text": jnp.asarray(b["text"].astype(np.int32)),
            "labels": jnp.asarray(b["labels"].astype(np.int32)),
            "mask": jnp.asarray(b["mask"])})
        want.append(float(met["loss"]))
    _, got = quickstart.train(cfg, run, loader, bridge.from_repro(params),
                              bridge.from_repro(frozen), 3, "cpu",
                              log=lambda *_: None)
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
