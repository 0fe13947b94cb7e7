"""The port's step pipeline on the CPU: prefetch determinism and resume,
batch placement, the in-place (donated) step against ``--no-donate``, the
metrics ring, telemetry neutrality, the sync-free Trainer, checkpoints
and bitwise restart, straggler masking and elastic rejoin (the cases of
``tests/test_pipeline.py`` and ``tests/test_trainer_ft.py``, each against
the port's own objects), and a 4-step Trainer run against the JAX
package's Trainer from the same params."""
import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import MPSLConfig as JMPSLConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import mpsl as jmpsl
from repro.core import split as jsplit
from repro.launch.train import make_lm_loader as jmake_lm_loader
from repro.optim import schedules as jsched
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import bridge, obs, tree
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro_torch.core import mpsl, split
from repro_torch.data import (ClientLoader, PrefetchLoader, SyntheticLM,
                              dirichlet_partition)
from repro_torch.launch.train import make_lm_loader
from repro_torch.obs import comm
from repro_torch.optim import schedules
from repro_torch.parallel import sharding
from repro_torch.train import MetricsRing, Trainer, TrainerConfig
from repro_torch.train.trainer import to_host

# The port's Trainer against the JAX package's over 4 steps, from the same
# params and batches, f32, compression off: each step's loss to 1e-4
# relative. One step's loss agrees to 1e-5 (LOSS_TOL of
# tests/test_torch_mpsl.py); AdamW's updates are ~lr sign(g), so where a
# gradient element is float noise the two sides step it 2 lr apart, and
# the later losses carry that.
TRAINER_LOSS_TOL = 1e-4


def _place(b):
    return sharding.place_batch(b, "cpu")


def _base_loader(seed=0, n=4, bn=2):
    ds = SyntheticLM(vocab_size=64, seq_len=32, size=512, seed=seed)
    shards = dirichlet_partition(ds.labels, n, alpha=0.1, seed=seed,
                                 min_per_client=bn)
    return ClientLoader(ds, shards, bn, seed=seed)


def _tree_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if torch.is_tensor(x) or torch.is_tensor(y):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# Prefetch determinism / resume


def test_prefetch_depth_invariance():
    """Batches at step k are bitwise identical with depth 0 / 2 / 8."""
    ref = {k: _base_loader().batch(k) for k in (0, 3, 7)}
    for depth in (0, 2, 8):
        with PrefetchLoader(_base_loader(), depth=depth) as pf:
            for k in (0, 3, 7):
                # non-contiguous requests force mid-stream reseeds too
                _tree_equal(pf.batch(k), ref[k])


def test_prefetch_sequential_stream_matches():
    inner = _base_loader()
    with PrefetchLoader(_base_loader(), depth=3) as pf:
        for k in range(10):
            _tree_equal(pf.batch(k), inner.batch(k))


def test_prefetch_resume_consumes_failed_runs_batches():
    """Crash at step 5, resume at 5: the restarted prefetcher yields
    exactly the batches the failed run would have consumed."""
    inner = _base_loader()
    pf = PrefetchLoader(_base_loader(), depth=4)
    for k in range(5):
        pf.batch(k)
    pf.close()                                   # "crash"
    pf2 = PrefetchLoader(_base_loader(), depth=4)
    for k in range(5, 9):
        _tree_equal(pf2.batch(k), inner.batch(k))
    pf2.close()


def test_prefetch_propagates_producer_error():
    class Boom:
        def batch(self, step):
            if step == 2:
                raise RuntimeError("boom")
            return {"x": np.zeros(3)}

    pf = PrefetchLoader(Boom(), depth=2)
    pf.batch(0)
    pf.batch(1)
    with pytest.raises(RuntimeError, match="boom"):
        pf.batch(2)


def test_prefetch_placement_makes_tensors_once():
    """place_fn runs on the producer: the batch arrives as tensors (token
    ids int64, the rest as the loader made them, every value equal), and
    the consumer's take_batch hands the same tensors on, uncopied."""
    cfg = reduced(get_config("whisper-tiny"))
    inner = make_lm_loader(cfg, 2, 2, 12, seed=0)
    with PrefetchLoader(make_lm_loader(cfg, 2, 2, 12, seed=0), depth=2,
                        place_fn=_place) as pf:
        b = pf.batch(0)
    assert isinstance(b, sharding.PlacedBatch) and b.ready is None
    want = inner.batch(0)
    assert sorted(b) == sorted(want)
    for k, v in b.items():
        assert torch.is_tensor(v) and v.device.type == "cpu"
        assert v.dtype == (torch.int64 if k in ("tokens", "labels")
                           else torch.from_numpy(want[k]).dtype)
        np.testing.assert_array_equal(v.numpy(), want[k])
    taken = sharding.take_batch(b, "cpu")
    assert all(taken[k] is b[k] for k in b)
    # an unplaced (numpy) batch is placed on the way
    raw = sharding.take_batch(want, "cpu")
    assert raw["tokens"].dtype == torch.int64


# ---------------------------------------------------------------------------
# The in-place (donated) step against --no-donate


def _tiny_train(donate, n=2, bn=2, seq=24):
    cfg = reduced(get_config("minitron-4b"))
    mp = MPSLConfig(n_clients=n, trainable_blocks=1, head_adapter_rank=4)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype="float32", learning_rate=1e-3,
                    attn_impl="kernel", ce_impl="kernel")
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), cfg, run)
    state = mpsl.init_state(params, frozen)
    step_fn = mpsl.make_train_step(mpsl.make_lm_loss(cfg, run), run,
                                   schedules.constant(1e-3))
    if not donate:
        step_fn = mpsl.undonated(step_fn)
    batch = sharding.take_batch(
        make_lm_loader(cfg, n, bn, seq, seed=0).batch(0), "cpu")
    return state, step_fn, batch


def _updated(state):
    return (tree.leaves(state["params"]) + tree.leaves(state["opt"]["mu"])
            + tree.leaves(state["opt"]["nu"]))


def test_donated_step_aliases_state_storages():
    """The default step updates params and both Adam moments in place:
    the new state's tensors live in the old state's storages (no second
    param + optimizer copy)."""
    state, step_fn, batch = _tiny_train(donate=True)
    ptrs = [t.data_ptr() for t in _updated(state)]
    before = [t.detach().clone() for t in _updated(state)]
    new_state, _ = step_fn(state, batch)
    assert [t.data_ptr() for t in _updated(new_state)] == ptrs
    # ... and it did move them: the old handles see the new values
    assert not all(torch.equal(a, b) for a, b in zip(before,
                                                     _updated(state)))


def test_undonated_step_leaves_old_state_untouched():
    """--no-donate: the caller's state keeps every bit and stays usable
    (stepping it again gives the same bits as the first time)."""
    state, step_fn, batch = _tiny_train(donate=False)
    before = [t.detach().clone() for t in _updated(state)]
    count = state["opt"]["count"].clone()
    first, _ = step_fn(state, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, _updated(state)))
    assert torch.equal(state["opt"]["count"], count) and state["step"] == 0
    assert {t.data_ptr() for t in _updated(first)}.isdisjoint(
        t.data_ptr() for t in _updated(state))
    again, _ = step_fn(state, batch)
    _tree_equal(first["params"], again["params"])


def test_donated_matches_undonated():
    state_a, step_a, batch = _tiny_train(donate=True)
    state_b, step_b, _ = _tiny_train(donate=False)
    out_a, met_a = step_a(state_a, batch)
    out_b, met_b = step_b(state_b, batch)
    _tree_equal(out_a["params"], out_b["params"])
    _tree_equal(out_a["opt"], out_b["opt"])
    assert torch.equal(met_a["loss"], met_b["loss"])


# ---------------------------------------------------------------------------
# Sync-free trainer loop


def test_metrics_ring_keeps_latest():
    ring = MetricsRing(4)
    for s in range(1, 8):
        ring.push(s, {"loss": torch.tensor(float(s))})
    got = ring.read_latest()
    assert got["step"] == 7
    assert float(got["loss"]) == 7.0


def test_metrics_ring_wraparound_bounds_live_entries():
    """Wraparound keeps at most `size` entries alive (the memory bound
    that lets the host run ahead without holding every step's metrics),
    and they are exactly the most recent `size` steps."""
    ring = MetricsRing(4)
    for s in range(1, 10):
        ring.push(s, {"loss": torch.tensor(float(s))})
    live = [e for e in ring._slots if e is not None]
    assert len(live) == 4
    assert sorted(step for step, _ in live) == [6, 7, 8, 9]
    assert ring.read_latest()["step"] == 9


def test_metrics_ring_overflow_slot_collision():
    """Pushing a step `size` ahead of a live entry overwrites that slot
    (step % size collision): the old metrics are dropped, latest() still
    resolves by step number, and an empty ring reads as None."""
    ring = MetricsRing(4)
    ring.push(1, {"loss": torch.tensor(1.0)})
    ring.push(5, {"loss": torch.tensor(5.0)})   # 5 % 4 == 1: same slot
    live = [e for e in ring._slots if e is not None]
    assert len(live) == 1
    got = ring.read_latest()
    assert got["step"] == 5 and float(got["loss"]) == 5.0
    assert MetricsRing(2).latest() is None
    assert MetricsRing(2).read_latest() is None


def test_metrics_readback_keeps_every_bit_and_dtype():
    """One entry's values, whatever their dtype and shape, come back
    bitwise (the readback carries them through one f64 tensor)."""
    m = {"loss": torch.tensor(1 / 3), "per_client": torch.rand(3),
         "count": torch.tensor(7, dtype=torch.int32),
         "ok": torch.tensor(True), "lr": 0.5}
    got = to_host(m)
    assert list(got) == list(m)
    for k in ("loss", "per_client", "count", "ok"):
        assert got[k].dtype == m[k].numpy().dtype
        np.testing.assert_array_equal(got[k], m[k].numpy())
    assert got["lr"] == 0.5


class _OpLog(TorchDispatchMode):
    """The aten ops a region runs, in order (forward and backward)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_obs_on_and_off_give_the_same_ops_launches_and_bits(tmp_path):
    """Telemetry neutrality: the step runs the same ops in the same order
    (and the kernel wrappers count the same launches) with the recorder
    disabled and enabled, and lands on the same bits; the hooks read
    shapes on the host and touch no tensor."""
    from repro_torch.kernels import (flash_attention as fa, quant8 as q8,
                                     softmax_xent as sx)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                sx.softmax_xent_fwd, sx.softmax_xent_bwd, q8.quant_dequant)
    cfg = reduced(get_config("minitron-4b"))
    mp = MPSLConfig(n_clients=2, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=True, compress_downlink=True)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype="float32", learning_rate=1e-3,
                    attn_impl="kernel", ce_impl="kernel")
    batch = make_lm_loader(cfg, 2, 2, 24, seed=0).batch(0)

    def one_step():
        comm.reset()
        params, frozen, _ = split.init_mpsl_lm(
            torch.Generator().manual_seed(0), cfg, run)
        state = mpsl.init_state(params, frozen)
        step = mpsl.make_train_step(mpsl.make_lm_loss(cfg, run), run,
                                    schedules.constant(1e-3))
        b = sharding.take_batch(batch, "cpu")
        for c in counters:
            c.launches = 0
        with _OpLog() as log:
            state, met = step(state, b)
        return state, log.ops, [c.launches for c in counters]

    assert not obs.get().enabled
    off, ops_off, n_off = one_step()
    with obs.enabled(str(tmp_path / "log.jsonl")):
        on, ops_on, n_on = one_step()
    comm.reset()
    assert len(ops_off) > 100 and ops_on == ops_off
    assert n_on == n_off
    _tree_equal(on["params"], off["params"])
    _tree_equal(on["opt"], off["opt"])


def _trainer_setup(ckpt_dir=None, drop_prob=0.0, n=4, steps=6,
                   prefetch=0, donate=True):
    cfg = reduced(get_config("minitron-4b"))
    mp = MPSLConfig(n_clients=n, trainable_blocks=1, head_adapter_rank=4)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype="float32", learning_rate=1e-3,
                    attn_impl="kernel", ce_impl="kernel")
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), cfg, run)
    state = mpsl.init_state(params, frozen)
    step_fn = mpsl.make_train_step(mpsl.make_lm_loss(cfg, run), run,
                                   schedules.constant(1e-3))
    if not donate:
        step_fn = mpsl.undonated(step_fn)
    loader = make_lm_loader(cfg, n, 2, 24, seed=0, drop_prob=drop_prob)
    if prefetch:
        loader = PrefetchLoader(loader, depth=prefetch, place_fn=_place)
    tc = TrainerConfig(total_steps=steps, ckpt_every=2,
                       ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
                       log_every=1)
    return state, step_fn, loader, tc


def test_trainer_overlapped_end_to_end():
    """Full pipeline: prefetch + in-place step + sync-free metrics, and
    the result reflects the LAST step, not the last logged step."""
    state, step_fn, loader, tc = _trainer_setup(n=2, steps=7, prefetch=3)
    tc.log_every = 100
    t = Trainer(step_fn, state, loader, tc, log_fn=lambda s: None)
    out = t.run()
    loader.close()
    assert out["final_loss"] is not None
    assert out["steps_per_sec"] > 0
    assert 0.0 <= out["host_stall_frac"] <= 1.0
    # history closes on the final step even though log_every never fired
    assert t.metrics_history[-1]["step"] == 7
    assert out["final_loss"] == t.metrics_history[-1]["loss"]
    assert len(t.step_times) == 7


# ---------------------------------------------------------------------------
# Checkpoints, restart, stragglers, elastic rejoin


def test_checkpoint_roundtrip_keeps_bits_and_rejects_mismatches(tmp_path):
    """bf16 leaves (stored as uint16 bits), f32 and int leaves and the
    state's Python ints restore bitwise, in place (the template's tensors
    keep their identity and requires_grad); a shape or dtype mismatch
    raises."""
    g = torch.Generator().manual_seed(3)
    tree_ = {"w": torch.randn(3, 4, generator=g).requires_grad_(True),
             "b16": torch.randn(5, generator=g).to(torch.bfloat16),
             "n": torch.tensor(7, dtype=torch.int32),
             "segments": [[{"a": torch.randn(2, generator=g)}]],
             "step": 12, "rng": 2 ** 40 + 3}
    save_checkpoint(str(tmp_path), 12, tree_)
    assert latest_step(str(tmp_path)) == 12
    tmpl = tree.map_(lambda v: torch.zeros_like(v) if torch.is_tensor(v)
                     else 0, tree_)
    ids = [id(v) for v in tree.leaves(tmpl) if torch.is_tensor(v)]
    tmpl["w"].requires_grad_(True)
    got, manifest = restore_checkpoint(str(tmp_path), tmpl)
    assert manifest["step"] == 12
    _tree_equal(got, tree_)
    assert [id(v) for v in tree.leaves(got) if torch.is_tensor(v)] == ids
    assert got["w"].requires_grad and got["step"] == 12
    assert got["rng"] == 2 ** 40 + 3
    bad = dict(tmpl, w=torch.zeros(4, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), bad)
    bad = dict(tmpl, b16=torch.zeros(5))
    with pytest.raises(ValueError, match="dtype mismatch"):
        restore_checkpoint(str(tmp_path), bad)
    assert restore_checkpoint(str(tmp_path / "none"), tmpl) == (None, None)


def test_async_checkpoint_snapshot_is_not_moved_by_later_updates(tmp_path):
    """The writer serializes the state as it was at save(), even if the
    caller updates it in place before the write lands."""
    state = {"w": torch.arange(4.0), "step": 1}
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(1, state)
    state["w"].add_(100.0)
    ck.wait()
    got, _ = restore_checkpoint(str(tmp_path),
                                {"w": torch.zeros(4), "step": 0})
    assert torch.equal(got["w"], torch.arange(4.0)) and got["step"] == 1
    for s in (2, 3, 4):
        ck.save(s, state)
    ck.wait()
    assert sorted(int(p.name[5:]) for p in tmp_path.iterdir()) == [3, 4]


@pytest.mark.parametrize("prefetch", [0, 3])
def test_restart_is_bitwise_identical(tmp_path, prefetch):
    """Run 6 steps straight vs 3 steps + crash + resume: identical params
    and optimizer state, with the prefetcher (placement on its producer
    thread) and without; the straight run is unprefetched."""
    state, step_fn, loader, tc = _trainer_setup(tmp_path / "a", steps=6)
    t = Trainer(step_fn, state, loader, tc, log_fn=lambda s: None)
    t.run()
    straight = t.state

    state2, step_fn2, loader2, tc2 = _trainer_setup(
        tmp_path / "b", steps=6, prefetch=prefetch)
    t2 = Trainer(step_fn2, state2, loader2, tc2, log_fn=lambda s: None)
    t2.run(3)
    t2.checkpoint_now()
    t2.ckpt.wait()
    if prefetch:
        loader2.close()                         # "crash" mid-stream
    # "crash": rebuild everything from scratch; the trainer auto-resumes
    state3, step_fn3, loader3, tc3 = _trainer_setup(
        tmp_path / "b", steps=6, prefetch=prefetch)
    logs = []
    t3 = Trainer(step_fn3, state3, loader3, tc3, log_fn=logs.append)
    assert t3.state["step"] == 3 and logs == ["[trainer] resumed from step 3"]
    assert int(t3.state["opt"]["count"]) == 3
    t3.run(6)
    if prefetch:
        loader3.close()
    _tree_equal(straight["params"], t3.state["params"])
    _tree_equal(straight["opt"], t3.state["opt"])
    assert t3.state["step"] == straight["step"] == 6


def test_straggler_masking_trains():
    state, step_fn, loader, tc = _trainer_setup(None, drop_prob=0.4, steps=8)
    t = Trainer(step_fn, state, loader, tc, log_fn=lambda s: None)
    out = t.run()
    assert out["final_loss"] is not None
    hist = [h["loss"] for h in t.metrics_history]
    assert hist[-1] < hist[0]
    assert len(hist) == 8


def test_elastic_rejoin():
    state, step_fn, loader, tc = _trainer_setup(None, steps=2)
    t = Trainer(step_fn, state, loader, tc, log_fn=lambda s: None)
    t.run(2)
    bank = t.state["params"]["client"]["adapter"]["a"]
    before = bank.detach().clone()
    t.rejoin_client(1)
    after = t.state["params"]["client"]["adapter"]["a"]
    assert after is bank                          # in place
    torch.testing.assert_close(after[1].detach(), before.mean(dim=0),
                               atol=1e-6, rtol=0)
    assert torch.equal(after[0].detach(), before[0])


# ---------------------------------------------------------------------------
# The Trainer against the JAX package's


def test_trainer_losses_match_jax_trainer():
    """4 steps of each package's Trainer from the same params (the JAX
    package's init, bridged), the same loader batches, f32, compression
    off: every step's loss within TRAINER_LOSS_TOL relative."""
    n, bn, seq, steps = 2, 2, 16, 4
    jcfg = jreduced(jget_config("minitron-4b"))
    jmp = JMPSLConfig(n_clients=n, trainable_blocks=1, head_adapter_rank=4)
    jrun = JRunConfig(model=jcfg, shape=JSHAPES["train_4k"], mpsl=jmp,
                      compute_dtype="float32", learning_rate=1e-3)
    params, frozen, _ = jsplit.init_mpsl_lm(jax.random.PRNGKey(0), jcfg,
                                            jrun)
    params = jax.tree_util.tree_map(np.asarray, params)
    frozen = jax.tree_util.tree_map(np.asarray, frozen)
    jstep = jax.jit(jmpsl.make_train_step(jmpsl.make_lm_loss(jcfg, jrun),
                                          jrun, jsched.constant(1e-3)))
    jt = JTrainer(jstep, jmpsl.init_state(params, frozen),
                  jmake_lm_loader(jcfg, n, bn, seq, seed=0),
                  JTrainerConfig(total_steps=steps, log_every=1),
                  log_fn=lambda s: None)
    jt.run()

    cfg = reduced(get_config("minitron-4b"))
    mp = MPSLConfig(n_clients=n, trainable_blocks=1, head_adapter_rank=4)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype="float32", learning_rate=1e-3,
                    attn_impl="kernel", ce_impl="kernel")
    state = mpsl.init_state(bridge.from_repro(params),
                            bridge.from_repro(frozen))
    step = mpsl.make_train_step(mpsl.make_lm_loss(cfg, run), run,
                                schedules.constant(1e-3))
    loader = PrefetchLoader(make_lm_loader(cfg, n, bn, seq, seed=0), depth=2,
                            place_fn=_place)
    t = Trainer(step, state, loader,
                TrainerConfig(total_steps=steps, log_every=1),
                log_fn=lambda s: None)
    t.run()
    loader.close()
    got = [h["loss"] for h in t.metrics_history]
    want = [h["loss"] for h in jt.metrics_history]
    assert [h["step"] for h in t.metrics_history] == [1, 2, 3, 4]
    assert [h["step"] for h in jt.metrics_history] == [1, 2, 3, 4]
    np.testing.assert_allclose(got, want, rtol=TRAINER_LOSS_TOL, atol=0)
    assert got[-1] < got[0]
