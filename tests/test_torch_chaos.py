"""The port's chaos suite on the CPU: fault plans, the injector and the
recovery paths (the cases of ``tests/test_chaos.py``, each against the
port's own objects), then parity with the JAX package: the same plans
from the same spec, JSON and seed, the same masks and poison from the
same batch, and the same loader batches under the same plan.

The invariants: a FaultPlan is a pure value; a producer crash restarts
the prefetcher into the bitwise-identical batch stream; a NaN-poisoned
step is skipped with params and Adam moments bitwise untouched; a failed
checkpoint write retries to a resumable checkpoint; a faulty run equals
the same plan run in two legs with a checkpoint between; and every
injection and recovery lands as a ``fault/*`` event in the run log."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro import faults as jfaults
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch.train import make_lm_loader as jmake_lm_loader
from repro_torch import faults, obs, tree
from repro_torch.checkpoint import AsyncCheckpointer, latest_step
from repro_torch.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro_torch.core import mpsl, split
from repro_torch.data import PrefetchLoader
from repro_torch.faults import FaultPlan, InjectedFault
from repro_torch.launch.train import make_lm_loader
from repro_torch.obs import report
from repro_torch.optim import schedules
from repro_torch.parallel import sharding
from repro_torch.train import Trainer, TrainerConfig


@pytest.fixture(autouse=True)
def _clean_globals():
    """The ambient injector and recorder are process globals (one set in
    each package): every test starts and ends without them."""
    faults.deactivate()
    obs.shutdown()
    yield
    faults.deactivate()
    obs.shutdown()
    jfaults.deactivate()


def _read_events(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r.get("kind") == "event"]


class StepLoader:
    """Pure step-indexed loader: batch(k) is a function of k alone."""

    def batch(self, step):
        rng = np.random.default_rng(1000 + step)
        return {"x": rng.standard_normal(8).astype(np.float32)}


# ---------------------------------------------------------------------------
# FaultPlan: determinism, parsing, serialization


def test_plan_spec_and_json_roundtrip(tmp_path):
    spec = ("producer_crash@7,straggler@11:1:0.2,nan_batch@13,"
            "ckpt_fail@20,deadline=0.05,seed=7")
    plan = FaultPlan.from_spec(spec)
    assert plan.kinds_present() == ["ckpt_fail", "nan_batch",
                                    "producer_crash", "straggler"]
    assert plan.seed == 7 and plan.deadline_s == 0.05
    (sg,) = plan.at("straggler", 11)
    assert sg.client == 1 and sg.delay_s == 0.2
    assert plan.at("nan_batch", 12) == []

    # JSON roundtrip through a file is exact (frozen dataclass equality)
    p = tmp_path / "plan.json"
    p.write_text(plan.to_json())
    assert FaultPlan.from_spec(str(p)) == plan

    with pytest.raises(ValueError):
        FaultPlan.from_spec("nonsense-token")
    with pytest.raises(ValueError):
        FaultPlan.from_spec("not_a_kind@3")


def test_plan_sampling_is_seed_deterministic():
    kw = dict(n_clients=4, p_producer_crash=0.1, p_straggler=0.2,
              p_nan_batch=0.1, p_ckpt_fail=0.05)
    a = FaultPlan.sample(5, 60, **kw)
    b = FaultPlan.sample(5, 60, **kw)
    c = FaultPlan.sample(6, 60, **kw)
    assert a == b
    assert a != c
    assert len(a.events) > 0
    assert all(e.step < 60 for e in a.events)
    # stragglers carry a client target and a latency
    for e in a.events:
        if e.kind == "straggler":
            assert e.client is not None and 0 <= e.client < 4
            assert e.delay_s > 0


def test_no_plan_is_a_noop():
    faults.deactivate()
    inj = faults.get()
    assert inj.enabled is False
    batch = {"mask": np.ones(3, np.float32)}
    assert inj.batch_hook(0, batch) is batch     # same object, untouched
    inj.producer(0)
    inj.ckpt_write(0)


# ---------------------------------------------------------------------------
# Producer crash -> bounded retry -> bitwise-identical stream


def test_producer_crash_recovers_bitwise_stream(tmp_path):
    reference = [StepLoader().batch(i) for i in range(6)]
    log = tmp_path / "log.jsonl"
    with obs.enabled(str(log)):
        with faults.injected(FaultPlan.from_spec("producer_crash@3")) as inj:
            pf = PrefetchLoader(StepLoader(), depth=2, retry_backoff_s=0.0)
            got = [pf.batch(i) for i in range(6)]
            pf.close()
    assert pf.retries == 1
    assert [e.kind for e in inj.fired_events] == ["producer_crash"]
    for r, g in zip(reference, got):
        np.testing.assert_array_equal(r["x"], g["x"])
    names = {e["name"] for e in _read_events(log)}
    assert "fault/producer_crash" in names       # the injection
    assert "fault/prefetch_restart" in names     # the recovery


def test_producer_crash_retry_exhaustion_raises():
    # three scheduled crashes at one step, budget of one retry: the
    # injector fires one crash per attempt, so the budget exhausts
    plan = FaultPlan.from_spec(
        "producer_crash@2,producer_crash@2,producer_crash@2")
    with faults.injected(plan):
        pf = PrefetchLoader(StepLoader(), depth=2, max_retries=1,
                            retry_backoff_s=0.0)
        assert pf.batch(0) is not None
        assert pf.batch(1) is not None
        with pytest.raises(InjectedFault):
            pf.batch(2)
        pf.close()


# ---------------------------------------------------------------------------
# Straggler deadline cutoff / client drop / NaN poison (hook level)


def test_straggler_cutoff_and_drop_update_mask():
    plan = FaultPlan.from_spec(
        "straggler@5:2:0.2,client_drop@5:0,deadline=0.05")
    batch = {"mask": np.ones(4, np.float32),
             "tokens": np.arange(4, dtype=np.int32)}
    with faults.injected(plan):
        inj = faults.get()
        clean = inj.batch_hook(4, dict(batch))
        np.testing.assert_array_equal(clean["mask"], np.ones(4))
        out = inj.batch_hook(5, dict(batch))
        # events fire once: a replayed assembly of the same step (e.g.
        # after a producer restart) does not re-inject
        again = inj.batch_hook(5, dict(batch))
    np.testing.assert_array_equal(out["mask"], [0.0, 1.0, 0.0, 1.0])
    np.testing.assert_array_equal(again["mask"], np.ones(4))
    # non-mask fields pass through bitwise
    np.testing.assert_array_equal(out["tokens"], batch["tokens"])


def test_sub_deadline_straggler_keeps_participation():
    plan = FaultPlan.from_spec("straggler@3:1:0.01,deadline=0.05")
    batch = {"mask": np.ones(2, np.float32)}
    with faults.injected(plan):
        out = faults.get().batch_hook(3, dict(batch))
    np.testing.assert_array_equal(out["mask"], np.ones(2))


def test_all_clients_cut_keeps_one():
    plan = FaultPlan.from_spec("client_drop@3:0,client_drop@3:1")
    batch = {"mask": np.ones(2, np.float32)}
    with faults.injected(plan):
        out = faults.get().batch_hook(3, dict(batch))
    # the server can't renormalize an empty round: lowest live client kept
    np.testing.assert_array_equal(out["mask"], [1.0, 0.0])


def test_nan_poison_hits_first_float_field():
    plan = FaultPlan.from_spec("nan_batch@1")
    batch = {"tokens": np.arange(6, dtype=np.int32),
             "mask": np.ones(3, np.float32)}
    with faults.injected(plan):
        out = faults.get().batch_hook(1, dict(batch))
    assert np.isnan(out["mask"].flat[0])
    assert np.isfinite(out["mask"].flat[1:]).all()
    np.testing.assert_array_equal(out["tokens"], batch["tokens"])


# ---------------------------------------------------------------------------
# Checkpoint-write failure -> retry -> resumable checkpoint


def test_ckpt_fail_retries_to_resumable_checkpoint(tmp_path):
    state = {"w": torch.arange(4, dtype=torch.float32)}
    log = tmp_path / "log.jsonl"
    with obs.enabled(str(log)):
        with faults.injected(FaultPlan.from_spec("ckpt_fail@5")):
            ck = AsyncCheckpointer(str(tmp_path / "ck"), retries=2,
                                   backoff_s=0.0)
            ck.save(5, state)
            ck.wait()
    assert ck.last_error is None
    assert latest_step(str(tmp_path / "ck")) == 5
    names = {e["name"] for e in _read_events(log)}
    assert "fault/ckpt_fail" in names
    assert "fault/ckpt_retry" in names


def test_ckpt_fail_exhaustion_surfaces_error(tmp_path):
    state = {"w": torch.zeros(2)}
    plan = FaultPlan.from_spec("ckpt_fail@7,ckpt_fail@7,ckpt_fail@7")
    with faults.injected(plan):
        ck = AsyncCheckpointer(str(tmp_path / "ck"), retries=1,
                               backoff_s=0.0)
        ck.save(7, state)
        with pytest.raises(InjectedFault):
            ck.wait()
    assert latest_step(str(tmp_path / "ck")) is None


# ---------------------------------------------------------------------------
# Guarded step + end-to-end chaos runs (reduced minitron-4b)


def _chaos_setup(ckpt_dir, steps=30, prefetch=True):
    cfg = reduced(get_config("minitron-4b"))
    mp = MPSLConfig(n_clients=4, trainable_blocks=1, head_adapter_rank=4)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype="float32", learning_rate=1e-3,
                    attn_impl="kernel", ce_impl="kernel")
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), cfg, run)
    state = mpsl.init_state(params, frozen)
    fn = mpsl.make_train_step(mpsl.make_lm_loss(cfg, run), run,
                              schedules.constant(1e-3), guard_nonfinite=True)
    inner = make_lm_loader(cfg, 4, 2, 24, seed=0)
    loader = (PrefetchLoader(inner, depth=2, retry_backoff_s=0.0,
                             place_fn=lambda b: sharding.place_batch(b, "cpu"))
              if prefetch else inner)
    tc = TrainerConfig(total_steps=steps, ckpt_every=10,
                       ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
                       log_every=10)
    return state, fn, loader, tc


def _assert_trees_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_nonfinite_guard_skip_leaves_state_untouched():
    """An injected NaN batch skips the update with params AND Adam
    moments bitwise untouched, while the step counter still advances
    (keeping the loader/rng schedule aligned)."""
    # synchronous loader: a prefetcher would speculatively assemble
    # batch 1 before the plan activates (chaos runs activate the plan
    # before building the pipeline, as launch/train.py does)
    state, step_fn, loader, _ = _chaos_setup(None, steps=2, prefetch=False)
    state, m0 = step_fn(state, sharding.take_batch(loader.batch(0), "cpu"))
    assert float(m0["skipped"]) == 0.0
    assert np.isfinite(float(m0["loss"]))

    params_before = tree.map_(lambda x: x.detach().clone(), state["params"])
    opt_before = tree.map_(lambda x: x.detach().clone(), state["opt"])
    step_before = state["step"]

    with faults.injected(FaultPlan.from_spec("nan_batch@1")):
        b1 = loader.batch(1)
    assert np.isnan(np.asarray(b1["mask"]).flat[0])
    state, m1 = step_fn(state, sharding.take_batch(b1, "cpu"))
    assert float(m1["skipped"]) == 1.0
    assert float(m1["participating"]) == 0.0
    assert state["step"] == step_before + 1
    _assert_trees_equal(params_before, state["params"])
    _assert_trees_equal(opt_before, state["opt"])


PLAN_FULL = ("producer_crash@7,straggler@11:1:0.2,nan_batch@13,"
             "ckpt_fail@20,deadline=0.05")


def test_chaos_end_to_end_30_steps(tmp_path):
    """A 30-step run under a seeded plan (producer crash, straggler past
    deadline, NaN batch, one ckpt-write failure) completes; every
    injection and recovery lands as a `fault/*` event; and the same plan
    run 15 steps + checkpoint + rebuild + resume lands on bitwise-equal
    parameters and optimizer state."""
    plan = FaultPlan.from_spec(PLAN_FULL)
    log_path = str(tmp_path / "chaos_e2e.jsonl")

    # -- straight 30-step run, with the run log enabled
    with obs.enabled(log_path, meta={"test": "chaos_e2e",
                                     "fault_plan": PLAN_FULL}):
        with faults.injected(plan) as inj:
            state, fn, loader, tc = _chaos_setup(tmp_path / "a")
            t = Trainer(fn, state, loader, tc, log_fn=lambda s: None)
            res = t.run()
            loader.close()
    straight = t.state

    assert res["final_loss"] is not None and np.isfinite(res["final_loss"])
    assert res["skipped_steps"] == [13]
    assert loader.retries == 1
    assert {e.kind for e in inj.fired_events} == {
        "producer_crash", "straggler", "nan_batch", "ckpt_fail"}

    names = [e["name"] for e in _read_events(log_path)]
    for required in ("fault/plan_activated",
                     "fault/producer_crash", "fault/prefetch_restart",
                     "fault/straggler_cutoff",
                     "fault/nan_batch", "fault/step_skipped",
                     "fault/ckpt_fail", "fault/ckpt_retry"):
        assert required in names, f"missing {required} in run log"
    skip = next(e for e in _read_events(log_path)
                if e["name"] == "fault/step_skipped")
    assert skip["fields"]["step"] == 13

    # the report renderer groups the fault events into its own section
    text = report.render(report.load_records(log_path))
    assert "faults" in text and "fault/nan_batch" in text

    # -- same plan: 15 steps, checkpoint, rebuild from scratch, resume
    with faults.injected(plan):
        state, fn, loader, tc = _chaos_setup(tmp_path / "b")
        t1 = Trainer(fn, state, loader, tc, log_fn=lambda s: None)
        t1.run(15)
        loader.close()
    assert t1.skipped_steps == [13]
    with faults.injected(plan):
        state, fn, loader2, tc = _chaos_setup(tmp_path / "b")
        t2 = Trainer(fn, state, loader2, tc, log_fn=lambda s: None)
        assert t2.state["step"] == 15
        t2.run(30)
        loader2.close()

    _assert_trees_equal(straight["params"], t2.state["params"])
    _assert_trees_equal(straight["opt"], t2.state["opt"])
    assert straight["step"] == t2.state["step"] == 30


def test_recovered_faults_are_invisible(tmp_path):
    """Faults whose recovery is exact (producer crash, ckpt-write
    failure) leave the training trajectory bitwise identical to an
    uninjected run — the retries reproduce exactly the work the fault
    interrupted."""
    plan = FaultPlan.from_spec("producer_crash@4,ckpt_fail@10")
    with faults.injected(plan) as inj:
        state, fn, loader, tc = _chaos_setup(tmp_path / "ck", steps=12)
        tc.ckpt_every = 5
        t1 = Trainer(fn, state, loader, tc, log_fn=lambda s: None)
        t1.run()
        loader.close()
    assert {e.kind for e in inj.fired_events} == {"producer_crash",
                                                  "ckpt_fail"}
    assert t1.skipped_steps == []

    state, fn, loader2, tc2 = _chaos_setup(None, steps=12)
    t2 = Trainer(fn, state, loader2, tc2, log_fn=lambda s: None)
    t2.run()
    loader2.close()

    _assert_trees_equal(t1.state["params"], t2.state["params"])
    _assert_trees_equal(t1.state["opt"], t2.state["opt"])


# ---------------------------------------------------------------------------
# Parity with the JAX package


SPECS = ("producer_crash@7,straggler@11:1:0.2,nan_batch@13,ckpt_fail@20,"
         "deadline=0.05,seed=7",
         "client_drop@3:0,client_drop@3:1,producer_delay@2::0.01",
         "straggler@5:2:0.2,client_drop@5:0,deadline=0.1,simulate_wait=1")


@pytest.mark.parametrize("spec", SPECS)
def test_plans_match_jax(spec, tmp_path):
    """from_spec, to_json, a JSON file and sample(seed) give the JAX
    package's plans."""
    got, want = FaultPlan.from_spec(spec), jfaults.FaultPlan.from_spec(spec)
    assert got.to_json() == want.to_json()
    assert [e.to_dict() for e in got.events] == \
        [e.to_dict() for e in want.events]
    p = tmp_path / "plan.json"
    p.write_text(want.to_json())
    assert FaultPlan.from_spec(str(p)).to_json() == want.to_json()
    kw = dict(n_clients=4, p_producer_crash=0.1, p_producer_delay=0.05,
              p_straggler=0.2, p_client_drop=0.1, p_nan_batch=0.1,
              p_ckpt_fail=0.05)
    for seed in (0, 5):
        assert FaultPlan.sample(seed, 40, **kw).to_json() == \
            jfaults.FaultPlan.sample(seed, 40, **kw).to_json()


def test_batch_hook_matches_jax():
    """The same plan on the same batch gives bitwise-equal masks and
    poison, firing the same events."""
    plan = ("straggler@1:2:0.2,client_drop@1:0,nan_batch@2,"
            "client_drop@3:0,client_drop@3:1,client_drop@3:2,"
            "client_drop@3:3,straggler@4:1:0.01,deadline=0.05")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 9, (4, 2, 6)).astype(np.int32),
             "frame_embeds": rng.standard_normal((4, 2, 3, 5),
                                                 dtype=np.float32),
             "mask": np.array([1, 1, 0, 1], np.float32)}
    with faults.injected(FaultPlan.from_spec(plan)) as a, \
            jfaults.injected(jfaults.FaultPlan.from_spec(plan)) as b:
        for step in range(6):
            got = a.batch_hook(step, dict(batch))
            want = b.batch_hook(step, dict(batch))
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    assert [e.to_dict() for e in a.fired_events] == \
        [e.to_dict() for e in b.fired_events]


def test_loader_under_a_plan_matches_jax():
    """``ClientLoader.batch`` (through make_lm_loader) under an active
    plan is bitwise equal to the JAX package's loader under the same
    plan, the mask cut, dropped and NaN-poisoned at the same steps."""
    plan = "straggler@1:0:0.2,client_drop@2:1,nan_batch@3,deadline=0.05"
    cfg = reduced(get_config("minitron-4b"))
    jcfg = jreduced(jget_config("minitron-4b"))
    with faults.injected(FaultPlan.from_spec(plan)), \
            jfaults.injected(jfaults.FaultPlan.from_spec(plan)):
        got = make_lm_loader(cfg, 4, 2, 16, seed=2, drop_prob=0.2)
        want = jmake_lm_loader(jcfg, 4, 2, 16, seed=2, drop_prob=0.2)
        for step in range(5):
            a, b = got.batch(step), want.batch(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            if step == 3:
                assert np.isnan(a["mask"][0])
