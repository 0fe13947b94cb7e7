"""The port's telemetry layer on the CPU: the recorder and report round
trips, prefetcher health telemetry, the runtime link accounting against
``core.costs``, an obs-enabled Trainer run (the cases of
``tests/test_obs.py``, each against the port's own objects), and parity
with the JAX package: the same records from the same recorder calls, the
same report text from the same file, the same link records after one
step. Then the serve and train CLIs' run logs."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import obs as jobs
from repro.configs import MPSLConfig as JMPSLConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import mpsl as jmpsl
from repro.core import split as jsplit
from repro.obs import comm as jcomm
from repro.obs import report as jreport
from repro_torch import obs
from repro_torch.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro_torch.core import compression, costs, mpsl, split
from repro_torch.data import PrefetchLoader
from repro_torch.launch import serve
from repro_torch.launch.train import make_lm_loader
from repro_torch.obs import comm, report
from repro_torch.optim import schedules
from repro_torch.parallel import sharding
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import trainer as trainer_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_globals():
    """The recorder and the link table are process globals (one set in
    each package): every test starts and ends without them."""
    obs.shutdown()
    comm.reset()
    yield
    obs.shutdown()
    comm.reset()
    jobs.shutdown()
    jcomm.reset()


# ---------------------------------------------------------------------------
# Recorder


def test_noop_default_is_inert():
    assert obs.get().enabled is False
    with obs.span("x/y", step=1):        # shared null span: no alloc, no IO
        pass
    obs.event("x/e")
    obs.counter("x/c")
    obs.gauge("x/g", 1.0)
    obs.observe("x/h", 0.5)
    assert obs.get() is obs.get()        # singleton


def test_recorder_jsonl_roundtrip(tmp_path):
    path = tmp_path / "log.jsonl"
    with obs.enabled(str(path), meta={"who": "test"}) as rec:
        assert obs.get() is rec and rec.enabled
        with rec.span("stage/a", step=3):
            pass
        rec.counter("n/steps", 2)
        rec.counter("n/steps", 3)
        rec.gauge("q/depth", 4, step=3)
        rec.observe("wall_s", 0.25)
        rec.observe("wall_s", 0.75)
        rec.event("boom", level="error", detail="x")
        # error events flush immediately (crash durability): visible
        # before close
        on_disk = [json.loads(l) for l in path.read_text().splitlines()]
        assert any(r["kind"] == "event" and r["level"] == "error"
                   for r in on_disk)
    assert obs.get().enabled is False    # context restored the no-op
    recs = report.load_records(str(path))
    by_kind = {}
    for r in recs:
        by_kind.setdefault(r["kind"], []).append(r)
    assert by_kind["meta"][0]["fields"] == {"who": "test"}
    span = by_kind["span"][0]
    assert span["name"] == "stage/a" and span["dur_s"] >= 0
    assert span["fields"] == {"step": 3}
    assert by_kind["counter"][-1]["total"] == 5
    hist = [h for h in by_kind["hist"] if h["name"] == "wall_s"][0]
    assert hist["count"] == 2 and hist["sum"] == 1.0
    assert hist["min"] == 0.25 and hist["max"] == 0.75


def test_report_renders_tables():
    records = [
        {"kind": "meta", "name": "run", "run_id": "abc", "fields": {}},
        {"kind": "span", "name": "step/dispatch", "dur_s": 0.01,
         "fields": {}},
        {"kind": "span", "name": "step/dispatch", "dur_s": 0.03,
         "fields": {}},
        {"kind": "link", "name": "uplink.activations",
         "direction": "uplink", "n_clients": 4,
         "per_client_shape": [2, 32, 64], "dtype": "bfloat16",
         "raw_bytes_per_client": 8192, "wire_bytes_per_client": 4352,
         "compressed": True, "bits": 8, "per_step": True,
         "quantized_in_trace": True},
        {"kind": "gauge", "name": "prefetch/queue_depth", "value": 2},
        {"kind": "event", "name": "prefetch/producer_error",
         "level": "error", "fields": {"step": 7, "error": "boom"}},
    ]
    out = report.render(records)
    assert "step/dispatch" in out and "uplink.activations" in out
    assert "traced" in out               # quant state column
    assert "ERROR prefetch/producer_error" in out
    # per-step aggregate: 4 clients x 4352 wire bytes = 17408 = 17.0KB
    assert "17.0KB" in out


def test_recorder_rotation_bounds_log_size(tmp_path):
    path = tmp_path / "log.jsonl"
    with obs.enabled(str(path), meta={"who": "rot"}, flush_every=1,
                     max_bytes=1500) as rec:
        for i in range(200):
            rec.event("spam", i=i)
    assert rec.rotations >= 1
    rotated = tmp_path / "log.jsonl.1"
    assert rotated.exists()
    # total footprint bounded by ~2x the cap (one flush of slack each)
    assert path.stat().st_size <= 2 * 1500
    assert rotated.stat().st_size <= 2 * 1500
    head = [json.loads(l) for l in path.read_text().splitlines()]
    tail = [json.loads(l) for l in rotated.read_text().splitlines()]
    # the live file re-opens self-describing: meta record first, carrying
    # the rotation count and the original run fields
    assert head[0]["kind"] == "meta"
    assert head[0]["fields"] == {"who": "rot"}
    assert head[0]["rotation"] >= 1
    # the rotation boundary loses nothing: rotated + live cover a
    # contiguous suffix of the stream, ending at the newest event
    seen = [r["fields"]["i"] for r in tail + head
            if r.get("kind") == "event" and r["name"] == "spam"]
    assert seen == list(range(min(seen), 200))


def _drive_recorder(mod, path):
    """The same calls against one package's recorder module."""
    with mod.enabled(str(path), meta={"who": "parity", "n": 3},
                     flush_every=4) as rec:
        with rec.span("stage/a", step=1):
            pass
        rec.counter("n/steps", 2)
        rec.counter("n/steps", 3, step=4)
        rec.gauge("q/depth", 4, step=3)
        for v in (0.25, 0.75, 3.0, 0.0):
            rec.observe("wall_s", v)
        rec.link({"name": "uplink.activations", "direction": "uplink",
                  "n_clients": 2, "per_client_shape": [2, 12, 64],
                  "dtype": "float32", "raw_bytes_per_client": 6144,
                  "wire_bytes_per_client": 6144, "compressed": False,
                  "bits": 32, "per_step": True})
        rec.link({"name": "uplink.activations", "direction": "uplink",
                  "n_clients": 2, "per_client_shape": [2, 12, 64],
                  "dtype": "float32", "raw_bytes_per_client": 6144,
                  "wire_bytes_per_client": 6144, "compressed": False,
                  "bits": 32, "per_step": True})      # a duplicate: dropped
        mod.get_logger("train", printer=lambda s: None).info("hello", k=1)
        rec.event("boom", level="error", detail="x")
    recs = [json.loads(l) for l in path.read_text().splitlines()]
    for r in recs:
        r.pop("ts")
        r.pop("run_id", None)
        if r["kind"] == "span":
            r.pop("dur_s")
    return recs


def test_recorder_records_match_jax(tmp_path):
    """The same recorder calls write the same records as the JAX
    package's recorder, apart from the time stamps, the run id and the
    spans' wall durations."""
    got = _drive_recorder(obs, tmp_path / "port.jsonl")
    want = _drive_recorder(jobs, tmp_path / "jax.jsonl")
    assert got == want
    assert [r["kind"] for r in got].count("link") == 1


def test_report_text_matches_jax(tmp_path):
    path = tmp_path / "log.jsonl"
    _drive_recorder(obs, path)
    with open(path, "a") as f:
        f.write("not json\n")                 # a corrupt line, both skip it
    assert report.load_records(str(path)) == jreport.load_records(str(path))
    recs = report.load_records(str(path))
    bench = {"entries": [{"cell": "a", "variant": "overlap",
                          "steps_per_sec": 2.5, "host_stall_frac": 0.1}]}
    assert report.render(recs, bench) == jreport.render(recs, bench)
    assert report.main([str(path)]) == 0


# ---------------------------------------------------------------------------
# Prefetcher health telemetry


class _Boom:
    def batch(self, step):
        if step == 3:
            raise RuntimeError("boom")
        return {"x": np.zeros(2)}


def test_prefetch_health_gauges_and_terminal_error_event(tmp_path):
    path = tmp_path / "log.jsonl"
    with obs.enabled(str(path)):
        pf = PrefetchLoader(_Boom(), depth=2)
        pf.batch(0)
        pf.batch(1)
        h = pf.health()
        assert h["restarts"] == 1 and h["queue_capacity"] == 2
        assert h["produced"] >= 2
        assert h["producer_wait_s"] >= 0.0
        # out-of-order read reseeds the producer
        pf.batch(0)
        assert pf.health()["restarts"] == 2
        with pytest.raises(RuntimeError, match="boom"):
            for k in range(1, 5):
                pf.batch(k)
        assert isinstance(pf.last_error, RuntimeError)
    recs = report.load_records(str(path))
    errs = [r for r in recs if r.get("kind") == "event"
            and r.get("level") == "error"]
    assert errs and errs[0]["name"] == "prefetch/producer_error"
    assert errs[0]["fields"]["step"] == 3
    spans = {r["name"] for r in recs if r.get("kind") == "span"}
    assert "host/assemble" in spans


# ---------------------------------------------------------------------------
# Runtime link accounting vs the core.costs analytic model


def _port_lm_links(compressed: bool, n=2, bn=2, seq=32,
                   dtype="bfloat16"):
    """The link table after one loss and backward of reduced minitron-4b
    on the port (the downlink's quant8 runs on the cotangent)."""
    comm.reset()
    cfg = reduced(get_config("minitron-4b"))
    mp = MPSLConfig(n_clients=n, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=compressed,
                    compress_downlink=compressed)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq)
    run = RunConfig(model=cfg, shape=shape, mpsl=mp, compute_dtype=dtype,
                    attn_impl="kernel", ce_impl="kernel")
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), cfg, run)
    state = mpsl.init_state(params, frozen)
    batch = {"tokens": torch.zeros((n, bn, seq), dtype=torch.int64),
             "labels": torch.zeros((n, bn, seq), dtype=torch.int64),
             "mask": torch.ones((n,))}
    mpsl.value_and_grad(mpsl.make_lm_loss(cfg, run), state["params"],
                        frozen, batch, 1)
    links = {e["name"]: e for e in comm.snapshot()}
    return cfg, mp, shape, links


@pytest.mark.parametrize("compressed", [False, True])
def test_runtime_link_bytes_match_analytic_model(compressed):
    """Measured per-step link bytes agree with the core.costs analytic
    model: exactly when uncompressed, within the per-row quant8 scale
    overhead when compressed."""
    bn, seq = 2, 32
    cfg, mp, shape, links = _port_lm_links(compressed, bn=bn, seq=seq)
    up = links["uplink.activations"]
    down = links["downlink.gradients"]
    assert up["n_clients"] == mp.n_clients
    assert up["per_client_shape"] == [bn, seq, cfg.d_model]
    assert up["compressed"] is compressed

    measured_per_sample = (up["wire_bytes_per_client"]
                           + down["wire_bytes_per_client"]) / bn
    analytic = costs.mpsl_lm_client_cost(
        cfg, mp, shape, compressed=compressed).comm_mb_per_epoch * 1e6
    overhead = (2 * seq * compression.SCALE_BYTES) if compressed else 0
    assert 0 <= measured_per_sample - analytic <= overhead, (
        measured_per_sample, analytic, overhead)
    if compressed:
        # quant8 actually ran on both links, and the wire format matches
        # compression.compressed_bytes exactly
        assert up.get("quantized_in_trace") is True
        assert down.get("quantized_in_trace") is True
        assert up["wire_bytes_per_client"] == compression.compressed_bytes(
            (bn, seq, cfg.d_model))
    else:
        assert up["wire_bytes_per_client"] == up["raw_bytes_per_client"]
    # one-time head-FedAvg link from core.split
    head = links["aggregation.client_head"]
    assert head["per_step"] is False
    assert head["raw_bytes_per_client"] == head["wire_bytes_per_client"] > 0


@pytest.mark.parametrize("compressed", [False, True])
def test_link_records_match_jax(compressed):
    """The port's link table after one step equals the JAX package's
    after its loss is traced at the same config, field for field; the
    quant impl is named for each package's kernel entry ("kernel" in the
    port, "pallas" in the JAX package)."""
    n, bn, seq = 2, 2, 16
    _, _, _, got = _port_lm_links(compressed, n, bn, seq, "float32")
    jcomm.reset()
    jcfg = jreduced(jget_config("minitron-4b"))
    jmp = JMPSLConfig(n_clients=n, trainable_blocks=1, head_adapter_rank=4,
                      compress_uplink=compressed,
                      compress_downlink=compressed)
    jrun = JRunConfig(model=jcfg, shape=JSHAPES["train_4k"], mpsl=jmp,
                      compute_dtype="float32")
    params, frozen, _ = jsplit.init_mpsl_lm(jax.random.PRNGKey(0), jcfg,
                                            jrun)
    jb = {"tokens": jnp.zeros((n, bn, seq), jnp.int32),
          "labels": jnp.zeros((n, bn, seq), jnp.int32),
          "mask": jnp.ones((n,), jnp.float32)}
    jax.eval_shape(jax.grad(lambda p: jmpsl.make_lm_loss(jcfg, jrun)(
        p, frozen, jb, jax.random.PRNGKey(1))[0]), params)
    want = {e["name"]: e for e in jcomm.snapshot()}
    for e in want.values():
        if "quant_impl" in e:
            assert e["quant_impl"] == "pallas"
            e["quant_impl"] = "kernel"
    assert got == want
    assert set(got) == {"uplink.activations", "downlink.gradients",
                        "aggregation.client_head"}


def test_link_records_reach_the_recorder_once_a_change(monkeypatch):
    """Eager steps fire the hooks every step; a link reaches the
    recorder only when it is new or changed: its first record, then the
    quantized refinement (the uplink's quant8 marks both links, whose
    payloads match), and nothing from later steps."""
    sent = []

    class _Cap(obs.NullRecorder):
        def link(self, rec):
            sent.append(rec)

    monkeypatch.setattr(obs.recorder, "_active", _Cap())
    cfg = reduced(get_config("minitron-4b"))
    mp = MPSLConfig(n_clients=2, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=True, compress_downlink=True)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                    compute_dtype="float32", attn_impl="kernel",
                    ce_impl="kernel")
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(0), cfg, run)
    state = mpsl.init_state(params, frozen)
    step = mpsl.make_train_step(mpsl.make_lm_loss(cfg, run), run,
                                schedules.constant(1e-3))
    loader = make_lm_loader(cfg, 2, 2, 12, seed=0)
    for i in range(3):
        state, _ = step(state, sharding.take_batch(loader.batch(i), "cpu"))
    names = [r["name"] for r in sent]
    assert names == ["aggregation.client_head", "uplink.activations",
                     "downlink.gradients", "uplink.activations",
                     "downlink.gradients"]
    assert all(r["quantized_in_trace"] for r in sent[3:])
    assert sent[3:] == [e for e in comm.snapshot()
                        if e["name"] != "aggregation.client_head"]


def test_mask_aware_link_accounting_matches_costs():
    """The link records assume full participation; the runtime mask
    weighting must agree with the core.costs analytic model scaled by the
    recorded participation fraction."""
    bn, seq = 2, 32
    cfg, mp, shape, links = _port_lm_links(False, bn=bn, seq=seq)
    agg = comm.per_step_wire_bytes()
    assert agg["participation_frac"] == 1.0      # nothing recorded yet
    assert agg["total_masked"] == agg["total"]

    # runtime mask: one of two clients cut on half the steps; replays of
    # a step (speculative re-assembly, restart) are idempotent
    comm.note_participation(0, 2.0, 2)
    comm.note_participation(1, 1.0, 2)
    comm.note_participation(1, 1.0, 2)
    ps = comm.participation_summary()
    assert ps["steps"] == 2
    assert ps["avg_frac"] == 0.75 and ps["min_frac"] == 0.5

    agg = comm.per_step_wire_bytes()
    assert agg["total_masked"] == int(round(agg["total"] * 0.75))
    analytic = costs.mpsl_lm_client_cost(
        cfg, mp, shape, compressed=False).comm_mb_per_epoch * 1e6
    assert agg["total"] == pytest.approx(analytic * bn * mp.n_clients)
    assert agg["total_masked"] == pytest.approx(
        0.75 * analytic * bn * mp.n_clients, abs=1)

    # the run-log mirror emits the participation gauges
    class _Cap:
        def __init__(self):
            self.gauges = {}

        def link(self, rec):
            pass

        def gauge(self, name, value, **fields):
            self.gauges[name] = (value, fields)

    cap = _Cap()
    comm.emit_snapshot(cap)
    val, fields = cap.gauges["comm/participation_frac"]
    assert val == 0.75 and fields["steps"] == 2
    assert cap.gauges["comm/per_step_wire_bytes_masked"][0] == agg[
        "total_masked"]


# ---------------------------------------------------------------------------
# End-to-end: an obs-enabled trainer produces a renderable run log without
# changing the dispatch/readback pattern


def test_trainer_obs_end_to_end(tmp_path, monkeypatch):
    log_path = tmp_path / "trainer_runlog.jsonl"
    readbacks = []
    real = trainer_mod.to_host
    monkeypatch.setattr(trainer_mod, "to_host",
                        lambda m: (readbacks.append(1), real(m))[1])

    steps = 5
    with obs.enabled(str(log_path), meta={"test": "trainer_e2e"}):
        cfg = reduced(get_config("minitron-4b"))
        mp = MPSLConfig(n_clients=2, trainable_blocks=1,
                        head_adapter_rank=4)
        run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                        compute_dtype="float32", learning_rate=1e-3,
                        attn_impl="kernel", ce_impl="kernel")
        params, frozen, _ = split.init_mpsl_lm(
            torch.Generator().manual_seed(0), cfg, run)
        state = mpsl.init_state(params, frozen)
        step_fn = mpsl.make_train_step(mpsl.make_lm_loss(cfg, run), run,
                                       schedules.constant(1e-3))
        dispatches = []

        def counted_step(state, batch):
            dispatches.append(1)
            return step_fn(state, batch)

        loader = PrefetchLoader(make_lm_loader(cfg, 2, 2, 24, seed=0),
                                depth=2, place_fn=lambda b:
                                sharding.place_batch(b, "cpu"))
        t = Trainer(counted_step, state, loader,
                    TrainerConfig(total_steps=steps, log_every=100),
                    log_fn=lambda s: None)
        out = t.run()
        loader.close()

    assert out["final_loss"] is not None
    # telemetry neutrality: one dispatch per step, and the only readbacks
    # are the two log boundaries (first-step log + final)
    assert len(dispatches) == steps
    assert len(readbacks) == 2

    recs = report.load_records(str(log_path))
    spans = {}
    for r in recs:
        if r.get("kind") == "span":
            spans[r["name"]] = spans.get(r["name"], 0) + 1
    assert spans["step/dispatch"] == steps
    assert spans["step/get_batch"] == steps
    assert spans["metrics/readback"] == 2
    assert spans.get("host/assemble", 0) >= steps      # prefetch producer
    assert spans.get("h2d/place_batch", 0) >= steps
    links = {r["name"] for r in recs if r.get("kind") == "link"}
    assert "uplink.activations" in links
    assert "downlink.gradients" in links
    gauges = {r["name"] for r in recs if r.get("kind") == "gauge"}
    assert "train/loss" in gauges and "prefetch/queue_depth" in gauges
    hists = {r["name"] for r in recs if r.get("kind") == "hist"}
    assert "step/wall_s" in hists
    events = {r["name"] for r in recs if r.get("kind") == "event"}
    assert {"trainer/run_start", "trainer/run_end"} <= events
    rendered = report.render(recs)
    assert "step/dispatch" in rendered
    assert "uplink.activations" in rendered


def test_profile_window_writes_a_trace(tmp_path):
    """The opt-in window traces steps [start, start + num) and exports a
    Chrome trace; with no directory it stays inert."""
    inert = obs.ProfileWindow(None)
    inert.on_step(10)
    inert.stop()
    path = tmp_path / "log.jsonl"
    with obs.enabled(str(path)):
        pw = obs.ProfileWindow(str(tmp_path / "prof"), start_step=1,
                               num_steps=2)
        for step in range(5):
            pw.on_step(step)
            torch.ones(4).sum()
        pw.stop()
    trace = tmp_path / "prof" / "trace_1.json"
    assert trace.exists() and json.loads(trace.read_text())
    names = [r["name"] for r in report.load_records(str(path))
             if r.get("kind") == "event"]
    assert names == ["profile/started", "profile/stopped"]


# ---------------------------------------------------------------------------
# The CLIs' run logs


def test_serve_cli_writes_a_run_log(tmp_path, capsys):
    """``--obs-log`` writes the recorder's run log (meta, the structured
    logger's lines), as the JAX package's serve CLI does, and the
    report renders it."""
    log = tmp_path / "serve.jsonl"
    assert serve.main(["--device", "cpu", "--reduced", "--batch", "2",
                       "--prompt-len", "6", "--decode-steps", "2",
                       "--obs-log", str(log)]) == 0
    recs = report.load_records(str(log))
    assert recs[0]["kind"] == "meta"
    assert recs[0]["fields"]["driver"] == "serve"
    lines = [r for r in recs if r.get("name") == "serve/log"]
    assert len(lines) == 2 and "ms_per_tok" in lines[0]["fields"]
    assert obs.get().enabled is False            # shut down at the end
    text = report.render(recs)
    assert text.startswith("run ") and "(2 info, 0 error)" in text
    assert "[serve] batch=2" in capsys.readouterr().out


def test_train_cli_checkpoints_resumes_and_logs_under_a_fault_plan(
        tmp_path):
    """``--ckpt-dir --obs-log --fault-plan`` at reduced size: the run
    exits 0 with the planned step skipped, a second run resumes from its
    checkpoint, and the run log renders with the fault table."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ck, log = tmp_path / "ck", tmp_path / "run.jsonl"
    common = [sys.executable, "-m", "repro_torch.launch.train", "--device",
              "cpu", "--seq", "16", "--n-clients", "2",
              "--trainable-blocks", "1", "--ckpt-dir", str(ck),
              "--ckpt-every", "2", "--obs-log", str(log)]
    first = subprocess.run(
        common + ["--steps", "4", "--fault-plan",
                  "producer_crash@1,nan_batch@2,ckpt_fail@2"],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert first.returncode == 0, first.stderr
    s1 = json.loads(first.stdout.strip().splitlines()[-1])
    assert s1["skipped_steps"] == [2] and s1["start_step"] == 0
    assert np.isnan(s1["losses"][2]) and np.isfinite(s1["final_loss"])
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004"]
    second = subprocess.run(common + ["--steps", "6"], capture_output=True,
                            text=True, env=env, timeout=300, cwd=tmp_path)
    assert second.returncode == 0, second.stderr
    s2 = json.loads(second.stdout.strip().splitlines()[-1])
    assert s2["start_step"] == 4 and len(s2["losses"]) == 2
    assert "resumed from step 4" in second.stdout
    rendered = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(log)],
        capture_output=True, text=True, env=env, timeout=60)
    assert rendered.returncode == 0, rendered.stderr
    for want in ("step/dispatch", "uplink.activations", "fault/ckpt_retry",
                 "fault/step_skipped", "fault/prefetch_restart"):
        assert want in rendered.stdout
