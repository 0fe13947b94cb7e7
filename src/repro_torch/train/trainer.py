"""Fault-tolerant MPSL training loop (counterpart of the JAX package's
``train/trainer.py``).

Fault-tolerance mechanisms:

  * checkpoint/restart — async checkpoints every `ckpt_every` steps; on
    construction the trainer auto-resumes from the latest complete
    checkpoint. The data pipeline is step-indexed, so the restarted run
    consumes exactly the batches the failed run would have.
  * straggler / dropout masking — the loader emits a per-step client
    participation mask; the MPSL aggregated loss renormalizes weights, so
    a slow or dead client simply contributes weight 0 that step.
  * elastic clients — a client joining mid-run receives the FedAvg of the
    live client heads.
  * crash-consistency — checkpoint publishing is atomic (write-temp +
    rename); a kill at any point leaves a loadable directory.

Pipeline overlap: the loop itself never forces a device sync. Metrics
stay on device in a small ring (`MetricsRing`) and are read back only at
log boundaries and at the end of the run, one copy to the host a
readback; per-step wall times are recorded from the host side without
blocking (they measure the host's time to enqueue a step, not device
compute — the run-level `steps_per_sec` is the synchronized number).
With a prefetching loader (`repro_torch.data.PrefetchLoader` with
`place_fn=parallel.sharding.place_batch`) host batch assembly, the H2D
copy and device compute all overlap, and the step updates the state in
place (the reference's donation).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import obs as obs_mod
from repro_torch import tree
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.core import aggregation
from repro_torch.obs.spans import ProfileWindow
from repro_torch.parallel import sharding


class MetricsRing:
    """Fixed-size ring of on-device step metrics. Pushing never syncs;
    reading copies exactly one entry to the host. Keeping at most `size`
    metric dicts alive bounds how many in-flight steps the host can run
    ahead."""

    def __init__(self, size: int = 64):
        self.size = size
        self._slots = [None] * size

    def push(self, step: int, metrics):
        self._slots[step % self.size] = (step, metrics)

    def latest(self):
        live = [s for s in self._slots if s is not None]
        return max(live, key=lambda s: s[0]) if live else None

    def read_latest(self) -> Optional[Dict[str, Any]]:
        """Host copy (numpy) of the newest entry: its device tensors
        flattened into one f64 tensor (exact for f32 and int32 values)
        and copied with one ``.cpu()`` — one sync."""
        ent = self.latest()
        if ent is None:
            return None
        step, m = ent
        return dict(to_host(m), step=step)

    def entries_after(self, start_step: int):
        """Live (step, metrics) entries with step > start_step, ascending.
        Metrics stay on device — touching a value is what blocks, so
        callers that only inspect dict keys stay sync-free."""
        live = [s for s in self._slots
                if s is not None and s[0] > start_step]
        return sorted(live, key=lambda s: s[0])


def to_host(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """{name: numpy value} of a metrics dict, with one device-to-host copy
    for all its device tensors (CPU tensors and Python numbers are read
    as they are)."""
    out, dev = {}, []
    for k, v in metrics.items():
        if torch.is_tensor(v) and v.device.type != "cpu":
            dev.append((k, v))
        else:
            out[k] = (v.detach().numpy() if torch.is_tensor(v)
                      else v)
    if dev:
        flat = torch.cat([v.detach().reshape(-1).to(torch.float64)
                          for _, v in dev]).cpu()
        i = 0
        for k, v in dev:
            n = v.numel()
            out[k] = flat[i:i + n].to(v.dtype).reshape(v.shape).numpy()
            i += n
    return {k: out[k] for k in metrics}


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    metrics_ring: int = 64
    # opt-in torch.profiler trace window (deep dives; inert when None —
    # the span telemetry never measures device time, by design)
    profile_dir: Optional[str] = None
    profile_start: int = 5
    profile_steps: int = 3


class Trainer:
    def __init__(self, step_fn: Callable, state, loader, config: TrainerConfig,
                 log_fn: Callable[[str], None] = print,
                 recorder=None):
        self.step_fn = step_fn
        self.state = state
        self.loader = loader
        self.cfg = config
        self.log = log_fn
        # the step's device: a batch that arrives unplaced goes there
        self.device = tree.leaves(state["params"])[0].device
        # ambient recorder resolved at construction; pass one explicitly
        # to pin a sink. All obs calls are host-side wall-clock only —
        # the step's launches and syncs are identical with telemetry on
        # or off (asserted in tests/test_torch_pipeline.py).
        self.obs = recorder if recorder is not None else obs_mod.get()
        self.ckpt = (AsyncCheckpointer(config.ckpt_dir, config.keep)
                     if config.ckpt_dir else None)
        self.metrics_history: list = []
        self.ring = MetricsRing(config.metrics_ring)
        self.step_times: list = []      # host time to enqueue each step (s)
        self.skipped_steps: list = []   # non-finite guard skips (fault mode)
        self._skip_scan_from = 0        # ring high-water mark for the scan
        self._profile = ProfileWindow(config.profile_dir,
                                      config.profile_start,
                                      config.profile_steps)
        self._maybe_resume()

    # -- fault tolerance ----------------------------------------------------

    def _maybe_resume(self):
        if not self.ckpt:
            return
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return
        restored, manifest = restore_checkpoint(self.cfg.ckpt_dir,
                                                self.state)
        if restored is not None:
            self.state = restored
            self.log(f"[trainer] resumed from step {step}")

    def checkpoint_now(self):
        if self.ckpt:
            step = int(self.state["step"])
            self.ckpt.save(step, self.state, extra={"step": step})

    @torch.no_grad()
    def rejoin_client(self, client_idx: int):
        """Elastic join: reinitialize a client head from the FedAvg of the
        current bank (paper Sec. 3.3 aggregation, applied online), in
        place."""
        heads = self.state["params"]["client"]
        agg = aggregation.fedavg_heads(heads)
        for bank, one in zip(tree.leaves(heads), tree.leaves(agg)):
            bank[client_idx].copy_(one.to(bank.dtype))

    # -- loop ----------------------------------------------------------------

    def _drain_skips(self):
        """Fault mode only: surface non-finite-guard skips at the same
        boundaries as the metrics readback. When the step is unguarded
        ("skipped" never appears in metrics) this touches no device
        value — the sync pattern of a clean run is unchanged. Entries
        older than the ring evict unseen; chaos runs keep log_every
        below the ring size (asserted nowhere, documented here)."""
        for step, m in self.ring.entries_after(self._skip_scan_from):
            self._skip_scan_from = max(self._skip_scan_from, step)
            if "skipped" not in m:
                continue
            if float(m["skipped"]) >= 0.5:
                # ring entries are pushed at i+1; report the batch/step
                # index i that was skipped (matches the injection event)
                self.skipped_steps.append(step - 1)
                self.obs.event("fault/step_skipped", step=step - 1)
                self.obs.counter("fault/steps_skipped")

    def _log_latest(self, total: int, t0: float):
        with self.obs.span("metrics/readback"):
            m = self.ring.read_latest()      # the only mid-loop device sync
        self._drain_skips()
        loss = float(m["loss"])
        step = int(m["step"])
        self.metrics_history.append({"step": step, "loss": loss})
        self.obs.gauge("train/loss", loss, step=step)
        self.obs.gauge("train/participating", int(m["participating"]),
                       step=step)
        health = getattr(self.loader, "health", None)
        if callable(health):
            for k, v in health().items():
                self.obs.gauge(f"prefetch/{k}", v, step=step)
        self.log(f"[trainer] step {m['step']}/{total} "
                 f"loss={loss:.4f} "
                 f"clients={int(m['participating'])} "
                 f"({time.perf_counter() - t0:.1f}s)")

    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        total = steps if steps is not None else self.cfg.total_steps
        t0 = time.perf_counter()
        start = int(self.state["step"])
        self._skip_scan_from = max(self._skip_scan_from, start)
        self.obs.event("trainer/run_start", start_step=start,
                       total_steps=total)
        host_s = 0.0                    # time spent assembling/placing input
        for i in range(start, total):
            self._profile.on_step(i)
            t_step = time.perf_counter()
            with self.obs.span("step/get_batch", step=i):
                batch = self.loader.batch(i)
                # a placed batch is not copied again: the step's stream
                # waits on its copies
                batch = sharding.take_batch(batch, self.device)
            t_in = time.perf_counter()
            host_s += t_in - t_step
            with self.obs.span("step/dispatch", step=i):
                self.state, metrics = self.step_fn(self.state, batch)
            self.ring.push(i + 1, metrics)
            dt = time.perf_counter() - t_step
            self.step_times.append(dt)
            self.obs.observe("step/wall_s", dt)
            if (i + 1) % self.cfg.log_every == 0 or i == start:
                self._log_latest(total, t0)
            if self.ckpt and (i + 1) % self.cfg.ckpt_every == 0:
                with self.obs.span("ckpt/save", step=i + 1):
                    self.ckpt.save(i + 1, self.state)
                self.obs.counter("trainer/checkpoints")
        self._profile.stop()
        # final readback reflects the LAST step, not the last logged step
        with self.obs.span("metrics/readback"):
            final = self.ring.read_latest()
        self._drain_skips()
        if final is not None and (not self.metrics_history or
                                  self.metrics_history[-1]["step"]
                                  < int(final["step"])):
            self.metrics_history.append({"step": int(final["step"]),
                                         "loss": float(final["loss"])})
        wall = time.perf_counter() - t0
        if self.ckpt:
            self.ckpt.save(total, self.state)
            self.ckpt.wait()
        ran = total - start
        result = {"final_loss": (float(final["loss"])
                                 if final is not None else None),
                  "history": self.metrics_history,
                  "steps_per_sec": (ran / wall) if wall > 0 and ran else 0.0,
                  "host_stall_frac": (host_s / wall) if wall > 0 else 0.0,
                  "skipped_steps": list(self.skipped_steps),
                  "wall_s": wall}
        # close out the run log: link accounting, histogram aggregations,
        # and the run summary
        obs_mod.comm.emit_snapshot(self.obs)
        self.obs.event("trainer/run_end", steps=ran,
                       final_loss=result["final_loss"],
                       steps_per_sec=round(result["steps_per_sec"], 4),
                       host_stall_frac=round(result["host_stall_frac"], 4),
                       wall_s=round(wall, 4))
        self.obs.emit_hists()
        self.obs.flush()
        return result
