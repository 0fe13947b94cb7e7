"""Span helpers beyond the recorder's wall-clock spans.

Counterpart of the JAX package's ``obs/spans.py``. The pipeline spans
(``step/get_batch``, ``step/dispatch``, ``host/assemble``,
``host/place``, ``h2d/place_batch``, ``metrics/readback``,
``ckpt/save``) are instrumented strictly at host boundaries and close on
wall clock — a ``step/dispatch`` span measures the host's time to
enqueue the step, NOT device compute (the loop never blocks on the
step's outputs; device time keeps coming from the MetricsRing readback
cadence and the run-level synchronized steps/sec).

For deep dives where device-side timing IS wanted, ``ProfileWindow``
arms an opt-in ``torch.profiler`` trace over a bounded step window and
exports it as a Chrome trace; it is entirely inert unless a log
directory is given.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.obs import recorder as _rec


class ProfileWindow:
    """Opt-in ``torch.profiler`` trace over steps [start, start+num): CPU
    activity, and CUDA activity when a card is present, exported to
    ``<logdir>/trace_<start>.json`` (chrome://tracing, Perfetto).

    The trainer calls ``on_step(step)`` at the top of every iteration
    and ``stop()`` on exit; with ``logdir=None`` both are no-ops. Any
    profiler failure disables the window rather than killing the run —
    profiling must never be load-bearing.
    """

    def __init__(self, logdir: Optional[str], start_step: int = 5,
                 num_steps: int = 3):
        self.logdir = logdir
        self.start = int(start_step)
        self.num = max(1, int(num_steps))
        self._prof = None
        self._done = logdir is None

    def on_step(self, step: int):
        if self._done:
            return
        if self._prof is None and step >= self.start:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                os.makedirs(self.logdir, exist_ok=True)
                prof = profile(activities=acts)
                prof.__enter__()
            except Exception as e:  # profiling is best-effort
                self._done = True
                _rec.event("profile/start_failed", level="error",
                           error=repr(e))
                return
            self._prof = prof
            _rec.event("profile/started", logdir=self.logdir, step=step)
        elif self._prof is not None and step >= self.start + self.num:
            self.stop()

    def stop(self):
        if self._prof is None:
            self._done = True
            return
        try:
            self._prof.__exit__(None, None, None)
            path = os.path.join(self.logdir, f"trace_{self.start}.json")
            self._prof.export_chrome_trace(path)
            _rec.event("profile/stopped", logdir=self.logdir, trace=path)
        except Exception as e:
            _rec.event("profile/stop_failed", level="error", error=repr(e))
        self._prof = None
        self._done = True
