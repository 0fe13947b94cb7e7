"""Runtime telemetry for the MPSL stack (the JAX package's ``obs/``, in
the port).

Three pieces:

  * ``recorder`` — structured, buffered JSONL event/metrics emitter
    (counters, gauges, histograms, spans, run metadata) with a no-op
    ambient default: until ``obs.configure(path)`` runs, every call
    site hits shared null singletons and the hot loop pays nothing.
  * ``spans``    — host-boundary span tracing of the step pipeline plus
    an opt-in ``torch.profiler`` trace window (``ProfileWindow``).
  * ``comm``     — per-client/per-link byte accounting of the
    smashed-activation uplink, cut-layer-gradient downlink, and
    head-FedAvg links, cross-checked against ``core.costs``.

``python -m repro_torch.obs.report runlog.jsonl`` renders a run log into
per-stage latency and per-link byte tables.
"""
from repro_torch.obs.recorder import (NullRecorder, Recorder,
                                      StructuredLogger, configure, counter,
                                      enabled, event, gauge, get, get_logger,
                                      observe, shutdown, span)
from repro_torch.obs.spans import ProfileWindow
from repro_torch.obs import comm

__all__ = [
    "NullRecorder", "Recorder", "StructuredLogger", "ProfileWindow",
    "comm", "configure", "counter", "enabled", "event", "gauge", "get",
    "get_logger", "observe", "shutdown", "span",
]
