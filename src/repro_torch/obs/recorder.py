"""Structured, buffered JSONL event/metrics recorder (a copy of the JAX
package's ``obs/recorder.py``, which imports no JAX: the same records
for the same calls).

The MPSL pipeline is sync-free by construction (ROADMAP "Step
pipeline"), so the telemetry layer must observe it without perturbing
it. Two rules enforce that:

  * no-op default — until ``configure()`` installs a Recorder, every
    call site reaches the shared ``NullRecorder``/``_NULL_SPAN``
    singletons: no allocation, no I/O, no lock. The hot loop pays one
    attribute lookup per span when telemetry is disabled.
  * host-side only — the recorder never touches device values. Spans
    close on wall clock; device metrics keep flowing through the
    existing ``MetricsRing`` readback cadence; link byte accounting
    (``repro_torch.obs.comm``) reads shapes at the links' hooks and
    sends a record only when it is new or changed.

Record schema (one JSON object per line):

  {"ts": <unix s>, "kind": "meta|event|counter|gauge|span|hist|link",
   "name": str, ...kind-specific fields...}

  meta    — run metadata, written once at configure time.
  event   — discrete occurrence; ``level`` in {info, error}. Error
            events flush the buffer immediately (crash durability).
  counter — monotonically accumulated value (emitted per bump).
  gauge   — instantaneous value (queue depth, loss, ...).
  span    — {"dur_s": wall duration, "fields": {...}} closed on exit.
  hist    — in-memory aggregation (count/sum/min/max + pow-2 buckets)
            emitted at ``emit_hists()``/``close()`` boundaries.
  link    — a communication-link record from ``repro_torch.obs.comm``
            (deduplicated per recorder by name+shape).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional


def _jsonable(x):
    """Last-resort JSON coercion (numpy scalars, dtypes, exceptions)."""
    item = getattr(x, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(x)


# ---------------------------------------------------------------------------
# Disabled path: shared singletons, zero allocation


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """Telemetry-disabled sink: every method is a no-op."""
    enabled = False

    def span(self, name, **fields):
        return _NULL_SPAN

    def event(self, name, level="info", **fields):
        pass

    def counter(self, name, value=1, **fields):
        pass

    def gauge(self, name, value, **fields):
        pass

    def observe(self, name, value):
        pass

    def link(self, record):
        pass

    def emit_hists(self):
        pass

    def flush(self):
        pass

    def close(self):
        pass


# ---------------------------------------------------------------------------
# Enabled path


class _Span:
    __slots__ = ("_rec", "name", "fields", "t0")

    def __init__(self, rec: "Recorder", name: str, fields: Dict[str, Any]):
        self._rec = rec
        self.name = name
        self.fields = fields
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self.t0
        if exc is not None:
            self.fields = dict(self.fields, error=repr(exc))
        self._rec._emit({"kind": "span", "name": self.name,
                         "dur_s": dur, "fields": self.fields},
                        urgent=exc is not None)
        return False


class _Hist:
    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[str, int] = {}

    def add(self, v: float):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        key = "0" if v <= 0 else f"{2.0 ** math.ceil(math.log2(v)):g}"
        self.buckets[key] = self.buckets.get(key, 0) + 1

    def record(self, name: str) -> Dict[str, Any]:
        return {"kind": "hist", "name": name, "count": self.count,
                "sum": self.sum, "min": self.min, "max": self.max,
                "buckets": self.buckets}


class Recorder:
    """Buffered JSONL sink. Thread-safe (spans run on the prefetch
    producer thread as well as the trainer loop).

    ``max_bytes`` caps the log: when the file crosses it after a flush,
    it rotates to ``<path>.1`` (replacing any previous rotation) and a
    fresh file — with the run's meta record re-emitted so the tail log
    stays self-describing — takes over. Total footprint is therefore
    bounded by ~2x max_bytes however long a chaos/soak run goes; the
    default (None) keeps today's append-forever behavior."""
    enabled = True

    def __init__(self, path, run_id: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 flush_every: int = 256,
                 max_bytes: Optional[int] = None):
        self.path = str(path)
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.max_bytes = int(max_bytes) if max_bytes else None
        self.rotations = 0
        self._lock = threading.Lock()
        self._buf: list = []
        self._flush_every = int(flush_every)
        self._hists: Dict[str, _Hist] = {}
        self._links_seen: set = set()
        self._counters: Dict[str, float] = {}
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "a")
        self._closed = False
        self._meta_rec = {"kind": "meta", "name": "run",
                          "run_id": self.run_id,
                          "fields": dict(meta or {})}
        self._emit(dict(self._meta_rec), urgent=True)

    # -- sinks ----------------------------------------------------------------

    def _emit(self, rec: Dict[str, Any], urgent: bool = False):
        rec.setdefault("ts", time.time())
        with self._lock:
            if self._closed:
                return
            self._buf.append(rec)
            if urgent or len(self._buf) >= self._flush_every:
                self._flush_locked()

    def _flush_locked(self):
        if not self._buf:
            return
        lines = "".join(json.dumps(r, default=_jsonable) + "\n"
                        for r in self._buf)
        self._buf.clear()
        self._f.write(lines)
        self._f.flush()
        if self.max_bytes and self._f.tell() >= self.max_bytes:
            self._rotate_locked()

    def _rotate_locked(self):
        self._f.close()
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "a")
        self.rotations += 1
        header = [dict(self._meta_rec, ts=time.time(),
                       rotation=self.rotations)]
        self._f.write("".join(json.dumps(r, default=_jsonable) + "\n"
                              for r in header))
        self._f.flush()

    # -- public API -----------------------------------------------------------

    def span(self, name: str, **fields):
        return _Span(self, name, fields)

    def event(self, name: str, level: str = "info", **fields):
        self._emit({"kind": "event", "name": name, "level": level,
                    "fields": fields}, urgent=level == "error")

    def counter(self, name: str, value=1, **fields):
        with self._lock:
            total = self._counters.get(name, 0) + value
            self._counters[name] = total
        self._emit({"kind": "counter", "name": name, "value": value,
                    "total": total, "fields": fields})

    def gauge(self, name: str, value, **fields):
        self._emit({"kind": "gauge", "name": name, "value": value,
                    "fields": fields})

    def observe(self, name: str, value):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Hist()
            h.add(value)

    def link(self, record: Dict[str, Any]):
        # dedup on full content: identical re-records (retrace, scan) are
        # dropped, refinements (e.g. quantized_in_trace) pass through
        key = json.dumps({k: v for k, v in record.items() if k != "ts"},
                         sort_keys=True, default=_jsonable)
        with self._lock:
            if key in self._links_seen:
                return
            self._links_seen.add(key)
        self._emit(dict(record, kind="link"), urgent=True)

    def emit_hists(self):
        with self._lock:
            recs = [h.record(n) for n, h in self._hists.items()]
        for r in recs:
            self._emit(r)

    def flush(self):
        with self._lock:
            self._flush_locked()

    def close(self):
        if self._closed:
            return
        self.emit_hists()
        with self._lock:
            self._flush_locked()
            self._closed = True
            self._f.close()


# ---------------------------------------------------------------------------
# Ambient recorder (module-level, like sharding's ambient mesh)


_NULL = NullRecorder()
_active: Optional[Recorder] = None


def get():
    """The active Recorder, or the shared no-op when disabled."""
    a = _active
    return a if a is not None else _NULL


def configure(path, meta: Optional[Dict[str, Any]] = None,
              run_id: Optional[str] = None,
              flush_every: int = 256,
              max_bytes: Optional[int] = None) -> Recorder:
    """Install a JSONL recorder as the ambient sink (closing any prior).
    ``max_bytes`` rotates the log to ``<path>.1`` once it crosses the
    cap, bounding long runs to ~2x max_bytes on disk."""
    global _active
    if _active is not None:
        _active.close()
    _active = Recorder(path, run_id=run_id, meta=meta,
                       flush_every=flush_every, max_bytes=max_bytes)
    return _active


def shutdown():
    """Close and uninstall the ambient recorder (no-op when disabled)."""
    global _active
    if _active is not None:
        _active.close()
        _active = None


@contextlib.contextmanager
def enabled(path, meta: Optional[Dict[str, Any]] = None,
            flush_every: int = 256, max_bytes: Optional[int] = None):
    """Scoped telemetry (tests / short-lived drivers)."""
    rec = configure(path, meta=meta, flush_every=flush_every,
                    max_bytes=max_bytes)
    try:
        yield rec
    finally:
        shutdown()


def span(name: str, **fields):
    return get().span(name, **fields)


def event(name: str, level: str = "info", **fields):
    get().event(name, level=level, **fields)


def counter(name: str, value=1, **fields):
    get().counter(name, value=value, **fields)


def gauge(name: str, value, **fields):
    get().gauge(name, value, **fields)


def observe(name: str, value):
    get().observe(name, value)


# ---------------------------------------------------------------------------
# Console sink: human-readable lines + structured events


class StructuredLogger:
    """Replaces bare ``print()`` in the launch drivers: prints the same
    ``[component] message`` line and mirrors it (plus structured fields)
    into the ambient run log when one is configured."""
    __slots__ = ("name", "_print")

    def __init__(self, name: str, printer: Callable[[str], None] = print):
        self.name = name
        self._print = printer

    def info(self, msg: str, **fields):
        self._print(f"[{self.name}] {msg}")
        get().event(f"{self.name}/log", message=msg, **fields)

    def error(self, msg: str, **fields):
        self._print(f"[{self.name}] {msg}")
        get().event(f"{self.name}/log", level="error", message=msg, **fields)

    # drop-in for callables expecting a bare print-like function
    def __call__(self, msg: str):
        self.info(msg)


def get_logger(name: str, printer: Callable[[str], None] = print
               ) -> StructuredLogger:
    return StructuredLogger(name, printer)
