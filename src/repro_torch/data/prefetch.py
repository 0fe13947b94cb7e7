"""Background-thread prefetching for step-indexed loaders (a copy of the
JAX package's ``data/prefetch.py``).

The MPSL data pipeline is *step-indexed*: ``loader.batch(k)`` is a pure
function of (seed, k). That purity is what makes prefetch safe — the
prefetcher speculatively assembles batches k+1..k+depth on a background
thread while step k runs on device, and a restarted run (or a run with
prefetch disabled) sees bitwise-identical batches, because batch contents
never depend on consumption order or queue depth.

``place_fn`` (e.g. ``repro_torch.parallel.sharding.place_batch``) also
runs on the prefetch thread, so H2D transfer overlaps device compute in
addition to host batch assembly: on the card it copies through pinned
memory on a side stream, and the consumer's stream waits on the copy's
event (``sharding.take_batch``) before the step reads the batch.

Out-of-order requests — a checkpoint resume jumping backwards, or an
evaluation loop re-reading a step — flush the speculation and reseed the
producer at the requested step; the returned batch is still exactly
``inner.batch(k)``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from repro_torch import faults, obs


class PrefetchLoader:
    """Wraps any step-indexed loader with a bounded producer queue.

    depth=0 degrades to a synchronous passthrough (placement still
    applied), which is what the determinism tests diff against.

    Health telemetry: ``health()`` exposes queue depth, produced-batch
    count, restart/reseed count, and cumulative producer wait time (time
    the producer spent blocked on a full queue — a deep queue with zero
    wait means the consumer is the bottleneck, not assembly). A producer
    error is no longer silent until the next ``get``: it is recorded as
    a terminal error event in the ambient obs run log the moment it
    happens, in addition to re-raising on the consumer side.

    Recovery: a producer crash is retried up to ``max_retries`` times
    with linear backoff — the producer is reseeded at the failed step
    and, because the loader is pure in (seed, step), the recovered
    stream is bitwise-identical to one that never crashed. Retries are
    bounded so a deterministic bug (every attempt fails) still surfaces
    as the original exception rather than a livelock.
    """

    def __init__(self, loader, depth: int = 2,
                 place_fn: Optional[Callable] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.05):
        self.inner = loader
        self.depth = int(depth)
        self.place = place_fn if place_fn is not None else (lambda b: b)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._next_consume: Optional[int] = None
        self.restarts = 0               # producer reseeds (resume/ooo reads)
        self.retries = 0                # producer crash recoveries
        self.last_error: Optional[BaseException] = None
        self._produced = 0
        self._wait_s = 0.0              # producer time blocked on full queue

    # -- consumer side -------------------------------------------------------

    def batch(self, step: int):
        if self.depth <= 0:
            return self.place(self.inner.batch(step))
        attempts = 0
        while True:
            if self._thread is None or step != self._next_consume:
                self._restart(step)
            got, payload, err = self._q.get()
            if err is None:
                break
            self.close()
            attempts += 1
            if attempts > self.max_retries:
                raise err
            self.retries += 1
            obs.event("fault/prefetch_restart", step=step,
                      attempt=attempts, max_retries=self.max_retries,
                      error=repr(err))
            obs.counter("fault/prefetch_restarts")
            time.sleep(self.retry_backoff_s * attempts)
        assert got == step, (got, step)
        self._next_consume = step + 1
        return payload

    def health(self) -> dict:
        """Prefetcher health gauges (all host-side, read without locks —
        single-writer counters under the GIL)."""
        q = self._q
        return {
            "queue_depth": q.qsize() if q is not None else 0,
            "queue_capacity": self.depth,
            "produced": self._produced,
            "restarts": self.restarts,
            "retries": self.retries,
            "producer_wait_s": round(self._wait_s, 6),
        }

    # -- producer side -------------------------------------------------------

    def _restart(self, step: int):
        self.close()
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._next_consume = step
        self.restarts += 1
        self._thread = threading.Thread(
            target=self._produce, args=(step, self._q, self._stop),
            name="mpsl-prefetch", daemon=True)
        self._thread.start()

    def _produce(self, step: int, q: queue.Queue, stop: threading.Event):
        while not stop.is_set():
            try:
                faults.get().producer(step)        # crash/delay injection
                with obs.span("host/assemble", step=step):
                    payload = self.inner.batch(step)
                with obs.span("host/place", step=step):
                    payload = self.place(payload)
            except BaseException as e:                 # surfaced to consumer
                self.last_error = e
                # terminal event NOW — not only on the consumer's next get
                obs.event("prefetch/producer_error", level="error",
                          step=step, error=repr(e))
                q.put((step, None, e))
                return
            t_wait = time.perf_counter()
            while not stop.is_set():
                try:
                    q.put((step, payload, None), timeout=0.05)
                    break
                except queue.Full:
                    continue
            self._wait_s += time.perf_counter() - t_wait
            self._produced += 1
            step += 1

    def close(self):
        """Stop the producer and drop speculative batches."""
        if self._thread is None:
            return
        self._stop.set()
        try:                                # unblock a producer stuck in put
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        self._thread = None
        self._q = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
