"""Ambient fault injector: the runtime half of ``FaultPlan`` (a copy of
the JAX package's ``faults/inject.py``: the same masks and poison on the
same batch).

Follows the same ambient-singleton pattern as ``obs.recorder`` and the
sharding mesh: until ``activate(plan)`` installs an ``Injector``, every
hook site reaches the shared ``NullInjector`` — a constant attribute
lookup, nothing else. That is the neutrality contract: with no plan
configured, the batch stream, the step, and the launch/sync
pattern are bitwise identical to a build without this module.

Hook sites (all host-side):

  ``PrefetchLoader._produce``     -> ``producer(step)``
  ``ClientLoader.batch``          -> ``batch_hook(step, batch)``
  ``checkpoint.io.save_checkpoint`` -> ``ckpt_write(step)``

Every injection emits a structured ``fault/<kind>`` obs event the moment
it fires, so a chaos run log reads as: injection event -> recovery event
(``fault/prefetch_restart``, ``fault/step_skipped``,
``fault/ckpt_retry``) -> normal telemetry resuming.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.faults.plan import FaultEvent, FaultPlan


class InjectedFault(RuntimeError):
    """An error raised by fault injection (retryable by construction)."""

    def __init__(self, kind: str, step: int):
        super().__init__(f"injected fault: {kind} at step {step}")
        self.kind = kind
        self.step = int(step)


class NullInjector:
    """Fault injection disabled: every hook is a no-op."""
    enabled = False

    def producer(self, step: int):
        pass

    def batch_hook(self, step: int, batch: Dict) -> Dict:
        return batch

    def ckpt_write(self, step: int):
        pass


class Injector:
    """Replays a ``FaultPlan`` once. Each event fires exactly one time
    (tracked in a fired set under a lock — the hooks run on the trainer,
    prefetch-producer, and checkpoint-writer threads), which is what
    makes the recovery paths convergent: a retried producer restart or
    checkpoint write re-executes the same step without re-injecting."""
    enabled = True

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._fired: set = set()
        self.fired_events: List[FaultEvent] = []   # in firing order

    def _take(self, kind: str, step: int, limit: Optional[int] = None
              ) -> List[FaultEvent]:
        """Unfired events of ``kind`` at ``step``, marked fired. ``limit``
        bounds how many fire per call (crash/ckpt faults fire one per
        attempt so N scheduled failures need N retries to clear)."""
        out: List[FaultEvent] = []
        with self._lock:
            for i, e in enumerate(self.plan.events):
                if e.kind != kind or e.step != int(step) or i in self._fired:
                    continue
                self._fired.add(i)
                self.fired_events.append(e)
                out.append(e)
                if limit is not None and len(out) >= limit:
                    break
        return out

    # -- prefetch producer ----------------------------------------------------

    def producer(self, step: int):
        for e in self._take("producer_delay", step):
            obs.event("fault/producer_delay", step=int(step),
                      delay_s=e.delay_s)
            time.sleep(e.delay_s)
        for e in self._take("producer_crash", step, limit=1):
            obs.event("fault/producer_crash", step=int(step))
            raise InjectedFault("producer_crash", step)

    # -- loader / participation ----------------------------------------------

    def batch_hook(self, step: int, batch: Dict) -> Dict:
        stragglers = self._take("straggler", step)
        drops = self._take("client_drop", step)
        poisons = self._take("nan_batch", step)
        if not (stragglers or drops or poisons):
            return batch
        batch = dict(batch)
        mask = batch.get("mask")
        if mask is not None and (stragglers or drops):
            mask = np.array(mask, copy=True)
            orig = mask.copy()
            cut = [e.client for e in stragglers
                   if e.delay_s > self.plan.deadline_s
                   and e.client is not None and e.client < mask.shape[0]]
            waits = [e.delay_s for e in stragglers
                     if e.delay_s <= self.plan.deadline_s]
            if self.plan.simulate_wait and waits:
                time.sleep(min(max(waits), self.plan.deadline_s))
            for c in cut:
                mask[c] = 0.0
            if cut:
                obs.event("fault/straggler_cutoff", step=int(step),
                          clients=cut, deadline_s=self.plan.deadline_s)
            dropped = [e.client for e in drops
                       if e.client is not None and e.client < mask.shape[0]]
            for c in dropped:
                mask[c] = 0.0
            if dropped:
                obs.event("fault/client_drop", step=int(step),
                          clients=dropped)
            if not mask.any():
                # the server cannot renormalize an empty round: keep the
                # lowest-indexed originally-live client (same at-least-one
                # guarantee the loader's Bernoulli dropout gives)
                keep = int(np.argmax(orig > 0)) if orig.any() else 0
                mask[keep] = orig[keep] if orig.any() else 1.0
                obs.event("fault/all_cut_kept_one", step=int(step),
                          client=keep)
            batch["mask"] = mask
        if poisons:
            batch = self._poison(step, batch)
        return batch

    def _poison(self, step: int, batch: Dict) -> Dict:
        """NaN-poison the first float array in the batch (the mask in the
        LM batches): the aggregated loss goes non-finite and the guarded
        step skips the update for exactly this step."""
        for key in sorted(batch.keys()):
            arr = np.asarray(batch[key])
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            poisoned = np.array(arr, copy=True)
            poisoned.flat[0] = np.nan
            batch[key] = poisoned
            obs.event("fault/nan_batch", step=int(step), field=key)
            return batch
        obs.event("fault/nan_batch", step=int(step), field=None,
                  level="error", note="no float field to poison")
        return batch

    # -- checkpoint writer ----------------------------------------------------

    def ckpt_write(self, step: int):
        for e in self._take("ckpt_fail", step, limit=1):
            obs.event("fault/ckpt_fail", step=int(step))
            raise InjectedFault("ckpt_fail", step)


# ---------------------------------------------------------------------------
# Ambient injector


_NULL = NullInjector()
_active: Optional[Injector] = None


def get():
    """The active Injector, or the shared no-op when none is installed."""
    a = _active
    return a if a is not None else _NULL


def activate(plan: FaultPlan) -> Injector:
    """Install a fresh injector for ``plan`` (replacing any prior one).
    A restarted run re-activates and replays the plan from scratch —
    events are keyed by step, so a resume at step k simply never
    revisits the injections before k."""
    global _active
    _active = Injector(plan)
    obs.event("fault/plan_activated", n_events=len(plan.events),
              kinds=plan.kinds_present(), seed=plan.seed,
              deadline_s=plan.deadline_s)
    return _active


def deactivate():
    global _active
    _active = None


class injected:
    """Scoped activation (tests): ``with faults.injected(plan): ...``"""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.injector: Optional[Injector] = None

    def __enter__(self) -> Injector:
        self.injector = activate(self.plan)
        return self.injector

    def __exit__(self, *exc):
        deactivate()
        return False
