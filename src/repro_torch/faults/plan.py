"""Deterministic, seed-driven fault schedules for the MPSL pipeline (a
copy of the JAX package's ``faults/plan.py``: the same plans from the
same spec, JSON or seed).

A ``FaultPlan`` is a static list of ``FaultEvent``s — (kind, step, and
kind-specific payload) — that the ambient injector (``repro_torch.faults.
inject``) replays against the running pipeline. Determinism is the whole
point: the same plan produces the same injections at the same steps, so
a chaos run is as reproducible as a clean one, and the recovery
invariants (bitwise restart identity, batch-stream identity) can be
asserted exactly.

Fault kinds and their injection sites:

  producer_crash   prefetch producer thread raises at step k
                   (``data/prefetch.py``; recovered by bounded
                   retry-with-backoff on the consumer side)
  producer_delay   prefetch producer sleeps ``delay_s`` before
                   assembling step k (straggling host)
  straggler        client ``client`` takes ``delay_s`` to deliver its
                   smashed data at step k; past ``deadline_s`` the
                   server cuts it from the participation mask
                   (``data/loader.py`` -> ``core/mpsl.py`` loss renorm)
  client_drop      client ``client`` is absent at step k (mask 0)
  nan_batch        step k's batch is poisoned with a NaN (the
                   non-finite-loss guard in ``core.mpsl.make_train_step``
                   skips the update for that step)
  ckpt_fail        the checkpoint write at step k raises once
                   (``checkpoint/io.py``; recovered by the
                   ``AsyncCheckpointer`` retry loop)

Plans are built explicitly (``FaultPlan(events=...)``), sampled from a
seed (``FaultPlan.sample``), or parsed from a JSON file / inline spec
(``FaultPlan.from_spec``) — the form the ``--fault-plan`` launch flag
accepts:

  producer_crash@3,nan_batch@13,straggler@11:1:0.2,ckpt_fail@20
  kind@step[:client][:delay_s], comma-separated; ``deadline=0.05`` /
  ``seed=7`` tokens set plan fields; a path to a .json file loads it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KINDS = ("producer_crash", "producer_delay", "straggler", "client_drop",
         "nan_batch", "ckpt_fail")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    step: int
    client: Optional[int] = None      # straggler / client_drop target
    delay_s: float = 0.0              # producer_delay / straggler latency

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")

    def to_dict(self) -> Dict:
        d = {"kind": self.kind, "step": int(self.step)}
        if self.client is not None:
            d["client"] = int(self.client)
        if self.delay_s:
            d["delay_s"] = float(self.delay_s)
        return d


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A replayable fault schedule. Every event fires exactly once —
    after a producer restart the crash it injected is consumed, which is
    what lets the retried assembly of the same step succeed (and keeps
    the recovered batch stream bitwise-identical to an uninjected run).
    """
    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0
    deadline_s: float = 0.05          # straggler participation cutoff
    simulate_wait: bool = False       # sleep sub-deadline straggler time

    # -- queries --------------------------------------------------------------

    def at(self, kind: str, step: int) -> List[FaultEvent]:
        return [e for e in self.events
                if e.kind == kind and e.step == int(step)]

    def kinds_present(self) -> List[str]:
        return sorted({e.kind for e in self.events})

    # -- construction ---------------------------------------------------------

    @classmethod
    def sample(cls, seed: int, steps: int, *, n_clients: int = 1,
               p_producer_crash: float = 0.0, p_producer_delay: float = 0.0,
               p_straggler: float = 0.0, p_client_drop: float = 0.0,
               p_nan_batch: float = 0.0, p_ckpt_fail: float = 0.0,
               deadline_s: float = 0.05, max_delay_s: float = 0.2
               ) -> "FaultPlan":
        """Bernoulli-per-step schedule, a pure function of (seed, rates).
        Straggler latencies draw uniform in (0, 2*max_delay_s) so roughly
        half the injected stragglers land past a deadline of max_delay_s.
        """
        r = np.random.default_rng((int(seed), 0xFA017))
        events: List[FaultEvent] = []
        rates = {"producer_crash": p_producer_crash,
                 "producer_delay": p_producer_delay,
                 "straggler": p_straggler,
                 "client_drop": p_client_drop,
                 "nan_batch": p_nan_batch,
                 "ckpt_fail": p_ckpt_fail}
        for step in range(int(steps)):
            for kind in KINDS:          # fixed draw order => determinism
                if r.random() >= rates[kind]:
                    continue
                client = (int(r.integers(0, max(1, n_clients)))
                          if kind in ("straggler", "client_drop") else None)
                delay = 0.0
                if kind == "producer_delay":
                    delay = float(r.random() * max_delay_s)
                elif kind == "straggler":
                    delay = float(r.random() * 2.0 * max_delay_s)
                events.append(FaultEvent(kind, step, client, delay))
        return cls(events=tuple(events), seed=int(seed),
                   deadline_s=float(deadline_s))

    # -- (de)serialization ----------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "deadline_s": self.deadline_s,
            "simulate_wait": self.simulate_wait,
            "events": [e.to_dict() for e in self.events],
        }, indent=1)

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultPlan":
        events = tuple(FaultEvent(e["kind"], int(e["step"]),
                                  e.get("client"),
                                  float(e.get("delay_s", 0.0)))
                       for e in d.get("events", ()))
        return cls(events=events, seed=int(d.get("seed", 0)),
                   deadline_s=float(d.get("deadline_s", 0.05)),
                   simulate_wait=bool(d.get("simulate_wait", False)))

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse the ``--fault-plan`` argument: a JSON file path or an
        inline ``kind@step[:client][:delay_s]`` comma list (``seed=`` /
        ``deadline=`` tokens set plan fields)."""
        spec = spec.strip()
        if os.path.exists(spec):
            with open(spec) as f:
                return cls.from_dict(json.load(f))
        events: List[FaultEvent] = []
        fields: Dict[str, float] = {}
        for token in filter(None, (t.strip() for t in spec.split(","))):
            if "=" in token:
                key, val = token.split("=", 1)
                fields[key.strip()] = float(val)
                continue
            if "@" not in token:
                raise ValueError(f"bad fault spec token {token!r} "
                                 "(want kind@step[:client][:delay_s])")
            kind, rest = token.split("@", 1)
            parts = rest.split(":")
            step = int(parts[0])
            client = int(parts[1]) if len(parts) > 1 and parts[1] else None
            delay = float(parts[2]) if len(parts) > 2 else 0.0
            events.append(FaultEvent(kind.strip(), step, client, delay))
        return cls(events=tuple(events),
                   seed=int(fields.get("seed", 0)),
                   deadline_s=float(fields.get("deadline", 0.05)),
                   simulate_wait=bool(fields.get("simulate_wait", 0)))
