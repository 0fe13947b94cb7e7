"""Fault injection & elastic participation for the MPSL pipeline (the
JAX package's ``faults/``, in the port).

Two halves:

  * ``plan``   — ``FaultPlan`` / ``FaultEvent``: a deterministic,
    seed-driven schedule of producer crashes/delays, client stragglers
    and drops, NaN-poisoned batches, and checkpoint-write failures.
  * ``inject`` — the ambient ``Injector`` that replays a plan against
    the pipeline's hook sites, plus the ``NullInjector`` no-op default
    (neutrality: with no plan active, nothing changes).

The recovery machinery lives with the components it protects: bounded
producer retry in ``data.prefetch``, runtime participation-mask cutoff
in ``data.loader`` (renormalized by ``core.mpsl``), the non-finite-loss
step guard in ``core.mpsl.make_train_step``, and checkpoint-write
retries in ``checkpoint.io.AsyncCheckpointer``.
"""
from repro_torch.faults.plan import KINDS, FaultEvent, FaultPlan
from repro_torch.faults.inject import (InjectedFault, Injector, NullInjector,
                                       activate, deactivate, get, injected)

__all__ = [
    "KINDS", "FaultEvent", "FaultPlan", "InjectedFault", "Injector",
    "NullInjector", "activate", "deactivate", "get", "injected",
]
