"""Runtime per-client / per-link communication accounting.

Counterpart of the JAX package's ``obs/comm.py``. ``core.costs`` *models*
the MPSL links analytically; this module *measures* them from the tensors
that actually cross the client/server boundary. The hooks live in
``core.mpsl`` (smashed-data uplink, cut-layer-gradient downlink),
``core.compression`` (the quant8 wire format actually applied), and
``core.split`` (the one-time client head FedAvg link). They read shapes
and dtypes on the host and touch no tensor's values, so they add no
launch and no sync to the step.

The JAX package's hooks fire once a trace; eager PyTorch fires them every
step. So an entry is sent to the ambient recorder only when it is new or
one of its fields changed: a run log holds one record a link (and one
per refinement, such as ``quantized_in_trace``), as the reference's does.

A link record:

  name                   "uplink.activations", "downlink.gradients",
                         per-modality variants ("uplink.activations/vision"),
                         "aggregation.client_head"
  direction              uplink | downlink
  n_clients              leading stacked-client axis of the tensor
  per_client_shape       the [Bn, ...] payload shape one client moves
  dtype                  wire dtype before quantization (numpy's name)
  raw_bytes_per_client   uncompressed payload bytes per client per step
  wire_bytes_per_client  bytes actually on the wire (== raw uncompressed;
                         quant payload + per-row scales when compressed)
  compressed / bits      quant8 link state
  per_step               True for the per-step training links; False for
                         one-time links (head FedAvg)
  quantized_in_trace     set by core.compression when quant8 actually ran
                         on the link (cross-checks the config flag against
                         the executed step); ``quant_impl`` "kernel", the
                         port's kernel entry (its plain version on CPU
                         tensors), where the JAX package writes "pallas"

Records merge by name and are mirrored into the ambient recorder as
``link`` records when telemetry is enabled.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional

from repro_torch import tree as _tree
from repro_torch.obs import recorder as _rec

_lock = threading.Lock()
_links: Dict[str, Dict[str, Any]] = {}
# step -> (participating clients, total clients); keyed by step so
# speculative prefetch re-assembly and restart replays stay idempotent
_participation: Dict[int, tuple] = {}
_MISSING = object()


def _dtype_name(dtype) -> str:
    """numpy's name of a torch (or numpy) dtype: torch.float32 -> float32."""
    return str(dtype).split(".")[-1]


def _store(name: str, fields: Dict[str, Any]):
    """Merge `fields` into the link's entry; send the entry to the recorder
    only when it is new or a field changed."""
    with _lock:
        entry = _links.setdefault(name, {"name": name})
        changed = len(entry) == 1 or any(
            entry.get(k, _MISSING) != v for k, v in fields.items())
        entry.update(fields)
        snap = dict(entry) if changed else None
    if snap is not None:
        _rec.get().link(snap)


def record_link(name: str, shape, dtype, *, direction: str,
                compressed: bool = False, bits: int = 8,
                wire_bytes_per_client: Optional[int] = None,
                per_step: bool = True):
    """Record a stacked-client link from a tensor's shape/dtype.

    ``shape`` is the full ``[N, ...]`` shape; the per-client payload is
    ``shape[1:]``. ``wire_bytes_per_client`` defaults to the raw bytes
    (uncompressed wire); compressed callers pass the actual wire size
    (``core.compression.compressed_bytes``).
    """
    shape = tuple(int(s) for s in shape)
    per_client = shape[1:]
    itemsize = dtype.itemsize
    raw = math.prod(per_client) * itemsize
    wire = raw if wire_bytes_per_client is None else int(
        wire_bytes_per_client)
    _store(name, {
        "direction": direction,
        "n_clients": shape[0],
        "per_client_shape": list(per_client),
        "dtype": _dtype_name(dtype),
        "raw_bytes_per_client": raw,
        "wire_bytes_per_client": wire,
        "compressed": bool(compressed),
        "bits": int(bits) if compressed else 8 * itemsize,
        "per_step": bool(per_step),
    })


def record_param_link(name: str, tree, *, direction: str = "uplink",
                      per_step: bool = False):
    """Record a link that moves a stacked ``[N, ...]`` parameter tree
    (e.g. the post-training client-head FedAvg sync)."""
    leaves = _tree.leaves(tree)
    if not leaves:
        return
    n = int(leaves[0].shape[0])
    raw = sum(math.prod(l.shape[1:]) * l.element_size() for l in leaves)
    _store(name, {
        "direction": direction,
        "n_clients": n,
        "per_client_shape": None,
        "dtype": "tree",
        "raw_bytes_per_client": raw,
        "wire_bytes_per_client": raw,
        "compressed": False,
        "bits": None,
        "per_step": bool(per_step),
        "n_leaves": len(leaves),
    })


def note_quant(shape, bits: int, impl: str):
    """Called by ``core.compression`` when a quant-dequant actually runs:
    marks every compressed link whose per-client payload matches the
    quantized tensor as executed (not just configured). Sends only the
    entries this changes."""
    shape = tuple(int(s) for s in shape)
    new = {"quantized_in_trace": True, "quant_impl": impl, "bits": int(bits)}
    with _lock:
        hits = [e for e in _links.values()
                if e.get("compressed")
                and tuple(e.get("per_client_shape") or ()) == shape[1:]]
        snaps = []
        for e in hits:
            if any(e.get(k, _MISSING) != v for k, v in new.items()):
                e.update(new)
                snaps.append(dict(e))
    rec = _rec.get()
    for s in snaps:
        rec.link(s)


def note_participation(step: int, participating: float, n_clients: int):
    """Record how many clients actually transmitted at ``step`` (the
    runtime participation mask after dropout/straggler cutoff — the
    loader reports it per assembled batch). The link records are static
    shapes that assume full participation; this is the runtime weighting
    that corrects the per-step aggregates."""
    with _lock:
        _participation[int(step)] = (float(participating), int(n_clients))


def participation_summary() -> Dict[str, Any]:
    """Mean/min participation fraction across the recorded steps;
    ``avg_frac`` is 1.0 when nothing was recorded (full participation)."""
    with _lock:
        vals = list(_participation.values())
    if not vals:
        return {"steps": 0, "avg_frac": 1.0, "min_frac": 1.0}
    fr = [p / max(n, 1) for p, n in vals]
    return {"steps": len(vals), "avg_frac": sum(fr) / len(fr),
            "min_frac": min(fr)}


def snapshot() -> List[Dict[str, Any]]:
    with _lock:
        return [dict(e) for e in _links.values()]


def reset():
    """Clear the accountant (tests; link records are process-ambient)."""
    with _lock:
        _links.clear()
        _participation.clear()


def per_step_wire_bytes() -> Dict[str, Any]:
    """Aggregate per-step wire traffic: total and per direction, summed
    over all clients of every per-step link — plus the mask-aware
    ``total_masked`` (total weighted by the mean runtime participation
    fraction), which is what dropout/straggler runs actually moved."""
    out = {"total": 0, "uplink": 0, "downlink": 0}
    for e in snapshot():
        if not e.get("per_step"):
            continue
        b = e["wire_bytes_per_client"] * e["n_clients"]
        out["total"] += b
        out[e["direction"]] = out.get(e["direction"], 0) + b
    ps = participation_summary()
    out["participation_frac"] = ps["avg_frac"]
    out["total_masked"] = int(round(out["total"] * ps["avg_frac"]))
    return out


def emit_snapshot(recorder=None):
    """Mirror every accounted link into a recorder (the trainer calls
    this at run end so links recorded before ``configure()`` — e.g. a
    step taken earlier in the process — still land in the run log), plus
    the runtime participation gauges that weight the per-step aggregate."""
    rec = recorder if recorder is not None else _rec.get()
    for e in snapshot():
        rec.link(e)
    ps = participation_summary()
    if ps["steps"]:
        agg = per_step_wire_bytes()
        rec.gauge("comm/participation_frac", round(ps["avg_frac"], 6),
                  steps=ps["steps"], min_frac=round(ps["min_frac"], 6))
        rec.gauge("comm/per_step_wire_bytes_masked", agg["total_masked"])
