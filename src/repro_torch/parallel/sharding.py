"""Host batch placement for the step pipeline.

The JAX package's ``parallel/sharding.py`` holds its mesh rules and its
``place_batch``; the port runs on one device, so this module holds only
the placement. ``place_batch`` runs on the prefetch producer thread
(``data.PrefetchLoader(place_fn=place_batch)``); ``take_batch`` runs on
the consumer, just before the step reads the batch.

On the card a placement copies each array through pinned host memory
with ``non_blocking=True`` on a side stream (not the step's), and
records an event after the last copy, so the H2D copy of batch k+1
overlaps step k. The consumer's stream waits on that event (a
device-side wait: the host does not block), and every placed tensor is
``record_stream``-ed on the consumer's stream, so the caching allocator
does not hand its memory to another tensor while the step may still
read it. On the CPU a placement makes plain copies.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs

# integer fields the step uses as indices: int64 on the device
INDEX_KEYS = ("tokens", "labels")


class PlacedBatch(dict):
    """A batch of device tensors; ``ready`` is the CUDA event recorded
    after its copies (None on the CPU, where the copies are done)."""
    ready = None


def place_batch(batch, device=None) -> PlacedBatch:
    """A host batch (numpy arrays) as tensors on `device` (the current
    CUDA device unless given; ``"cpu"`` for plain copies), token ids and
    labels as int64. The ``h2d/place_batch`` span measures the host's
    time to enqueue the copies, not their transfer."""
    with obs.span("h2d/place_batch"):
        device = torch.device("cuda" if device is None else device)
        out = PlacedBatch()
        if device.type != "cuda":
            for k, v in batch.items():
                t = torch.from_numpy(np.array(v))
                out[k] = t.long() if k in INDEX_KEYS else t
            return out
        stream = torch.cuda.Stream(device)      # from torch's stream pool
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                t = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                t = t.to(device, non_blocking=True)
                out[k] = t.long() if k in INDEX_KEYS else t
            out.ready = torch.cuda.Event()
            out.ready.record(stream)
        return out


def take_batch(batch, device) -> dict:
    """The batch the step on `device` may read: a ``PlacedBatch`` as it is
    (no second copy), after making the current stream wait on its copies;
    any other batch (numpy arrays) placed first."""
    if not isinstance(batch, PlacedBatch):
        batch = place_batch(batch, device)
    if batch.ready is not None:
        stream = torch.cuda.current_stream(next(iter(batch.values())).device)
        stream.wait_event(batch.ready)
        for v in batch.values():
            v.record_stream(stream)
    return dict(batch)
