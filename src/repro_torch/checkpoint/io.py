"""Checkpoint I/O (counterpart of the JAX package's ``checkpoint/io.py``).

Layout, the reference's own: ``<dir>/step_<k>/arrays.npz`` +
``manifest.json``, written to a temp dir and atomically renamed — a crash
mid-write can never corrupt the latest checkpoint (restore scans for
complete manifests only). Keys are the ``/``-joined paths of the port's
tree (``tree.paths``); bfloat16 leaves are stored as their uint16 bits,
as the reference stores them; the state's Python-int leaves (``step``,
``rng``) as 0-d int64.

An async writer thread overlaps serialization with the next training
steps. Its snapshot copies every tensor leaf into pinned host buffers
with ``non_blocking=True`` on the step's stream (so the next in-place
update cannot overtake the copy) and then waits on one event: a save
costs the main thread one sync, not one a leaf.

Restores are in place: each leaf is copied into the template's tensor,
which keeps its device, dtype and ``requires_grad``.

Under the SPMD program (``parallel.collectives``) a checkpoint holds the
whole leaves, as the reference's does: a save gathers every shard
(``sharding.gather_tree``; every rank takes part) and rank 0 alone
writes; a restore reads the whole arrays on every rank and copies each
rank's slice into its shard (``sharding.shard_leaf`` by the shard's
spec), so a checkpoint written at one world size restores at another
(the reference's ``restore_checkpoint(shardings=...)`` onto the active
mesh)."""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import faults, obs, tree as _tree
from repro_torch.parallel import collectives, sharding

# bfloat16, which numpy has no type for, is stored as its raw bits
_BF16_BITS = np.uint16


def _to_host(v) -> np.ndarray:
    """A leaf (a tensor or a Python int) as a numpy array npz can hold."""
    if not torch.is_tensor(v):
        return np.asarray(v, np.int64)
    t = v.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype) -> torch.Tensor:
    """A stored array as a CPU tensor (bfloat16's raw bits viewed back as
    bfloat16 where the template's `dtype` is bfloat16)."""
    if dtype == torch.bfloat16 and arr.dtype == _BF16_BITS:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree) -> Dict[str, object]:
    return dict(zip(_tree.paths(tree), _tree.leaves(tree)))


def _rebuild(template, leaves):
    it = iter(leaves)
    return _tree.map_(lambda _: next(it), template)


def save_checkpoint(directory: str, step: int, tree, extra: Optional[Dict]
                    = None, keep: int = 3):
    faults.get().ckpt_write(step)              # injection site (no-op default)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {k: _to_host(v) for k, v in _flatten(tree).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(arrays.keys()),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(_complete_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def _complete_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if os.path.exists(os.path.join(directory, name, "manifest.json")):
            out.append(int(name.split("_")[1]))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _complete_steps(directory)
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(directory: str, template, step: Optional[int] = None):
    """Restore into `template` in place: each tensor leaf is ``copy_``-ed
    from the stored array (keeping its device, dtype and
    ``requires_grad``); a Python-int leaf is replaced by the stored int.
    Returns (the template's tree with the restored leaves, the manifest),
    or (None, None) with no complete checkpoint. A shape or dtype
    mismatch raises."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))

    flat = _flatten(template)
    restored = []
    for key, leaf in flat.items():
        arr = data[key]
        want = (sharding.global_shape(leaf) if torch.is_tensor(leaf)
                else ())
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {want}")
        if torch.is_tensor(leaf):
            src = _from_host(arr, leaf.dtype)
            if src.dtype != leaf.dtype:
                raise ValueError(f"dtype mismatch for {key}: {arr.dtype} vs "
                                 f"{leaf.dtype}")
            spec = collectives.spec_of(leaf)
            if spec and collectives.active() is not None:
                src = sharding.shard_leaf(src, spec)   # this rank's slice
            leaf.copy_(src)
            restored.append(leaf)
        else:
            if arr.dtype != np.int64:
                raise ValueError(f"dtype mismatch for {key}: {arr.dtype} vs "
                                 f"int")
            restored.append(int(arr))
    return _rebuild(template, restored), manifest


def snapshot(tree):
    """A host copy of `tree` that later in-place updates cannot touch:
    CUDA leaves copied into pinned buffers, ``non_blocking`` on the current
    stream, then one wait on an event recorded after the last copy; CPU
    tensors cloned; ints kept. Under the SPMD program the whole leaves,
    gathered from every rank's shards."""
    if collectives.active() is not None:
        tree = sharding.gather_tree(tree)
    out, on_card = [], False
    for v in _tree.leaves(tree):
        if torch.is_tensor(v):
            v = v.detach()
            if v.is_cuda:
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                h.copy_(v, non_blocking=True)
                on_card = True
            else:
                h = v.clone()
            out.append(h)
        else:
            out.append(v)
    if on_card:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return _rebuild(tree, out)


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writes on a background thread.

    A failed write is retried in place up to ``retries`` times with
    linear backoff (the temp-dir + atomic-rename layout makes a retry
    safe at any point: a partial write never shadows a complete
    checkpoint). Each retry is recorded as a ``fault/ckpt_retry`` obs
    event; only an exhausted retry budget surfaces the error on the
    next ``wait()`` — the run stays resumable from the previous
    complete checkpoint either way."""

    def __init__(self, directory: str, keep: int = 3, retries: int = 2,
                 backoff_s: float = 0.05):
        self.directory = directory
        self.keep = keep
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree, extra=None):
        self.wait()
        host_tree = snapshot(tree)
        prog = collectives.active()
        if prog is not None and prog.rank != 0:
            return                 # it took part in the gathers; rank 0 writes

        def work():
            for attempt in range(self.retries + 1):
                try:
                    save_checkpoint(self.directory, step, host_tree, extra,
                                    self.keep)
                    return
                except BaseException as e:  # surfaced on next wait()
                    if attempt >= self.retries:
                        self.last_error = e
                        return
                    obs.event("fault/ckpt_retry", step=step,
                              attempt=attempt + 1,
                              max_retries=self.retries, error=repr(e))
                    obs.counter("fault/ckpt_retries")
                    time.sleep(self.backoff_s * (attempt + 1))

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
