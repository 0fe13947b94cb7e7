"""Sharding rules (logical axes -> mesh axes) and host batch placement.

Counterpart of the JAX package's ``parallel/sharding.py``. The rule table
is the same: every tensor dim has a chain of logical candidates, and the
first whose mesh-axis product divides the dim wins, else the dim is
unsharded. Logical axes resolve against whatever axes the active mesh
(``launch.mesh.Mesh``) has:

  batch, client -> (pod, data)   activations' batch / the MPSL client axis
  fsdp          -> (data,)       weight sharding within a pod
  model         -> (model,)      tensor parallelism (heads / ff / vocab /
                                 experts)
  dboth         -> (data, model) fully-sharded fallback for a contraction
  pod           -> (pod,)
  seq_model     -> (model,)      sequence parallelism

A spec is a tuple with one entry a dim: None, a mesh axis name, or a
tuple of them (the JAX package's ``PartitionSpec`` entries). One entry
is the port's own: Mamba's in_proj [D, 2 di] holds x's channels and then
z's, and its 2 di dim is cut section by section (``Paired``: rank r holds
x's r-th channel slice and z's r-th), so that every model rank splits its
xz where the block does; the entry still equals the rule table's axis
name.
``shard_shape`` gives a leaf's per-device shape under a spec, as
``NamedSharding.shard_shape`` does; the dry run counts bytes with it.
The port keeps per-layer lists where the JAX package stacks [L, ...]
segments (``bridge.py``), so a segment leaf's spec is the JAX spec
without its leading layer entry, and so is a per-layer cache's.

Under the SPMD program (``parallel.collectives``: one process a rank,
``launch/spmd.py`` or ``torchrun``) every rank holds plain local tensors:
``shard_tree`` cuts a tree by these specs into this rank's slices (and
marks each with its spec, which ``collectives.gather_param`` reads),
``gather_tree`` joins them back, ``place_batch(mesh=...)`` places this
rank's clients of a host batch. The model code calls the collectives
itself, so ``shard_act`` stays the identity (see there): the layouts
its constraints ask for, ``seq_model`` included, are the program's own.

``place_batch`` runs on the prefetch producer thread
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

import contextlib
import math
import threading
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch import obs

LOGICAL = {
    "batch": ("pod", "data"),
    "client": ("pod", "data"),
    "fsdp": ("data",),
    "model": ("model",),
    "dboth": ("data", "model"),
    "pod": ("pod",),
    "seq_model": ("model",),
}

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Set the active mesh for ``shard_act`` and the rules (per thread)."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _axes_in_mesh(mesh, logical: str) -> Tuple[str, ...]:
    return tuple(a for a in LOGICAL[logical] if a in mesh.axis_names)


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    return math.prod(int(mesh.shape[a]) for a in axes)


def resolve_dim(mesh, dim: int, candidates) -> Optional[Any]:
    """candidates: None | str | sequence of str (a fallback chain)."""
    if candidates is None:
        return None
    if isinstance(candidates, str):
        candidates = (candidates,)
    for logical in candidates:
        axes = _axes_in_mesh(mesh, logical)
        size = _axes_size(mesh, axes)
        if axes and size > 1 and dim % size == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def resolve_spec(mesh, shape: Sequence[int], dims) -> tuple:
    if len(dims) != len(shape):
        raise ValueError(f"dims {dims} do not match shape {tuple(shape)}")
    return tuple(resolve_dim(mesh, d, c) for d, c in zip(shape, dims))


def shard_shape(shape: Sequence[int], spec, mesh) -> tuple:
    """The per-device shape of a `shape` laid out by `spec` on `mesh`
    (``NamedSharding.shard_shape``): each dim divided by the product of
    its entry's axis sizes, rounded up."""
    out = []
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(-(-int(d) // _axes_size(mesh, axes)))
    return tuple(out)


def shard_act(x, dims):
    """The JAX package's ``with_sharding_constraint`` against the active
    mesh: the identity. No partitioner runs in the port; the explicit
    program already holds the layouts those constraints ask for: the
    clients' stacked activations on the client axis (``repro/core/
    mpsl.py:132, 143, 160``: each rank of `data`, or of (pod, data), runs
    its own clients) and the batch of the body, the decoder's hidden
    states and the logits (``repro/models/model.py:156, 287, 328``: batch
    on the client axis, logits vocab-sharded over `model`). Between the
    blocks the hidden states are replicated over `model`, or, where
    ``act_dims`` is ``("batch", "seq_model", None)`` (training at d_model
    >= 8192, ``RunConfig.seq_shard_acts``), cut on the sequence over
    `model` by ``models.model.cut_stream`` and gathered whole inside each
    block (the sequence left whole where it does not divide the axis, as
    the rule table leaves it). The query sequence that
    ``repro/models/attention.py:271-276`` shards for the core attention
    under ``RunConfig.attn_seq_shard`` is held by the program as well:
    each model rank runs the core over its S/m queries
    (``models.attention._query_slice``)."""
    return x


def _map_with_path(fn, tree_, path=()):
    """A tree of fn(path, leaf), shaped as `tree_` (dicts and lists; the
    path holds dict keys and list indices as str)."""
    if isinstance(tree_, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree_.items()}
    if isinstance(tree_, (list, tuple)):
        return type(tree_)(_map_with_path(fn, v, path + (str(i),))
                           for i, v in enumerate(tree_))
    return fn(path, tree_)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", np.shape(leaf)))


def batch_specs(batch, mesh):
    """Per-leaf specs of an MPSL host batch: the leading axis of every
    array is the client axis, sharded over the mesh data axes when
    divisible; everything else replicated."""
    def rule(_path, leaf):
        shape = _shape(leaf)
        return resolve_spec(mesh, shape, ("client",) + (None,) * (len(shape) - 1))
    return _map_with_path(rule, batch)


# ---------------------------------------------------------------------------
# Parameter rules (path-based)


def _param_dims(path: Tuple[str, ...], shape: Tuple[int, ...]):
    """Rule table: (parent..., leaf) names + shape -> per-dim candidates.
    A segment leaf is one layer's (the port's per-layer lists): the JAX
    package's rule past its stacked layer dim."""
    if "adapter" in path or "tokenizers" in path:
        return ("client",) + (None,) * (len(shape) - 1)
    return _param_dims_base(path, shape)


def _param_dims_base(path: Tuple[str, ...], shape: Tuple[int, ...]):
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else ""

    # embeddings / heads
    if leaf == "table":                       # [V, D]
        return ("fsdp", "model")
    if leaf == "lm_head":                     # [D, V]
        return ("fsdp", "model")
    if leaf == "pos":                         # [S, D]
        return (None, "model")

    # attention
    if leaf in ("wq", "wk", "wv"):            # [D, H|K, hd]
        if shape[1] % _model_size() == 0:     # TP over heads, FSDP over D
            return ("fsdp", "model", None)
        return (("dboth", "model"), None, None)
    if leaf == "wo" and len(shape) == 3 and parent != "moe":
        # attention output [H, hd, D]
        if shape[0] % _model_size() == 0:
            return ("model", None, "fsdp")
        return (None, None, ("dboth", "model"))
    if leaf in ("bq", "bk", "bv"):            # [H|K, hd]
        if shape[0] % _model_size() == 0:
            return ("model", None)
        return (None, None)

    # MoE (expert-stacked weights)
    if len(shape) == 3 and leaf in ("wi", "wg"):      # [E, D, F]
        if shape[0] % _model_size() == 0:             # expert parallelism
            return ("model", "fsdp", None)
        return (None, "fsdp", "model")
    if len(shape) == 3 and leaf == "wo":              # [E, F, D]
        if shape[0] % _model_size() == 0:
            return ("model", None, "fsdp")
        return (None, "model", "fsdp")
    if leaf == "router":                      # [D, E]
        return ("fsdp", None)
    if leaf == "shared_gate":                 # [D, 1]
        return ("fsdp", None)

    # dense MLP
    if leaf in ("wi", "wg") and len(shape) == 2:   # [D, F]
        return ("fsdp", "model")
    if leaf == "wo" and len(shape) == 2:           # [F, D]
        return ("model", "fsdp")

    # Mamba
    if leaf == "in_proj":                     # [D, 2*di]
        return ("fsdp", "model")
    if leaf == "conv_w":                      # [dc, di]
        return (None, "model")
    if leaf in ("conv_b", "dt_bias", "D"):    # [di]
        return ("model",)
    if leaf == "x_proj":                      # [di, dtr+2ds]
        return ("model", None)
    if leaf == "dt_proj":                     # [dtr, di]
        return (None, "model")
    if leaf == "A_log":                       # [di, ds]
        return ("model", None)
    if leaf == "out_proj":                    # [di, D]
        return ("model", "fsdp")

    # tokenizers / misc
    if leaf == "embed" and len(shape) == 2:   # text tokenizer table [V, D]
        return ("fsdp", "model")
    if leaf == "proj" and len(shape) == 2:    # patch proj [p*p*c, D]
        return (None, "model")

    # norms, biases, scalars, cls, betas: replicated
    return tuple(None for _ in shape)


def _model_size() -> int:
    mesh = current_mesh()
    return int(mesh.shape["model"]) if mesh is not None \
        and "model" in mesh.axis_names else 1


class Paired(str):
    """A spec entry: the mesh axis `axis` (and equal to its name, as the
    rule table's entry), for a dim that holds `sections` equal sections
    side by side, each cut over the axis on its own. Part i of the dim is
    the i-th slice of every section, joined in order: Mamba's in_proj
    [D, 2 di] on `model` gives rank r x's channels r di/m .. (r+1) di/m
    and z's same channels, so the block's split of xz into (x, z) is the
    same on every rank and needs no data movement."""

    def __new__(cls, axis: str, sections: int = 2):
        self = super().__new__(cls, axis)
        self.sections = int(sections)
        return self

    def __reduce__(self):
        return (Paired, (str(self), self.sections))

    def __repr__(self):
        return f"Paired({str(self)!r}, {self.sections})"


def _sections(entry) -> int:
    return getattr(entry, "sections", 1)


# leaves whose dim (by index) holds equal sections, each cut on its own
PAIRED = {"in_proj": (1, 2)}          # Mamba's [D, 2 di]: (x | z)


def param_specs(params, mesh):
    """A tree of specs mirroring `params` (tensors, meta tensors or
    anything with a ``.shape``); a ``PAIRED`` leaf's sectioned dim gets a
    ``Paired`` entry."""
    def rule(path, leaf):
        shape = _shape(leaf)
        with use_mesh(mesh):
            spec = resolve_spec(mesh, shape, _param_dims(path, shape))
        if path and path[-1] in PAIRED:
            dim, n = PAIRED[path[-1]]
            if isinstance(spec[dim], str):
                spec = spec[:dim] + (Paired(spec[dim], n),) + spec[dim + 1:]
        return spec
    return _map_with_path(rule, params)


# ---------------------------------------------------------------------------
# Cache rules


def cache_dims(shape: Tuple[int, ...], leaf: str, stacked: bool,
               kv_heads: Optional[int] = None):
    """KV cache [L?, B, S, K, hd] / pos [L?, B, S] / SSM h [L?, B, di, ds]
    / conv [L?, B, dc-1, di]; the port's per-layer caches are unstacked.

    When the KV heads don't divide the TP axis, the cache's SEQ dim is
    sharded over `model` instead, and `pos` follows the same seq sharding
    so decode masks stay local."""
    lead = ("__layer__",) if stacked else ()
    n = len(shape) - len(lead)
    if leaf in ("k", "v") and n == 4:
        _, _, k_heads, _ = shape[-4:]
        kv = "model" if k_heads % _model_size() == 0 else None
        seq = None if kv else "model"
        return (None,) * len(lead) + ("batch", seq, kv, None)
    if leaf == "pos" and n == 2:
        seq = None if (kv_heads is not None
                       and kv_heads % _model_size() == 0) else "model"
        return (None,) * len(lead) + ("batch", seq)
    if leaf == "index":
        return (None,) * len(shape)
    if leaf == "h" and n == 3:                # [B, di, ds]
        return (None,) * len(lead) + ("batch", "model", None)
    if leaf == "conv" and n == 3:             # [B, dc-1, di]
        return (None,) * len(lead) + ("batch", None, "model")
    return tuple(None for _ in shape)


def cache_specs(cache, mesh, stacked: bool = False, kv_heads=None):
    """A tree of specs mirroring `cache` (the port's per-layer caches:
    ``stacked=False``; an int ``index`` gets the spec ())."""
    def rule(path, leaf):
        shape = _shape(leaf)
        with use_mesh(mesh):
            return resolve_spec(mesh, shape, cache_dims(
                shape, path[-1], stacked, kv_heads=kv_heads))
    return _map_with_path(rule, cache)


# ---------------------------------------------------------------------------
# This rank's shards (the SPMD program)


def _program(prog):
    from repro_torch.parallel import collectives
    return prog if prog is not None else collectives.active()


def _entry(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _part(prog, axes) -> Tuple[int, int]:
    """(this rank's index, the part count) of a dim laid on `axes`
    (row-major over them, as ``NamedSharding`` cuts a dim on two axes)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * prog.size(a) + prog.index(a)
        n *= prog.size(a)
    return idx, n


def _cut(x, dim: int, i: int, n: int, sections: int = 1):
    """Part i of n of `x`'s dim `dim`: the i-th of n equal slices of
    each of its `sections` equal sections, joined in order."""
    shape = tuple(x.shape)
    if shape[dim] % (n * sections):
        raise ValueError(f"dim {dim} of {shape} does not split into {n} "
                         f"parts of {sections} sections")
    step = shape[dim] // sections // n
    lead = (slice(None),) * dim
    if sections == 1:
        return x[lead + (slice(i * step, (i + 1) * step),)]
    y = x.reshape(shape[:dim] + (sections, shape[dim] // sections)
                  + shape[dim + 1:])
    y = y[lead + (slice(None), slice(i * step, (i + 1) * step))]
    return y.reshape(shape[:dim] + (sections * step,) + shape[dim + 1:])


def shard_leaf(x, spec, prog=None):
    """This rank's slice of `x` (a tensor or a numpy array) laid out by
    `spec`: each dim cut into equal parts by its axes, the part at this
    rank's coordinates (a ``Paired`` dim section by section). A tensor
    slice is a contiguous copy marked with its spec
    (``collectives.set_spec``)."""
    from repro_torch.parallel import collectives
    prog = _program(prog)
    if prog is None or not hasattr(x, "shape"):
        return x
    out = x
    for dim, entry in enumerate(spec or ()):
        i, n = _part(prog, _entry(entry))
        if n > 1:
            out = _cut(out, dim, i, n, _sections(entry))
    if torch.is_tensor(out):
        out = out.contiguous()
        # a slice at x's start (or x uncut) is cloned; a fake tensor (the
        # dry run's) has no data to share
        if out is x or (not is_fake(out) and out.data_ptr() == x.data_ptr()):
            out = out.clone()
        collectives.set_spec(out, spec)
        return out
    return np.ascontiguousarray(out)


def shard_tree(tree_, specs, prog=None):
    """``shard_leaf`` of every leaf of `tree_` by the matching leaf of
    `specs` (a spec tree of ``param_specs``, ``cache_specs``,
    ``batch_specs``, ``steps.state_specs``...); a non-array leaf as it
    is. `prog`: the program (``collectives.Program``; the active one by
    default)."""
    if isinstance(tree_, dict):
        return {k: shard_tree(v, specs[k], prog) for k, v in tree_.items()}
    if isinstance(tree_, list):
        return [shard_tree(v, sp, prog) for v, sp in zip(tree_, specs)]
    return shard_leaf(tree_, specs, prog)


def gather_leaf(x, spec=None):
    """The whole leaf from this rank's shard: each sharded dim all-gathered
    over its axes (the inverse of ``shard_leaf``). `spec`: the shard's own
    (``collectives.spec_of``) by default."""
    from repro_torch.parallel import collectives
    spec = collectives.spec_of(x) if spec is None else spec
    if not torch.is_tensor(x) or not spec or collectives.active() is None:
        return x
    for dim, entry in enumerate(spec):
        k = _sections(entry)
        if k > 1:
            x = x.unflatten(dim, (k, -1))
        for a in reversed(_entry(entry)):     # the inner axis first
            x = collectives.all_gather(x, dim + (k > 1), a)
        if k > 1:
            x = x.flatten(dim, dim + 1)
    return x


def gather_tree(tree_):
    """``gather_leaf`` of every leaf, by its own spec (every rank takes
    part; every rank gets the whole tree)."""
    if isinstance(tree_, dict):
        return {k: gather_tree(v) for k, v in tree_.items()}
    if isinstance(tree_, list):
        return [gather_tree(v) for v in tree_]
    return gather_leaf(tree_)


def global_shape(x) -> tuple:
    """The whole leaf's shape from a shard's (its spec's axis sizes)."""
    from repro_torch.parallel import collectives
    spec = collectives.spec_of(x)
    prog = collectives.active()
    shape = tuple(x.shape)
    if not spec or prog is None:
        return shape
    return tuple(d * (_part(prog, _entry(spec[i]))[1] if i < len(spec)
                      else 1) for i, d in enumerate(shape))


# ---------------------------------------------------------------------------
# Host batch placement

# integer fields the step uses as indices: int64 on the device
INDEX_KEYS = ("tokens", "labels")


class PlacedBatch(dict):
    """A batch of device tensors; ``ready`` is the CUDA event recorded
    after its copies (None on the CPU, where the copies are done)."""
    ready = None


def place_batch(batch, device=None, mesh=None) -> PlacedBatch:
    """A host batch (numpy arrays) as tensors on `device` (the current
    CUDA device unless given; ``"cpu"`` for plain copies), token ids and
    labels as int64. With `mesh` (the active program's), only this rank's
    slice of each array's client (or batch) axis is placed, as
    ``batch_specs`` lays it out. The ``h2d/place_batch`` span measures
    the host's time to enqueue the copies, not their transfer."""
    if mesh is not None:
        batch = shard_tree(batch, batch_specs(batch, mesh))
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
