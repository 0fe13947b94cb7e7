"""Collectives by logical mesh axis, for the explicit SPMD program.

The port runs a sharded step as one program a rank (``launch/spmd.py``,
or ``torchrun``): every rank holds plain local tensors, the shards that
``sharding.shard_tree`` cuts by the rule table's specs, and the model
code calls the collectives below at fixed points, where the JAX
partitioner puts them. No DTensor op propagation drives the step: the
kernels are ``ctypes`` launches with no sharding rules of their own.

A ``Program`` is the active layout: the mesh record (``launch.mesh.Mesh``),
this rank's coordinates, one process group an axis (from a
``torch.distributed.device_mesh.DeviceMesh``), the backend and the
rank -> card map. It is a module global, not per thread: the autograd
engine runs a CUDA backward, and the collectives in it, on a thread of
its own. With no program active, or on an axis of size 1, every function
here is the identity and launches nothing, so the one-rank paths run
exactly as they did.

Transport. NCCL where each rank owns a card; gloo otherwise (the CPU, or
several ranks sharing one card); "fake" (torch's fake process group, no
transport) where the dry run traces one rank's program. Gloo's
collectives take host tensors: a CUDA tensor is staged through a pinned
host buffer, the collective runs on that, and the result is copied
back. A sum over bf16 is taken in f32 on gloo and rounded once (NCCL sums
bf16 as it goes). Gloo's reduce-scatter is an all-reduce and this rank's
slice, its all-gather an exact all-reduce of the ranks' bytes
(``_all_gather``). The backend and the
card of each rank are in the program and in every counter record.

Autograd pairs (each identity, in both directions, on an axis of size 1):

  copy_to(x, axis)          identity forward, all-reduce backward: a
                            replicated input entering an axis-parallel
                            region (its users' partial gradients summed)
  reduce_from(x, axis)      all-reduce forward, identity backward: the
                            region's partial sums leaving it
  gather_from(x, dim, axis) all-gather forward, reduce-scatter backward:
                            an fsdp weight gathered at use, its gradient
                            summed over the axis and cut back to the shard
  gather_to(x, dim, axis)   all-gather forward, this rank's slice backward
                            (no sum): a region's output parts joined into
                            the replicated whole, whose gradient every rank
                            holds whole already (Megatron's gather/split)
  slice_to(x, dim, axis)    this rank's slice forward, all-gather
                            backward: the inverse pair, a replicated whole
                            cut into the ranks' parts (the residual stream
                            cut on the sequence between blocks: seq_model)

A weight dim on (data, model), the rule table's ``dboth`` fallback, is
gathered over `data` only (``gather_param``); its model part stays, and
the user runs row-parallel over it (``model_cols`` picks the matching
input columns) or, on an output dim, joins the ranks' parts by
``gather_to``.

The client axis. The clients and the batch lie on `data`, or on a mesh
with a `pod` axis (the JAX package's 2 x 16 x 16) on (pod, data),
flattened pod-major: ``client_axis()`` names it (``POD_DATA``: a process
group of its own, rank index pod * |data| + data, as ``Mesh.coords`` and
the rule table lay a ("pod", "data") entry). fsdp stays on `data`, within
a pod; a weight is replicated across pods, and the gradient of such a
leaf crosses `pod` once a step (``reduce_grads``).

``COUNTS`` records every collective that moves data, by (op, axis): calls
and bytes (an all-reduce counts its tensor, an all-gather its output, a
reduce-scatter its input).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Program:
    mesh: object                     # launch.mesh.Mesh
    rank: int
    world: int
    coords: Dict[str, int]
    groups: Dict[str, object]        # axis -> ProcessGroup
    backend: str
    device: torch.device
    cards: Tuple[int, ...]           # rank -> CUDA device index (-1: CPU)
    dmesh: object = None             # the DeviceMesh the groups come from

    def size(self, axis: str) -> int:
        return axis_size(self.mesh, axis)

    def index(self, axis: str) -> int:
        if axis == WORLD:
            return self.rank
        if axis == POD_DATA:
            return self.index("pod") * self.size("data") + self.index("data")
        return int(self.coords.get(axis, 0))

    def record(self) -> dict:
        return {"backend": self.backend, "ranks": self.world,
                "mesh": dict(self.mesh.shape), "rank_to_card": list(self.cards)}


_ACTIVE: Optional[Program] = None
# the axis name of every rank at once (the default process group)
WORLD = "world"
# the flattened (pod, data) axis: the clients and the batch on a mesh with
# a pod axis
POD_DATA = "pod+data"


def axis_size(mesh, axis: str) -> int:
    """The ranks of `axis` on `mesh` (a mesh axis, the flattened (pod,
    data) axis or the world; 1 for an axis the mesh lacks)."""
    if axis == WORLD:
        return mesh.size
    if axis == POD_DATA:
        return axis_size(mesh, "pod") * axis_size(mesh, "data")
    return int(mesh.shape.get(axis, 1))


def active() -> Optional[Program]:
    return _ACTIVE


@contextlib.contextmanager
def program(prog: Optional[Program]):
    """Make `prog` the active program (for every thread) while open."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, prog
    try:
        yield prog
    finally:
        _ACTIVE = prev


def size(axis: str) -> int:
    """The active program's size of `axis` (1 with none, or no such axis)."""
    return 1 if _ACTIVE is None else _ACTIVE.size(axis)


def index(axis: str) -> int:
    """This rank's coordinate on `axis` (0 with no program)."""
    return 0 if _ACTIVE is None else _ACTIVE.index(axis)


def client_axis() -> str:
    """The axis the clients and the batch lie on: `data`, or the
    flattened (pod, data) axis where the active mesh has a pod axis above
    1."""
    return POD_DATA if size("pod") > 1 else "data"


def client_entry():
    """The spec entry of a dim laid on the client axis (a cache's or a
    batch's rows): None where it has one rank, else "data" or ("pod",
    "data")."""
    if size(client_axis()) == 1:
        return None
    return ("pod", "data") if size("pod") > 1 else "data"


def local(n: int, axis: str) -> int:
    """The local extent of a dim of `n` laid out on `axis`: n / size where
    the size divides it, else n (the rule table leaves it unsharded)."""
    s = size(axis)
    return n // s if s > 1 and n % s == 0 else n


def default_backend(device, world: int) -> str:
    """NCCL where every rank can own a card of its own, else gloo."""
    device = torch.device(device)
    if (device.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


def card_of(rank: int, device) -> int:
    """The CUDA device index rank `rank` runs on (-1 on the CPU): ranks
    share the cards round robin."""
    device = torch.device(device)
    if device.type != "cuda":
        return -1
    return rank % torch.cuda.device_count()


def start(mesh, device) -> Program:
    """The program of this rank on `mesh`, over the initialized default
    process group (its world must be the mesh's size): a DeviceMesh with
    dims named by ``mesh.axis_names`` supplies one group an axis."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"a {mesh.name} mesh needs {mesh.size} ranks; the "
                         f"process group has {world}")
    backend = str(dist.get_backend()).lower()
    rank = dist.get_rank()
    # the DeviceMesh's device type only names where DTensors would live:
    # gloo's groups move host tensors, whatever device the step runs on
    dmesh = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                             tuple(mesh.axis_sizes),
                             mesh_dim_names=tuple(mesh.axis_names))
    coords = mesh.coords(rank)
    if tuple(coords.values()) != tuple(dmesh.get_coordinate()):
        raise RuntimeError(f"rank {rank}: the DeviceMesh puts it at "
                           f"{dmesh.get_coordinate()}, the mesh at {coords}")
    groups = {a: dmesh.get_group(a) for a in mesh.axis_names}
    groups[WORLD] = dist.group.WORLD
    if mesh.shape.get("pod", 1) > 1:
        groups[POD_DATA] = _pod_data_group(mesh, rank)
    return Program(mesh=mesh, rank=rank, world=world, coords=coords,
                   groups=groups, backend=backend,
                   device=torch.device(device),
                   cards=tuple(card_of(r, device) for r in range(world)),
                   dmesh=dmesh)


def _pod_data_group(mesh, rank):
    """This rank's process group of the flattened (pod, data) axis: one
    group a coordinate of the other axes, its ranks in pod-major order.
    Every rank creates every group, in the same order (``dist.new_group``
    asks it), and keeps its own. A group's ranks are numbered by their
    global rank, which must follow the flattened order (pod and data
    before model in the mesh's row-major layout)."""
    members = collections.defaultdict(list)
    for r in range(mesh.size):
        c = mesh.coords(r)
        key = tuple(v for a, v in c.items() if a not in ("pod", "data"))
        members[key].append((c["pod"] * mesh.shape.get("data", 1)
                             + c.get("data", 0), r))
    mine = None
    for key in sorted(members):
        ranks = [r for _, r in sorted(members[key])]
        if ranks != sorted(ranks):
            raise ValueError(f"a {mesh.name} mesh {mesh.axis_names} does not "
                             f"order (pod, data) before its other axes")
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


# ---------------------------------------------------------------------------
# The counter


COUNTS: Dict[Tuple[str, str], Dict[str, int]] = collections.defaultdict(
    lambda: {"calls": 0, "bytes": 0})


def reset_counts() -> None:
    COUNTS.clear()


def read_counts() -> dict:
    """{"op/axis": {"calls", "bytes"}} of the collectives since the last
    reset, with the program's backend, ranks and rank -> card map."""
    out = {f"{op}/{axis}": dict(v) for (op, axis), v in sorted(COUNTS.items())}
    if _ACTIVE is not None:
        out["program"] = _ACTIVE.record()
    return out


def _count(op: str, axis: str, t) -> None:
    rec = COUNTS[(op, axis)]
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# Raw collectives (no autograd)

# Gloo runs a collective on one of its worker threads, one TCP stream a
# peer: a tensor past GLOO_SPLIT_BYTES goes as GLOO_PIECES collectives on
# contiguous pieces, issued together and awaited together. Its all-gather
# runs as an all-reduce (sum) of the ranks' words, each rank's placed in a
# zero buffer at its own offset: every word is one rank's bits plus
# zeros, so the sum is the gather bit for bit (gloo's all-reduce moved
# bytes faster than its all-gather, 2 ranks on the CPU). The zero buffer
# is made on the host (pinned for a CUDA tensor), so a gather's device
# memory is its output alone (and one copy more where it joins on a dim
# other than 0). A CUDA tensor is otherwise laid out, cast and cut on the
# card; only the collective's own buffer crosses to the host and back.
# NCCL takes each tensor whole, and so does the "fake" backend
# (``torch.testing._internal.distributed.fake_pg``: no transport, the dry
# run's one-rank trace, ``launch.dryrun.trace_program``), so that a
# traced rank issues what an NCCL rank issues; the counter records the
# same calls and bytes on every backend.
WHOLE_BACKENDS = ("nccl", "fake")
GLOO_SPLIT_BYTES = 1 << 22
GLOO_PIECES = 2


def _pieces(h):
    """Contiguous flat pieces of h, or (h,) where h is small."""
    if h.numel() * h.element_size() <= GLOO_SPLIT_BYTES:
        return (h,)
    return h.view(-1).chunk(GLOO_PIECES)


def _gloo_all_reduce(h, op, group) -> None:
    """In place over `group`, in pieces."""
    works = [dist.all_reduce(p, op=op, group=group, async_op=True)
             for p in _pieces(h)]
    for w in works:
        w.wait()


def _host(x, fresh: bool = False):
    """The buffer gloo runs on: x's values in host memory of their own (a
    pinned copy of a CUDA x; a CPU x cloned unless `fresh`, made for the
    call)."""
    if x.is_cuda:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h
    return x.contiguous() if fresh else x.clone(
        memory_format=torch.contiguous_format)


def _reduce_dtype(x):
    """Gloo sums a bf16 / f16 tensor in f32 (rounded once, back in x's
    dtype)."""
    return (torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
            else x.dtype)


def all_reduce(x, axis: str, op: str = "sum"):
    """The sum (or max) of x over `axis`, a new tensor on every rank."""
    if size(axis) == 1:
        return x
    _count("all_reduce", axis, x)
    rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    group = _ACTIVE.groups[axis]
    if _ACTIVE.backend in WHOLE_BACKENDS:
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=rop, group=group)
        return y
    h = _host(x.to(_reduce_dtype(x)), fresh=x.dtype != _reduce_dtype(x))
    _gloo_all_reduce(h, rop, group)
    return h.to(x.device).to(x.dtype)


def all_gather(x, dim: int, axis: str):
    """The ranks' x joined along `dim` in the order of their coordinate on
    `axis`."""
    n = size(axis)
    if n == 1:
        return x
    group = _ACTIVE.groups[axis]
    x = x.contiguous()
    if _ACTIVE.backend in WHOLE_BACKENDS:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts, dim=dim)
    else:
        nbytes = x.numel() * x.element_size()
        word = torch.int32 if nbytes % 4 == 0 else torch.uint8
        own = x.reshape(-1).view(torch.uint8).view(word)
        h = torch.zeros((n, own.numel()), dtype=word, pin_memory=x.is_cuda)
        h[_ACTIVE.index(axis)].copy_(own)
        _gloo_all_reduce(h, dist.ReduceOp.SUM, group)
        full = h.to(x.device).view(torch.uint8).view(x.dtype)
        if dim == 0 and x.dim() > 0:
            out = full.view(n * x.shape[0], *x.shape[1:])
        else:
            out = torch.cat(full.view(n, *x.shape).unbind(0), dim=dim)
    _count("all_gather", axis, out)
    return out


def reduce_scatter(x, dim: int, axis: str):
    """The sum of x over `axis`, cut along `dim` into size(axis) equal
    parts: this rank's (by its coordinate)."""
    n = size(axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axis!r}")
    _count("reduce_scatter", axis, x)
    group = _ACTIVE.groups[axis]
    if _ACTIVE.backend in WHOLE_BACKENDS:
        chunks = [c.contiguous() for c in x.chunk(n, dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=group)
        return out
    h = _host(x.to(_reduce_dtype(x)), fresh=x.dtype != _reduce_dtype(x))
    _gloo_all_reduce(h, dist.ReduceOp.SUM, group)
    mine = h.chunk(n, dim)[_ACTIVE.index(axis)]
    return mine.to(x.device).to(x.dtype).contiguous()


# ---------------------------------------------------------------------------
# Autograd pairs


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.dim, ctx.axis), None, None


class _GatherTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        part = g.chunk(size(ctx.axis), ctx.dim)[index(ctx.axis)]
        return part.contiguous(), None, None


class _SliceTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return x.chunk(size(axis), dim)[index(axis)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.axis), None, None


def copy_to(x, axis: str = "model"):
    """Identity forward, all-reduce backward over `axis`."""
    return x if size(axis) == 1 else _CopyTo.apply(x, axis)


def reduce_from(x, axis: str = "model"):
    """All-reduce forward over `axis`, identity backward."""
    return x if size(axis) == 1 else _ReduceFrom.apply(x, axis)


def gather_from(x, dim: int, axis: str = "data"):
    """All-gather forward along `dim` over `axis`, reduce-scatter
    backward."""
    return x if size(axis) == 1 else _GatherFrom.apply(x, dim, axis)


def gather_to(x, dim: int, axis: str = "model"):
    """All-gather forward along `dim` over `axis`, this rank's slice of
    the gradient backward (every rank holds the same whole gradient)."""
    return x if size(axis) == 1 else _GatherTo.apply(x, dim, axis)


def slice_to(x, dim: int, axis: str = "model"):
    """This rank's slice of x along `dim` (its size(axis) equal parts, by
    the rank's coordinate) forward, the ranks' gradient parts all-gathered
    backward: x is the same on every rank of `axis`, and so is its
    gradient, whole. Slicing with ``narrow`` instead would hand x's users
    the gradient of this rank's part only."""
    if size(axis) == 1:
        return x
    if x.shape[dim] % size(axis):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {size(axis)} ranks of {axis!r}")
    return _SliceTo.apply(x, dim, axis)


# ---------------------------------------------------------------------------
# Params laid out by a spec


SPEC_ATTR = "_repro_spec"


def spec_of(t) -> Optional[tuple]:
    """The spec a shard was cut by (``sharding.shard_tree``), or None."""
    return getattr(t, SPEC_ATTR, None)


def set_spec(t, spec) -> None:
    if torch.is_tensor(t):
        setattr(t, SPEC_ATTR, None if spec is None else tuple(spec))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dim_axes(t, dim: int) -> Tuple[str, ...]:
    """The mesh axes `t`'s spec lays its dim `dim` on (() unsharded or
    with no spec)."""
    spec = spec_of(t)
    return _entry_axes(spec[dim]) if spec and dim < len(spec) else ()


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec lays a dim on."""
    return tuple(a for e in (spec or ()) for a in _entry_axes(e))


def gather_param(w):
    """The weight a rank computes with: each dim of `w` that its spec lays
    on `data` (fsdp) all-gathered (``gather_from``: its gradient is
    reduce-scattered back); a dim on `model` stays local, and so does the
    model part of a dim on (data, model) (the rule table's `dboth`
    fallback: its data part gathered, the ranks' parts in data order, this
    model rank's among each). A dim on ("pod", "data"), the client axis
    of a multi-pod mesh (the adapters), is gathered over that axis as a
    dim on `data` is on a mesh with no pod. No rule lays a weight on `pod`
    alone or on (pod, data, model)."""
    spec = spec_of(w)
    if spec is None or _ACTIVE is None:
        return w
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes == ("pod", "data"):
            w = gather_from(w, dim, client_axis())
            continue
        if axes not in ((), ("data",), ("model",), ("data", "model")):
            raise NotImplementedError(
                f"a weight laid out {spec}: no rule of the table lays one "
                f"so (ROADMAP.md Queue 1 item 7)")
        if axes[:1] == ("data",):
            w = gather_from(w, dim, "data")
    return w


def model_cols(x, entry):
    """The slice of x's last dim that a weight's contraction dim laid on
    `entry` holds on this rank once ``gather_param`` gathered its `data`
    part: with the dim cut row-major over (data, model) into d x m parts,
    the parts (i, this model rank) for every i, in order; on `model`
    alone, this rank's contiguous part. x whole where the entry has no
    `model` (or its size is 1)."""
    axes = _entry_axes(entry)
    m = size("model")
    if "model" not in axes or m == 1:
        return x
    d = size("data") if "data" in axes else 1
    j = index("model")
    parts = x.unflatten(-1, (d, m, -1))[..., j:j + 1, :]
    return parts.flatten(-3)


def join_model_parts(y, entry):
    """The whole last dim from this rank's output part of a weight whose
    output dim lies on `entry` (``model_cols``' layout): the model ranks'
    parts all-gathered and interleaved back into row-major order
    (``gather_to``: the gradient's own slice backward)."""
    axes = _entry_axes(entry)
    if "model" not in axes or size("model") == 1:
        return y
    d = size("data") if "data" in axes else 1
    whole = gather_to(y.unflatten(-1, (d, -1)), y.dim(), "model")
    return whole.flatten(-2)


def model_parallel(w) -> bool:
    """Whether `w` is a shard cut on `model` (its users then run a
    model-parallel region); False with no program or a model axis of 1."""
    return size("model") > 1 and "model" in spec_axes(spec_of(w))


def replica_weight(t) -> float:
    """1 / the number of ranks that hold the same copy of `t`'s shard (the
    product of the sizes of the mesh axes its spec does not lay it on):
    summing weight x a local quantity over the world counts the leaf
    once."""
    if _ACTIVE is None:
        return 1.0
    on = set(spec_axes(spec_of(t)))
    return 1.0 / math.prod(_ACTIVE.size(a) for a in _ACTIVE.mesh.axis_names
                           if a not in on)


@torch.no_grad()
def reduce_grads(params, grads) -> None:
    """Sum, in place, the gradients of the server's leaves over the client
    axis: each rank of it holds other clients' tokens, so its gradient of
    a shared leaf is a partial sum. A leaf whose spec lays no dim on
    `data` is summed over the client axis (`data`, or (pod, data)); an
    fsdp leaf, whose gradient ``gather_from`` already reduce-scattered
    over `data` within its pod, over `pod` alone (replicated across pods,
    its gradient crosses `pod` once a step); a client-axis leaf (the
    adapters) needs nothing: it holds only this rank's clients."""
    axis = client_axis()
    if size(axis) == 1:
        return
    pods = size("pod") > 1
    for p, g in zip(params, grads):
        on = spec_axes(spec_of(p))
        if "data" not in on:
            g.copy_(all_reduce(g, axis))
        elif pods and "pod" not in on:
            g.copy_(all_reduce(g, "pod"))
