"""Parameter bridge between the JAX package's trees and the port's params.

``from_repro`` takes a param tree of the JAX package with array leaves
(numpy, or anything ``np.asarray`` reads, e.g. the output of
``M.init_lm``) and returns the port's params; ``to_repro`` goes back to
numpy. Both keep every dtype and every bit: a bfloat16 leaf arrives as an
``ml_dtypes`` array, which ``torch.from_numpy`` rejects, so it goes
through float32 (exact) and then to ``torch.bfloat16``.

The JAX package stacks the layers of each body segment on a leading axis
(the leaves of every ``tree["segments"][i]`` are ``[L, ...]``); the port
keeps a list of L per-layer dicts instead. The conversion goes down nested
dicts, so the MPSL trees of ``core.split.init_mpsl_lm`` (``client.adapter``
stays stacked [N, ...], ``server.segments`` and the frozen segments are
split per layer) and AdamW's ``{mu, nu, count}``, whose moments mirror
the params, cross as well. So do the SSM and hybrid trees: a hybrid
layer's beta scalars, stacked [L] in the JAX package, become 0-d tensors.
So does whisper's ``encoder`` subtree, whose stacked ``segments`` are
split as the body's. So do the paper-mode trees (``init_mpsl_vit``: the
stacked [N, ...] ``client.tokenizers``, the task head or the retrieval
projections and 0-d ``logit_scale``; ``init_full_vit``). A client bank
of full models (``core.baselines.make_fl_round``), every leaf stacked
[N, ...], crosses with ``client_axis=True``: its segment leaves are [N,
L, ...] in the JAX package and split on L, each layer's leaves keeping
the client axis.

``cache_to_repro`` stacks the port's per-layer serving caches (KV, SSM,
hybrid) into the JAX package's stacked layout, for comparing the two.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import leaves as _leaves
from repro_torch.tree import map_ as _map


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # only where a bf16 tree goes back to the JAX side
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy().copy()


def from_repro(tree, device="cpu", client_axis=False):
    """JAX-package tree -> the port's on `device`: tensors for arrays, each
    stacked ``segments`` list split into per-layer lists (on axis 1, the
    layer axis after the client axis, with `client_axis`)."""
    if not isinstance(tree, dict):
        return _map(lambda a: _to_tensor(a, device), tree)
    out = {k: from_repro(v, device, client_axis) for k, v in tree.items()
           if k != "segments"}
    if "segments" in tree:
        ax = int(client_axis)
        out["segments"] = []
        for seg in tree["segments"]:
            count = np.shape(_leaves(seg)[0])[ax]
            out["segments"].append(
                [_map(lambda a, i=i: _to_tensor(
                    np.take(np.asarray(a), i, axis=ax), device), seg)
                 for i in range(count)])
    return out


def to_repro(params, client_axis=False):
    """The port's tree -> a JAX-package tree of numpy arrays, each
    per-layer ``segments`` list stacked back (on axis 1 with
    `client_axis`)."""
    if not isinstance(params, dict):
        return _map(_to_numpy, params)
    out = {k: to_repro(v, client_axis) for k, v in params.items()
           if k != "segments"}
    if "segments" in params:
        out["segments"] = [_stack([_map(_to_numpy, lp) for lp in layer_list],
                                  int(client_axis))
                           for layer_list in params["segments"]]
    return out


def _stack(trees, axis=0):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], axis) for k in first}
    return np.stack(trees, axis=axis)


def cache_to_repro(caches):
    """The port's body cache (per segment, a list of per-layer cache dicts;
    a KV cache's ``index`` is an int) -> the JAX package's (per segment, one
    dict of stacked numpy arrays; ``index`` int32 [L])."""
    def leaf(x):
        return np.asarray(x, np.int32) if isinstance(x, int) else _to_numpy(x)
    return [_stack([_map(leaf, layer) for layer in seg]) for seg in caches]
