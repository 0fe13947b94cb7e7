"""Parameter bridge between the JAX package's trees and the port's params.

``from_repro`` takes a param tree of the JAX package with array leaves
(numpy, or anything ``np.asarray`` reads, e.g. the output of
``M.init_lm``) and returns the port's params; ``to_repro`` goes back to
numpy. Both keep every dtype and every bit: a bfloat16 leaf arrives as an
``ml_dtypes`` array, which ``torch.from_numpy`` rejects, so it goes
through float32 (exact) and then to ``torch.bfloat16``.

The JAX package stacks the layers of each body segment on a leading axis
(``params["segments"][i]`` leaves are ``[L, ...]``); the port keeps a list
of L per-layer dicts instead.
"""
from __future__ import annotations

import numpy as np
import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


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


def from_repro(tree, device="cpu"):
    """JAX-package param tree -> the port's params on `device`."""
    if "encoder" in tree:
        raise NotImplementedError(
            "encoders come with the enc-dec / VLM slice of the port")
    out = {k: _map(lambda a: _to_tensor(a, device), v)
           for k, v in tree.items() if k != "segments"}
    out["segments"] = []
    for seg in tree["segments"]:
        count = np.shape(_leaves(seg)[0])[0]
        out["segments"].append(
            [_map(lambda a, i=i: _to_tensor(np.asarray(a)[i], device), seg)
             for i in range(count)])
    return out


def to_repro(params):
    """The port's params -> a JAX-package param tree of numpy arrays."""
    out = {k: _map(_to_numpy, v) for k, v in params.items()
           if k != "segments"}
    out["segments"] = []
    for layer_list in params["segments"]:
        per_layer = [_map(_to_numpy, lp) for lp in layer_list]
        out["segments"].append(_stack(per_layer))
    return out


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)
