"""Carry model variables between the JAX tree and the port's modules.

The JAX package holds a model's state as ``{"params": ..., "batch_stats":
...}``, nested dicts keyed by the flax module names.  The port's modules
carry the same names (``models/cv.py``), so a leaf maps by path and layout:

* ``Conv``: ``params/.../kernel`` HWIO ↔ ``weight`` OIHW;
* ``Dense``: ``kernel`` [in, out] ↔ ``weight`` [out, in], ``bias`` ↔ ``bias``;
* ``BatchNorm``: ``scale``/``bias`` ↔ ``weight``/``bias``, and
  ``batch_stats/.../mean``/``var`` ↔ ``running_mean``/``running_var``.

Trees cross as numpy arrays, so neither side imports the other.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..models.cv import BatchNorm, Conv, Dense

# (module type, torch leaf) → (collection, flax leaf, torch→flax, flax→torch)
_MAP = {
    (Conv, "weight"): ("params", "kernel",
                       lambda a: a.transpose(2, 3, 1, 0),
                       lambda a: a.transpose(3, 2, 0, 1)),
    (Dense, "weight"): ("params", "kernel", np.transpose, np.transpose),
    (Dense, "bias"): ("params", "bias", None, None),
    (BatchNorm, "weight"): ("params", "scale", None, None),
    (BatchNorm, "bias"): ("params", "bias", None, None),
    (BatchNorm, "running_mean"): ("batch_stats", "mean", None, None),
    (BatchNorm, "running_var"): ("batch_stats", "var", None, None),
}


def _leaf_map(model: nn.Module):
    """Yield (tensor, collection, flax path, torch→flax, flax→torch) for
    every parameter and buffer of ``model``."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    for name, t in named:
        prefix, _, leaf = name.rpartition(".")
        owner = model.get_submodule(prefix)
        entry = _MAP.get((type(owner), leaf))
        if entry is None:
            raise KeyError(f"no flax counterpart for {name!r} "
                           f"({type(owner).__name__})")
        coll, flax_leaf, to_flax, from_flax = entry
        path = tuple(prefix.split(".")) if prefix else ()
        yield t, coll, path + (flax_leaf,), to_flax, from_flax


def _get(tree: Dict[str, Any], path: Tuple[str, ...]) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _count_leaves(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def from_flax_variables(np_tree: Dict[str, Any], model: nn.Module) -> None:
    """Copy a JAX variables tree (numpy leaves) into ``model`` in place —
    into whatever storage the module's tensors are, flat views included.
    Raises on a missing, extra or misshapen leaf."""
    n = 0
    with torch.no_grad():
        for t, coll, path, _, from_flax in _leaf_map(model):
            a = np.array(_get(np_tree[coll], path), np.float32)
            if from_flax is not None:
                a = from_flax(a)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{coll}/{'/'.join(path)}: flax shape "
                                 f"{a.shape} does not fit {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            n += 1
    total = sum(_count_leaves(v) for v in np_tree.values())
    if total != n:
        raise ValueError(f"flax tree has {total} leaves, the model {n}")


def to_flax_variables(model: nn.Module) -> Dict[str, Any]:
    """The inverse: ``{"params": ..., "batch_stats": ...}`` with float32
    numpy leaves in the flax layouts."""
    out: Dict[str, Any] = {}
    for t, coll, path, to_flax, _ in _leaf_map(model):
        a = t.detach().float().cpu().numpy()
        if to_flax is not None:
            a = to_flax(a)
        node = out.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out
