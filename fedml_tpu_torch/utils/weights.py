"""Carry model variables between the JAX tree and the port's modules.

The JAX package holds a model's state as ``{"params": ..., "batch_stats":
...}``, nested dicts keyed by the flax module names.  The port's modules
carry the same names (``models/cv.py``, ``models/nlp.py``), so a leaf maps
by path and layout:

* ``Conv``: ``params/.../kernel`` HWIO ↔ ``weight`` OIHW;
* ``Dense``: ``kernel`` [in, out] ↔ ``weight`` [out, in], ``bias`` ↔ ``bias``;
* ``BatchNorm``: ``scale``/``bias`` ↔ ``weight``/``bias``, and
  ``batch_stats/.../mean``/``var`` ↔ ``running_mean``/``running_var``;
* ``Embed``: ``embedding`` [vocab, dim] ↔ ``weight``, as it is;
* ``LayerNorm``: ``scale``/``bias`` ↔ ``weight``/``bias``;
* ``DenseGeneral`` (the attention heads' ``query``, ``key``, ``value``
  and ``out``): ``kernel`` ↔ ``weight`` and ``bias`` ↔ ``bias`` in flax's
  layouts, ``[dim, heads, head_dim]``/``[heads, head_dim]`` and
  ``[heads, head_dim, dim]``/``[dim]``;
* ``TinyTransformerLM.pos_embed`` ↔ ``params/pos_embed``.

Trees cross as numpy arrays, so neither side imports the other.

LoRA adapters (``train/llm/lora.py``) are trees of their own, ``{flax
path of the kernel: {"a": [d_in, r], "b": [r, d_out]}}`` in flax's
layout on both sides: ``adapters_from_jax`` and ``adapters_to_jax`` carry
them across as they are.  ``named_tensors_from_tree`` turns a variables
tree into the module's own names and layouts (views, so a gradient flows
back into the tree's leaves), the parameters ``torch.func.functional_call``
takes.

FedOpt's server state crosses the same way (``opt_state_from_jax`` and
``opt_state_to_jax``).  The JAX package keeps it as trees shaped like
``params``: the fused epilogue's ``{"m", "v", "t"}`` (``m`` alone for
momentum, None for sgd), or optax's state on the unfused arm (a tuple of
named tuples: ``count``/``mu``/``nu``, ``sum_of_squares`` or ``trace``).
The port keeps it per dtype group of ``FlatVariables``, over that group's
parameter columns: ``{dtype: {"m": [P], "v": [P], "t": int}}``, or optax's
field names with flat ``[P]`` tensors and an int ``count``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ..ml.engine.model_bundle import FlatVariables
from ..models.cv import BatchNorm, Conv, Dense
from ..models.nlp import DenseGeneral, Embed, LayerNorm, TinyTransformerLM

# (module type, torch leaf) → (collection, flax leaf, axes of the torch
# tensor in the flax layout, axes of the flax leaf in the torch layout)
_MAP = {
    (Conv, "weight"): ("params", "kernel", (2, 3, 1, 0), (3, 2, 0, 1)),
    (Dense, "weight"): ("params", "kernel", (1, 0), (1, 0)),
    (Dense, "bias"): ("params", "bias", None, None),
    (BatchNorm, "weight"): ("params", "scale", None, None),
    (BatchNorm, "bias"): ("params", "bias", None, None),
    (BatchNorm, "running_mean"): ("batch_stats", "mean", None, None),
    (BatchNorm, "running_var"): ("batch_stats", "var", None, None),
    (Embed, "weight"): ("params", "embedding", None, None),
    (LayerNorm, "weight"): ("params", "scale", None, None),
    (LayerNorm, "bias"): ("params", "bias", None, None),
    (DenseGeneral, "weight"): ("params", "kernel", None, None),
    (DenseGeneral, "bias"): ("params", "bias", None, None),
    (TinyTransformerLM, "pos_embed"): ("params", "pos_embed", None, None),
}


def _leaf_map(model: nn.Module):
    """Yield (name, tensor, collection, flax path, torch→flax axes,
    flax→torch axes) for every parameter and buffer of ``model``; an axes
    entry is None where the layouts agree."""
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
        yield name, t, coll, path + (flax_leaf,), to_flax, from_flax


def _get(tree: Dict[str, Any], path: Tuple[str, ...]) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _count_leaves(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def _read_tree(np_tree: Dict[str, Any], leaves) -> Iterator[Tuple[Any,
                                                                  torch.Tensor]]:
    """Yield ``(target, tensor)``: for each ``(target, shape, flax path,
    flax→torch)`` of ``leaves``, the leaf of ``np_tree`` at that path in the
    torch layout, as float32.  Raises on a misshapen leaf."""
    for target, shape, path, from_flax in leaves:
        a = np.array(_get(np_tree, path), np.float32)
        if from_flax is not None:
            a = a.transpose(from_flax)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{'/'.join(path)}: flax shape {a.shape} does "
                             f"not fit {tuple(shape)}")
        yield target, torch.from_numpy(np.ascontiguousarray(a))


def _build_tree(leaves) -> Dict[str, Any]:
    """The nested flax tree, with float32 numpy leaves in the flax layouts,
    of ``leaves``: ``(tensor in the torch layout, flax path, torch→flax)``."""
    out: Dict[str, Any] = {}
    for t, path, to_flax in leaves:
        a = t.detach().float().cpu().numpy()
        if to_flax is not None:
            a = a.transpose(to_flax)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out


def from_flax_variables(np_tree: Dict[str, Any], model: nn.Module) -> None:
    """Copy a JAX variables tree (numpy leaves) into ``model`` in place —
    into whatever storage the module's tensors are, flat views included.
    Raises on a missing, extra or misshapen leaf."""
    leaves = [(t, t.shape, (coll,) + path, from_flax)
              for _, t, coll, path, _, from_flax in _leaf_map(model)]
    with torch.no_grad():
        for t, a in _read_tree(np_tree, leaves):
            t.copy_(a)
    total = sum(_count_leaves(v) for v in np_tree.values())
    if total != len(leaves):
        raise ValueError(f"flax tree has {total} leaves, the model "
                         f"{len(leaves)}")


def to_flax_variables(model: nn.Module) -> Dict[str, Any]:
    """The inverse: ``{"params": ..., "batch_stats": ...}`` with float32
    numpy leaves in the flax layouts."""
    return _build_tree((t, (coll,) + path, to_flax)
                       for _, t, coll, path, to_flax, _ in _leaf_map(model))


def tree_from_module(model: nn.Module) -> Dict[str, Any]:
    """``model``'s variables as the JAX package's tree of them —
    ``{"params": ..., "batch_stats": ...}`` in the flax names and layouts —
    with tensors in their own dtype on the module's device.  Every leaf is
    a fresh contiguous copy: later training of the module leaves the tree
    as it is.  The cross-silo plane exchanges these trees."""
    out: Dict[str, Any] = {}
    with torch.no_grad():
        for _, t, coll, path, to_flax, _ in _leaf_map(model):
            leaf = t.detach()
            if to_flax is not None:
                leaf = leaf.permute(to_flax)
            node = out.setdefault(coll, {})
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = leaf.clone(memory_format=torch.contiguous_format)
    return out


def load_tree(tree: Dict[str, Any], model: nn.Module) -> None:
    """The inverse of ``tree_from_module``: copy a tree of tensors in the
    flax layouts into ``model`` in place (flat views included), casting to
    each tensor's dtype and device.  The tree is only read."""
    with torch.no_grad():
        for name, t, coll, path, _, from_flax in _leaf_map(model):
            leaf = _get(tree, (coll,) + path)
            if from_flax is not None:
                leaf = leaf.permute(from_flax)
            if tuple(leaf.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join((coll,) + path)}: shape "
                                 f"{tuple(leaf.shape)} does not fit {name} "
                                 f"{tuple(t.shape)}")
            t.copy_(leaf)


# ------------------------------------------------------- FedOpt server state
def _param_leaves(flat_vars: FlatVariables):
    """Yield (layout leaf, flax path, torch→flax, flax→torch) for every
    parameter of ``flat_vars``' module."""
    places = {leaf.name: leaf for leaf in flat_vars.layout}
    for name, _, coll, path, to_flax, from_flax in _leaf_map(
            flat_vars.module):
        if coll == "params":
            yield places[name], path, to_flax, from_flax


def flat_from_flax_params(np_tree: Dict[str, Any], flat_vars: FlatVariables,
                          device: Any = "cpu") -> Dict[torch.dtype,
                                                       torch.Tensor]:
    """A tree shaped like the JAX ``params`` (numpy leaves) as float32
    tensors over each dtype group's parameter columns ``[0, P)``."""
    out = {dt: torch.zeros(flat_vars.param_cols[dt], dtype=torch.float32,
                           device=device)
           for dt in flat_vars.param_dtypes()}
    for leaf, a in _read_tree(np_tree, (
            (leaf, leaf.shape, path, from_flax)
            for leaf, path, _, from_flax in _param_leaves(flat_vars))):
        out[leaf.dtype][leaf.offset:leaf.offset + leaf.numel] = a.reshape(-1)
    return out


def flax_params_from_flat(flat: Dict[torch.dtype, torch.Tensor],
                          flat_vars: FlatVariables) -> Dict[str, Any]:
    """The inverse: float32 numpy leaves in the flax layouts."""
    return _build_tree(
        (flat[leaf.dtype][leaf.offset:leaf.offset + leaf.numel]
         .reshape(leaf.shape), path, to_flax)
        for leaf, path, to_flax, _ in _param_leaves(flat_vars))


def flat_from_params_tree(tree: Dict[str, Any], flat_vars: FlatVariables
                          ) -> Dict[torch.dtype, torch.Tensor]:
    """A tree of tensors shaped like the JAX ``params`` (the flax names and
    layouts, ``tree_from_module(...)["params"]``) as one ``[P]`` tensor per
    dtype group over its parameter columns, in the group's dtype on the
    module's device: the per-client state of the local update's arms
    (``ml/engine/local_update.py``)."""
    device = next(iter(flat_vars.flat.values())).device
    out = {dt: torch.zeros(flat_vars.param_cols[dt], dtype=dt,
                           device=device)
           for dt in flat_vars.param_dtypes()}
    with torch.no_grad():
        for leaf, path, _, from_flax in _param_leaves(flat_vars):
            a = _get(tree, path)
            if from_flax is not None:
                a = a.permute(from_flax)
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(f"{'/'.join(path)}: shape {tuple(a.shape)} "
                                 f"does not fit {tuple(leaf.shape)}")
            out[leaf.dtype][leaf.offset:leaf.offset + leaf.numel].copy_(
                a.reshape(-1))
    return out


def params_tree_from_flat(flat: Dict[torch.dtype, torch.Tensor],
                          flat_vars: FlatVariables) -> Dict[str, Any]:
    """The inverse: a tree shaped like the JAX ``params`` whose leaves are
    fresh contiguous tensors in the flax layouts, in ``flat``'s dtype and
    device."""
    out: Dict[str, Any] = {}
    with torch.no_grad():
        for leaf, path, to_flax, _ in _param_leaves(flat_vars):
            t = flat[leaf.dtype][leaf.offset:leaf.offset + leaf.numel].view(
                leaf.shape)
            if to_flax is not None:
                t = t.permute(to_flax)
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = t.clone(memory_format=torch.contiguous_format)
    return out


def opt_state_from_jax(np_state: Any, flat_vars: FlatVariables,
                       device: Any = "cpu") -> Dict[torch.dtype, Any]:
    """The JAX package's FedOpt server state (numpy leaves) as the port's,
    per dtype group.  Takes the fused epilogue's dict or None, and optax's
    state (any tuple of named tuples)."""
    dtypes = flat_vars.param_dtypes()
    if np_state is None:
        return {dt: None for dt in dtypes}
    if isinstance(np_state, dict):
        fields = dict(np_state)
    else:
        fields = {}
        for part in np_state:
            fields.update(part._asdict())
    out: Dict[torch.dtype, Dict[str, Any]] = {dt: {} for dt in dtypes}
    for key, val in fields.items():
        if isinstance(val, dict):
            flat = flat_from_flax_params(val, flat_vars, device)
            for dt in dtypes:
                out[dt][key] = flat[dt]
        else:
            for dt in dtypes:
                out[dt][key] = int(np.asarray(val))
    return out


def opt_state_to_jax(state: Dict[torch.dtype, Any],
                     flat_vars: FlatVariables) -> Any:
    """The inverse, as a dict of numpy trees (``t``/``count``, ints or 0-d
    tensors, as int32 scalars); None for a stateless channel."""
    groups = [state[dt] for dt in flat_vars.param_dtypes()]
    if not groups or groups[0] is None:
        return None
    out: Dict[str, Any] = {}
    for key, val in groups[0].items():
        if isinstance(val, torch.Tensor) and val.dim() > 0:
            out[key] = flax_params_from_flat(
                {dt: state[dt][key] for dt in flat_vars.param_dtypes()},
                flat_vars)
        else:
            out[key] = np.asarray(int(val), np.int32)
    return out


# ------------------------------------------------------------ LoRA adapters
def adapters_from_jax(np_tree: Dict[str, Any], device: Any = "cpu",
                      dtype: Any = None) -> Dict[str, Any]:
    """A JAX adapter tree (numpy leaves) as the port's: the same keys and
    layouts, tensors on ``device`` (in their own dtype, or ``dtype``), the
    leaves of each dtype views into one flat buffer."""
    from ..ops.epilogue import flat_tree

    def conv(a: Any) -> torch.Tensor:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t if dtype is None else t.to(dtype)

    tree = {path: {k: conv(v) for k, v in ab.items()}
            for path, ab in np_tree.items()}
    return flat_tree(tree, device)


def adapters_to_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: numpy leaves (float32 adapters as float32, bfloat16 as
    float32 holding the same values)."""
    return {path: {k: v.detach().float().cpu().numpy() for k, v in ab.items()}
            for path, ab in tree.items()}


def named_tensors_from_tree(tree: Dict[str, Any], model: nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """``{torch name: tensor}`` of every leaf of ``tree`` (a variables tree
    ``{"params": ...}`` in the flax names and layouts) that ``model`` has,
    in the module's layouts: permuted views of the tree's tensors, so
    autograd reaches the tree's leaves through them.  Leaves the tree
    lacks are left out (``functional_call`` then takes the module's
    own)."""
    out: Dict[str, torch.Tensor] = {}
    for name, _, coll, path, _, from_flax in _leaf_map(model):
        try:
            leaf = _get(tree, (coll,) + path)
        except KeyError:
            continue
        out[name] = leaf.permute(from_flax) if from_flax is not None \
            else leaf
    return out
