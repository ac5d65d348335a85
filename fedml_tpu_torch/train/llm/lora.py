"""LoRA on the JAX package's parameter trees.

Port of ``fedml_tpu/train/llm/lora.py``.  LoRA is a transform on the
parameter tree, not a model wrapper: ``init_lora`` allocates factors
``(a, b)`` for every 2-D kernel whose path matches a target pattern,
``apply_lora`` returns the effective parameters ``W + (alpha/r)·(a@b)``,
and training updates only the factors.

The trees are the JAX package's: nested dicts of tensors in flax's names
and layouts (``utils/weights.tree_from_module(model)["params"]``), walked
in JAX's flatten order (dict keys sorted as strings).  Adapters are keyed
by the flax path of their kernel (``TransformerBlock_0/Dense_1/kernel``)
and held in flax's layout, ``a`` ``[d_in, r]`` and ``b`` ``[r, d_out]``, so
the adapter tree that crosses the wire is the JAX package's, leaf for
leaf.  A torch ``Dense.weight`` is the kernel transposed, so the merged
kernel carried into the module adds ``scale·(a@b)ᵀ`` to it
(``utils/weights.named_tensors_from_tree`` transposes).

Targets match on the flax path and shape: 2-D kernels only, by
``re.fullmatch`` ignoring case.  On ``TinyTransformerLM`` that is the five
``Dense`` kernels, and none of the 3-D attention ``DenseGeneral`` kernels:
the JAX package's behaviour, kept.

Draws: ``init_lora`` draws ``a ~ N(0, 0.01²)`` from a ``torch.Generator``
per leaf, seeded from ``(seed, leaf index)`` as JAX folds the leaf index
into its key, and sets ``b = 0``.  Torch's draws are not JAX's: the
distribution is the same, the numbers are not (``utils/weights.
adapters_from_jax`` carries JAX's adapters across).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.epilogue import flat_tree
from ...utils.tree import leaf_generator

DEFAULT_TARGETS = (r".*attention.*kernel", r".*(query|key|value|out).*kernel",
                   r".*Dense_\d+.*kernel",
                   # functional-LM layout (parallel/seq_parallel.py):
                   # per-block attention/MLP matmuls
                   r".*/w[qkvo]", r".*/w[12]")


def _path_str(path: Sequence[Any]) -> str:
    """A tree path (a sequence of dict keys) as ``"a/b/c"``."""
    return "/".join(str(p) for p in path)


def leaves_with_path(tree: Any, prefix: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` for every leaf of a nested dict, in JAX's flatten
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (k,))
    elif tree is not None:
        yield prefix, tree


def _is_target(path: str, shape: Sequence[int],
               targets: Sequence[str]) -> bool:
    if len(shape) != 2:
        return False
    return any(re.fullmatch(t, path, flags=re.IGNORECASE) for t in targets)


def init_lora(params: Any, rank: int = 8,
              targets: Optional[Sequence[str]] = None, seed: int = 0,
              dtype: torch.dtype = torch.float32,
              device: Any = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{path: {"a": [d_in, r], "b": [r, d_out]}}`` for each targeted
    kernel of ``params``, on ``device`` (else the kernels' own), every leaf
    a view into one flat buffer (``ops/epilogue.flat_tree``), so the fold
    kernel takes them all in one launch.  ``seed`` should be the caller's
    own stream for adapters, apart from the base parameters' draws."""
    targets = tuple(targets or DEFAULT_TARGETS)
    lora: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, (path, leaf) in enumerate(leaves_with_path(params)):
        p = _path_str(path)
        if _is_target(p, tuple(leaf.shape), targets):
            d_in, d_out = leaf.shape
            a = torch.randn((d_in, rank), generator=leaf_generator(seed, i))
            lora[p] = {"a": (a * 0.01).to(dtype),
                       "b": torch.zeros((rank, d_out), dtype=dtype)}
    if not lora:
        return lora
    dev = device if device is not None else next(
        leaf for _, leaf in leaves_with_path(params)).device
    return flat_tree(lora, dev)


def lora_scale(lora: Dict[str, Any], alpha: float) -> float:
    """``alpha / r``, the rank read from any ``a`` factor."""
    some = next(iter(lora.values()))
    return float(alpha) / some["a"].shape[1]


def apply_lora(params: Any, lora: Dict[str, Any], alpha: float = 16.0
               ) -> Any:
    """Effective parameters: ``W' = W + (alpha/r)·(a@b)`` for the targeted
    kernels, in flax's layout; ``a@b`` is cast to the kernel's dtype before
    the scale, as ``fedml_tpu/train/llm/lora.py:73-74`` casts it.  Other
    leaves are returned as they are (the same tensors)."""
    if not lora:
        return params
    scale = float(np.float32(lora_scale(lora, alpha)))

    def walk(tree: Any, prefix: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict):
            return {k: walk(tree[k], prefix + (k,)) for k in sorted(tree)}
        p = _path_str(prefix)
        if p in lora:
            ab = (lora[p]["a"] @ lora[p]["b"]).to(tree.dtype)
            return tree + scale * ab
        return tree

    return walk(params, ())


def merge_lora(params: Any, lora: Dict[str, Any], alpha: float = 16.0
               ) -> Any:
    """Bake LoRA into the base weights (for serving or export)."""
    return apply_lora(params, lora, alpha)


def count_trainable(lora: Dict[str, Any]) -> int:
    return sum(int(v.numel()) for d in lora.values() for v in d.values())
