"""Trees of tensors: nested dicts, lists and tuples, walked in JAX's order.

The JAX package's cross-silo plane exchanges pytrees and flattens them with
``jax.tree_util``, whose order sorts dict keys as strings
(``batch_stats`` before ``params``, ``BasicBlock_10`` before
``BasicBlock_2``) and walks lists and tuples in place; ``None`` holds no
leaf.  The wire codec's flat vector, and so every 512-value block and its
scale, follows that order (``utils/compression.py``), so the port walks
its trees the same way: a model payload from either package flattens to
the same vector.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

#: stands for a leaf in a tree structure (``tree_structure``)
LEAF = object()


def tree_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
                ) -> List[Any]:
    """The leaves of ``tree`` in JAX's flatten order."""
    out: List[Any] = []

    def walk(t: Any) -> None:
        if is_leaf is not None and is_leaf(t):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif t is not None:
            out.append(t)

    walk(tree)
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` (and the leaves at the same places
    of ``rest``), keeping the containers; called in flatten order, and dict
    keys come back sorted, as from JAX's ``tree_map``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_structure(tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``LEAF``; two trees of one
    structure compare equal."""
    return tree_map(lambda _: LEAF, tree)


def tree_unflatten(structure: Any, leaves: List[Any]) -> Any:
    """The inverse of ``tree_leaves``: ``leaves``, in flatten order, put
    back at the places of ``structure`` (a tree, or ``tree_structure`` of
    one)."""
    it = iter(leaves)

    def build(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(structure)
    if next(it, LEAF) is not LEAF:
        raise ValueError("more leaves than the structure has places")
    return out


def leaf_generator(seed: int, index: int) -> torch.Generator:
    """A CPU ``torch.Generator`` for the draws of leaf ``index`` of a tree,
    seeded from ``(seed, index)`` as JAX folds a leaf's index into its key.
    The numbers are not JAX's; the distributions are."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))
