"""Server-side aggregation arithmetic.

Port of ``fedml_tpu/ml/aggregator/agg_operator.py``: ``agg_stacked`` (the
vectorized Parrot path), ``mix_global`` and ``fold_buffer`` (the
buffered-async fold), ``weighted_average``, ``uniform_average``, and the
host-driven ``FedMLAggOperator`` (the funnel of the SP simulation and the
cross-silo server) with its sample-weighted arm and the SCAFFOLD and Mime
pair arms.  Robust aggregation raises ``NotImplementedError`` naming port
item A9.

``agg_stacked`` and ``fold_buffer`` take dicts of tensors: one ``[C, ...]``
tensor per key (the Parrot engine passes one ``[C, D]`` buffer per dtype),
``mix_global`` and ``fold_buffer`` the global's tensor under the same key.
``weighted_average`` and ``FedMLAggOperator`` take ``(n_samples, tree)``
pairs, the trees nested dicts of tensors (``utils/tree.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch

from ...constants import FED_OPT_MIME, FED_OPT_SCAFFOLD
from ...ops.epilogue import fused_epilogue, weighted_reduce
from ...utils.tree import tree_leaves, tree_map, tree_structure, tree_unflatten

K = TypeVar("K")


def agg_stacked(stacked: Dict[K, torch.Tensor], weights: torch.Tensor,
                out: Optional[Dict[K, torch.Tensor]] = None
                ) -> Dict[K, torch.Tensor]:
    """Weighted average over a leading client axis, for each ``[C, ...]``
    tensor of ``stacked``; ``weights`` ([C]) need not be normalised —
    masked-out clients carry weight 0.

    Accumulation runs in float32 and float results come back in their input
    dtype; non-float inputs give float32.  The Parrot engine passes one
    ``[C, D]`` buffer per dtype, so each round is one kernel launch per
    dtype (``ops/epilogue.py``).  ``out``: tensors under the same keys to
    write the results into (the Parrot engine's global buffers, whose
    addresses a captured round keeps); returned."""
    if out is None:
        return {k: weighted_reduce(v, weights) for k, v in stacked.items()}
    for k, v in stacked.items():
        weighted_reduce(v, weights, out=out[k])
    return out


def mix_global(global_tree: Dict[K, torch.Tensor],
               agg_tree: Dict[K, torch.Tensor],
               server_lr: Any) -> Dict[K, torch.Tensor]:
    """Server-rate mixing ``global ← global + server_lr · (agg − global)``,
    in float32 and back in the global's dtype (``server_lr`` = 1 replaces
    outright).  Non-float globals take the aggregate as it is — a
    fractional mix of step counters is meaningless.  Plain PyTorch; the
    rate meets the float32 tensors rounded to float32, as in JAX."""
    lr = float(np.float32(float(server_lr)))

    def mix(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        if not g.dtype.is_floating_point:
            return a
        gf = g.float()
        return (gf + lr * (a.float() - gf)).to(g.dtype)

    return {k: mix(g, agg_tree[k]) for k, g in global_tree.items()}


def fold_buffer(global_tree: Dict[K, torch.Tensor],
                stacked: Dict[K, torch.Tensor], weights: torch.Tensor,
                server_lr: Any = 1.0) -> Dict[K, torch.Tensor]:
    """Buffered-async fold core: staleness-decayed ``weights``
    ([n_buffer], staleness × sample counts, computed by the caller) weight
    one reduction over the stacked update buffer, and the result mixes into
    the global at ``server_lr`` — reduce and mix as one ``fused_epilogue``
    launch per key (its ``none`` channel)."""
    out = {}
    for k, g in global_tree.items():
        x = stacked[k]
        new, _ = fused_epilogue(g.reshape(-1), x.reshape(x.shape[0], -1),
                                weights, server_lr)
        out[k] = new.reshape(g.shape)
    return out


def weighted_average(grad_list: Sequence[Tuple[float, Any]]) -> Any:
    """Sample-count weighted average of trees, leaf by leaf in plain torch
    (``Σ_k (n_k / Σn) · leaf_k``); a round whose total is 0 takes uniform
    weights."""
    total = float(sum(n for n, _ in grad_list))
    if total <= 0:
        total = float(len(grad_list))
        grad_list = [(1.0, g) for _, g in grad_list]
    ws = [n / total for n, _ in grad_list]
    trees = [g for _, g in grad_list]
    return tree_map(lambda *leaves: sum(w * leaf for w, leaf
                                        in zip(ws, leaves)), *trees)


def uniform_average(trees: Sequence[Any], denom: Optional[float] = None
                    ) -> Any:
    """``Σ trees / denom`` leaf by leaf (``denom`` the number of trees by
    default): SCAFFOLD's control variates, averaged uniformly over
    ``client_num_in_total``.  Trees that stack into ``[C, D]`` buffers take
    the weighted-reduce kernel with unit weights (``agg_trees``: their mean,
    in float32), scaled by ``C / denom`` rounded to float32; others are
    summed leaf by leaf in plain torch on the CPU, and raise on a card."""
    k = len(trees)
    denom = float(denom if denom is not None else k)
    pairs = [(1.0, t) for t in trees]
    why = _unstackable(pairs)
    if not why:
        device = tree_leaves(trees[0])[0].device
        mean = agg_trees(trees, torch.ones(k, dtype=torch.float32,
                                           device=device))
        if k == denom:
            return mean
        scale = float(np.float32(k / denom))
        return tree_map(lambda x: x * scale, mean)
    if _on_card(pairs):
        raise ValueError(f"trees on a card that do not stack into one "
                         f"[C, D] buffer per dtype for the weighted-reduce "
                         f"kernel: {why}")
    return tree_map(lambda *leaves: sum(leaves) / denom, *trees)


def _unstackable(grad_list: Sequence[Tuple[float, Any]]) -> str:
    """Why the client payloads cannot be stacked into ``[C, D]`` buffers,
    or ``""`` when they can: every payload a tree of one structure, with
    float or integer tensors of matching shapes and dtypes on one
    device."""
    trees = [g for _, g in grad_list]
    structure = tree_structure(trees[0])
    first = tree_leaves(trees[0])
    if not first:
        return "a payload without tensors"
    for c, tree in enumerate(trees):
        if tree_structure(tree) != structure:
            return f"payload {c} is another tree than payload 0"
        for a, b in zip(first, tree_leaves(tree)):
            if not isinstance(b, torch.Tensor):
                return f"payload {c} holds a {type(b).__name__}"
            if b.dtype.is_complex or b.dtype == torch.bool:
                return f"payload {c} holds a {b.dtype} leaf"
            if (b.shape != a.shape or b.dtype != a.dtype
                    or b.device != a.device):
                return (f"payload {c} holds a {b.dtype} {tuple(b.shape)} "
                        f"leaf on {b.device} where payload 0 holds "
                        f"{a.dtype} {tuple(a.shape)} on {a.device}")
    return ""


def _on_card(grad_list: Sequence[Tuple[float, Any]]) -> bool:
    return any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
               for _, g in grad_list for leaf in tree_leaves(g))


def _stack_trees(trees: Sequence[Any]
                ) -> Tuple[Dict[torch.dtype, torch.Tensor],
                           Dict[torch.dtype, List[int]]]:
    """Stack the leaves of ``trees`` (one structure) into one ``[C, D]``
    buffer per dtype, row ``c`` the concatenated leaves of tree ``c`` in
    flatten order; with, per dtype, the flatten indexes of its leaves."""
    first = tree_leaves(trees[0])
    groups: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(first):
        groups.setdefault(leaf.dtype, []).append(i)
    rows = [tree_leaves(t) for t in trees]
    stacked = {}
    for dt, idx in groups.items():
        d = sum(first[i].numel() for i in idx)
        buf = torch.empty((len(trees), d), dtype=dt, device=first[0].device)
        for c, leaves in enumerate(rows):
            torch.cat([leaves[i].reshape(-1) for i in idx], out=buf[c])
        stacked[dt] = buf
    return stacked, groups


def agg_trees(trees: Sequence[Any], weights: torch.Tensor) -> Any:
    """Weighted average of ``trees`` with ``agg_stacked``: stacked once
    into a ``[C, D]`` buffer per dtype, so a round of float32 trees is one
    weighted-reduce launch.  Float leaves come back in their dtype,
    integer leaves as float32."""
    stacked, groups = _stack_trees(trees)
    agg = agg_stacked(stacked, weights)
    first = tree_leaves(trees[0])
    leaves: List[Any] = [None] * len(first)
    for dt, idx in groups.items():
        off = 0
        for i in idx:
            n = first[i].numel()
            leaves[i] = agg[dt][off:off + n].reshape(first[i].shape)
            off += n
    return tree_unflatten(tree_structure(trees[0]), leaves)


class FedMLAggOperator:
    """The host-driven aggregation funnel, dispatched on
    ``args.federated_optimizer``: the sample-weighted average, and the
    SCAFFOLD and Mime arms on ``(params, extra)`` pair payloads."""

    @staticmethod
    def _reduce(args: Any, grad_list: List[Tuple[float, Any]],
                center: Any = None) -> Any:
        """One weighted reduction, stacked once and reduced by the
        weighted-reduce kernel (``agg_trees``) while ``fused_epilogue`` is
        on; a round whose total weight is 0 takes uniform weights.  The
        leaf-by-leaf ``weighted_average`` takes the explicit
        ``fused_epilogue: false`` and, on the CPU, payloads that do not
        stack; on a card such payloads raise, as no kernel takes them."""
        if getattr(args, "robust_agg", None):
            raise NotImplementedError(
                "robust_agg is not ported yet (port item A9)")
        if grad_list and bool(getattr(args, "fused_epilogue", True)):
            why = _unstackable(grad_list)
            if not why:
                ns = [float(n) for n, _ in grad_list]
                device = tree_leaves(grad_list[0][1])[0].device
                weights = (torch.ones(len(ns), dtype=torch.float32,
                                      device=device) if sum(ns) <= 0 else
                           torch.tensor(ns, dtype=torch.float32,
                                        device=device))
                return agg_trees([g for _, g in grad_list], weights)
            if _on_card(grad_list):
                raise ValueError(
                    f"client payloads on a card that do not stack into one "
                    f"[C, D] buffer per dtype for the weighted-reduce "
                    f"kernel: {why}")
        return weighted_average(grad_list)

    @staticmethod
    def agg(args: Any, raw_grad_list: List[Tuple[float, Any]],
            center: Any = None) -> Any:
        """``center`` is the current global model, the clipping anchor of
        the JAX package's robust operators (A9); the ported arms ignore it.

        Payloads that are not pairs take one weighted reduction, whatever
        the optimizer.  SCAFFOLD's pairs ``(n_k, (params, c_delta))``: the
        params sample-weighted, the variates averaged uniformly over
        ``client_num_in_total`` (``uniform_average``); Mime's ``(n_k,
        (params, grads))``: both sample-weighted.  Returns the two averages
        as a pair."""
        opt = getattr(args, "federated_optimizer", "FedAvg")
        is_pair = bool(raw_grad_list) and isinstance(raw_grad_list[0][1],
                                                     tuple)
        if is_pair and opt == FED_OPT_SCAFFOLD:
            n_total = float(getattr(args, "client_num_in_total",
                                    len(raw_grad_list)))
            params_avg = FedMLAggOperator._reduce(
                args, [(n, pair[0]) for n, pair in raw_grad_list], center)
            c_avg = uniform_average([pair[1] for _, pair in raw_grad_list],
                                    denom=n_total)
            return params_avg, c_avg
        if is_pair and opt == FED_OPT_MIME:
            params_avg = FedMLAggOperator._reduce(
                args, [(n, pair[0]) for n, pair in raw_grad_list], center)
            grads_avg = FedMLAggOperator._reduce(
                args, [(n, pair[1]) for n, pair in raw_grad_list])
            return params_avg, grads_avg
        return FedMLAggOperator._reduce(args, raw_grad_list, center)
