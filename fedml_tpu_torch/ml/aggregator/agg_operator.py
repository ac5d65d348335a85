"""Server-side aggregation arithmetic.

Port of ``fedml_tpu/ml/aggregator/agg_operator.py``: ``agg_stacked`` (the
vectorized Parrot path), ``mix_global`` and ``fold_buffer`` (the
buffered-async fold).  The robust operators and the host-driven
``FedMLAggOperator`` are not ported yet.

Trees are dicts of tensors: ``agg_stacked`` and ``fold_buffer`` take one
``[C, ...]`` tensor per key (the Parrot engine passes one ``[C, D]`` buffer
per dtype), ``mix_global`` and ``fold_buffer`` the global's tensor under
the same key.
"""

from __future__ import annotations

from typing import Any, Dict, TypeVar

import numpy as np
import torch

from ...ops.epilogue import fused_epilogue, weighted_reduce

K = TypeVar("K")


def agg_stacked(stacked: Dict[K, torch.Tensor],
                weights: torch.Tensor) -> Dict[K, torch.Tensor]:
    """Weighted average over a leading client axis, for each ``[C, ...]``
    tensor of ``stacked``; ``weights`` ([C]) need not be normalised —
    masked-out clients carry weight 0.

    Accumulation runs in float32 and float results come back in their input
    dtype; non-float inputs give float32.  The Parrot engine passes one
    ``[C, D]`` buffer per dtype, so each round is one kernel launch per
    dtype (``ops/epilogue.py``)."""
    return {k: weighted_reduce(v, weights) for k, v in stacked.items()}


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
