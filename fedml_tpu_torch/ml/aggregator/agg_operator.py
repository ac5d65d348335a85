"""Server-side aggregation arithmetic.

Port of ``fedml_tpu/ml/aggregator/agg_operator.py::agg_stacked``, the
vectorized Parrot path.  The robust operators, ``mix_global``,
``fold_buffer`` and the host-driven ``FedMLAggOperator`` are not ported yet.
"""

from __future__ import annotations

from typing import Dict, TypeVar

import torch

from ...ops.epilogue import weighted_reduce

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
