"""The server's round-boundary step of the fed-LLM plane.

Port of ``fedml_tpu/train/fed_llm/delta_round.py``: fold the aggregated
adapter delta into the global adapter tree (float32 accumulate, cast back:
``ops/epilogue.fold_delta``, the kernel ``csrc/fold_delta.cu`` on a card,
one launch per adapter dtype) and merge the result into the frozen base
parameters for evaluation.

``server_lr`` is a float32 scalar: 1.0 for the sync fold, 0.0 for a
re-merge of the current global (the fold is then the identity).  The
returned adapters are a new tree — one new buffer per dtype — never the
input global, which a caller may still read.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ...ops.epilogue import flat_tree, fold_delta
from ...utils.tree import tree_map
from ..llm.lora import apply_lora


def zeros_like_adapters(adapters: Dict[str, Any]) -> Dict[str, Any]:
    """An all-zero delta tree (float32, the delta space's working dtype),
    its leaves views into one buffer."""
    return flat_tree(tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.float32,
                              device=a.device), adapters))


def make_delta_round(alpha: float) -> Callable:
    """→ ``(adapters, base_params, agg_delta, server_lr) → (new_adapters,
    merged_params)`` with the LoRA scale ``alpha`` closed over."""

    def delta_round(adapters: Any, base_params: Any, agg_delta: Any,
                    server_lr: Any) -> Tuple[Any, Any]:
        lr = float(np.float32(float(server_lr)))
        new_adapters = fold_delta(adapters, agg_delta, lr)
        merged = apply_lora(base_params, new_adapters, alpha)
        return new_adapters, merged

    return delta_round
