"""ModelBundle — the uniform wrapper around a model, and its flat variables.

Port of ``fedml_tpu/ml/engine/model_bundle.py``.  Model state is the
module's parameters plus its BatchNorm running statistics (the JAX
``{"params", "batch_stats"}`` tree); the whole of it is what federated
aggregation averages.

``FlatVariables`` lays that state out as one contiguous buffer per dtype,
with every parameter and buffer of the module a view into it.  Loading a
global model into the module is then one copy per dtype, a client's trained
state is one row of a stacked ``[C, D]`` buffer, and the aggregation kernel
reduces every leaf of one dtype in one launch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

TASK_CLASSIFICATION = "classification"

#: each flat buffer's length is a multiple of this many elements, so its
#: rows stay 16-byte aligned for the kernel's vector loads
FLAT_ALIGN = 8


@dataclasses.dataclass
class ModelBundle:
    module: nn.Module
    input_shape: Tuple[int, ...]      # per-example shape (no batch dim)
    num_classes: int
    task: str = TASK_CLASSIFICATION
    input_dtype: torch.dtype = torch.float32
    name: str = "model"

    def apply(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """Logits; in train mode the BatchNorm running statistics are
        updated in place."""
        return self.module(x, train=train)

    def loss(self, logits: torch.Tensor, y: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return masked_loss(self.task, logits, y, mask)

    def correct_count(self, logits: torch.Tensor, y: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        hit = (torch.argmax(logits, dim=-1) == y).float()
        if mask is not None:
            hit = hit * broadcast_mask(mask, hit.shape)
        return hit.sum()

    def valid_count(self, y: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
        """Number of valid label elements — the denominator matching
        ``correct_count``."""
        return broadcast_mask(mask, y.shape).sum()


def broadcast_mask(mask: torch.Tensor, shape) -> torch.Tensor:
    """[B] example mask → per-element mask of ``shape``."""
    mask = mask.float()
    while mask.dim() < len(shape):
        mask = mask[..., None]
    return mask.expand(shape)


def masked_loss(task: str, logits: torch.Tensor, y: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over valid (mask=1) examples, computed in
    float32."""
    if task != TASK_CLASSIFICATION:
        raise NotImplementedError(f"loss for task {task!r} is not ported yet")
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    per = logz - gold
    if mask is None:
        return per.mean()
    mask = broadcast_mask(mask, per.shape)
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class FlatVariables:
    """A module's parameters and buffers as views into one flat buffer per
    dtype (``self.flat[dtype]``, length padded to ``FLAT_ALIGN``).

    Construct it after the module is on its device: moving the module
    afterwards would reallocate the tensors and break the views."""

    def __init__(self, module: nn.Module) -> None:
        self.module = module
        leaves: List[Tuple[str, torch.Tensor]] = (
            list(module.named_parameters()) + list(module.named_buffers()))
        sizes: Dict[torch.dtype, int] = {}
        layout = []
        for name, t in leaves:
            off = sizes.get(t.dtype, 0)
            layout.append((name, t, off))
            sizes[t.dtype] = off + t.numel()
        device = leaves[0][1].device
        self.flat: Dict[torch.dtype, torch.Tensor] = {
            dt: torch.zeros(-(-n // FLAT_ALIGN) * FLAT_ALIGN, dtype=dt,
                            device=device)
            for dt, n in sizes.items()}
        self.params: List[nn.Parameter] = []
        for name, t, off in layout:
            view = self.flat[t.dtype][off:off + t.numel()].view(t.shape)
            view.copy_(t.detach())
            prefix, _, leaf = name.rpartition(".")
            owner = module.get_submodule(prefix)
            if isinstance(t, nn.Parameter):
                t.data = view
                self.params.append(t)
            else:
                owner._buffers[leaf] = view

    def snapshot(self) -> Dict[torch.dtype, torch.Tensor]:
        return {dt: f.clone() for dt, f in self.flat.items()}

    def load(self, flat: Dict[torch.dtype, torch.Tensor]) -> None:
        for dt, f in self.flat.items():
            f.copy_(flat[dt])
