"""ModelBundle — the uniform wrapper around a model, and its flat variables.

Port of ``fedml_tpu/ml/engine/model_bundle.py``.  Model state is the
module's parameters plus its BatchNorm running statistics (the JAX
``{"params", "batch_stats"}`` tree); the whole of it is what federated
aggregation averages.

``FlatVariables`` lays that state out as one contiguous buffer per dtype,
with every parameter and buffer of the module a view into it, parameters
first.  Loading a global model into the module is then one copy per dtype,
a client's trained state is one row of a stacked ``[C, D]`` buffer, and the
aggregation kernels take every leaf of one dtype in one launch — the
parameter columns and the statistics columns apart where FedOpt's server
step treats them apart.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

TASK_CLASSIFICATION = "classification"
TASK_LM = "lm"                 # next-token prediction, logits [B, T, V]

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
    #: guards the module's state.  A JAX bundle is stateless; this one
    #: trains and evaluates its module in place, so every thread that loads,
    #: trains or evaluates it (the cross-silo plane's silo threads and its
    #: server) holds the lock from loading variables to reading results —
    #: one module used by one thread at a time, as one card runs one stream
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    #: the module's ``FlatVariables`` once ``bind`` has built them
    variables: Optional["FlatVariables"] = dataclasses.field(
        default=None, repr=False, compare=False)

    def bind(self, device: torch.device) -> "FlatVariables":
        """The module on ``device`` with its state laid out flat — moved and
        built on the first call, the same afterwards.  Caller holds
        ``lock``."""
        device = torch.device(device)
        if self.variables is None:
            self.module.to(device)
            self.variables = FlatVariables(self.module)
        have = next(iter(self.variables.flat.values())).device
        if have.type != device.type or (device.index is not None
                                        and have.index != device.index):
            raise ValueError(f"{self.name} is bound to {have}, not {device}")
        return self.variables

    def apply(self, x: torch.Tensor, train: bool,
              rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits; in train mode the BatchNorm running statistics are
        updated in place.  ``rng`` draws the dropout masks of a training
        pass (JAX's ``rngs={"dropout": rng}``), on the device of ``x``."""
        return self.module(x, train=train, rng=rng)

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
        """Number of valid label elements (tokens, not sequences, for a
        language model) — the denominator matching ``correct_count``."""
        return broadcast_mask(mask, y.shape).sum()


def broadcast_mask(mask: torch.Tensor, shape) -> torch.Tensor:
    """[B] example mask → per-element mask of ``shape`` ([B, T] tokens)."""
    mask = mask.float()
    while mask.dim() < len(shape):
        mask = mask[..., None]
    return mask.expand(shape)


def masked_loss(task: str, logits: torch.Tensor, y: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over valid (mask=1) examples, or over the
    valid tokens of a language model's ``[B, T, V]`` logits, computed in
    float32."""
    if task not in (TASK_CLASSIFICATION, TASK_LM):
        raise NotImplementedError(f"loss for task {task!r} is not ported yet")
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    per = logz - gold
    if mask is None:
        return per.mean()
    mask = broadcast_mask(mask, per.shape)
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _pad(n: int) -> int:
    return -(-n // FLAT_ALIGN) * FLAT_ALIGN


class FlatLeaf(NamedTuple):
    """Where one parameter or buffer of the module lies in its dtype's flat
    buffer."""

    name: str
    dtype: torch.dtype
    offset: int
    shape: Tuple[int, ...]
    is_param: bool

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


class FlatVariables:
    """A module's parameters and buffers as views into one flat buffer per
    dtype (``self.flat[dtype]``, length padded to ``FLAT_ALIGN``).

    The layout contract: in each dtype's buffer the parameters (the JAX
    ``params`` collection) come first, from column 0, and the buffers (the
    BatchNorm ``batch_stats``) follow from column ``param_cols[dtype]``, the
    parameters' count padded to ``FLAT_ALIGN`` — so both ranges start
    16-byte aligned and a kernel can take either as a column range of a
    stacked ``[C, D]`` buffer.  Padding columns hold zeros.

    Construct it after the module is on its device: moving the module
    afterwards would reallocate the tensors and break the views."""

    def __init__(self, module: nn.Module) -> None:
        self.module = module
        params = list(module.named_parameters())
        buffers = list(module.named_buffers())
        n_params: Dict[torch.dtype, int] = {}
        for _, t in params:
            n_params[t.dtype] = n_params.get(t.dtype, 0) + t.numel()
        #: per dtype, P: where the buffers start (0 without parameters)
        self.param_cols: Dict[torch.dtype, int] = {
            t.dtype: _pad(n_params.get(t.dtype, 0)) for _, t in
            params + buffers}
        #: every leaf's place, parameters first, in module order
        self.layout: List[FlatLeaf] = []
        for leaves, is_param, start in ((params, True, {}),
                                        (buffers, False, self.param_cols)):
            ends = {dt: start.get(dt, 0) for dt in self.param_cols}
            for name, t in leaves:
                self.layout.append(FlatLeaf(name, t.dtype, ends[t.dtype],
                                            tuple(t.shape), is_param))
                ends[t.dtype] += t.numel()
        device = (params + buffers)[0][1].device
        self.flat: Dict[torch.dtype, torch.Tensor] = {
            dt: torch.zeros(_pad(n), dtype=dt, device=device)
            for dt, n in ends.items()}
        self.params: List[nn.Parameter] = []
        tensors = dict(params + buffers)
        for leaf in self.layout:
            t = tensors[leaf.name]
            view = self.flat[leaf.dtype][
                leaf.offset:leaf.offset + leaf.numel].view(leaf.shape)
            view.copy_(t.detach())
            prefix, _, name = leaf.name.rpartition(".")
            owner = module.get_submodule(prefix)
            if leaf.is_param:
                t.data = view
                self.params.append(t)
            else:
                owner._buffers[name] = view

    def param_dtypes(self) -> List[torch.dtype]:
        """The float dtype groups that hold parameters: those a server
        optimizer steps."""
        return [dt for dt, p in self.param_cols.items()
                if p and dt.is_floating_point]

    def params_range(self, dtype: torch.dtype) -> slice:
        """The parameter columns of ``dtype``'s buffer, ``[0, P)``."""
        return slice(0, self.param_cols[dtype])

    def stats_range(self, dtype: torch.dtype) -> slice:
        """The buffer (BatchNorm statistics) columns, ``[P, D)``."""
        return slice(self.param_cols[dtype], self.flat[dtype].numel())

    def param_views(self, cols: Dict[torch.dtype, torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Views of ``cols`` (per dtype, a tensor whose first
        ``param_cols[dtype]`` elements are laid out as the parameter
        columns: a ``[P]`` or ``[D]`` buffer, or a row of one) shaped as
        the parameters, in the order of ``self.params``."""
        return [cols[leaf.dtype][leaf.offset:leaf.offset + leaf.numel]
                .view(leaf.shape) for leaf in self.layout if leaf.is_param]

    def snapshot(self) -> Dict[torch.dtype, torch.Tensor]:
        return {dt: f.clone() for dt, f in self.flat.items()}

    def load(self, flat: Dict[torch.dtype, torch.Tensor]) -> None:
        for dt, f in self.flat.items():
            f.copy_(flat[dt])
