"""Local-update engine: client training and evaluation.

Port of ``fedml_tpu/ml/engine/local_update.py``: the FedAvg arm of
``build_local_update``, ``make_batches`` and ``build_eval_step``.

``batches`` is the fixed-shape layout of the JAX package: ``{"x": [nb, B,
...], "y": [nb, B], "mask": [nb, B]}`` with zero-mask padding.  The JAX
engine runs every batch and keeps parameters and BatchNorm state unchanged
where ``any(mask)`` is false (``jnp.where(valid, new, old)``); here the
caller knows each batch's validity on the host, and a fully padded batch is
skipped, which leaves the same state and statistics.  A partly padded batch
runs whole: BatchNorm's batch statistics cover its zero rows, and the mask
enters only the loss.

The local update trains the bundle's module in place: the caller loads the
global variables into it first (``FlatVariables.load``) and reads the
trained state from it afterwards.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...constants import FED_OPT_FEDAVG
from .model_bundle import FlatVariables, ModelBundle
from .optimizers import build_client_optimizer


def make_batches(x, y, batch_size: int, num_batches: int,
                 dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None
                 ) -> Dict[str, torch.Tensor]:
    """Pad (x, y) host arrays into the fixed [nb, B, ...] layout with mask."""
    cap = batch_size * num_batches
    x = np.asarray(x)[:cap]
    y = np.asarray(y)[:cap]
    pad = cap - len(y)
    mask = np.concatenate([np.ones(len(y), np.float32),
                           np.zeros(pad, np.float32)])
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
    bx = torch.as_tensor(x.reshape((num_batches, batch_size) + x.shape[1:]),
                         device=device)
    if dtype is not None:
        bx = bx.to(dtype)
    return {"x": bx,
            "y": torch.as_tensor(
                y.reshape((num_batches, batch_size) + y.shape[1:]),
                device=device),
            "mask": torch.as_tensor(mask.reshape(num_batches, batch_size),
                                    device=device)}


def build_local_update(bundle: ModelBundle, cfg: Any) -> Callable:
    """Returns ``local_update(variables, batches, valid=None) -> metrics``.

    ``variables`` is the bundle module's ``FlatVariables``, already holding
    the global model; it is trained in place.  ``valid`` lists, per batch,
    whether any mask entry is set (computed from ``batches["mask"]`` when
    omitted, which waits for the device)."""
    algo = str(getattr(cfg, "federated_optimizer", FED_OPT_FEDAVG))
    if algo != FED_OPT_FEDAVG:
        raise NotImplementedError(
            f"local update for {algo!r} is not ported yet; the port runs "
            f"{FED_OPT_FEDAVG}")
    epochs = int(getattr(cfg, "epochs", 1))
    sgd_step = build_client_optimizer(cfg)

    def local_update(variables: FlatVariables,
                     batches: Dict[str, torch.Tensor],
                     valid: Optional[List[bool]] = None
                     ) -> Dict[str, torch.Tensor]:
        params = variables.params
        mask_all = batches["mask"]
        if valid is None:
            valid = (mask_all > 0).any(dim=1).tolist()
        zero = torch.zeros((), device=mask_all.device)
        loss_sum, correct, n = zero.clone(), zero.clone(), zero.clone()
        steps = 0
        for _ in range(epochs):
            for b in range(mask_all.shape[0]):
                if not valid[b]:
                    continue
                x, y, m = batches["x"][b], batches["y"][b], mask_all[b]
                logits = bundle.apply(x, train=True)
                loss = bundle.loss(logits, y, m)
                grads = torch.autograd.grad(loss, params)
                sgd_step(params, list(grads))
                with torch.no_grad():
                    nv = bundle.valid_count(y, m)
                    loss_sum += loss.detach() * nv
                    correct += bundle.correct_count(logits.detach(), y, m)
                    n += nv
                steps += 1
        denom = torch.clamp(n, min=1.0)
        return {"train_loss": loss_sum / denom,
                "train_acc": correct / denom,
                "n_samples": n,
                "local_steps": steps}

    return local_update


def build_eval_step(bundle: ModelBundle) -> Callable:
    """``eval_batches(batches) -> {loss_sum, correct, n}`` over one padded
    batch stack, with the module's current variables and running BN
    statistics."""

    def eval_batches(batches: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        mask_all = batches["mask"]
        zero = torch.zeros((), device=mask_all.device)
        out = {"loss_sum": zero.clone(), "correct": zero.clone(),
               "n": zero.clone()}
        with torch.no_grad():
            for b in range(mask_all.shape[0]):
                x, y, m = batches["x"][b], batches["y"][b], mask_all[b]
                logits = bundle.apply(x, train=False)
                # valid label ELEMENTS, so acc = correct/n stays in [0, 1]
                n = bundle.valid_count(y, m)
                out["loss_sum"] += bundle.loss(logits, y, m) * n
                out["correct"] += bundle.correct_count(logits, y, m)
                out["n"] += n
        return out

    return eval_batches
