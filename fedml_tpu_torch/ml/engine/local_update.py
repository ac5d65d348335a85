"""Local-update engine: client training and evaluation.

Port of ``fedml_tpu/ml/engine/local_update.py``: the FedAvg and FedOpt
arms of ``build_local_update`` (both plain local SGD; FedOpt differs only
in the server step), ``make_batches`` and ``build_eval_step``.

``batches`` is the fixed-shape layout of the JAX package: ``{"x": [nb, B,
...], "y": [nb, B], "mask": [nb, B]}`` with zero-mask padding.  The JAX
engine runs every batch and keeps parameters and BatchNorm state unchanged
where ``any(mask)`` is false (``jnp.where(valid, new, old)``).  The port has
both bodies:

* the host-skip body (the per-round path): the caller knows each batch's
  validity on the host, and a fully padded batch is skipped, which leaves
  the same state and statistics;
* the gated body (``gated=True``, the fused rounds): every batch runs, and
  after each step one ``torch.where`` per dtype over the flat buffer
  (parameters and BatchNorm statistics together) keeps the old state where
  the device flag ``valid[b]`` is false, as the metrics keep their sums.
  Nothing is read on the host, so a CUDA graph can hold it.  It gives the
  host-skip body's bits.

A partly padded batch runs whole: BatchNorm's batch statistics cover its
padding rows, and the mask enters only the loss.

The local update trains the bundle's module in place: the caller loads the
global variables into it first (``FlatVariables.load``) and reads the
trained state from it afterwards.

Token batches (a language model's ``x`` and ``y`` of ``[nb, B, T]`` integer
tokens) take the same path: ``x`` keeps its integer type, the ``[B]``
mask broadcasts over the tokens, and the statistics count valid tokens.
Dropout draws, in the host-skip body, from a generator on the batch's
device reseeded from the caller's host generator once per step — the JAX
engine splits its key once per step; in the gated body, from the caller's
generator on the batch's device, read by no host.  The two frameworks draw
different bits from one seed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...constants import FED_OPT_FEDAVG, FED_OPT_FEDOPT
from .model_bundle import FlatVariables, ModelBundle
from .optimizers import build_client_optimizer


#: algorithms whose clients train with plain local SGD
_PLAIN_SGD = (FED_OPT_FEDAVG, FED_OPT_FEDOPT)


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
    # integer inputs (tokens) are indices: never cast to a float dtype
    if dtype is not None and (bx.dtype.is_floating_point
                              or not dtype.is_floating_point):
        bx = bx.to(dtype)
    return {"x": bx,
            "y": torch.as_tensor(
                y.reshape((num_batches, batch_size) + y.shape[1:]),
                device=device),
            "mask": torch.as_tensor(mask.reshape(num_batches, batch_size),
                                    device=device)}


def _step_generator(rng: Optional[torch.Generator],
                    device: torch.device) -> Optional[torch.Generator]:
    """A generator on ``device`` for one step's dropout, seeded from the
    host generator ``rng`` (None without one)."""
    if rng is None:
        return None
    seed = int(torch.randint(0, 2 ** 62, (), generator=rng))
    return torch.Generator(device=device).manual_seed(seed)


def build_local_update(bundle: ModelBundle, cfg: Any,
                       gated: bool = False) -> Callable:
    """Returns ``local_update(variables, batches, valid=None, rng=None) ->
    metrics``.

    ``variables`` is the bundle module's ``FlatVariables``, already holding
    the global model; it is trained in place.  ``valid`` lists, per batch,
    whether any mask entry is set (computed from ``batches["mask"]`` when
    omitted, which waits for the device).  ``rng``, a host
    ``torch.Generator``, seeds each step's dropout: a model that trains with
    dropout needs it.

    ``gated``: the gated body, ``local_update(variables, batches, valid,
    rng=None)`` with ``valid`` the ``[nb]`` bool tensor of the batches'
    flags on the batches' device; its metrics are all tensors,
    ``local_steps`` the count of valid steps.  Its ``rng`` is a generator on
    the batches' device that every step's dropout draws from, a padded
    step's too, so a CUDA graph can hold the draws."""
    algo = str(getattr(cfg, "federated_optimizer", FED_OPT_FEDAVG))
    if algo not in _PLAIN_SGD:
        raise NotImplementedError(
            f"local update for {algo!r} is not ported yet (port item A9); "
            f"the port runs {', '.join(_PLAIN_SGD)}")
    epochs = int(getattr(cfg, "epochs", 1))
    sgd_step = build_client_optimizer(cfg)

    def local_update(variables: FlatVariables,
                     batches: Dict[str, torch.Tensor],
                     valid: Optional[List[bool]] = None,
                     rng: Optional[torch.Generator] = None
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
                logits = bundle.apply(x, train=True,
                                      rng=_step_generator(rng, x.device))
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

    def gated_update(variables: FlatVariables,
                     batches: Dict[str, torch.Tensor],
                     valid: torch.Tensor,
                     rng: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
        params, flat = variables.params, variables.flat
        mask_all = batches["mask"]
        zero = torch.zeros((), device=mask_all.device)
        loss_sum, correct, n, steps = (zero.clone() for _ in range(4))
        prev = {dt: torch.empty_like(f) for dt, f in flat.items()}
        for _ in range(epochs):
            for b in range(mask_all.shape[0]):
                ok = valid[b]
                for dt, f in flat.items():
                    prev[dt].copy_(f)
                x, y, m = batches["x"][b], batches["y"][b], mask_all[b]
                logits = bundle.apply(x, train=True, rng=rng)
                loss = bundle.loss(logits, y, m)
                grads = torch.autograd.grad(loss, params)
                sgd_step(params, list(grads))
                with torch.no_grad():
                    for dt, f in flat.items():
                        f.copy_(torch.where(ok, f, prev[dt]))
                    nv = bundle.valid_count(y, m)
                    loss_sum += torch.where(ok, loss.detach(), zero) * nv
                    correct += bundle.correct_count(logits.detach(), y, m)
                    n += nv
                    steps += ok
        denom = torch.clamp(n, min=1.0)
        return {"train_loss": loss_sum / denom,
                "train_acc": correct / denom,
                "n_samples": n,
                "local_steps": steps}

    return gated_update if gated else local_update


def build_eval_step(bundle: ModelBundle) -> Callable:
    """``eval_batches(batches) -> {loss_sum, correct, n}`` over one padded
    batch stack, with the module's current variables and running BN
    statistics; ``n`` counts valid label elements (tokens for a language
    model), so ``correct / n`` is the token accuracy."""

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
