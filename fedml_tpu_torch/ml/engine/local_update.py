"""Local-update engine: client training and evaluation.

Port of ``fedml_tpu/ml/engine/local_update.py``: ``build_local_update``
with every arm of the JAX engine, ``make_batches`` and
``build_eval_step``.  The arms:

* FedAvg and FedOpt: plain local training (FedOpt differs only in the
  server step);
* FedProx: ``+ μ/2·‖w − w_g‖²`` in the loss;
* FedDyn: ``− ⟨λ_i, w⟩ + α/2·‖w − w_g‖²`` in the loss; ``algo_out``
  ``feddyn_lambda`` = ``λ_i − α·(w − w_g)``;
* SCAFFOLD: each step's gradient plus ``c − c_i``; ``algo_out``
  ``c_local`` = ``c_i − c + (w_g − w)/(τ·lr)`` and ``c_delta`` =
  ``c_local − c_i``;
* Mime (MimeLite): each step's gradient blended with the fixed server
  momentum, ``β·m + (1 − β)·g``; then a second pass over the valid batches
  at ``w_g`` (with the starting BatchNorm statistics) gives ``full_grad``,
  the mean of the batch gradients;
* FedNova: ``algo_out`` ``nova_d`` = ``(w_g − w)/(τ·lr)`` and ``tau``;

with ``τ = max(valid steps, 1)``, ``lr`` the configured learning rate and
``w_g`` the global parameters the update starts from (copied first: the
update trains in place).  The per-client state (``algo_state``:
``c_global`` and ``c_local``, ``feddyn_lambda``, ``server_momentum``) and
``algo_out`` cover the parameter columns only (``FlatVariables
.params_range``, per dtype group), as the JAX trees cover ``params``.  The
penalty terms enter the loss value (the ``train_loss`` metric), summed over
each dtype's columns at once, and the gradient as their exact gradients,
``μ·(w − w_g)`` and ``−λ_i + α·(w − w_g)``, added leaf by leaf.  The JAX
engine's ``mime_ref_compat`` (the reference-Mime parity audit) raises.

``batches`` is the fixed-shape layout of the JAX package: ``{"x": [nb, B,
...], "y": [nb, B], "mask": [nb, B]}`` with zero-mask padding.  The JAX
engine runs every batch and keeps parameters, BatchNorm state and the
optimizer state unchanged where ``any(mask)`` is false (``jnp.where(valid,
new, old)``).  The port has both bodies:

* the host-skip body (the per-round path): the caller knows each batch's
  validity on the host, and a fully padded batch is skipped, which leaves
  the same state and statistics;
* the gated body (``gated=True``, the fused rounds): every batch runs, and
  after each step one ``torch.where`` per dtype over the flat buffer
  (parameters and BatchNorm statistics together), and one per tensor of the
  client optimizer's state (its step count included), keeps the old state
  where the device flag ``valid[b]`` is false, as the metrics keep their
  sums.  Nothing is read on the host, so a CUDA graph can hold it.  It
  gives the host-skip body's bits.

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

from ...constants import (
    FED_OPT_FEDAVG,
    FED_OPT_FEDDYN,
    FED_OPT_FEDNOVA,
    FED_OPT_FEDOPT,
    FED_OPT_FEDPROX,
    FED_OPT_MIME,
    FED_OPT_SCAFFOLD,
)
from .model_bundle import FlatVariables, ModelBundle
from .optimizers import _f32, build_client_optimizer

#: the arms of the local update, and the per-client state each reads
ALGO_STATE_KEYS = {
    FED_OPT_FEDAVG: (), FED_OPT_FEDOPT: (), FED_OPT_FEDPROX: (),
    FED_OPT_FEDNOVA: (), FED_OPT_FEDDYN: ("feddyn_lambda",),
    FED_OPT_SCAFFOLD: ("c_global", "c_local"),
    FED_OPT_MIME: ("server_momentum",),
}

Cols = Dict[torch.dtype, torch.Tensor]


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


def _params_cols(variables: FlatVariables) -> Cols:
    """The parameter columns of each dtype group's flat buffer (views)."""
    return {dt: variables.flat[dt][variables.params_range(dt)]
            for dt in variables.param_dtypes()}


def _sq_dist(w: Cols, g: Cols) -> torch.Tensor:
    return sum(torch.square(w[dt] - g[dt]).sum() for dt in w)


class _Arm:
    """One client's algorithm arm: its loss penalty and gradient terms and
    its ``algo_out``, on the parameter columns ``w`` (views into the flat
    buffer, trained in place) against ``w_g``, the copy of the global ones
    taken before the first step."""

    def __init__(self, algo: str, cfg: Any, variables: FlatVariables,
                 algo_state: Dict[str, Any]) -> None:
        self.algo = algo
        self.mu = float(getattr(cfg, "fedprox_mu", 0.1) or 0.0)
        self.alpha = float(getattr(cfg, "feddyn_alpha", 0.01) or 0.0)
        self.beta = float(getattr(cfg, "server_momentum", 0.9) or 0.9)
        self.lr = float(getattr(cfg, "learning_rate", 0.03))
        missing = [k for k in ALGO_STATE_KEYS[algo] if k not in algo_state]
        if missing:
            raise ValueError(f"{algo} local update needs algo_state "
                             f"{', '.join(missing)}")
        self.state = algo_state
        self.w = _params_cols(variables)
        self.prox = algo == FED_OPT_FEDPROX and self.mu > 0
        self.w_g: Optional[Cols] = None
        views = variables.param_views
        if self.prox or algo in (FED_OPT_FEDDYN, FED_OPT_SCAFFOLD,
                                 FED_OPT_FEDNOVA):
            self.w_g = {dt: w.clone() for dt, w in self.w.items()}
            self.g_views = views(self.w_g)
        if algo == FED_OPT_FEDDYN:
            self.lam_views = views(algo_state["feddyn_lambda"])
        if algo == FED_OPT_SCAFFOLD:
            self.c_views = views(algo_state["c_global"])
            self.ci_views = views(algo_state["c_local"])
        if algo == FED_OPT_MIME:
            # β·m is the same every step
            self.bm = torch._foreach_mul(
                views(algo_state["server_momentum"]), _f32(self.beta))

    def loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss value with the arm's penalty (no gradient flows
        through the penalty: ``grads`` adds its gradient)."""
        if self.prox:
            with torch.no_grad():
                return loss + _f32(0.5 * self.mu) * _sq_dist(self.w,
                                                             self.w_g)
        if self.algo == FED_OPT_FEDDYN:
            with torch.no_grad():
                lam = self.state["feddyn_lambda"]
                dot = sum((lam[dt] * self.w[dt]).sum() for dt in self.w)
                return (loss - dot) + _f32(0.5 * self.alpha) * _sq_dist(
                    self.w, self.w_g)
        return loss

    def grads(self, params: List[torch.Tensor],
              grads: List[torch.Tensor]) -> List[torch.Tensor]:
        g = list(grads)
        with torch.no_grad():
            if self.prox:
                g = torch._foreach_add(g, torch._foreach_mul(
                    torch._foreach_sub(params, self.g_views), _f32(self.mu)))
            elif self.algo == FED_OPT_FEDDYN:
                g = torch._foreach_add(
                    torch._foreach_sub(g, self.lam_views),
                    torch._foreach_mul(torch._foreach_sub(
                        params, self.g_views), _f32(self.alpha)))
            elif self.algo == FED_OPT_SCAFFOLD:
                g = torch._foreach_sub(torch._foreach_add(g, self.c_views),
                                       self.ci_views)
            elif self.algo == FED_OPT_MIME:
                g = torch._foreach_add(self.bm, torch._foreach_mul(
                    g, _f32(1.0 - self.beta)))
        return g

    def out(self, steps: Any) -> Dict[str, Any]:
        """``algo_out`` after the last step; ``steps`` counts the valid
        steps (a host int, or a device tensor in the gated body)."""
        w, w_g, dev = self.w, self.w_g, next(iter(self.w.values())).device
        with torch.no_grad():
            tau = (torch.clamp(steps, min=1.0) if isinstance(
                steps, torch.Tensor) else torch.tensor(
                    float(max(steps, 1)), dtype=torch.float32, device=dev))
            inv = 1.0 / (tau * self.lr)
            if self.algo == FED_OPT_SCAFFOLD:
                c, ci = self.state["c_global"], self.state["c_local"]
                c_new = {dt: (ci[dt] - c[dt]) + (w_g[dt] - w[dt]) * inv
                         for dt in w}
                return {"c_local": c_new,
                        "c_delta": {dt: c_new[dt] - ci[dt] for dt in w}}
            if self.algo == FED_OPT_FEDDYN:
                lam = self.state["feddyn_lambda"]
                return {"feddyn_lambda": {
                    dt: lam[dt] - _f32(self.alpha) * (w[dt] - w_g[dt])
                    for dt in w}}
            if self.algo == FED_OPT_FEDNOVA:
                return {"nova_d": {dt: (w_g[dt] - w[dt]) * inv for dt in w},
                        "tau": tau}
        return {}


def _mime_full_grad(bundle: ModelBundle, variables: FlatVariables,
                    start: Cols, batches: Dict[str, torch.Tensor],
                    valid: Any, gen_for_step: Callable[[], Any]) -> Cols:
    """Mime's ``full_grad``: the mean of the batch gradients at the global
    model (``start``, BatchNorm statistics included) over the valid
    batches.  The host-skip body passes ``valid`` as host flags and skips
    the padded batches; the gated body passes the device flags and adds
    every batch's gradient, a padded batch's being zero (its loss is 0), as
    the JAX engine does.  The trained state is put back afterwards."""
    params = variables.params
    trained = variables.snapshot()
    variables.load(start)
    acc = {dt: torch.zeros_like(w) for dt, w in
           _params_cols(variables).items()}
    acc_views = variables.param_views(acc)
    gated = isinstance(valid, torch.Tensor)
    cnt: Any = (torch.zeros((), device=batches["mask"].device) if gated
                else 0)
    for b in range(batches["mask"].shape[0]):
        if not gated and not valid[b]:
            continue
        x, y, m = batches["x"][b], batches["y"][b], batches["mask"][b]
        logits = bundle.apply(x, train=True, rng=gen_for_step())
        grads = torch.autograd.grad(bundle.loss(logits, y, m), params)
        with torch.no_grad():
            torch._foreach_add_(acc_views, list(grads))
        cnt = cnt + (valid[b] if gated else 1)
    variables.load(trained)
    with torch.no_grad():
        den = (torch.clamp(cnt, min=1.0) if gated else torch.tensor(
            float(max(cnt, 1)), dtype=torch.float32,
            device=batches["mask"].device))
        inv = 1.0 / den
        return {dt: a * inv for dt, a in acc.items()}


def build_local_update(bundle: ModelBundle, cfg: Any,
                       gated: bool = False) -> Callable:
    """Returns ``local_update(variables, batches, valid=None, rng=None,
    algo_state=None) -> metrics``.

    ``variables`` is the bundle module's ``FlatVariables``, already holding
    the global model; it is trained in place.  ``valid`` lists, per batch,
    whether any mask entry is set (computed from ``batches["mask"]`` when
    omitted, which waits for the device).  ``rng``, a host
    ``torch.Generator``, seeds each step's dropout: a model that trains with
    dropout needs it.  ``algo_state``: the client's state of the arm (see
    the module's docstring), per dtype group over the parameter columns.
    The metrics hold ``train_loss``, ``train_acc``, ``n_samples``,
    ``local_steps`` and ``algo_out``, the arm's output (empty for FedAvg,
    FedOpt and FedProx).

    ``gated``: the gated body, ``local_update(variables, batches, valid,
    rng=None, algo_state=None)`` with ``valid`` the ``[nb]`` bool tensor of
    the batches' flags on the batches' device; its metrics are all tensors,
    ``local_steps`` the count of valid steps.  Its ``rng`` is a generator on
    the batches' device that every step's dropout draws from, a padded
    step's too, so a CUDA graph can hold the draws."""
    algo = str(getattr(cfg, "federated_optimizer", FED_OPT_FEDAVG))
    if algo not in ALGO_STATE_KEYS:
        raise NotImplementedError(
            f"local update for {algo!r} is not ported yet (port item A9); "
            f"the port runs {', '.join(ALGO_STATE_KEYS)}")
    if bool(getattr(cfg, "mime_ref_compat", False)):
        raise NotImplementedError(
            "mime_ref_compat (the reference-Mime parity audit) is not ported "
            "yet (port item A9)")
    epochs = int(getattr(cfg, "epochs", 1))
    opt = build_client_optimizer(cfg)

    def local_update(variables: FlatVariables,
                     batches: Dict[str, torch.Tensor],
                     valid: Optional[List[bool]] = None,
                     rng: Optional[torch.Generator] = None,
                     algo_state: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        params = variables.params
        mask_all = batches["mask"]
        if valid is None:
            valid = (mask_all > 0).any(dim=1).tolist()
        arm = _Arm(algo, cfg, variables, algo_state or {})
        start = variables.snapshot() if algo == FED_OPT_MIME else None
        opt_state = opt.init(params)
        rows = None if opt.plain else opt.step_rows(
            epochs * mask_all.shape[0], mask_all.device)
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
                loss = arm.loss(loss)
                opt_state = opt.step(params, arm.grads(params, grads),
                                     opt_state, rows)
                with torch.no_grad():
                    nv = bundle.valid_count(y, m)
                    loss_sum += loss.detach() * nv
                    correct += bundle.correct_count(logits.detach(), y, m)
                    n += nv
                steps += 1
        algo_out = arm.out(steps)
        if algo == FED_OPT_MIME:
            algo_out["full_grad"] = _mime_full_grad(
                bundle, variables, start, batches, valid,
                lambda: _step_generator(rng, mask_all.device))
        denom = torch.clamp(n, min=1.0)
        return {"train_loss": loss_sum / denom,
                "train_acc": correct / denom,
                "n_samples": n,
                "local_steps": steps,
                "algo_out": algo_out}

    def gated_update(variables: FlatVariables,
                     batches: Dict[str, torch.Tensor],
                     valid: torch.Tensor,
                     rng: Optional[torch.Generator] = None,
                     algo_state: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        params, flat = variables.params, variables.flat
        mask_all = batches["mask"]
        arm = _Arm(algo, cfg, variables, algo_state or {})
        start = variables.snapshot() if algo == FED_OPT_MIME else None
        opt_state = opt.init(params, device_count=True)
        rows = None if opt.plain else opt.step_rows(
            epochs * mask_all.shape[0], mask_all.device)
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
                loss = arm.loss(loss)
                new_state = opt.step(params, arm.grads(params, grads),
                                     opt_state, rows)
                with torch.no_grad():
                    for dt, f in flat.items():
                        f.copy_(torch.where(ok, f, prev[dt]))
                    if not opt.plain:
                        opt_state = opt.keep(ok, new_state, opt_state)
                    nv = bundle.valid_count(y, m)
                    loss_sum += torch.where(ok, loss.detach(), zero) * nv
                    correct += bundle.correct_count(logits.detach(), y, m)
                    n += nv
                    steps += ok
        algo_out = arm.out(steps)
        if algo == FED_OPT_MIME:
            algo_out["full_grad"] = _mime_full_grad(
                bundle, variables, start, batches, valid, lambda: rng)
        denom = torch.clamp(n, min=1.0)
        return {"train_loss": loss_sum / denom,
                "train_acc": correct / denom,
                "n_samples": n,
                "local_steps": steps,
                "algo_out": algo_out}

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
