"""Client and server optimizers.

Port of ``fedml_tpu/ml/engine/optimizers.py``:

* ``build_client_optimizer`` for the setting the north-star config uses:
  plain SGD at a constant learning rate (``optax.sgd(lr)``: ``p ← p +
  (−lr·g)``, in the parameter's dtype).  Momentum, weight decay, adam and
  the lr schedules are not ported yet and raise.
* ``build_server_optimizer``, FedOpt's server optimizer on the unfused arm
  (yogi, adagrad, or ``fused_epilogue: false``): optax's ``adam``, ``yogi``,
  ``adagrad`` and ``sgd`` (with or without momentum), in plain PyTorch on
  the flat parameter columns.  Constants, initial accumulators and the order
  of every operation are optax 0.2.6's (``scale_by_adam``,
  ``scale_by_yogi``, ``scale_by_rss``, ``trace``, then
  ``scale(−learning_rate)``); Python-float constants meet float32 tensors as
  JAX's weakly typed scalars do, rounded to float32 first.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch


def build_client_optimizer(cfg: Any) -> Callable[[List[torch.Tensor],
                                                  List[torch.Tensor]], None]:
    """Returns ``step(params, grads)``, which updates ``params`` in place."""
    name = str(getattr(cfg, "client_optimizer", "sgd")).lower()
    kind = str(getattr(cfg, "lr_schedule", "constant") or "constant").lower()
    momentum = float(getattr(cfg, "momentum", 0.0) or 0.0)
    wd = float(getattr(cfg, "weight_decay", 0.0) or 0.0)
    if name != "sgd" or kind != "constant" or momentum or wd:
        raise NotImplementedError(
            f"client optimizer {name!r} (lr_schedule {kind!r}, momentum "
            f"{momentum}, weight_decay {wd}) is not ported yet; the port "
            f"runs plain sgd at a constant learning rate")
    lr = float(getattr(cfg, "learning_rate", 0.03))

    def step(params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        with torch.no_grad():
            torch._foreach_add_(params, torch._foreach_mul(grads, -lr))

    return step


State = Dict[str, Any]


class ServerOptimizer(NamedTuple):
    """optax's ``GradientTransformation`` on one flat tensor:
    ``init(params) -> state`` and ``update(grads, state) -> (updates,
    state)``; ``apply_updates`` adds the updates.  The state's keys are
    optax's field names (``count``/``mu``/``nu``, ``sum_of_squares``,
    ``trace``)."""

    init: Callable[[torch.Tensor], State]
    update: Callable[[torch.Tensor, State], Tuple[torch.Tensor, State]]


def apply_updates(params: torch.Tensor, updates: torch.Tensor
                  ) -> torch.Tensor:
    """``optax.apply_updates``: ``p + u`` in the parameters' dtype."""
    return (params + updates).to(params.dtype)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _bias_correction(decay: float, count: int) -> float:
    """``1 − decay**count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.power(np.float32(decay),
                                            np.float32(count)))


def _adam_like(name: str, lr: float, b1: float, b2: float, eps: float,
               init_value: float) -> ServerOptimizer:
    """``adam`` (zero accumulators) and ``yogi`` (``init_value``, and the
    sign-controlled second moment)."""

    def init(params: torch.Tensor) -> State:
        full = torch.full(params.shape, init_value, dtype=params.dtype,
                          device=params.device)
        return {"count": 0, "mu": full, "nu": full.clone()}

    def update(grads: torch.Tensor, state: State
               ) -> Tuple[torch.Tensor, State]:
        mu = _f32(1 - b1) * grads + _f32(b1) * state["mu"]
        sq = grads * grads
        if name == "yogi":
            nu = state["nu"] - _f32(1 - b2) * torch.sign(
                state["nu"] - sq) * sq
        else:
            nu = _f32(1 - b2) * sq + _f32(b2) * state["nu"]
        count = int(state["count"]) + 1
        mu_hat = mu / _bias_correction(b1, count)
        nu_hat = nu / _bias_correction(b2, count)
        u = mu_hat / (torch.sqrt(nu_hat + 0.0) + _f32(eps))
        return _f32(-lr) * u, {"count": count, "mu": mu, "nu": nu}

    return ServerOptimizer(init, update)


def _adagrad(lr: float, init_value: float = 0.1, eps: float = 1e-7
             ) -> ServerOptimizer:
    def init(params: torch.Tensor) -> State:
        return {"sum_of_squares": torch.full(
            params.shape, init_value, dtype=params.dtype,
            device=params.device)}

    def update(grads: torch.Tensor, state: State
               ) -> Tuple[torch.Tensor, State]:
        sos = grads * grads + state["sum_of_squares"]
        inv = torch.where(sos > 0, torch.rsqrt(sos + _f32(eps)),
                          torch.zeros((), dtype=sos.dtype, device=sos.device))
        return _f32(-lr) * (inv * grads), {"sum_of_squares": sos}

    return ServerOptimizer(init, update)


def _sgd(lr: float, momentum: float) -> ServerOptimizer:
    def init(params: torch.Tensor) -> State:
        if not momentum:
            return {}
        return {"trace": torch.zeros_like(params)}

    def update(grads: torch.Tensor, state: State
               ) -> Tuple[torch.Tensor, State]:
        if not momentum:
            return _f32(-lr) * grads, {}
        trace = grads + _f32(momentum) * state["trace"]
        return _f32(-lr) * trace, {"trace": trace}

    return ServerOptimizer(init, update)


def build_server_optimizer(cfg: Any) -> ServerOptimizer:
    name = str(getattr(cfg, "server_optimizer", "adam")).lower()
    lr = float(getattr(cfg, "server_lr", 1e-3))
    momentum = float(getattr(cfg, "server_momentum", 0.9) or 0.0)
    if name == "adam":
        return _adam_like("adam", lr, 0.9, 0.999, 1e-8, 0.0)
    if name == "yogi":
        return _adam_like("yogi", lr, 0.9, 0.999, 1e-3, 1e-6)
    if name == "adagrad":
        return _adagrad(lr)
    return _sgd(lr, momentum if momentum > 0 else 0.0)
