"""Client and server optimizers.

Port of ``fedml_tpu/ml/engine/optimizers.py``:

* ``build_client_optimizer`` for the setting the north-star config uses:
  plain SGD at a constant learning rate (``optax.sgd(lr)``: ``p ← p +
  (−lr·g)``, in the parameter's dtype).  Momentum, weight decay, adam and
  the lr schedules are not ported yet for it and raise (port item A9).
* ``make_lr`` — the learning rate or schedule: constant, cosine (optax's
  ``warmup_cosine_decay_schedule``) and linear (``linear_schedule``, with
  a warmup leg through ``join_schedules``, which rebases the step count at
  its boundary), each evaluated in float32 as optax evaluates it.
* ``LLMOptimizer`` — the LLM trainer's client chain,
  ``clip_by_global_norm(grad_clip)`` then ``adamw(lr)`` at optax's
  defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every leaf),
  wrapped in ``MultiSteps`` gradient accumulation when
  ``grad_accum_steps`` > 1.  ``torch.optim.AdamW`` places eps and the
  decay elsewhere, so the chain is written out in optax's order.
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

import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

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
    ``init(params) -> state`` and ``update(grads, state, bias_rows=None)
    -> (updates, state)``; ``apply_updates`` adds the updates.  The state's
    keys are optax's field names (``count``/``mu``/``nu``,
    ``sum_of_squares``, ``trace``).

    ``betas``: adam's and yogi's ``(b1, b2)``, whose bias corrections
    depend on the step count (None for the others).  Their ``count`` is a
    host int, or a 0-d int64 tensor on the state's device that ``update``
    advances in place; the corrections then come from ``bias_rows``, a
    device table whose row ``t − 1`` holds ``1 − b1^t`` and ``1 − b2^t``
    rounded on the host as ``_bias_correction`` rounds them (the last two
    columns of ``ops/epilogue.step_rows``), its last row taken for every
    later step — so nothing on the host reads the count."""

    init: Callable[[torch.Tensor], State]
    update: Callable[..., Tuple[torch.Tensor, State]]
    betas: Optional[Tuple[float, float]] = None


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

    def update(grads: torch.Tensor, state: State,
               bias_rows: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, State]:
        mu = _f32(1 - b1) * grads + _f32(b1) * state["mu"]
        sq = grads * grads
        if name == "yogi":
            nu = state["nu"] - _f32(1 - b2) * torch.sign(
                state["nu"] - sq) * sq
        else:
            nu = _f32(1 - b2) * sq + _f32(b2) * state["nu"]
        count = state["count"]
        if isinstance(count, torch.Tensor):
            if bias_rows is None:
                raise ValueError(f"{name}: a step count in a tensor needs "
                                 f"the bias-correction table (bias_rows)")
            count.add_(1)
            row = torch.clamp(count, 1, bias_rows.shape[0]) - 1
            bc = bias_rows.index_select(0, row.reshape(1))[0]
            bc1, bc2 = bc[0], bc[1]
        else:
            count = int(count) + 1
            bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2,
                                                                     count)
        u = (mu / bc1) / (torch.sqrt(nu / bc2 + 0.0) + _f32(eps))
        return _f32(-lr) * u, {"count": count, "mu": mu, "nu": nu}

    return ServerOptimizer(init, update, (b1, b2))


def _adagrad(lr: float, init_value: float = 0.1, eps: float = 1e-7
             ) -> ServerOptimizer:
    def init(params: torch.Tensor) -> State:
        return {"sum_of_squares": torch.full(
            params.shape, init_value, dtype=params.dtype,
            device=params.device)}

    def update(grads: torch.Tensor, state: State,
               bias_rows: Optional[torch.Tensor] = None
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

    def update(grads: torch.Tensor, state: State,
               bias_rows: Optional[torch.Tensor] = None
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


# ----------------------------------------------------------- LLM client chain
Schedule = Callable[[int], float]


def _polynomial(init: float, end: float, steps: int) -> Schedule:
    """``optax.polynomial_schedule`` at power 1 (``linear_schedule``), in
    float32: ``(init − end)·(1 − clip(count, 0, steps)/steps) + end``."""
    if steps <= 0:
        return lambda count: float(np.float32(init))

    def schedule(count: int) -> float:
        c = np.float32(min(max(int(count), 0), steps))
        frac = np.float32(1.0) - c / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))

    return schedule


def _cosine(init: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` (alpha 0, exponent 1), in float32:
    ``init · 0.5·(1 + cos(π·min(count, T)/T))``."""

    def schedule(count: int) -> float:
        c = np.minimum(np.float32(count), np.float32(decay_steps))
        cos = np.cos(np.float32(math.pi) * c / np.float32(decay_steps))
        decayed = np.float32(0.5) * (np.float32(1.0) + cos)
        return float(np.float32(init) * decayed)

    return schedule


def _join(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    """``optax.join_schedules``: past each boundary the next schedule runs
    on the step count rebased to that boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def make_lr(cfg: Any) -> Union[float, Schedule]:
    """Learning rate or schedule of ``cfg``: ``lr_schedule`` "constant"
    (default; the float itself) | "cosine" | "linear", with
    ``warmup_steps`` and ``lr_decay_steps`` counting optimizer steps.  A
    schedule maps the step count to the float32 rate."""
    lr = float(getattr(cfg, "learning_rate", 0.03))
    kind = str(getattr(cfg, "lr_schedule", "constant") or "constant").lower()
    if kind == "constant":
        return lr
    warmup = int(getattr(cfg, "warmup_steps", 0) or 0)
    decay = int(getattr(cfg, "lr_decay_steps", 1000) or 1000)
    if kind == "cosine":
        w = max(warmup, 1)
        d = max(decay, warmup + 1)
        if not d - w > 0:
            raise ValueError(f"cosine schedule needs lr_decay_steps > "
                             f"warmup_steps, got {decay} and {warmup}")
        return _join([_polynomial(0.0, lr, w), _cosine(lr, d - w)], [w])
    if kind == "linear":
        sched = _polynomial(lr, 0.0, max(decay - warmup, 1))
        if warmup:
            return _join([_polynomial(0.0, lr, warmup), sched], [warmup])
        return sched
    raise ValueError(f"unknown lr_schedule {kind!r}; "
                     f"known: constant, cosine, linear")


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: the leaves as they are while their
    global norm is below ``max_norm``, else ``g / norm · max_norm``, chosen
    on the device (no host sync)."""
    sums = torch.stack([s.sum() for s in torch._foreach_mul(grads, grads)])
    norm = torch.sqrt(sums.sum())
    keep = norm < _f32(max_norm)
    return [torch.where(keep, g, g / norm * _f32(max_norm)) for g in grads]


class LLMOptimizer:
    """``[MultiSteps(k)](chain(clip_by_global_norm(grad_clip),
    adamw(lr)))`` on a list of float32 leaves, updated in place.

    ``init(params)`` → state; ``step(params, grads, state)`` applies one
    mini-step: the gradient joins the running mean of the accumulation
    window (``acc + (g − acc)/(n + 1)``), and on the window's last
    mini-step the chain runs on that mean — clip, adam's moments, bias
    corrections and ``m̂ / (sqrt(v̂ + 0) + eps)``, ``+ wd·p``, ``× −lr``
    — and ``p + u`` lands.  Python-float constants meet float32 tensors
    rounded to float32, as JAX's weakly typed scalars do; the schedule's
    count is the number of updates applied."""

    def __init__(self, learning_rate: Union[float, Schedule],
                 grad_clip: float = 1.0, accum_steps: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4) -> None:
        self.lr = learning_rate
        self.grad_clip = float(grad_clip)
        self.k = max(1, int(accum_steps))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: List[torch.Tensor]) -> State:
        zeros = [torch.zeros_like(p) for p in params]
        return {"count": 0, "mu": zeros,
                "nu": [torch.zeros_like(p) for p in params],
                "mini_step": 0,
                "acc": [torch.zeros_like(p) for p in params]
                if self.k > 1 else None}

    def _rate(self, count: int) -> float:
        lr = self.lr(count) if callable(self.lr) else self.lr
        return _f32(-lr)

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: State) -> None:
        with torch.no_grad():
            if self.k > 1:
                n = state["mini_step"]
                acc = torch._foreach_add(state["acc"], torch._foreach_div(
                    torch._foreach_sub(grads, state["acc"]), float(n + 1)))
                if n < self.k - 1:
                    state["acc"], state["mini_step"] = acc, n + 1
                    return
                grads = acc
                state["acc"] = [torch.zeros_like(p) for p in params]
                state["mini_step"] = 0
            g = clip_by_global_norm(list(grads), self.grad_clip)
            mu = torch._foreach_add(torch._foreach_mul(g, _f32(1 - self.b1)),
                                    torch._foreach_mul(state["mu"],
                                                       _f32(self.b1)))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g),
                                   _f32(1 - self.b2)),
                torch._foreach_mul(state["nu"], _f32(self.b2)))
            count = int(state["count"]) + 1
            mu_hat = torch._foreach_div(mu, _bias_correction(self.b1, count))
            nu_hat = torch._foreach_div(nu, _bias_correction(self.b2, count))
            den = torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_add(nu_hat, 0.0)), _f32(self.eps))
            u = torch._foreach_div(mu_hat, den)
            u = torch._foreach_add(u, torch._foreach_mul(
                params, _f32(self.weight_decay)))
            u = torch._foreach_mul(u, self._rate(count - 1))
            torch._foreach_add_(params, u)
            state.update(count=count, mu=mu, nu=nu)


def build_llm_optimizer(cfg: Any) -> LLMOptimizer:
    """The LLM trainer's chain for ``cfg`` (an ``LLMTrainConfig``):
    ``learning_rate`` through ``make_lr``, ``grad_clip`` and
    ``grad_accum_steps``."""
    return LLMOptimizer(make_lr(cfg),
                        grad_clip=float(getattr(cfg, "grad_clip", 1.0)),
                        accum_steps=int(getattr(cfg, "grad_accum_steps", 1)
                                        or 1))
