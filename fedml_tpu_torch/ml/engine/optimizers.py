"""Client optimizer.

Port of ``fedml_tpu/ml/engine/optimizers.py::build_client_optimizer`` for the
setting the north-star config uses: plain SGD at a constant learning rate
(``optax.sgd(lr)``: ``p ← p + (−lr·g)``, in the parameter's dtype).
Momentum, weight decay, adam and the lr schedules are not ported yet and
raise.
"""

from __future__ import annotations

from typing import Any, Callable, List

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
