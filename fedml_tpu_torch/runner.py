"""FedMLRunner — dispatch on training_type × backend.

Port of ``fedml_tpu/runner.py``.  The port runs ``training_type:
simulation`` with ``backend: parrot``, and ``training_type: cross_silo``
with ``backend: INPROC`` (synchronous FedAvg, ``cross_silo/runner.py``).
Every other combination, and custom client trainers or server
aggregators, raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .constants import (
    SIMULATION_BACKEND_PARROT,
    TRAINING_PLATFORM_CROSS_SILO,
    TRAINING_PLATFORM_SIMULATION,
)


class FedMLRunner:
    def __init__(self, args: Any, device: Any, dataset: Tuple, model: Any,
                 client_trainer: Optional[Any] = None,
                 server_aggregator: Optional[Any] = None) -> None:
        self.args = args
        ttype = str(getattr(args, "training_type", "simulation"))
        backend = str(getattr(args, "backend", "sp"))
        if client_trainer is not None or server_aggregator is not None:
            raise NotImplementedError(
                "custom client trainers and server aggregators are not "
                "ported yet")
        if ttype == TRAINING_PLATFORM_CROSS_SILO:
            from .cross_silo.runner import build_cross_silo_runner
            self.runner = build_cross_silo_runner(args, device, dataset,
                                                  model)
            return
        if (ttype != TRAINING_PLATFORM_SIMULATION
                or backend != SIMULATION_BACKEND_PARROT):
            raise NotImplementedError(
                f"training_type {ttype!r} with backend {backend!r} is not "
                f"ported yet; the PyTorch port runs training_type "
                f"{TRAINING_PLATFORM_SIMULATION!r} with backend "
                f"{SIMULATION_BACKEND_PARROT!r}, and "
                f"{TRAINING_PLATFORM_CROSS_SILO!r} with backend 'INPROC'")
        from .simulation.parrot.parrot_api import ParrotAPI
        self.runner = ParrotAPI(args, device, dataset, model)

    def run(self):
        return self.runner.train()
