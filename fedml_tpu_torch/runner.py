"""FedMLRunner — dispatch on training_type × backend.

Port of ``fedml_tpu/runner.py``.  The port runs ``training_type:
simulation`` with ``backend: sp`` (``simulation/sp/fed_api.FedSimAPI``:
FedAvg, FedOpt, FedProx, FedNova, SCAFFOLD, FedDyn and Mime) and ``backend:
parrot``, and ``training_type: cross_silo`` with ``backend: INPROC``
(synchronous FedAvg, ``cross_silo/runner.py``).  SP's algorithm-structured
variants (hierarchical, decentralized, async, vertical, split, FedGKT,
FedGAN, TurboAggregate, FedAvg_seq: A9), the ``mesh`` (A16) and
``hyperscale`` (A14) backends, other combinations, and custom client
trainers or server aggregators raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .constants import (
    FED_OPT_ASYNC_FEDAVG,
    FED_OPT_DECENTRALIZED,
    FED_OPT_FEDAVG_SEQ,
    FED_OPT_HIERARCHICAL,
    FED_OPT_SPLIT_NN,
    FED_OPT_VERTICAL,
    SIMULATION_BACKEND_HYPERSCALE,
    SIMULATION_BACKEND_MESH,
    SIMULATION_BACKEND_PARROT,
    SIMULATION_BACKEND_SP,
    TRAINING_PLATFORM_CROSS_SILO,
    TRAINING_PLATFORM_SIMULATION,
)

#: the JAX package's SP variants that run their own API
#: (``simulation/sp/algorithms.py``, ``vertical_fl.py``,
#: ``advanced_algorithms.py``), port item A9
_SP_VARIANTS = (FED_OPT_HIERARCHICAL, FED_OPT_DECENTRALIZED,
                FED_OPT_ASYNC_FEDAVG, FED_OPT_VERTICAL, FED_OPT_SPLIT_NN,
                "FedGKT", "FedGAN", "TurboAggregate", FED_OPT_FEDAVG_SEQ)
#: the simulation backends still to come, and their port items
_LATER_BACKENDS = {SIMULATION_BACKEND_MESH: "A16",
                   SIMULATION_BACKEND_HYPERSCALE: "A14"}


class FedMLRunner:
    def __init__(self, args: Any, device: Any, dataset: Tuple, model: Any,
                 client_trainer: Optional[Any] = None,
                 server_aggregator: Optional[Any] = None) -> None:
        self.args = args
        ttype = str(getattr(args, "training_type", "simulation"))
        backend = str(getattr(args, "backend", "sp"))
        opt = str(getattr(args, "federated_optimizer", "FedAvg"))
        if client_trainer is not None or server_aggregator is not None:
            raise NotImplementedError(
                "custom client trainers and server aggregators are not "
                "ported yet")
        if ttype == TRAINING_PLATFORM_CROSS_SILO:
            from .cross_silo.runner import build_cross_silo_runner
            self.runner = build_cross_silo_runner(args, device, dataset,
                                                  model)
            return
        if ttype == TRAINING_PLATFORM_SIMULATION:
            if backend == SIMULATION_BACKEND_SP:
                if opt in _SP_VARIANTS:
                    raise NotImplementedError(
                        f"SP {opt!r} is not ported yet (port item A9)")
                from .simulation.sp.fed_api import FedSimAPI
                self.runner = FedSimAPI(args, device, dataset, model)
                return
            if backend == SIMULATION_BACKEND_PARROT:
                from .simulation.parrot.parrot_api import ParrotAPI
                self.runner = ParrotAPI(args, device, dataset, model)
                return
            if backend in _LATER_BACKENDS:
                raise NotImplementedError(
                    f"backend {backend!r} is not ported yet (port item "
                    f"{_LATER_BACKENDS[backend]})")
        raise NotImplementedError(
            f"training_type {ttype!r} with backend {backend!r} is not "
            f"ported yet; the PyTorch port runs training_type "
            f"{TRAINING_PLATFORM_SIMULATION!r} with backend "
            f"{SIMULATION_BACKEND_SP!r} or {SIMULATION_BACKEND_PARROT!r}, "
            f"and {TRAINING_PLATFORM_CROSS_SILO!r} with backend 'INPROC'")

    def run(self):
        return self.runner.train()
