"""Cross-silo runners.

Port of ``fedml_tpu/cross_silo/runner.py`` for synchronous FedAvg over the
INPROC transport: ``init_server`` and ``init_client`` build the manager
pair, and ``LocalFederationRunner`` runs the server and one client
manager per silo on threads over the in-process hub, so the whole message
protocol runs in one process (``backend: INPROC``, any ``role``).  With
``fed_llm: true`` the pair is the fed-LLM plane's, as
``fedml_tpu/cross_silo/runner.py:27-33`` and
``client/trainer_dist_adapter.py:29-33`` swap it in: the server's
aggregator is ``train/fed_llm.FedLLMAggregator`` and each silo's trainer a
``FedLLMTrainer``, so only LoRA adapter trees cross the wire.

Left out, each raising ``NotImplementedError`` naming its port item: the
other transports and the single-role runner (A11), buffered-async rounds
(A11, with the fed-LLM plane too), the aggregation hierarchy (A11), SecAgg
and LightSecAgg (A13), algorithms other than FedAvg and robust aggregation
(A9, with the fed-LLM plane too), and custom client trainers or server
aggregators.

Threads and the card: every silo thread trains on the one shared bundle
under ``bundle.lock`` (``ml/trainer/default_trainer.py``), and runs under
the card's device context, since the current CUDA device is per thread.
A failure on any thread stops every receive loop and is raised by
``train()``; no thread is left waiting.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, List, Optional, Tuple

import torch

from ..constants import (
    FED_OPT_FEDAVG,
    FED_OPT_LIGHTSECAGG,
    FED_OPT_SECAGG,
)
from ..ml.engine.device import get_device
from ..ml.trainer.default_trainer import DefaultServerAggregator, initial_params
from .client.fedml_client_master_manager import ClientMasterManager
from .client.trainer_dist_adapter import TrainerDistAdapter
from .server.fedml_aggregator import FedMLAggregator
from .server.fedml_server_manager import FedMLServerManager, fleet_size


def _check_algorithm(args: Any) -> None:
    opt = str(getattr(args, "federated_optimizer", FED_OPT_FEDAVG))
    if opt in (FED_OPT_SECAGG, FED_OPT_LIGHTSECAGG):
        raise NotImplementedError(
            f"secure aggregation (federated_optimizer {opt!r}) is not ported "
            f"yet (port item A13)")
    if opt != FED_OPT_FEDAVG:
        raise NotImplementedError(
            f"cross-silo {opt!r} is not ported yet (port item A9); the port "
            f"runs {FED_OPT_FEDAVG}")
    if getattr(args, "robust_agg", None):
        raise NotImplementedError(
            "robust aggregation (robust_agg) is not ported yet (port item "
            "A9)")
    if bool(getattr(args, "async_agg", False)):
        raise NotImplementedError(
            "buffered-async rounds (async_agg) are not ported yet (port item "
            "A11)")


def init_server(args: Any, device: torch.device, dataset: Tuple, bundle: Any,
                backend: str = "INPROC") -> FedMLServerManager:
    """The server manager, its aggregator holding the bundle's own seeded
    variables as the first global model — or, with ``fed_llm``, the
    fed-LLM aggregator holding the seeded initial adapters."""
    _check_algorithm(args)
    if bool(getattr(args, "fed_llm", False)):
        from ..train.fed_llm import FedLLMAggregator
        aggregator_impl = FedLLMAggregator(bundle, args, device)
    else:
        aggregator_impl = DefaultServerAggregator(bundle, args, device)
        aggregator_impl.set_model_params(initial_params(bundle, device))
    agg = FedMLAggregator(args, aggregator_impl, dataset[3])
    return FedMLServerManager(args, agg, rank=0, client_num=fleet_size(args),
                              backend=backend)


def init_client(args: Any, device: torch.device, dataset: Tuple, bundle: Any,
                rank: int, backend: str = "INPROC") -> ClientMasterManager:
    _check_algorithm(args)
    adapter = TrainerDistAdapter(args, device, bundle, dataset)
    return ClientMasterManager(args, adapter, rank=rank,
                               size=fleet_size(args) + 1, backend=backend)


class LocalFederationRunner:
    """Server + N clients over INPROC threads; returns the server's final
    metrics.  ``server`` is the server manager of the last ``train()``."""

    JOIN_TIMEOUT_S = 30.0

    def __init__(self, args: Any, device: Any, dataset: Tuple,
                 bundle: Any) -> None:
        self.args = args
        self.device = (torch.device(device) if device is not None
                       else get_device(args))
        self.dataset = dataset
        self.bundle = bundle
        self.server: Optional[FedMLServerManager] = None

    def _context(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def train(self):
        n = fleet_size(self.args)
        server = init_server(self.args, self.device, self.dataset,
                             self.bundle, backend="INPROC")
        clients: List[ClientMasterManager] = [
            init_client(self.args, self.device, self.dataset, self.bundle,
                        rank, backend="INPROC")
            for rank in range(1, n + 1)]
        self.server = server
        errors: List[BaseException] = []

        def run_client(client: ClientMasterManager) -> None:
            try:
                with self._context():
                    client.run()
            except BaseException as e:  # noqa: BLE001 — re-raised by train()
                errors.append(e)
                logging.exception("client %d failed; stopping the run",
                                  client.rank)
                server.finish()

        threads = [threading.Thread(target=run_client, args=(c,),
                                    daemon=True, name=f"client-{c.rank}")
                   for c in clients]
        for t in threads:
            t.start()
        failed = True
        try:
            with self._context():
                server.run()  # returns after FINISH, or when stopped
            failed = bool(errors)
        finally:
            if failed:
                for c in clients:
                    c.finish()
            for t in threads:
                t.join(timeout=self.JOIN_TIMEOUT_S)
        if errors:
            raise errors[0]
        hist = server.aggregator.metrics_history
        return hist[-1] if hist else {}


def build_cross_silo_runner(args: Any, device: Any, dataset: Tuple,
                            bundle: Any) -> LocalFederationRunner:
    backend = str(getattr(args, "backend", "INPROC")).upper()
    if int(getattr(args, "hier_regions", 0) or 0) >= 2:
        raise NotImplementedError(
            "the cross-silo aggregation hierarchy (hier_regions >= 2) is not "
            "ported yet (port item A11)")
    if backend != "INPROC":
        raise NotImplementedError(
            f"cross-silo backend {backend!r} (and the single-role runner of "
            f"the networked backends) is not ported yet (port item A11); the "
            f"PyTorch port runs INPROC")
    _check_algorithm(args)
    return LocalFederationRunner(args, device, dataset, bundle)
