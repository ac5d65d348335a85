"""Default ClientTrainer and ServerAggregator.

Port of ``fedml_tpu/ml/trainer/default_trainer.py``: ``batches_for``,
``DefaultClientTrainer`` and ``DefaultServerAggregator`` on the port's
``build_local_update`` and ``build_eval_step``.  Model parameters are trees
of tensors in the JAX package's layout (``utils/weights.tree_from_module``)
on the trainer's device.  The client trainer carries the federated
optimizer's per-client state in (``algo_state``: SCAFFOLD's ``c_global``
and ``c_local``, FedDyn's ``feddyn_lambda``, Mime's ``server_momentum``)
and the arm's output out (``algo_out``) of the local update, as trees
shaped like the JAX ``params`` (FedNova's ``tau`` a 0-d tensor), as the
JAX trainer does.

The JAX package's bundle is stateless: its trainers pass variables in and
out of jitted functions.  The port's bundle trains and evaluates its module
in place, and every trainer and aggregator built on one bundle shares that
module — the cross-silo plane builds one per silo thread, and the server's
aggregator, on the same bundle.  So each holds ``bundle.lock`` from
loading a tree into the module to copying the result out
(``ModelBundle.lock``): one module, used by one thread at a time, as one
card runs one stream.  The parameters a trainer hands back are a fresh
tree, never a view into the module.

The JAX package's tracing spans, metrics, flight-recorder phases and
``jax.profiler`` captures around the local update are not ported (port
item A18).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core.alg_frame.client_trainer import ClientTrainer
from ...core.alg_frame.server_aggregator import ServerAggregator
from ...utils.weights import (
    flat_from_params_tree,
    load_tree,
    params_tree_from_flat,
    tree_from_module,
)
from ..engine.device import get_device
from ..engine.local_update import build_eval_step, build_local_update, make_batches
from ..engine.model_bundle import FlatVariables, ModelBundle


def batches_for(data: Tuple[np.ndarray, np.ndarray], batch_size: int,
                num_batches: int, input_dtype: Optional[torch.dtype] = None,
                device: Optional[torch.device] = None
                ) -> Dict[str, torch.Tensor]:
    x, y = data
    return make_batches(x, y, batch_size, num_batches, dtype=input_dtype,
                        device=device)


def _valid(n: int, batch_size: int, num_batches: int) -> List[bool]:
    """Which of the padded batches hold a real sample: the first
    ``⌈n / batch_size⌉`` of them (known on the host, so no device sync)."""
    return [b * batch_size < n for b in range(num_batches)]


def initial_params(bundle: ModelBundle, device: torch.device) -> Any:
    """The bundle's own seeded variables as a tree on ``device``: the global
    model a server starts from when it is given none."""
    with bundle.lock:
        bundle.bind(device)
        return tree_from_module(bundle.module)


def _resolve(device: Any, args: Any) -> torch.device:
    return torch.device(device) if device is not None else get_device(args)


def _flat_state(algo_state: Dict[str, Any], variables: FlatVariables
                ) -> Dict[str, Any]:
    """Per-client state trees (shaped like the JAX ``params``) as the local
    update takes them: per dtype group over the parameter columns."""
    return {k: flat_from_params_tree(t, variables)
            for k, t in algo_state.items()}


def _tree_out(algo_out: Dict[str, Any], variables: FlatVariables
              ) -> Dict[str, Any]:
    """The local update's ``algo_out`` as trees shaped like the JAX
    ``params`` (scalars, such as FedNova's ``tau``, as they are)."""
    return {k: params_tree_from_flat(v, variables) if isinstance(v, dict)
            else v for k, v in algo_out.items()}


def _metrics(out: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    n = max(float(out["n"]), 1.0)
    return {"test_loss": float(out["loss_sum"]) / n,
            "test_acc": float(out["correct"]) / n,
            "test_total": n}


class DefaultClientTrainer(ClientTrainer):
    """Local training of one silo on the shared bundle."""

    def __init__(self, bundle: ModelBundle, args: Any,
                 device: Any = None) -> None:
        super().__init__(bundle, args)
        self.bundle = bundle
        self.device = _resolve(device, args)
        self.local_update = build_local_update(bundle, args)
        self.batch_size = int(getattr(args, "batch_size", 32))
        #: the padded batch-grid length, fixed by the plane for every silo
        self.num_batches: Optional[int] = None
        #: the federated optimizer's state for the next local update, and
        #: the arm's output of the last one (trees shaped like ``params``)
        self.algo_state: Dict[str, Any] = {}
        self.algo_out: Dict[str, Any] = {}
        self.last_metrics: Dict[str, Any] = {}

    def set_num_batches(self, nb: Optional[int]) -> None:
        """Fix the padded batch-grid length (None → derive from data)."""
        self.num_batches = None if nb is None else int(nb)

    def _dropout_rng(self) -> torch.Generator:
        """One host generator per silo, the same stream every round (the
        JAX trainer folds its id into one key); it seeds dropout only."""
        seed = np.random.SeedSequence([self.rng_seed, int(self.id)])
        return torch.Generator().manual_seed(int(seed.generate_state(1)[0]))

    def train(self, train_data, device=None, args=None) -> Dict[str, Any]:
        n = len(train_data[1])
        nb = self.num_batches or max(1, -(-n // self.batch_size))
        batches = batches_for(train_data, self.batch_size, nb,
                              self.bundle.input_dtype, self.device)
        valid = _valid(n, self.batch_size, nb)
        with self.bundle.lock:
            variables = self.bundle.bind(self.device)
            load_tree(self.params, self.bundle.module)
            out = self.local_update(
                variables, batches, valid, rng=self._dropout_rng(),
                algo_state=_flat_state(self.algo_state, variables))
            new_params = tree_from_module(self.bundle.module)
            algo_out = _tree_out(out.pop("algo_out"), variables)
        self.last_metrics = {k: float(v) for k, v in out.items()}
        self.params = new_params
        self.algo_out = algo_out
        return self.last_metrics


class DefaultServerAggregator(ServerAggregator):
    """Aggregation (``ServerAggregator.aggregate``) and evaluation of the
    global model on the shared bundle."""

    def __init__(self, bundle: ModelBundle, args: Any,
                 device: Any = None) -> None:
        super().__init__(bundle, args)
        self.bundle = bundle
        self.device = _resolve(device, args)
        self.batch_size = int(getattr(args, "batch_size", 32))
        self._eval = build_eval_step(bundle)
        #: the padded test batches on the device, made once per test set
        self._test_batches: Optional[Tuple[Any, Dict[str, torch.Tensor]]] \
            = None

    def test(self, test_data, device=None, args=None) -> Dict[str, Any]:
        if self._test_batches is None or self._test_batches[0] is not \
                test_data:
            nb = max(1, -(-len(test_data[1]) // self.batch_size))
            self._test_batches = (test_data, batches_for(
                test_data, self.batch_size, nb, self.bundle.input_dtype,
                self.device))
        with self.bundle.lock:
            self.bundle.bind(self.device)
            load_tree(self.params, self.bundle.module)
            out = self._eval(self._test_batches[1])
        return _metrics(out)
