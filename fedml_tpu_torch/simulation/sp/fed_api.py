"""SP (single-process) simulation: the sequential round loop.

Port of ``fedml_tpu/simulation/sp/fed_api.py``: per-round client sampling
with ``np.random.seed(round_idx)`` (reference ``simulation/sp/fedavg/
fedavg_api.py:127-136``), each sampled client's local update in turn on one
``DefaultClientTrainer``, the server's aggregation through
``ServerAggregator.aggregate`` (``FedMLAggOperator``: the weighted-reduce
kernel on one ``[C, D]`` stack a round), the eval every
``frequency_of_the_test`` rounds and at the last, and the server arms of
every federated optimizer the JAX package's SP runs: FedAvg, FedOpt
(``build_server_optimizer``, optax's order, leaf by leaf), FedProx, FedNova,
SCAFFOLD, FedDyn and Mime.

Models and the server's per-client state are trees of tensors in the JAX
package's layout on the device (``utils/weights.tree_from_module``): the
global model ``{"params", "batch_stats"}``, SCAFFOLD's ``c_global`` and
``c_locals[cid]``, FedDyn's ``feddyn_h`` and ``feddyn_lambdas[cid]``,
Mime's ``mime_momentum``, each shaped like ``params``.  The server's tree
arithmetic runs leaf by leaf in plain PyTorch, in the JAX package's order,
its Python-float constants rounded to float32 as JAX's weakly typed scalars
are; every weighted mean over the round's clients goes through
``FedMLAggOperator`` or ``agg_trees``, so on a card through the
weighted-reduce kernel: the model (every arm), FedNova's ``nova_d``, Mime's
``full_grad`` and SCAFFOLD's ``c_delta`` (``uniform_average``).

Not ported: the reference-parity compatibility modes
(``scaffold_ref_bug_compat``, ``fedavg_ref_chain_compat``,
``mime_ref_compat``, ``feddyn_ref_bug_compat``) and ``robust_agg`` (port
item A9), ``contribution_alg`` (A13), the mlops spans and logs (A18); each
raises ``NotImplementedError`` when the API is built.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...constants import (
    FED_OPT_FEDDYN,
    FED_OPT_FEDNOVA,
    FED_OPT_FEDOPT,
    FED_OPT_MIME,
    FED_OPT_SCAFFOLD,
)
from ...core.alg_frame.context import Context
from ...ml.aggregator.agg_operator import (
    FedMLAggOperator,
    agg_trees,
    uniform_average,
)
from ...ml.engine.device import get_device
from ...ml.engine.optimizers import (
    ServerOptimizer,
    _f32,
    apply_updates,
    build_server_optimizer,
)
from ...ml.trainer.default_trainer import (
    DefaultClientTrainer,
    DefaultServerAggregator,
    initial_params,
)
from ...utils.tree import tree_leaves, tree_map, tree_structure, tree_unflatten
from ...utils.weights import from_flax_variables, tree_from_module

#: configuration keys of the JAX package's SP that the port refuses, with
#: the port item that brings each
_UNPORTED = (("scaffold_ref_bug_compat", "A9"),
             ("fedavg_ref_chain_compat", "A9"),
             ("mime_ref_compat", "A9"),
             ("feddyn_ref_bug_compat", "A9"),
             ("robust_agg", "A9"),
             ("contribution_alg", "A13"))


def _zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` with ``s`` rounded to ``x``'s dtype, divided as JAX
    divides (PyTorch's CUDA division by a Python number multiplies by its
    reciprocal)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


class FedSimAPI:
    """One object drives the whole simulated federation."""

    def __init__(self, args: Any, device: Any, dataset: Tuple, bundle: Any,
                 client_trainer: Optional[DefaultClientTrainer] = None,
                 server_aggregator: Optional[DefaultServerAggregator] = None,
                 initial_variables: Optional[Dict[str, Any]] = None) -> None:
        """``initial_variables``: a JAX ``{"params", "batch_stats"}`` tree
        of numpy arrays to start from (``utils/weights.py``); by default the
        bundle's own seeded initialisation."""
        for key, item in _UNPORTED:
            if getattr(args, key, None):
                raise NotImplementedError(
                    f"SP simulation with {key} is not ported yet (port item "
                    f"{item})")
        self.args = args
        self.device = (torch.device(device) if device is not None
                       else get_device(args))
        (self.train_num, self.test_num, self.train_global, self.test_global,
         self.local_num_dict, self.train_data_local_dict,
         self.test_data_local_dict, self.class_num) = dataset
        self.bundle = bundle
        self.algo = str(getattr(args, "federated_optimizer", "FedAvg"))

        self.trainer = client_trainer or DefaultClientTrainer(
            bundle, args, self.device)
        self.aggregator = server_aggregator or DefaultServerAggregator(
            bundle, args, self.device)
        if initial_variables is None:
            self.global_vars = initial_params(bundle, self.device)
        else:
            with bundle.lock:
                bundle.bind(self.device)
                from_flax_variables(initial_variables, bundle.module)
                self.global_vars = tree_from_module(bundle.module)
        self.aggregator.set_model_params(self.global_vars)

        # one batch geometry for every client, as the JAX package's
        bs = int(getattr(args, "batch_size", 32))
        max_n = max(self.local_num_dict.values()) if self.local_num_dict \
            else bs
        self.num_batches = max(1, -(-int(max_n) // bs))
        self.trainer.set_num_batches(self.num_batches)

        # server-side algorithm state, trees shaped like params
        params = self.global_vars["params"]
        self.server_tx: Optional[ServerOptimizer] = None
        #: FedOpt's server state, one per leaf of params in flatten order
        self.server_opt_state: Optional[List[Dict[str, Any]]] = None
        if self.algo == FED_OPT_FEDOPT:
            self.server_tx = build_server_optimizer(args)
            self.server_opt_state = [self.server_tx.init(leaf)
                                     for leaf in tree_leaves(params)]
        self.c_global = (_zeros_like(params) if self.algo == FED_OPT_SCAFFOLD
                         else None)
        self.c_locals: Dict[int, Any] = {}
        self.feddyn_h = (_zeros_like(params) if self.algo == FED_OPT_FEDDYN
                         else None)
        self.feddyn_lambdas: Dict[int, Any] = {}
        self.mime_momentum = (_zeros_like(params) if self.algo == FED_OPT_MIME
                              else None)

        #: eval rounds, as the JAX package records them
        self.metrics_history: List[Dict[str, Any]] = []
        #: every round: the clients' sample-weighted train_loss, its
        #: training seconds (sampling to the new global model) and samples
        self.round_history: List[Dict[str, Any]] = []

    # -- sampling (reference :127-136) ---------------------------------
    def _client_sampling(self, round_idx: int) -> List[int]:
        total = int(self.args.client_num_in_total)
        per_round = int(self.args.client_num_per_round)
        if total == per_round:
            return list(range(total))
        np.random.seed(round_idx)  # reference parity: reproducible
        return [int(c) for c in
                np.random.choice(range(total), per_round, replace=False)]

    # -- algorithm state plumbing --------------------------------------
    def _algo_state_for(self, cid: int) -> Dict[str, Any]:
        params = self.global_vars["params"]
        if self.algo == FED_OPT_SCAFFOLD:
            if cid not in self.c_locals:
                self.c_locals[cid] = _zeros_like(params)
            return {"c_global": self.c_global, "c_local": self.c_locals[cid]}
        if self.algo == FED_OPT_FEDDYN:
            if cid not in self.feddyn_lambdas:
                self.feddyn_lambdas[cid] = _zeros_like(params)
            return {"feddyn_lambda": self.feddyn_lambdas[cid]}
        if self.algo == FED_OPT_MIME:
            return {"server_momentum": self.mime_momentum}
        return {}

    # -- the round loop ------------------------------------------------
    def _local_train(self, cid: int) -> Tuple[float, Any]:
        """One client's local round: its dataset, the global model, its
        algorithm state, the hooks around training, and training.  Returns
        (n_samples, trained variables)."""
        self.trainer.set_id(cid)
        self.trainer.update_dataset(
            self.train_data_local_dict[cid],
            self.test_data_local_dict[cid],
            self.local_num_dict[cid])
        self.trainer.set_model_params(self.global_vars)
        self.trainer.algo_state = self._algo_state_for(cid)
        self.trainer.on_before_local_training(
            self.trainer.local_train_dataset, self.device, self.args)
        self.trainer.train(self.trainer.local_train_dataset, self.device,
                           self.args)
        self.trainer.on_after_local_training(
            self.trainer.local_train_dataset, self.device, self.args)
        return float(self.local_num_dict[cid]), self.trainer.get_model_params()

    def train(self) -> Dict[str, Any]:
        comm_rounds = int(self.args.comm_round)
        freq = int(getattr(self.args, "frequency_of_the_test", 5) or 5)
        final_metrics: Dict[str, Any] = {}
        for round_idx in range(comm_rounds):
            t0 = time.perf_counter()
            client_ids = self._client_sampling(round_idx)
            logging.info("round %d clients %s", round_idx, client_ids)
            results: List[Tuple[float, Any]] = []
            algo_outs: List[Tuple[int, float, Dict[str, Any]]] = []
            loss_sum = trained = 0.0
            for cid in client_ids:
                n_k, params = self._local_train(cid)
                results.append((n_k, params))
                algo_outs.append((cid, n_k, self.trainer.algo_out))
                m = self.trainer.last_metrics
                loss_sum += m["train_loss"] * n_k
                trained += m["n_samples"]

            # publish the round's context before aggregation, as the JAX
            # package does for its history-aware defenses
            Context().add(Context.KEY_CLIENT_ID_LIST_IN_THIS_ROUND, client_ids)
            Context().add(Context.KEY_CLIENT_MODEL_LIST, results)

            self.global_vars = self._server_update(round_idx, client_ids,
                                                   results, algo_outs)
            self.aggregator.set_model_params(self.global_vars)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            weight = sum(n for n, _ in results)
            self.round_history.append({
                "round": round_idx,
                "train_loss": loss_sum / max(weight, 1e-12),
                "train_seconds": time.perf_counter() - t0,
                "samples_trained": trained})

            if round_idx % freq == 0 or round_idx == comm_rounds - 1:
                metrics = self.aggregator.test(self.test_global, self.device,
                                               self.args)
                metrics["round"] = round_idx
                metrics["round_time"] = time.perf_counter() - t0
                ctx = Context()
                ctx.add(Context.KEY_METRICS_ON_LAST_ROUND,
                        self.metrics_history[-1] if self.metrics_history
                        else metrics)
                ctx.add(Context.KEY_METRICS_ON_AGGREGATED_MODEL, metrics)
                ctx.add(Context.KEY_TEST_DATA, self.test_global)
                self.metrics_history.append(metrics)
                final_metrics = metrics
                logging.info("round %d: %s", round_idx, metrics)
        return final_metrics

    # -- server aggregation per algorithm ------------------------------
    def _server_update(self, round_idx: int, client_ids: List[int],
                       results: List[Tuple[float, Any]],
                       algo_outs: List[Tuple[int, float, Dict[str, Any]]]
                       ) -> Any:
        raw = self.aggregator.on_before_aggregation(results)
        args = self.args
        params = self.global_vars["params"]
        if self.algo == FED_OPT_SCAFFOLD:
            n_total = float(args.client_num_in_total)
            for cid, _, out in algo_outs:
                self.c_locals[cid] = out["c_local"]
            new_vars = self.aggregator.aggregate(raw)
            delta = uniform_average([out["c_delta"] for _, _, out in
                                     algo_outs], denom=n_total)
            self.c_global = tree_map(lambda c, d: c + d, self.c_global,
                                     delta)
        elif self.algo == FED_OPT_FEDNOVA:
            weights = np.array([n for _, n, _ in algo_outs], np.float64)
            p = weights / weights.sum()
            taus = np.array([float(out["tau"]) for _, _, out in algo_outs])
            tau_eff = float((p * taus).sum())
            lr = float(args.learning_rate)
            d_avg = agg_trees([out["nova_d"] for _, _, out in algo_outs],
                              torch.tensor(weights, dtype=torch.float32,
                                           device=self.device))
            step = _f32(tau_eff * lr)
            new_params = tree_map(lambda w, d: w - step * d, params, d_avg)
            avg_vars = self.aggregator.aggregate(raw)   # the model state's
            new_vars = dict(avg_vars, params=new_params)
        elif self.algo == FED_OPT_MIME:
            new_vars = self.aggregator.aggregate(raw)
            g = FedMLAggOperator._reduce(
                args, [(n, out["full_grad"]) for _, n, out in algo_outs])
            beta = float(getattr(args, "server_momentum", 0.9) or 0.9)
            self.mime_momentum = tree_map(
                lambda m, gg: _f32(beta) * m + _f32(1.0 - beta) * gg,
                self.mime_momentum, g)
        elif self.algo == FED_OPT_FEDDYN:
            for cid, _, out in algo_outs:
                self.feddyn_lambdas[cid] = out["feddyn_lambda"]
            alpha = float(getattr(args, "feddyn_alpha", 0.01) or 0.01)
            avg_vars = self.aggregator.aggregate(raw)
            frac = _f32(float(len(results)) / float(args.client_num_in_total))
            delta = tree_map(lambda avg, g: (avg - g) * frac,
                             avg_vars["params"], params)
            self.feddyn_h = tree_map(lambda h, d: h - _f32(alpha) * d,
                                     self.feddyn_h, delta)
            new_params = tree_map(lambda avg, h: avg - _div(h, alpha),
                                  avg_vars["params"], self.feddyn_h)
            new_vars = dict(avg_vars, params=new_params)
        elif self.algo == FED_OPT_FEDOPT:
            avg_vars = self.aggregator.aggregate(raw)
            pseudo = tree_leaves(tree_map(lambda g, a: g - a, params,
                                          avg_vars["params"]))
            leaves = []
            for i, (g, w) in enumerate(zip(pseudo, tree_leaves(params))):
                updates, self.server_opt_state[i] = self.server_tx.update(
                    g, self.server_opt_state[i])
                leaves.append(apply_updates(w, updates))
            new_vars = dict(avg_vars, params=tree_unflatten(
                tree_structure(params), leaves))
        else:
            new_vars = self.aggregator.aggregate(raw)
        return self.aggregator.on_after_aggregation(new_vars)
