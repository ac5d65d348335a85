"""FedLLMAggregator — delta-space server aggregation of the fed-LLM plane.

Port of ``fedml_tpu/train/fed_llm/aggregator.py`` for synchronous rounds.
The global model the cross-silo server holds and broadcasts is the LoRA
adapter tree, never the base parameters.  Per round:

1. each silo's upload (an adapter tree) minus the current global, in
   float32 (``_tree_sub``);
2. one reduction of those deltas through ``FedMLAggOperator.agg``, with
   the zero tree as its centre — on a card one weighted-reduce launch over
   the stacked ``[C, adapter params]`` buffer;
3. ``delta_round`` folds the aggregate into the global adapters (the
   fold kernel) and merges them into the frozen base; the merged
   parameters feed the round-boundary evaluation.

``test`` evaluates the merged parameters with the port's
``build_eval_step`` on the shared bundle: under ``ModelBundle.lock`` it
loads them into the module, evaluates (the flash kernel on a card) and
puts the seeded base back, so the module keeps the parameters every
trainer on the bundle starts from.

Not ported: the buffered-async server's mix (A11) and robust aggregation
(A9), which the cross-silo runner refuses, and the serving probe
``fed_llm_serve_eval`` (A17), which raises here.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...core.alg_frame.server_aggregator import ServerAggregator
from ...ml.aggregator.agg_operator import FedMLAggOperator
from ...ml.engine.local_update import build_eval_step
from ...ml.trainer.default_trainer import batches_for
from ...utils.tree import tree_map
from ...utils.weights import load_tree
from ..llm.lora import count_trainable
from ..llm.trainer import LLMTrainer
from .config import llm_config_from_args
from .delta_round import make_delta_round, zeros_like_adapters


def _tree_sub(tree: Any, ref: Any) -> Any:
    """upload − global, leaf by leaf in float32 (exact for float32 and
    bfloat16 adapter leaves)."""
    return tree_map(lambda a, b: a.float() - b.float(), tree, ref)


class FedLLMAggregator(ServerAggregator):
    """Server aggregator whose ``params`` is the global adapter tree.
    ``variables`` and ``adapters`` (JAX trees, numpy leaves) replace the
    seeded base and initial adapters when given."""

    def __init__(self, bundle: Any, args: Any, device: Any = None,
                 variables: Optional[Dict[str, Any]] = None,
                 adapters: Optional[Dict[str, Any]] = None) -> None:
        cfg = llm_config_from_args(args)
        if bool(getattr(args, "fed_llm_serve_eval", False)):
            raise NotImplementedError(
                "fed_llm_serve_eval (the round-boundary serving probe on "
                "serving/llm_engine) is not ported yet (port item A17)")
        super().__init__(bundle, args)
        self.bundle = bundle
        self.cfg = cfg
        seed = int(getattr(args, "random_seed", 0) or 0)
        # built exactly as every silo's trainer: the same base parameters
        # and initial adapters
        self._ref = LLMTrainer(bundle, cfg, seed=seed, device=device,
                               variables=variables, adapters=adapters)
        self.device = self._ref.device
        self.params = self._ref.lora
        if not self.params:
            raise ValueError(
                "fed_llm: no LoRA targets matched any 2D kernel of model "
                f"{getattr(args, 'model', None)!r} — check --lora-targets")
        self._delta_round = make_delta_round(cfg.lora_alpha)
        self._eval = build_eval_step(bundle)
        self.batch_size = int(getattr(args, "batch_size", 32))
        #: merged-parameters cache, valid while the global IS the tree the
        #: last delta_round produced
        self._merged: Any = None
        self._merged_for: Any = None
        self._loss_history: List[float] = []
        self._test_batches: Optional[Tuple[Any, Dict[str, torch.Tensor]]] \
            = None
        logging.info("fed_llm server: %d adapter params over %d targets "
                     "(rank %d)", count_trainable(self.params),
                     len(self.params), cfg.lora_rank)

    def base_params(self) -> Any:
        """The frozen base parameters (flax names and layouts)."""
        return self._ref.variables["params"]

    # -- aggregation ---------------------------------------------------------
    def aggregate(self, raw_client_model_or_grad_list: List[Tuple[float, Any]]
                  ) -> Any:
        gl = self.get_model_params()
        deltas = [(n, _tree_sub(tree, gl))
                  for n, tree in raw_client_model_or_grad_list]
        agg_delta = FedMLAggOperator.agg(self.args, deltas,
                                         center=zeros_like_adapters(gl))
        new_adapters, merged = self._delta_round(gl, self.base_params(),
                                                 agg_delta, 1.0)
        self._merged, self._merged_for = merged, new_adapters
        return new_adapters

    def _merged_params(self) -> Any:
        """Base + current global adapters: the cached merge while the
        global is the tree the last ``aggregate`` produced, else the same
        step at ``server_lr`` 0 (the fold is then the identity)."""
        gl = self.get_model_params()
        if self._merged is not None and self._merged_for is gl:
            return self._merged
        new_adapters, merged = self._delta_round(
            gl, self.base_params(), zeros_like_adapters(gl), 0.0)
        self.set_model_params(new_adapters)
        self._merged, self._merged_for = merged, new_adapters
        return merged

    # -- round-boundary eval -------------------------------------------------
    def test(self, test_data, device=None, args=None) -> Dict[str, Any]:
        merged = self._merged_params()
        if self._test_batches is None or self._test_batches[0] is not \
                test_data:
            nb = max(1, -(-len(test_data[1]) // self.batch_size))
            self._test_batches = (test_data, batches_for(
                test_data, self.batch_size, nb, self.bundle.input_dtype,
                self.device))
        with self.bundle.lock:
            flat = self.bundle.bind(self.device)
            base = flat.snapshot()
            try:
                load_tree({"params": merged}, self.bundle.module)
                out = self._eval(self._test_batches[1])
            finally:
                flat.load(base)
        n = max(float(out["n"]), 1.0)
        m: Dict[str, Any] = {
            "test_loss": float(out["loss_sum"]) / n,
            "test_acc": float(out["correct"]) / n,
            "test_total": n,
            "adapter_params": count_trainable(self.get_model_params()),
        }
        self._loss_history.append(m["test_loss"])
        # the whole trajectory rides on every metrics dict: INPROC runs
        # return only the last one
        m["server_loss_history"] = list(self._loss_history)
        return m
