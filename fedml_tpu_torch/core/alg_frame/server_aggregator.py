"""ServerAggregator — the server-side aggregation contract with hooks.

Port of ``fedml_tpu/core/alg_frame/server_aggregator.py``: client results
arrive as a list of ``(n_samples, tree)`` and ``aggregate`` reduces them
with ``FedMLAggOperator.agg``.  The hooks' work in the JAX package —
global DP clipping and noise, model attacks, defenses, FHE aggregation and
contribution assessment — is port item A13: the aggregator refuses those
options when it is built, so ``on_before_aggregation`` and
``on_after_aggregation`` pass their input through.
"""

from __future__ import annotations

import abc
from typing import Any, List, Tuple

from ...ml.aggregator.agg_operator import FedMLAggOperator
from .client_trainer import refuse_privacy_options


class ServerAggregator(abc.ABC):
    """Abstract server aggregator (user-overridable)."""

    def __init__(self, model: Any, args: Any) -> None:
        refuse_privacy_options(args)
        self.model = model
        self.params: Any = None
        self.args = args

    def get_model_params(self) -> Any:
        return self.params

    def set_model_params(self, model_parameters: Any) -> None:
        self.params = model_parameters

    def on_before_aggregation(
        self, raw_client_model_or_grad_list: List[Tuple[float, Any]]
    ) -> List[Tuple[float, Any]]:
        return raw_client_model_or_grad_list

    def aggregate(self, raw_client_model_or_grad_list: List[Tuple[float, Any]]
                  ) -> Any:
        return FedMLAggOperator.agg(self.args, raw_client_model_or_grad_list,
                                    center=self.get_model_params())

    def on_after_aggregation(self, aggregated_model_or_grad: Any) -> Any:
        return aggregated_model_or_grad

    @abc.abstractmethod
    def test(self, test_data, device=None, args=None) -> Any:
        """Evaluate ``self.params`` on test data; returns a metrics dict."""
