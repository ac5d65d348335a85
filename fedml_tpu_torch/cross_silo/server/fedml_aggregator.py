"""Cross-silo server-side aggregation state.

Port of ``fedml_tpu/cross_silo/server/fedml_aggregator.py`` for the sync
path: the round's received set (keep-first on duplicates),
``aggregate`` over the reporting clients in sorted index order, the
deterministic cohort draw (``client_sampling``: the JAX package's numpy
stream, keyed by run id, seed and round) and the server-side
evaluation.  Upload admission control (``admission_control``)
is port item A11 and raises; the async buffer fold, crash-resume state and
FHE are not ported.
"""

from __future__ import annotations

import logging
import zlib
from typing import Any, Dict, List

import numpy as np


class FedMLAggregator:
    def __init__(self, args: Any, aggregator, test_global) -> None:
        if getattr(args, "admission_control", False):
            raise NotImplementedError(
                "upload admission control is not ported yet (port item A11)")
        self.args = args
        self.aggregator = aggregator            # ServerAggregator impl
        self.test_global = test_global
        self.client_num = int(args.client_num_per_round)
        self.model_dict: Dict[int, Any] = {}
        self.sample_num_dict: Dict[int, float] = {}
        self._received_this_round: set = set()
        self.metrics_history: List[Dict[str, Any]] = []
        #: a second upload counted for the same index in the same round
        self.duplicate_uploads = 0
        self._run_label = str(getattr(args, "run_id", "0"))

    def get_global_model_params(self):
        return self.aggregator.get_model_params()

    def add_local_trained_result(self, index: int, model_params,
                                 sample_num) -> None:
        """Admit one upload into the round's received set.  Keep-first: a
        second upload for an index already counted this round is counted
        as a duplicate and never replaces the first."""
        if index in self._received_this_round:
            self.duplicate_uploads += 1
            return None
        self.model_dict[index] = model_params
        self.sample_num_dict[index] = float(sample_num)
        self._received_this_round.add(index)
        return None

    def receive_count(self) -> int:
        return len(self._received_this_round)

    def has_received(self, index: int) -> bool:
        return index in self._received_this_round

    def received_samples(self) -> float:
        """The sample counts of this round's uploads, summed."""
        return float(sum(self.sample_num_dict[i]
                         for i in self._received_this_round))

    def check_whether_all_receive(self) -> bool:
        return len(self._received_this_round) >= self.client_num

    def aggregate(self) -> Any:
        """Aggregate the clients that reported this round, in sorted index
        order, and clear the received set for the next round."""
        idxs = sorted(self._received_this_round)
        self._received_this_round = set()
        raw = [(self.sample_num_dict[i], self.model_dict[i]) for i in idxs]
        raw = self.aggregator.on_before_aggregation(raw)
        agg = self.aggregator.aggregate(raw)
        agg = self.aggregator.on_after_aggregation(agg)
        self.aggregator.set_model_params(agg)
        return agg

    # -- selection -----------------------------------------------------------
    def _round_rng(self, round_idx: int, stream: int) -> np.random.Generator:
        """A private generator per ``(run_id, random_seed, round_idx,
        stream)``: the cohort is a pure function of the run's identity."""
        seq = np.random.SeedSequence([
            zlib.crc32(self._run_label.encode()),
            int(getattr(self.args, "random_seed", 0) or 0),
            int(round_idx), int(stream)])
        return np.random.default_rng(seq)

    def client_sampling(self, round_idx: int, client_num_in_total: int,
                        client_num_per_round: int) -> List[int]:
        if client_num_in_total <= client_num_per_round:
            return list(range(client_num_in_total))
        rng = self._round_rng(round_idx, stream=0)
        return [int(c) for c in rng.choice(
            client_num_in_total, client_num_per_round, replace=False)]

    def test_on_server_for_all_clients(self, round_idx: int
                                       ) -> Dict[str, Any]:
        metrics = self.aggregator.test(self.test_global, None, self.args)
        metrics["round"] = round_idx
        self.metrics_history.append(metrics)
        logging.info("cross-silo round %d server eval: %s", round_idx,
                     metrics)
        return metrics
