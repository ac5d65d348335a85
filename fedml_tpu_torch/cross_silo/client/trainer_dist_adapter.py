"""TrainerDistAdapter — the silo's training adapter.

Port of ``fedml_tpu/cross_silo/client/trainer_dist_adapter.py`` for the
horizontal scenario: it owns the silo's trainer, points it at the client
index the server assigns each round, fixes the padded batch count for
every silo (the largest silo's), and returns ``(params, n_samples)``.
With ``fed_llm`` the silo's trainer is ``train/fed_llm.FedLLMTrainer``
(local LoRA SFT; the exchanged parameters are the adapter tree).  The
hierarchical scenario (a data-parallel mesh inside a silo) is port item
A11 and raises.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ...constants import CROSS_SILO_SCENARIO_HIERARCHICAL
from ...ml.trainer.default_trainer import DefaultClientTrainer


class TrainerDistAdapter:
    def __init__(self, args: Any, device: Any, bundle: Any, dataset: Tuple,
                 client_trainer: Optional[Any] = None) -> None:
        self.args = args
        (self.train_num, self.test_num, self.train_global, self.test_global,
         self.local_num_dict, self.train_data_local_dict,
         self.test_data_local_dict, self.class_num) = dataset
        if str(getattr(args, "scenario", "horizontal")) == \
                CROSS_SILO_SCENARIO_HIERARCHICAL:
            raise NotImplementedError(
                "the hierarchical cross-silo scenario is not ported yet "
                "(port item A11)")
        if client_trainer is None and bool(getattr(args, "fed_llm", False)):
            from ...train.fed_llm import FedLLMTrainer
            client_trainer = FedLLMTrainer(bundle, args, device)
        self.trainer = client_trainer or DefaultClientTrainer(bundle, args,
                                                              device)
        bs = int(getattr(args, "batch_size", 32))
        max_n = max(self.local_num_dict.values()) if self.local_num_dict \
            else bs
        self.trainer.set_num_batches(max(1, -(-int(max_n) // bs)))

    def update_dataset(self, client_index: int) -> None:
        self.client_index = int(client_index)
        self.trainer.set_id(self.client_index)
        self.trainer.update_dataset(
            self.train_data_local_dict[self.client_index],
            self.test_data_local_dict[self.client_index],
            self.local_num_dict[self.client_index])

    def update_model(self, model_params: Any) -> None:
        self.trainer.set_model_params(model_params)

    def train(self, round_idx: int) -> Tuple[Any, float]:
        self.trainer.on_before_local_training(
            self.trainer.local_train_dataset, None, self.args)
        self.trainer.train(self.trainer.local_train_dataset, None, self.args)
        self.trainer.on_after_local_training(
            self.trainer.local_train_dataset, None, self.args)
        return (self.trainer.get_model_params(),
                float(self.trainer.local_sample_number))
