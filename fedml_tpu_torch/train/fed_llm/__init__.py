"""The fed-LLM plane: cross-silo LoRA SFT where only adapter trees cross
the wire (port of ``fedml_tpu/train/fed_llm``, the sync cut).

* ``FedLLMTrainer`` — the ``ClientTrainer`` of a silo; its exchanged
  parameters are the adapter tree.
* ``FedLLMAggregator`` — the ``ServerAggregator`` that aggregates in delta
  space through ``FedMLAggOperator.agg`` and folds and merges through
  ``delta_round``.
* ``delta_round`` — the server's round-boundary step (fold the adapters +
  server_lr·Δ with the fold kernel, merge into the base for evaluation).
* ``config`` — flag parsing and validation at start-up.
"""

from .aggregator import FedLLMAggregator
from .config import (
    llm_config_from_args,
    parse_lora_targets,
    validate_fed_llm_args,
)
from .delta_round import make_delta_round
from .trainer import FedLLMTrainer

__all__ = [
    "FedLLMAggregator",
    "FedLLMTrainer",
    "llm_config_from_args",
    "make_delta_round",
    "parse_lora_targets",
    "validate_fed_llm_args",
]
