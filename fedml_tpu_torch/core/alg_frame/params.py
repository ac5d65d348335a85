"""Params / Context — the algorithm-frame data plumbing.

Port of ``fedml_tpu/core/alg_frame/params.py``: ``Params``, a kwargs bag
passed between flow executors and hooks, and ``Context``, the process-wide
singleton blackboard the SP simulation publishes each round's client ids
and models on (reference ``core/alg_frame/context.py:19``).  Model payloads
are trees of tensors in the JAX package's layout.
"""

from __future__ import annotations

from typing import Any


class Params:
    """A kwargs bag passed between flow executors and hooks."""

    def __init__(self, **kwargs: Any) -> None:
        self.__dict__.update(kwargs)

    def add(self, name: str, value: Any) -> "Params":
        self.__dict__[name] = value
        return self

    def get(self, name: str, default: Any = None) -> Any:
        return self.__dict__.get(name, default)

    def remove(self, name: str) -> None:
        self.__dict__.pop(name, None)

    def keys(self):
        return self.__dict__.keys()

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__


class Context(Params):
    """Process-wide singleton blackboard: side-band data (each round's
    client ids and models, the metrics of the last and the aggregated
    model) without widening the ``aggregate()`` signature."""

    _instance: "Context" = None

    KEY_TEST_DATA = "test_data"
    KEY_METRICS_ON_LAST_ROUND = "metrics_on_last_round"
    KEY_METRICS_ON_AGGREGATED_MODEL = "metrics_on_aggregated_model"
    KEY_CLIENT_MODEL_LIST = "client_model_list"
    KEY_CLIENT_ID_LIST_IN_THIS_ROUND = "client_id_list_in_this_round"
    KEY_CLIENT_NUM_PER_ROUND = "client_num_per_round"

    def __new__(cls) -> "Context":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None
