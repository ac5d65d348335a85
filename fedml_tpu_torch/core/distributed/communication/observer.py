"""Observer interface (port of
``fedml_tpu/core/distributed/communication/observer.py``)."""

from __future__ import annotations

import abc
from typing import Any


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type: str, msg_params: Any) -> None:
        ...
