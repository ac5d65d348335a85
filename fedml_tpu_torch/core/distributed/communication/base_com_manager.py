"""BaseCommunicationManager (port of
``fedml_tpu/core/distributed/communication/base_com_manager.py``)."""

from __future__ import annotations

import abc

from .message import Message
from .observer import Observer


class BaseCommunicationManager(abc.ABC):
    @abc.abstractmethod
    def send_message(self, msg: Message) -> None:
        ...

    @abc.abstractmethod
    def add_observer(self, observer: Observer) -> None:
        ...

    @abc.abstractmethod
    def remove_observer(self, observer: Observer) -> None:
        ...

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Blocking receive loop; dispatches to observers."""

    @abc.abstractmethod
    def stop_receive_message(self) -> None:
        ...
