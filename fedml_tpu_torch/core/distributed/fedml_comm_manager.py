"""FedMLCommManager — the node runtime.

Port of ``fedml_tpu/core/distributed/fedml_comm_manager.py``: a msg_type →
handler registry, a blocking ``run()`` over the transport's receive loop,
``send_message`` and ``finish()``.  The port's one transport is INPROC
(``backend: INPROC``); every other backend — GRPC, MQTT_S3 and its
variants, MPI, custom backends — and the reliability runtime
(``reliable: true``) raise ``NotImplementedError`` naming port item A11.
The wire-contract audit hook is not ported.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from .communication.base_com_manager import BaseCommunicationManager
from .communication.inprocess import InProcCommManager, InProcHub
from .communication.message import Message
from .communication.observer import Observer


class FedMLCommManager(Observer):
    def __init__(self, args: Any, comm: Any = None, rank: int = 0,
                 size: int = 0, backend: str = "INPROC") -> None:
        self.args = args
        self.size = int(size)
        self.rank = int(rank)
        self.backend = backend
        self.comm = comm
        self.com_manager: Optional[BaseCommunicationManager] = None
        self.message_handler_dict: Dict[str, Callable[[Message], None]] = {}
        self._init_manager()

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> None:
        self.register_message_receive_handlers()
        logging.debug("rank %d running (%s)", self.rank, self.backend)
        self.com_manager.handle_receive_message()
        logging.debug("rank %d done", self.rank)

    def finish(self) -> None:
        logging.debug("rank %d finishing", self.rank)
        self.com_manager.stop_receive_message()
        InProcHub.release(self.com_manager.channel, self.com_manager.hub)

    # -- messaging -----------------------------------------------------------
    def get_sender_id(self) -> int:
        return self.rank

    def send_message(self, message: Message) -> None:
        self.com_manager.send_message(message)

    def register_message_receive_handler(self, msg_type: Any,
                                         handler: Callable[[Message], None]
                                         ) -> None:
        self.message_handler_dict[str(msg_type)] = handler

    def register_message_receive_handlers(self) -> None:
        """Subclasses register their typed handlers here."""

    def receive_message(self, msg_type: str, msg_params: Message) -> None:
        handler = self.message_handler_dict.get(str(msg_type))
        if handler is None:
            logging.warning("rank %d: no handler for msg_type %s",
                            self.rank, msg_type)
            return
        try:
            handler(msg_params)
        except Exception:
            # a crashing handler must not strand the fleet: release this
            # node's receive loop before propagating, or every peer blocked
            # on a reply from it waits forever
            logging.exception("rank %d: handler for %s raised — closing "
                              "the receive loop", self.rank, msg_type)
            self.finish()
            raise

    # -- backend factory -----------------------------------------------------
    def _init_manager(self) -> None:
        backend = str(self.backend).upper()
        if backend != "INPROC":
            raise NotImplementedError(
                f"comm backend {self.backend!r} is not ported yet (port item "
                f"A11); the PyTorch port runs INPROC")
        if getattr(self.args, "reliable", False):
            raise NotImplementedError(
                "the reliability runtime (reliable: true) is not ported yet "
                "(port item A11)")
        channel = str(getattr(self.args, "run_id", "default"))
        self.com_manager = InProcCommManager(self.rank, self.size, channel)
        self.com_manager.add_observer(self)
