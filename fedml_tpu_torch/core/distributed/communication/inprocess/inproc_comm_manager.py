"""In-process transport.

Port of ``fedml_tpu/core/distributed/communication/inprocess/
inproc_comm_manager.py``: every rank of a run gets a queue on a hub shared
by the run (one hub per channel, the run id); send = enqueue on the
receiver's queue; the receive loop = blocking dequeue + observer dispatch.
The whole cross-silo protocol then runs in one process, one thread per
node, with messages passed by reference.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List

from ..base_com_manager import BaseCommunicationManager
from ..message import Message
from ..observer import Observer

_STOP = object()


class InProcHub:
    """Shared mailbox set, one queue per rank.  Thread-safe."""

    _hubs: Dict[str, "InProcHub"] = {}
    _lock = threading.Lock()

    def __init__(self) -> None:
        self.queues: Dict[int, "queue.Queue"] = {}
        self._qlock = threading.Lock()

    @classmethod
    def get(cls, channel: str = "default") -> "InProcHub":
        with cls._lock:
            hub = cls._hubs.get(channel)
            if hub is None:
                hub = cls._hubs[channel] = InProcHub()
            return hub

    @classmethod
    def release(cls, channel: str, hub: "InProcHub") -> None:
        """Drop ``channel`` from the registry only if it still maps to
        ``hub``: a finishing node calls this so that a run's stale queued
        messages cannot leak into a later run of the same run id, while a
        new run that already re-created the channel is left alone."""
        with cls._lock:
            if cls._hubs.get(channel) is hub:
                cls._hubs.pop(channel, None)

    def queue_for(self, rank: int) -> "queue.Queue":
        with self._qlock:
            q = self.queues.get(rank)
            if q is None:
                q = self.queues[rank] = queue.Queue()
            return q


class InProcCommManager(BaseCommunicationManager):
    def __init__(self, rank: int, size: int, channel: str = "default") -> None:
        self.rank = int(rank)
        self.size = int(size)
        self.channel = str(channel)
        self.hub = InProcHub.get(channel)
        self._observers: List[Observer] = []
        self._running = False

    def send_message(self, msg: Message) -> None:
        self.hub.queue_for(msg.get_receiver_id()).put(msg)

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        self._running = True
        q = self.hub.queue_for(self.rank)
        while self._running:
            msg = q.get()
            if msg is _STOP:
                if self._running:
                    # a stale sentinel of an earlier incarnation of this
                    # rank on this channel: skip it
                    continue
                break
            for obs in list(self._observers):
                obs.receive_message(msg.get_type(), msg)

    def stop_receive_message(self) -> None:
        self._running = False
        self.hub.queue_for(self.rank).put(_STOP)
