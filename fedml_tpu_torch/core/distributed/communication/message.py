"""Message — the typed key-value envelope of the control plane.

Port of ``fedml_tpu/core/distributed/communication/message.py``: sender and
receiver ids, the message type, and a params dict whose values may be
trees of tensors.  The INPROC transport passes a message by reference, so
a receiver must not write into a tensor it received.
"""

from __future__ import annotations

from typing import Any, Dict


class Message:
    MSG_ARG_KEY_TYPE = "msg_type"
    MSG_ARG_KEY_SENDER = "sender"
    MSG_ARG_KEY_RECEIVER = "receiver"

    def __init__(self, type: Any = 0, sender_id: int = 0,
                 receiver_id: int = 0) -> None:
        self.type = str(type)
        self.sender_id = int(sender_id)
        self.receiver_id = int(receiver_id)
        self.msg_params: Dict[str, Any] = {
            Message.MSG_ARG_KEY_TYPE: str(type),
            Message.MSG_ARG_KEY_SENDER: int(sender_id),
            Message.MSG_ARG_KEY_RECEIVER: int(receiver_id),
        }

    def get_sender_id(self) -> int:
        return self.sender_id

    def get_receiver_id(self) -> int:
        return self.receiver_id

    def add_params(self, key: str, value: Any) -> None:
        self.msg_params[key] = value

    def get_params(self) -> Dict[str, Any]:
        return self.msg_params

    def get(self, key: str, default: Any = None) -> Any:
        return self.msg_params.get(key, default)

    def get_type(self) -> str:
        return str(self.msg_params.get(Message.MSG_ARG_KEY_TYPE))

    def __repr__(self) -> str:
        return (f"Message(type={self.type}, {self.sender_id}->"
                f"{self.receiver_id}, keys={sorted(self.msg_params)})")
