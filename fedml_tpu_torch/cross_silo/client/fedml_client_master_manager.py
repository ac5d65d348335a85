"""Cross-silo ClientMasterManager.

Port of ``fedml_tpu/cross_silo/client/fedml_client_master_manager.py``:
announce the silo online with its wire-codec capabilities, handle INIT,
SYNC and FINISH, train through the ``TrainerDistAdapter`` and upload —
raw parameters, or, when the server assigned a codec, the encoded delta
against the decoded broadcast with the error-feedback residual.

Not ported: heartbeats (``heartbeat_interval_s`` > 0, port item A11), the
sparse ``enable_compression`` upload leg (A11), and the tracing and mlops
hooks (A18); the first two raise when the manager is built.
"""

from __future__ import annotations

import logging
from typing import Any

from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...utils.compression import WIRE_BYTES, WIRE_CAPS, WireCodec
from ...utils.serialization import estimate_nbytes
from ..message_define import MyMessage
from .trainer_dist_adapter import TrainerDistAdapter


class ClientMasterManager(FedMLCommManager):
    def __init__(self, args: Any, trainer_dist_adapter: TrainerDistAdapter,
                 comm=None, rank: int = 0, size: int = 0,
                 backend: str = "INPROC") -> None:
        if float(getattr(args, "heartbeat_interval_s", 0) or 0) > 0:
            raise NotImplementedError(
                "client heartbeats (heartbeat_interval_s > 0) are not ported "
                "yet (port item A11)")
        if getattr(args, "enable_compression", False):
            raise NotImplementedError(
                "the sparse enable_compression upload is not ported yet "
                "(port item A11); wire_compression is")
        super().__init__(args, comm, rank, size, backend)
        self.trainer_dist_adapter = trainer_dist_adapter
        #: the uplink codec the server assigned on the last broadcast (None
        #: for raw uploads); one instance per assignment, so the
        #: error-feedback residual carries across rounds
        self._wire_codec = None
        self._wire_codec_spec: str = ""
        self.round_idx = 0

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
            self.handle_message_receive_model_from_server)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_FINISH, self.handle_message_finish)

    def run(self) -> None:
        self.register_message_receive_handlers()
        self.send_client_status(0)
        self.com_manager.handle_receive_message()

    # -- protocol ------------------------------------------------------------
    def send_client_status(self, receiver_id: int,
                           status: str = MyMessage.CLIENT_STATUS_ONLINE
                           ) -> None:
        msg = Message(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS,
                      self.get_sender_id(), receiver_id)
        msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_STATUS, status)
        msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_OS, "python")
        # capability advertisement: the server only assigns a wire codec
        # this build can encode and decode
        msg.add_params(MyMessage.MSG_ARG_KEY_WIRE_CAPS, list(WIRE_CAPS))
        self.send_message(msg)

    def _unpack_broadcast(self, msg: Message) -> Any:
        """Model payload → tree, honouring the server's codec assignment.
        The decoded tree doubles as the delta reference of compressed
        uploads: the same bits as the server's copy by construction."""
        global_model = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        if msg.get(MyMessage.MSG_ARG_KEY_MODEL_ENCODED):
            global_model = WireCodec.decode_model(global_model)
        codec_spec = msg.get(MyMessage.MSG_ARG_KEY_WIRE_CODEC)
        if codec_spec and str(codec_spec) != self._wire_codec_spec:
            self._wire_codec = WireCodec(str(codec_spec))
            self._wire_codec_spec = str(codec_spec)
        elif not codec_spec:
            self._wire_codec = None
            self._wire_codec_spec = ""
        return global_model

    def handle_message_init(self, msg: Message) -> None:
        global_model = self._unpack_broadcast(msg)
        self.round_idx = int(msg.get(MyMessage.MSG_ARG_KEY_ROUND, 0))
        self._train_and_upload(global_model,
                               msg.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX))

    def handle_message_receive_model_from_server(self, msg: Message) -> None:
        global_model = self._unpack_broadcast(msg)
        self.round_idx = int(msg.get(MyMessage.MSG_ARG_KEY_ROUND,
                                     self.round_idx + 1))
        self._train_and_upload(global_model,
                               msg.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX))

    def handle_message_finish(self, msg: Message) -> None:
        logging.info("client %d: finish", self.rank)
        self.finish()

    def _train_and_upload(self, global_model: Any, client_index: int) -> None:
        self.trainer_dist_adapter.update_dataset(int(client_index))
        self.trainer_dist_adapter.update_model(global_model)
        weights, n_samples = self.trainer_dist_adapter.train(self.round_idx)
        msg = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
                      self.get_sender_id(), 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
        run_id = str(getattr(self.args, "run_id", "0"))
        if self._wire_codec is not None:
            # the negotiated codec: delta(weights, received global) through
            # quantize or sparsify with client-side error feedback; the
            # server reconstructs against its identical reference
            payload = self._wire_codec.encode_delta(weights, global_model)
            msg.add_params(MyMessage.MSG_ARG_KEY_WIRE_UPDATE, payload)
            WIRE_BYTES.inc(run_id, "up", self._wire_codec.spec.kind,
                           estimate_nbytes(payload))
        else:
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, weights)
            WIRE_BYTES.inc(run_id, "up", "raw", estimate_nbytes(weights))
        msg.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, n_samples)
        msg.add_params(MyMessage.MSG_ARG_KEY_TRAIN_METRICS,
                       getattr(self.trainer_dist_adapter.trainer,
                               "last_metrics", {}))
        self.send_message(msg)
