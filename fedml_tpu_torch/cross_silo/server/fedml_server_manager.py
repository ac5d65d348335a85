"""Cross-silo FedMLServerManager, the sync path.

Port of ``fedml_tpu/cross_silo/server/fedml_server_manager.py`` for
synchronous rounds: wait for every silo's ONLINE status (recording the
wire-codec capabilities each advertises), send the init config, collect one
upload per sampled client, aggregate, evaluate, and advance to the next
round or send FINISH.

With ``wire_compression`` set, every link whose capabilities cover the codec
receives the quantized model (int8, or bf16 for the bf16 codec) and its
uplink codec assignment.  The server encodes a round's model once
(``_enc_cache``) and decodes its own payload: that decoded broadcast is the
round's delta reference, the same bits the silos decode, and compressed
uploads are reconstructed against it.

Everything else of the JAX package's manager is left out, and its options
raise ``NotImplementedError`` naming their port item when the manager is
built (``refuse_unported``): the elastic round timer, the deadline pacer,
over-provisioning, heartbeat failure detection, late joins,
checkpoint/resume, pod drain and resize (A11), and the tracing, ledger,
SLO and flight-recorder hooks (A18).  Handlers run on the receive loop's
thread only — no timer or monitor thread touches the round state — so the
port needs none of the JAX manager's round lock.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...utils.compression import (
    WIRE_BYTES,
    WireCodec,
    decode_delta,
    parse_wire_compression,
    required_caps,
)
from ...utils.serialization import estimate_nbytes
from ..message_define import MyMessage
from .fedml_aggregator import FedMLAggregator

#: (option, what it switches on, port item) of the JAX manager's options
#: that the sync path here leaves out
_UNPORTED = (
    ("round_timeout_s", "the elastic round timer", "A11"),
    ("round_deadline_s", "the round deadline pacer", "A11"),
    ("heartbeat_interval_s", "heartbeat failure detection", "A11"),
    ("over_provision", "over-provisioned cohorts", "A11"),
    ("checkpoint_dir", "round checkpoints", "A11"),
    ("resume_from", "crash-resume", "A11"),
    ("drain_file", "pod drain at a round boundary", "A11"),
    ("resize_file", "elastic resize at a round boundary", "A11"),
    ("flight_recorder", "the flight recorder", "A18"),
    ("run_ledger", "the run ledger", "A18"),
    ("slo_rules", "the SLO engine", "A18"),
)


def refuse_unported(args: Any) -> None:
    """Raise ``NotImplementedError`` naming the port item of the first
    option in ``args`` that the sync path leaves out."""
    for key, what, item in _UNPORTED:
        val = getattr(args, key, None)
        if val not in (None, False, 0, 0.0, ""):
            raise NotImplementedError(
                f"{key}={val!r} ({what}) is not ported yet (port item "
                f"{item})")


def fleet_size(args: Any) -> int:
    """Client ranks per round: ``client_num_per_round``, capped by the
    population (the JAX package adds the over-provision margin, A11)."""
    return min(int(args.client_num_per_round),
               int(args.client_num_in_total))


class FedMLServerManager(FedMLCommManager):
    def __init__(self, args: Any, aggregator: FedMLAggregator, comm=None,
                 rank: int = 0, client_num: int = 0,
                 backend: str = "INPROC") -> None:
        refuse_unported(args)
        super().__init__(args, comm, rank, client_num + 1, backend)
        self.aggregator = aggregator
        self.round_num = int(args.comm_round)
        self.args.round_idx = 0
        self.client_num = client_num
        self.client_online_status: Dict[int, bool] = {}
        self.client_id_list_in_this_round: List[int] = []
        self.is_initialized = False
        self._wire_spec = parse_wire_compression(
            getattr(args, "wire_compression", None))
        self._peer_caps: Dict[int, tuple] = {}
        #: the round's delta reference: the decoded broadcast on codec
        #: links, the raw global otherwise
        self._round_ref: Optional[Any] = None
        #: (round_idx, enc_payload, decoded): one encode per round
        self._enc_cache: Optional[tuple] = None
        self._run_label = str(getattr(args, "run_id", "0"))
        #: client-reported training metrics of the round in flight, by rank
        self._round_train_metrics: Dict[int, Dict] = {}
        self._round_t0 = 0.0
        #: every round: its index, seconds from broadcast to aggregated,
        #: samples trained and the clients' mean train loss
        self.round_history: List[Dict[str, Any]] = []

    # -- protocol ------------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_CLIENT_STATUS,
            self.handle_message_client_status_update)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_receive_model_from_client)

    def handle_message_client_status_update(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        status = msg.get(MyMessage.MSG_ARG_KEY_CLIENT_STATUS)
        caps = msg.get(MyMessage.MSG_ARG_KEY_WIRE_CAPS)
        if caps:
            self._peer_caps[sender] = tuple(str(c) for c in caps)
        if status == MyMessage.CLIENT_STATUS_ONLINE:
            self.client_online_status[sender] = True
        logging.info("server: client %d (%s) status %s (%d/%d online)",
                     sender, msg.get(MyMessage.MSG_ARG_KEY_CLIENT_OS,
                                     "unknown"), status,
                     sum(self.client_online_status.values()), self.client_num)
        if self.is_initialized:
            # a re-announce after the start: late joins are A11's
            logging.warning("server: ignoring status from client %d after "
                            "the start", sender)
        elif len(self.client_online_status) == self.client_num:
            self.is_initialized = True
            self.send_init_msg()

    def send_init_msg(self) -> None:
        self.client_id_list_in_this_round = self.aggregator.client_sampling(
            self.args.round_idx, int(self.args.client_num_in_total),
            self.client_num)
        self._broadcast_round()

    def _link_codec(self, rank: int) -> bool:
        """True when this link negotiated the configured wire codec: the
        peer's capability tokens cover it and the quantized downlink."""
        if self._wire_spec is None:
            return False
        caps = set(self._peer_caps.get(rank, ()))
        need = set(required_caps(self._wire_spec))
        need.add("bf16" if self._wire_spec.kind == "bf16" else "int8")
        return need.issubset(caps)

    def _broadcast_round(self) -> None:
        """Send the round's model to every participating rank.  With a
        wire codec negotiated, codec links receive the quantized model and
        their uplink codec; the decoded broadcast becomes the round's delta
        reference on both ends."""
        self._round_t0 = time.perf_counter()
        mtype = (MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT
                 if self.args.round_idx else
                 MyMessage.MSG_TYPE_S2C_INIT_CONFIG)
        global_model = self.aggregator.get_global_model_params()
        enc_payload = None
        if self._wire_spec is not None:
            version = int(self.args.round_idx)
            if self._enc_cache is not None and self._enc_cache[0] == version:
                _, enc_payload, decoded = self._enc_cache
            else:
                enc_payload = WireCodec.encode_model(
                    global_model,
                    "bf16" if self._wire_spec.kind == "bf16" else "int8")
                decoded = WireCodec.decode_model(enc_payload)
                self._enc_cache = (version, enc_payload, decoded)
            self._round_ref = decoded
        else:
            self._round_ref = global_model
        for i, rank in enumerate(
                self._ranks_for(self.client_id_list_in_this_round)):
            use_codec = enc_payload is not None and self._link_codec(rank)
            payload = enc_payload if use_codec else global_model
            msg = Message(mtype, self.get_sender_id(), rank)
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, payload)
            if use_codec:
                msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_ENCODED, True)
                msg.add_params(MyMessage.MSG_ARG_KEY_WIRE_CODEC,
                               str(getattr(self.args, "wire_compression")))
            WIRE_BYTES.inc(self._run_label, "down",
                           self._wire_spec.kind if use_codec else "raw",
                           estimate_nbytes(payload))
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX,
                           self.client_id_list_in_this_round[i])
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.args.round_idx)
            self.send_message(msg)

    def _ranks_for(self, client_ids: List[int]) -> List[int]:
        """Client slots → comm ranks 1..client_num."""
        return [1 + (i % self.client_num) for i in range(len(client_ids))]

    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        upload_round = msg.get(MyMessage.MSG_ARG_KEY_ROUND)
        if (upload_round is not None
                and int(upload_round) != int(self.args.round_idx)):
            logging.warning("server: dropping stale round-%s upload from "
                            "client %d (now round %d)", upload_round, sender,
                            self.args.round_idx)
            return
        model_params = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        wire_update = msg.get(MyMessage.MSG_ARG_KEY_WIRE_UPDATE)
        if model_params is None and wire_update is not None:
            # the negotiated codec: weights = round reference + decoded delta
            ref = (self._round_ref if self._round_ref is not None
                   else self.aggregator.get_global_model_params())
            model_params = decode_delta(wire_update, ref)
        if model_params is None:
            raise NotImplementedError(
                f"client {sender} uploaded neither parameters nor a wire "
                f"payload (the sparse compressed_update leg is port item "
                f"A11)")
        train_metrics = msg.get(MyMessage.MSG_ARG_KEY_TRAIN_METRICS)
        if isinstance(train_metrics, dict) and train_metrics:
            self._round_train_metrics[sender] = train_metrics
        self.client_online_status[sender] = True
        self.aggregator.add_local_trained_result(
            sender - 1, model_params,
            msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES))
        if self.aggregator.check_whether_all_receive():
            self._complete_round()

    def _complete_round(self) -> None:
        """Aggregate, evaluate at the test frequency or on the last round,
        then start the next round or finish."""
        n_samples = self.aggregator.received_samples()
        self.aggregator.aggregate()
        round_s = time.perf_counter() - self._round_t0
        freq = int(getattr(self.args, "frequency_of_the_test", 1) or 1)
        if (self.args.round_idx % freq == 0
                or self.args.round_idx == self.round_num - 1):
            self.aggregator.test_on_server_for_all_clients(
                self.args.round_idx)
        losses = [m.get("train_loss")
                  for m in self._round_train_metrics.values()
                  if isinstance(m.get("train_loss"), (int, float))]
        self._round_train_metrics = {}
        self.round_history.append({
            "round": int(self.args.round_idx), "seconds": round_s,
            "samples": float(n_samples),
            "train_loss": sum(losses) / len(losses) if losses else None})
        self.args.round_idx += 1
        if self.args.round_idx >= self.round_num:
            self.send_finish_to_all()
            self.finish()
            return
        self.client_id_list_in_this_round = self.aggregator.client_sampling(
            self.args.round_idx, int(self.args.client_num_in_total),
            self.client_num)
        self._broadcast_round()

    def send_finish_to_all(self) -> None:
        for rank in range(1, self.client_num + 1):
            self.send_message(Message(MyMessage.MSG_TYPE_S2C_FINISH,
                                      self.get_sender_id(), rank))
