"""Cross-silo message schema.

Port of ``fedml_tpu/cross_silo/message_define.py`` for the sync path: the
same message types and payload keys as the JAX package's, so a message
means the same in both packages.
"""


class MyMessage:
    # handshake
    MSG_TYPE_C2S_CLIENT_STATUS = "C2S_CLIENT_STATUS"

    # training round-trip
    MSG_TYPE_S2C_INIT_CONFIG = "S2C_INIT_CONFIG"
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = "S2C_SYNC_MODEL_TO_CLIENT"
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = "C2S_SEND_MODEL_TO_SERVER"
    MSG_TYPE_S2C_FINISH = "S2C_FINISH"

    # payload keys
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_ROUND = "round_idx"
    MSG_ARG_KEY_CLIENT_STATUS = "client_status"
    MSG_ARG_KEY_CLIENT_OS = "client_os"
    MSG_ARG_KEY_TRAIN_METRICS = "train_metrics"
    # wire-compression negotiation: clients advertise codec capability
    # tokens on their status message; the server assigns a codec per link
    # on every round broadcast (only when the link's tokens cover it).
    # Compressed uploads travel as a self-describing delta payload;
    # compressed broadcasts replace the model tree with per-leaf quantized
    # marker dicts and set the MODEL_ENCODED flag
    MSG_ARG_KEY_WIRE_CAPS = "wire_caps"
    MSG_ARG_KEY_WIRE_CODEC = "wire_codec"
    MSG_ARG_KEY_WIRE_UPDATE = "wire_update"
    MSG_ARG_KEY_MODEL_ENCODED = "model_wq"

    CLIENT_STATUS_ONLINE = "ONLINE"
