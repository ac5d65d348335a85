"""Config system: YAML → flat ``Config`` namespace.

Capability parity with reference `python/fedml/arguments.py:75-110`: every key
of every YAML section becomes a top-level attribute (section-free flat
namespace), CLI ``--key value`` overrides win, and per-client override files
can be layered on (`python/fedml/__init__.py:187-211`).

Port of ``fedml_tpu/arguments.py``, kept identical (pure Python plus yaml) so
one YAML file drives both packages: defaults live in one table, and CLI
string overrides are type-coerced.  ``device_type`` selects the device:
``"cpu"`` or ``"cuda"``; unset means the card.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml

from .constants import (
    FED_OPT_FEDAVG,
    SIMULATION_BACKEND_SP,
    TRAINING_PLATFORM_SIMULATION,
)

# Defaults mirror the canonical config schema surveyed from
# `python/examples/federate/quick_start/parrot/fedml_config.yaml`.
_DEFAULTS: Dict[str, Any] = {
    # common_args
    "training_type": TRAINING_PLATFORM_SIMULATION,
    "random_seed": 0,
    "run_id": "0",
    "rank": 0,
    "role": "server",
    # data_args
    "dataset": "synthetic",
    "data_cache_dir": os.path.expanduser("~/.cache/fedml_tpu/data"),
    "partition_method": "hetero",
    "partition_alpha": 0.5,
    # model_args
    "model": "lr",
    # train_args
    "federated_optimizer": FED_OPT_FEDAVG,
    "client_id_list": None,
    "client_num_in_total": 10,
    "client_num_per_round": 10,
    "comm_round": 10,
    "epochs": 1,
    "batch_size": 32,
    "client_optimizer": "sgd",
    "learning_rate": 0.03,
    "weight_decay": 0.0,
    "momentum": 0.0,
    "server_optimizer": "adam",      # FedOpt
    "server_lr": 1e-3,
    "server_momentum": 0.9,
    # fused round epilogue (ops/epilogue.py): reduce + mix + server-opt
    # + cast-back as one pass per leaf on every aggregation funnel; off
    # → the legacy separately-materialized chain (A/B via bench.py
    # --epilogue)
    "fused_epilogue": True,
    # parrot warm pool: background-precompile the round/bucketed/fused
    # step executables into the shared AOT cache at startup (also env
    # FEDML_TPU_COMPILE_AHEAD=1)
    "parrot_compile_ahead": False,
    "fedprox_mu": 0.1,
    "feddyn_alpha": 0.01,
    # validation_args
    "frequency_of_the_test": 5,
    # device_args
    "using_gpu": False,
    "device_type": None,             # None (the card) | cuda | cpu
    "mesh_shape": None,              # e.g. {"clients": 8} or {"data": 4, "model": 2}
    # comm_args
    "backend": SIMULATION_BACKEND_SP,
    "grpc_ipconfig_path": None,
    "grpc_base_port": 8890,
    "grpc_send_retries": 3,
    "grpc_retry_backoff_s": 0.5,
    "grpc_send_timeout_s": 600.0,
    # robustness: reliability runtime (ACK/retransmit/dedup above any
    # backend), heartbeat failure detection, crash-resume (docs/ROBUSTNESS.md)
    "reliable": False,
    "reliable_retx_initial_s": 0.1,
    "reliable_retx_max_s": 2.0,
    "reliable_deadline_s": 30.0,
    "reliable_flush_s": 5.0,
    "reliable_dedup_window": 1024,
    "heartbeat_interval_s": 0.0,     # 0 disables the failure detector
    "heartbeat_miss_threshold": 3,
    "lsa_share_wait_s": 30.0,        # LSA share-holder give-up deadline
    "checkpoint_dir": None,          # enables per-round crash-resume state
    "resume_from": None,             # "latest" or a round index
    "round_timeout_s": 0.0,          # elastic round timer (0 disables)
    "min_clients_per_round": 1,
    # robustness: byzantine-robust data plane (docs/ROBUSTNESS.md
    # "Data-plane robustness") — robust aggregation operator selector
    # (trimmed_mean[:frac]|median|krum:f|multi_krum:f[:k]|
    #  geo_median[:iters]|norm_clip:C), upload admission control, and
    # straggler-tolerant round pacing
    "robust_agg": None,
    "admission_control": False,
    "admission_norm_bound": 0.0,     # L2 screen on ||upload - global|| (0 off)
    "admission_resolicit_max": 1,    # re-solicits per quarantined client/round
    "over_provision": 0,             # solicit K+m clients, aggregate first K
    "round_deadline_s": 0.0,         # hard round deadline (0 disables)
    "round_deadline_grace_s": 2.0,   # extension while below the floor
    "min_aggregation_clients": 1,    # deadline never closes a round below this
    # robustness: buffered-async rounds + wire compression
    # (docs/ROBUSTNESS.md "Asynchronous rounds").  async_agg folds
    # admitted uploads into a buffer as they arrive (staleness-weighted,
    # FedBuff-style) instead of waiting out a K-upload barrier; the
    # buffer flushes every async_buffer_k updates (0 → K) or
    # async_flush_s seconds (0 → count-trigger only); comm_round then
    # counts FLUSHES.  wire_compression negotiates a per-link update
    # codec: none|bf16|int8|topk[:ratio]|topk8[:ratio] (delta encoding +
    # client-side error feedback always included).
    "async_agg": False,
    "async_buffer_k": 0,             # flush after this many folded updates
    "async_flush_s": 0.0,            # flush a non-empty buffer this often
    "async_staleness": "poly:0.5",   # constant|poly[:a]|exp[:a]|hinge[:c[:a]]
    "async_staleness_cutoff": 10,    # versions; older uploads expire
    "async_server_lr": 1.0,          # global ← global + lr·(agg − global)
    "wire_compression": None,        # per-link update codec (see above)
    # fed-LLM plane (docs/FED_LLM.md) — cross-silo LoRA SFT where ONLY
    # adapter deltas cross the wire; fed_llm swaps the default trainer/
    # aggregator pair for train/fed_llm's at both seams
    "fed_llm": False,
    "lora_rank": 8,                  # adapter rank r per targeted kernel
    "lora_alpha": 16.0,              # merge scale = alpha / rank
    "lora_targets": None,            # comma-sep regexes (None → defaults)
    "fed_llm_seq_len": 32,           # packed next-token sequence length
    "fed_llm_strategy": "none",      # silo-local sharding: none|dp|fsdp
    "fed_llm_serve_eval": False,     # round-boundary llm_engine probe
    # tracking_args
    "enable_tracking": True,
    "log_file_dir": None,
    "enable_wandb": False,
    # performance flight recorder (docs/OBSERVABILITY.md): opt-in
    # round-phase attribution + measured MFU; env toggle
    # FEDML_TPU_FLIGHT_RECORDER=1 overrides
    "flight_recorder": False,
    "flight_max_records": 0,         # 0 → module default (4096)
    # run ledger (docs/OBSERVABILITY.md "Run ledger"): opt-in cross-plane
    # per-round event log + anatomy correlator; env toggle
    # FEDML_TPU_RUN_LEDGER=1 overrides
    "run_ledger": False,
    "ledger_max_records": 0,         # 0 → module default (16384)
    "trace_max_spans": 0,            # spans.jsonl cap (0 → default 16384)
    # declarative SLO engine: path to slo.yaml evaluated at round
    # boundaries (env FEDML_TPU_SLO_RULES); breaches inc
    # fedml_slo_breaches_total and ledger `breach` events
    "slo_rules": None,
    # hyper-scale simulation (backend="hyperscale", docs/HYPERSCALE.md):
    # double-buffered host→device cohort streaming over a virtual
    # 10⁵–10⁶-client population
    "stream_prefetch": 2,            # >=2 double-buffers; 1 = sequential
    "cohort_sampling": None,         # reference | hierarchical (auto)
    "availability_trace": None,      # None | "diurnal:<duty>:<period>"
    "population_sizes_path": None,   # JSON {"sizes": [...]} per-client sizes
    "population_virtual_threshold": 2048,  # N above this → virtual population
    # precision / engine
    "dtype": "float32",
    "compute_dtype": "bfloat16",
    # security / privacy toggles (reference: core/security, core/dp yaml flags)
    "enable_attack": False,
    "attack_type": None,
    "enable_defense": False,
    "defense_type": None,
    "enable_dp": False,
    "mechanism_type": "gaussian",
    "dp_solution_type": None,        # local | central | NbAFL
    "epsilon": None,
    "delta": None,
    "sigma": None,
    "max_grad_norm": None,
    # cross-silo
    "scenario": "horizontal",
    "n_node_in_silo": 1,
    "n_proc_per_node": 1,
}

_SECTION_KEYS = (
    "common_args",
    "data_args",
    "model_args",
    "train_args",
    "validation_args",
    "device_args",
    "comm_args",
    "tracking_args",
    "attack_args",
    "defense_args",
    "dp_args",
    "fhe_args",
    "mpc_args",
    "fa_args",
)


def _coerce(value: str) -> Any:
    """Best-effort typed coercion of a CLI string override."""
    for caster in (int, float):
        try:
            return caster(value)
        except (TypeError, ValueError):
            pass
    low = str(value).lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", "null"):
        return None
    return value


class Config:
    """Flat attribute namespace with defaults, YAML sections and overrides."""

    def __init__(self, **kwargs: Any) -> None:
        self.__dict__.update(_DEFAULTS)
        self.__dict__.update(kwargs)

    # -- mapping-ish helpers ------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def update(self, other: Dict[str, Any]) -> "Config":
        self.__dict__.update(other)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __getattr__(self, key: str) -> Any:  # only called when missing
        raise AttributeError(
            f"Config has no key {key!r}; set it in YAML or pass --{key}"
        )

    def __repr__(self) -> str:
        keys = ", ".join(sorted(self.__dict__))
        return f"Config({keys})"

    # -- loading ------------------------------------------------------------
    @classmethod
    def from_yaml(cls, path: str, overrides: Optional[Dict[str, Any]] = None) -> "Config":
        with open(path, "r") as f:
            raw = yaml.safe_load(f) or {}
        flat: Dict[str, Any] = {}
        for section, value in raw.items():
            if section in _SECTION_KEYS and isinstance(value, dict):
                flat.update(value)
            else:
                flat[section] = value
        cfg = cls(**flat)
        if overrides:
            cfg.update(overrides)
        cfg.yaml_config_file = path
        return cfg

    def apply_client_override(self, path: str) -> "Config":
        """Per-silo override file (reference `__init__.py:187-211`
        `client_specific_args.data_silo_config`)."""
        with open(path, "r") as f:
            raw = yaml.safe_load(f) or {}
        for section, value in raw.items():
            if isinstance(value, dict):
                self.update(value)
            else:
                self.__dict__[section] = value
        return self


def load_arguments(
    config_path: Optional[str] = None,
    extra: Optional[Dict[str, Any]] = None,
    argv: Optional[List[str]] = None,
) -> Config:
    """Build a Config from (optional) YAML + CLI ``--cf/--key value`` overrides.

    Mirrors the reference entry contract (`arguments.py:22-41` add_args: every
    unknown ``--key value`` pair becomes an attribute override).
    """
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--cf", "--yaml_config_file", dest="cf", type=str,
                        default=config_path)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--role", type=str, default=None)
    parser.add_argument("--run_id", type=str, default=None)
    known, unknown = parser.parse_known_args(argv if argv is not None else [])

    overrides: Dict[str, Any] = {}
    key = None
    for token in unknown:
        if token.startswith("--"):
            key = token[2:]
            overrides[key] = True  # bare flag
        elif key is not None:
            overrides[key] = _coerce(token)
            key = None
    for k in ("rank", "role", "run_id"):
        v = getattr(known, k)
        if v is not None:
            overrides[k] = v
    if extra:
        overrides.update(extra)

    if known.cf and os.path.exists(known.cf):
        return Config.from_yaml(known.cf, overrides)
    return Config(**overrides)
