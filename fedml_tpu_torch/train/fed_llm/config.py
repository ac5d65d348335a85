"""Fed-LLM flag parsing and validation.

Port of ``fedml_tpu/train/fed_llm/config.py``, copied: pure Python, the
same checks and messages.  Every selector raises ``ValueError`` at
start-up — trainer and aggregator construction and
``fedml_tpu_torch.init`` funnel through ``validate_fed_llm_args`` — so a
mistyped flag fails before the first round, never mid-federation.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

from ..llm.trainer import LLMTrainConfig

#: silo-local base-param sharding strategies the LLM trainer models
FED_LLM_STRATEGIES = ("none", "dp", "fsdp")


def parse_lora_targets(spec: Any) -> Optional[Tuple[str, ...]]:
    """``None``/empty → None (``lora.DEFAULT_TARGETS`` applies); else a
    comma-separated regex list, each compiled HERE so a malformed pattern
    fails at startup, not on the first ``init_lora`` walk."""
    if spec is None or spec is False or str(spec).strip() == "":
        return None
    patterns = tuple(p.strip() for p in str(spec).split(",") if p.strip())
    if not patterns:
        return None
    for p in patterns:
        try:
            re.compile(p)
        except re.error as e:
            raise ValueError(
                f"malformed lora_targets pattern {p!r}: {e}") from e
    return patterns


def validate_fed_llm_args(args: Any) -> Dict[str, Any]:
    """Validate every ``--fed-llm`` companion flag; returns the parsed
    values.  Raises ``ValueError`` on the first bad one."""
    try:
        rank = int(getattr(args, "lora_rank", 8))
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"lora_rank must be an integer, got "
            f"{getattr(args, 'lora_rank', None)!r}") from e
    if rank < 1:
        raise ValueError(f"lora_rank must be >= 1, got {rank}")
    try:
        alpha = float(getattr(args, "lora_alpha", 16.0))
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"lora_alpha must be a number, got "
            f"{getattr(args, 'lora_alpha', None)!r}") from e
    if not alpha > 0:
        raise ValueError(f"lora_alpha must be > 0, got {alpha}")
    try:
        seq_len = int(getattr(args, "fed_llm_seq_len", 32))
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"fed_llm_seq_len must be an integer, got "
            f"{getattr(args, 'fed_llm_seq_len', None)!r}") from e
    if seq_len < 2:
        raise ValueError(
            f"fed_llm_seq_len must be >= 2 (next-token packing needs at "
            f"least one input/target pair), got {seq_len}")
    strategy = str(getattr(args, "fed_llm_strategy", "none") or "none")
    if strategy not in FED_LLM_STRATEGIES:
        raise ValueError(
            f"unknown fed_llm_strategy {strategy!r}; expected one of "
            f"{'|'.join(FED_LLM_STRATEGIES)}")
    targets = parse_lora_targets(getattr(args, "lora_targets", None))
    return {"lora_rank": rank, "lora_alpha": alpha, "seq_len": seq_len,
            "strategy": strategy, "targets": targets}


def llm_config_from_args(args: Any) -> LLMTrainConfig:
    """args → the silo-local ``LLMTrainConfig`` (validated).  LoRA is
    forced ON: the plane's contract is that ONLY adapters cross the wire,
    so a full-param config has nothing to federate here."""
    v = validate_fed_llm_args(args)
    return LLMTrainConfig(
        seq_len=v["seq_len"],
        batch_size=int(getattr(args, "batch_size", 8)),
        learning_rate=float(getattr(args, "learning_rate", 1e-3)),
        epochs=int(getattr(args, "epochs", 1)),
        use_lora=True,
        lora_rank=v["lora_rank"],
        lora_alpha=v["lora_alpha"],
        lora_targets=v["targets"],
        strategy=v["strategy"],
        data_parallel=-1,
    )
