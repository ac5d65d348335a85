"""LLM fine-tuning: LoRA on parameter trees and the SFT trainer (port of
``fedml_tpu/train/llm``; ``weight_import`` is port item A15)."""

from .lora import apply_lora, init_lora, merge_lora
from .trainer import LLMTrainConfig, LLMTrainer, format_prompt, pack_sequences

__all__ = ["LLMTrainer", "LLMTrainConfig", "init_lora", "apply_lora",
           "merge_lora", "pack_sequences", "format_prompt"]
