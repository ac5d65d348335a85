"""LLM fine-tuning trainer (SFT) with LoRA.

Port of ``fedml_tpu/train/llm/trainer.py``: ``LLMTrainConfig``,
``pack_sequences``, ``format_prompt`` and ``LLMTrainer`` with strategy
``none`` — ``train`` over packed fixed-length next-token batches and
``generate`` (greedy, or sampled at a temperature).

Each step merges the adapters into the frozen base parameters
(``lora.apply_lora``, flax layouts) and runs the bundle's module on the
merged tree through ``torch.func.functional_call``, so the gradient
reaches the factors ``a`` and ``b`` alone; the optimizer is the JAX
package's chain, clip then adamw, with MultiSteps accumulation
(``ml/engine/optimizers.LLMOptimizer``).  The JAX trainer scans an epoch
inside one jit; here the steps are eager.

The bundle is shared and stateful: ``functional_call`` swaps the merged
tensors into the module for the call, so ``train`` and ``generate`` hold
``ModelBundle.lock`` from loading parameters to copying results out.  The
base parameters are the module's own at construction — the seeded build,
the same in every trainer built on one bundle — copied into a tree the
trainer keeps; nothing here writes them back into the module.

Draws: dropout takes a ``torch.Generator`` seeded with 1 anew at every
``train`` call (JAX's ``PRNGKey(1)``), reseeding a device generator per
step as the local update does; sampling in ``generate`` one seeded with 2.
Torch's bits are not JAX's: at dropout 0 and greedy decoding the two agree,
otherwise only in distribution.

Not ported, each raising ``NotImplementedError`` naming its port item:
``strategy`` dp and fsdp (A16), ``pretrained_path`` (``weight_import``,
A15) and ``checkpoint_dir`` (checkpoints, A11).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ...ml.engine.device import get_device
from ...ml.engine.local_update import _step_generator
from ...ml.engine.model_bundle import TASK_LM, ModelBundle, masked_loss
from ...ml.engine.optimizers import build_llm_optimizer
from ...ops.epilogue import flat_tree
from ...utils.tree import tree_leaves, tree_map
from ...utils.weights import (
    adapters_from_jax,
    named_tensors_from_tree,
    tree_from_module,
)
from .lora import apply_lora, count_trainable, init_lora


@dataclasses.dataclass
class LLMTrainConfig:
    """The JAX package's ``LLMTrainConfig`` (reference
    ``train/llm/configurations.py`` ExperimentArguments subset)."""

    seq_len: int = 128
    batch_size: int = 8
    learning_rate: float = 1e-3
    epochs: int = 1
    use_lora: bool = True
    lora_rank: int = 8
    lora_alpha: float = 16.0
    #: regex list selecting the 2-D kernels that get (a, b) factors; None →
    #: lora.DEFAULT_TARGETS
    lora_targets: Optional[Tuple[str, ...]] = None
    grad_clip: float = 1.0
    checkpoint_dir: Optional[str] = None
    #: "none" | "dp" | "fsdp"; dp and fsdp are port item A16
    strategy: str = "none"
    data_parallel: int = -1
    #: apply the optimizer every k batches, accumulating gradients between
    grad_accum_steps: int = 1
    #: "constant" | "cosine" | "linear" (ml/engine/optimizers.make_lr)
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_decay_steps: int = 1000
    #: checkpoint to fine-tune from (weight_import, port item A15)
    pretrained_path: Optional[str] = None
    pretrained_schema: str = "auto"


def pack_sequences(token_ids: np.ndarray, seq_len: int,
                   batch_size: int) -> Dict[str, np.ndarray]:
    """Pack a token stream into ``[n_batches, B, T]`` next-token batches."""
    n_tokens = (len(token_ids) - 1) // seq_len * seq_len
    x = token_ids[:n_tokens].reshape(-1, seq_len)
    y = token_ids[1:n_tokens + 1].reshape(-1, seq_len)
    n_seq = len(x) // batch_size * batch_size
    x, y = x[:n_seq], y[:n_seq]
    return {
        "x": x.reshape(-1, batch_size, seq_len),
        "y": y.reshape(-1, batch_size, seq_len),
        "mask": np.ones((n_seq // batch_size, batch_size, seq_len),
                        np.float32),
    }


def format_prompt(instruction: str, response: str = "") -> str:
    """Alpaca-style template (reference ``dataset_utils.py``)."""
    return (f"### Instruction:\n{instruction}\n\n### Response:\n{response}")


def _check_config(config: LLMTrainConfig) -> None:
    if config.strategy in ("dp", "fsdp"):
        raise NotImplementedError(
            f"llm strategy {config.strategy!r} (sharded base parameters "
            f"over a device mesh) is not ported yet (port item A16)")
    if config.strategy != "none":
        raise ValueError(f"unknown llm strategy {config.strategy!r}; "
                         f"known: none, dp, fsdp")
    if config.pretrained_path:
        raise NotImplementedError(
            "pretrained_path (train/llm/weight_import) is not ported yet "
            "(port item A15)")
    if config.checkpoint_dir:
        raise NotImplementedError(
            "checkpoint_dir (LLM epoch checkpoints) is not ported yet (port "
            "item A11)")


class LLMTrainer:
    """LoRA (or full-parameter) SFT of a language-model bundle.

    ``variables``: the base variables tree ``{"params": ...}`` in flax's
    names and layouts; ``lora``: the adapter tree.  By default both come
    from the seeded build: the module's own variables, and adapters drawn
    from ``seed``.  ``variables`` and ``adapters`` given as JAX trees
    (numpy leaves) start the trainer from those instead."""

    def __init__(self, bundle: ModelBundle, config: LLMTrainConfig,
                 seed: int = 0, device: Any = None,
                 variables: Optional[Dict[str, Any]] = None,
                 adapters: Optional[Dict[str, Any]] = None) -> None:
        _check_config(config)
        if bundle.task != TASK_LM:
            raise ValueError(f"LLMTrainer needs a language-model bundle, not "
                             f"task {bundle.task!r}")
        self.bundle = bundle
        self.cfg = config
        self.device = torch.device(device) if device is not None \
            else get_device()
        with bundle.lock:
            bundle.bind(self.device)
            own = tree_from_module(bundle.module)
        if variables is not None:
            own = tree_map(lambda a: torch.from_numpy(
                np.array(a, np.float32)).to(self.device), variables)
        #: frozen base variables (LoRA) or the trained ones (full)
        self.variables: Dict[str, Any] = {"params": own["params"]}
        self.lora: Dict[str, Any] = {}
        if config.use_lora:
            if adapters is not None:
                self.lora = adapters_from_jax(adapters, self.device)
            else:
                # a stream of its own: the adapters never correlate with
                # the base parameters' draws
                self.lora = init_lora(self.variables["params"],
                                      rank=config.lora_rank,
                                      targets=config.lora_targets,
                                      seed=int(seed) + 1,
                                      device=self.device)
            logging.info("LoRA: %d trainable params",
                         count_trainable(self.lora))
        self.tx = build_llm_optimizer(config)

    def _trainables(self) -> Any:
        return self.lora if self.cfg.use_lora else self.variables["params"]

    def _merged(self, trainable: Any) -> Dict[str, Any]:
        params = (apply_lora(self.variables["params"], trainable,
                             self.cfg.lora_alpha)
                  if self.cfg.use_lora else trainable)
        return named_tensors_from_tree({"params": params},
                                       self.bundle.module)

    def _logits(self, trainable: Any, x: torch.Tensor, train: bool,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return functional_call(self.bundle.module, self._merged(trainable),
                               (x,), {"train": train, "rng": rng})

    def train(self, token_ids: np.ndarray) -> Dict[str, Any]:
        cfg = self.cfg
        batches = pack_sequences(np.asarray(token_ids), cfg.seq_len,
                                 cfg.batch_size)
        dev = self.device
        x = torch.as_tensor(batches["x"], device=dev).to(
            self.bundle.input_dtype)
        y = torch.as_tensor(batches["y"], device=dev).long()
        mask = torch.as_tensor(batches["mask"], device=dev)
        rng = torch.Generator().manual_seed(1)
        history = []
        with self.bundle.lock:
            self.bundle.bind(dev)
            trainable = flat_tree(self._trainables())
            leaves = tree_leaves(trainable)
            state = self.tx.init(leaves)
            for ep in range(cfg.epochs):
                t0 = time.time()
                losses = []
                for i in range(x.shape[0]):
                    live = tree_map(
                        lambda t: t.detach().requires_grad_(), trainable)
                    with torch.enable_grad():
                        logits = self._logits(
                            live, x[i], True, _step_generator(rng, dev))
                        loss = masked_loss(TASK_LM, logits, y[i], mask[i])
                        grads = torch.autograd.grad(loss, tree_leaves(live))
                    self.tx.step(leaves, list(grads), state)
                    losses.append(loss.detach())
                # one sync per epoch: the scalar for the history
                loss_host = (float(torch.stack(losses).mean()) if losses
                             else float("nan"))
                history.append(loss_host)
                logging.info("llm epoch %d: loss %.4f (%.1fs)", ep,
                             loss_host, time.time() - t0)
        if cfg.use_lora:
            self.lora = trainable
        else:
            self.variables = dict(self.variables, params=trainable)
        return {"train_loss": history[-1] if history else float("nan"),
                "loss_history": history}

    def generate(self, prompt_ids: np.ndarray, max_new: int = 20,
                 temperature: float = 0.0) -> np.ndarray:
        """Greedy (temperature 0) or sampled continuation with the merged
        model; the window is the last ``seq_len`` tokens."""
        ids = list(np.asarray(prompt_ids).tolist())
        rng = torch.Generator().manual_seed(2)
        with self.bundle.lock, torch.no_grad():
            self.bundle.bind(self.device)
            merged = self._merged(self._trainables())
            for _ in range(max_new):
                x = torch.tensor([ids[-self.cfg.seq_len:]],
                                 dtype=self.bundle.input_dtype,
                                 device=self.device)
                logits = functional_call(self.bundle.module, merged, (x,),
                                         {"train": False})
                last = logits[0, -1].float().cpu()
                if temperature > 0:
                    probs = torch.softmax(last / float(temperature), dim=-1)
                    nxt = int(torch.multinomial(probs, 1, generator=rng))
                else:
                    nxt = int(torch.argmax(last))
                ids.append(nxt)
        return np.asarray(ids)
