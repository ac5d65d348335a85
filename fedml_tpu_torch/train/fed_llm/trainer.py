"""FedLLMTrainer — one silo's local SFT for the fed-LLM plane.

Port of ``fedml_tpu/train/fed_llm/trainer.py``: the ``LLMTrainer`` behind
the ``ClientTrainer`` seam, whose exchanged "model parameters" are the
LoRA adapter tree, so everything upstream (the wire codecs, aggregation)
works on the small adapter tree unchanged.

Base-parameter consistency: every silo and the server build on the same
bundle, whose module holds the seeded base parameters (``random_seed``),
and draw their initial adapters from the same seed, so a merge on the
server is what each silo would compute: no base parameter crosses the
wire.

``FED_LLM_TOKENS`` and ``FED_LLM_TRAIN_SECONDS`` count, per run and silo,
the tokens the local epochs consume and the seconds they take — the
port's own counters (the JAX package's live in its metrics registry).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...core.alg_frame.client_trainer import ClientTrainer
from ...ops.epilogue import flat_tree
from ..llm.trainer import LLMTrainer
from .config import llm_config_from_args


class SiloCounter:
    """A monotone count per ``(run_id, silo)``; thread-safe, since the silo
    threads of a run count into it at once."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str], float] = {}

    def inc(self, run_id: Any, silo: Any, value: float) -> None:
        key = (str(run_id), str(silo))
        with self._lock:
            self._counts[key] = self._counts.get(key, 0.0) + float(value)

    def value(self, run_id: Any, silo: Any) -> float:
        with self._lock:
            return self._counts.get((str(run_id), str(silo)), 0.0)

    def for_run(self, run_id: Any) -> Dict[str, float]:
        """``{silo: count}`` of one run."""
        with self._lock:
            return {s: v for (r, s), v in self._counts.items()
                    if r == str(run_id)}


#: tokens consumed by fed-LLM local SFT epochs, per run and silo
FED_LLM_TOKENS = SiloCounter()
#: wall seconds of fed-LLM local SFT, per run and silo
FED_LLM_TRAIN_SECONDS = SiloCounter()


class FedLLMTrainer(ClientTrainer):
    """Silo-local LoRA SFT; ``params`` is the adapter tree.  ``variables``
    and ``adapters`` (JAX trees, numpy leaves) replace the seeded base and
    initial adapters when given."""

    def __init__(self, bundle: Any, args: Any, device: Any = None,
                 variables: Optional[Dict[str, Any]] = None,
                 adapters: Optional[Dict[str, Any]] = None) -> None:
        cfg = llm_config_from_args(args)
        super().__init__(bundle, args)
        self.cfg = cfg
        seed = int(getattr(args, "random_seed", 0) or 0)
        self.llm = LLMTrainer(bundle, cfg, seed=seed, device=device,
                              variables=variables, adapters=adapters)
        self.params = self.llm.lora
        self.num_batches: Optional[int] = None
        self.last_metrics: Dict[str, Any] = {}
        self._run_label = str(getattr(args, "run_id", "0"))

    def set_num_batches(self, nb: Optional[int]) -> None:
        """The adapter's hook; the LLM epoch derives its own batch grid
        from the packed stream, so this is bookkeeping only."""
        self.num_batches = None if nb is None else int(nb)

    def set_model_params(self, model_parameters: Any) -> None:
        # copy, never alias: the INPROC hub may hand over the server's own
        # tensors, and training updates the adapters in place
        adapters = flat_tree(model_parameters, self.llm.device)
        self.params = adapters
        self.llm.lora = adapters

    def get_model_params(self) -> Any:
        return self.params

    def _token_stream(self, train_data: Any) -> np.ndarray:
        """The (x, y) sequence partition as one flat token stream for the
        packer; raises when it cannot fill one batch."""
        x = np.asarray(train_data[0])
        stream = x.reshape(-1).astype(np.int64)
        need = self.cfg.seq_len * self.cfg.batch_size + 1
        if len(stream) < need:
            raise ValueError(
                f"silo partition too small for fed_llm packing: "
                f"{len(stream)} tokens < seq_len*batch_size+1 = {need}; "
                f"lower --fed-llm-seq-len/--batch-size or raise "
                f"--data-scale")
        return stream

    def train(self, train_data, device=None, args=None) -> Any:
        stream = self._token_stream(train_data)
        t0 = time.time()
        out = self.llm.train(stream)
        dt = max(time.time() - t0, 1e-9)
        self.params = self.llm.lora
        n_seq = (len(stream) - 1) // self.cfg.seq_len
        n_seq = n_seq // self.cfg.batch_size * self.cfg.batch_size
        n_tokens = n_seq * self.cfg.seq_len * max(1, self.cfg.epochs)
        silo = str(self.id)
        FED_LLM_TOKENS.inc(self._run_label, silo, n_tokens)
        FED_LLM_TRAIN_SECONDS.inc(self._run_label, silo, dt)
        self.last_metrics = {
            "train_loss": float(out["train_loss"]),
            "n_tokens": float(n_tokens),
            "tokens_per_sec": float(n_tokens / dt),
        }
        logging.info("fed_llm silo %s: loss %.4f, %.0f tok/s",
                     silo, self.last_metrics["train_loss"],
                     self.last_metrics["tokens_per_sec"])
        return out
