"""Model hub — ``create(args, output_dim)`` dispatch.

Port of ``fedml_tpu/models/model_hub.py`` for logistic regression
(``lr``), the CIFAR ResNets (``resnet20``, ``resnet32``, ``resnet56``) with
BatchNorm and the plain convolution, and the BERT-tiny-scale transformer
language model (``transformer``, ``bert_tiny``, ``bert-tiny``).  The model's variables
are initialised from a ``torch.Generator`` seeded with ``random_seed``: the
same initializers as flax, not the same numbers (``utils/weights.py``
carries JAX's across).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ..ml.engine.model_bundle import TASK_CLASSIFICATION, TASK_LM, ModelBundle
from .cv import CIFARResNet, LogisticRegression
from .nlp import TinyTransformerLM

# dataset → (input_shape, default_classes, task)
_DATASET_SHAPES = {
    "mnist": ((28, 28, 1), 10, TASK_CLASSIFICATION),
    "synthetic": ((60,), 10, TASK_CLASSIFICATION),
    "femnist": ((28, 28, 1), 62, TASK_CLASSIFICATION),
    "cifar10": ((32, 32, 3), 10, TASK_CLASSIFICATION),
    "cifar100": ((32, 32, 3), 100, TASK_CLASSIFICATION),
    "fed_cifar100": ((32, 32, 3), 100, TASK_CLASSIFICATION),
    "cinic10": ((32, 32, 3), 10, TASK_CLASSIFICATION),
    "shakespeare": ((80,), 90, TASK_LM),
    "fed_shakespeare": ((80,), 90, TASK_LM),
}

RESNETS = ("resnet20", "resnet32", "resnet56")
TRANSFORMERS = ("transformer", "bert_tiny", "bert-tiny")
MODELS = ("lr",) + RESNETS + TRANSFORMERS
#: the JAX package's other models, and the port item that brings each
_LATER = {"rnn": "A10", "vit": "A10", "vit_tiny": "A10", "vit-tiny": "A10",
          "functional_lm": "A15", "kv_lm": "A15"}


def dataset_meta(dataset: str) -> Tuple[Tuple[int, ...], int, str]:
    name = str(dataset).lower()
    if name.startswith("synthetic_") and name not in _DATASET_SHAPES:
        # LEAF SYNTHETIC(α,β) variants share the base synthetic contract
        return _DATASET_SHAPES["synthetic"]
    return _DATASET_SHAPES.get(name, ((32, 32, 3), 10, TASK_CLASSIFICATION))


def create(args: Any, output_dim: Optional[int] = None) -> ModelBundle:
    name = str(getattr(args, "model", "lr")).lower()
    if name in _LATER:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (port item {_LATER[name]}); "
            f"the PyTorch port builds {', '.join(MODELS)}")
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; the PyTorch port builds "
                         f"{', '.join(MODELS)}")
    dataset = str(getattr(args, "dataset", "cifar10")).lower()
    input_shape, default_dim, task = dataset_meta(dataset)
    num_classes = int(output_dim or default_dim)
    dtype = (torch.bfloat16 if str(getattr(args, "compute_dtype", "bfloat16"))
             == "bfloat16" else torch.float32)
    input_dtype = torch.int32 if task == TASK_LM else torch.float32
    gen = torch.Generator().manual_seed(int(getattr(args, "random_seed", 0)
                                            or 0))
    if name == "lr":
        module = LogisticRegression(
            math.prod(input_shape), num_classes, dtype=dtype,
            sigmoid_output=bool(getattr(args, "lr_sigmoid_outputs", False)),
            generator=gen)
        if task == TASK_LM:  # lr on text = bag-of-words; keep classification
            task = TASK_CLASSIFICATION
    elif name in TRANSFORMERS:
        module = TinyTransformerLM(vocab_size=num_classes, dtype=dtype,
                                   generator=gen)
        task = TASK_LM
    else:
        norm = str(getattr(args, "norm", "bn") or "bn")
        conv_impl = str(getattr(args, "conv_impl", "lax") or "lax")
        if norm != "bn" or conv_impl != "lax":
            raise NotImplementedError(
                f"{name} with norm {norm!r} and conv_impl {conv_impl!r} is "
                f"not ported yet; the port builds norm 'bn', conv_impl 'lax'")
        module = CIFARResNet(depth=int(name.replace("resnet", "")),
                             num_classes=num_classes, dtype=dtype,
                             in_channels=input_shape[-1], generator=gen)
    return ModelBundle(module=module, input_shape=input_shape,
                       num_classes=num_classes, task=task,
                       input_dtype=input_dtype, name=name)
