"""Model hub — ``create(args, output_dim)`` dispatch.

Port of ``fedml_tpu/models/model_hub.py`` for the CIFAR ResNets
(``resnet20``, ``resnet32``, ``resnet56``) with BatchNorm and the plain
convolution.  The model's variables are initialised from a
``torch.Generator`` seeded with ``random_seed``: the same initializers as
flax, not the same numbers (``utils/weights.py`` carries JAX's across).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..ml.engine.model_bundle import TASK_CLASSIFICATION, ModelBundle
from .cv import CIFARResNet

# dataset → (input_shape, default_classes, task)
_DATASET_SHAPES = {
    "mnist": ((28, 28, 1), 10, TASK_CLASSIFICATION),
    "femnist": ((28, 28, 1), 62, TASK_CLASSIFICATION),
    "cifar10": ((32, 32, 3), 10, TASK_CLASSIFICATION),
    "cifar100": ((32, 32, 3), 100, TASK_CLASSIFICATION),
    "fed_cifar100": ((32, 32, 3), 100, TASK_CLASSIFICATION),
    "cinic10": ((32, 32, 3), 10, TASK_CLASSIFICATION),
}

MODELS = ("resnet20", "resnet32", "resnet56")


def dataset_meta(dataset: str) -> Tuple[Tuple[int, ...], int, str]:
    return _DATASET_SHAPES.get(str(dataset).lower(),
                               ((32, 32, 3), 10, TASK_CLASSIFICATION))


def create(args: Any, output_dim: Optional[int] = None) -> ModelBundle:
    name = str(getattr(args, "model", "lr")).lower()
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; the PyTorch port builds "
                         f"{', '.join(MODELS)}")
    norm = str(getattr(args, "norm", "bn") or "bn")
    conv_impl = str(getattr(args, "conv_impl", "lax") or "lax")
    if norm != "bn" or conv_impl != "lax":
        raise NotImplementedError(
            f"{name} with norm {norm!r} and conv_impl {conv_impl!r} is not "
            f"ported yet; the port builds norm 'bn', conv_impl 'lax'")
    dataset = str(getattr(args, "dataset", "cifar10")).lower()
    input_shape, default_dim, task = dataset_meta(dataset)
    num_classes = int(output_dim or default_dim)
    dtype = (torch.bfloat16 if str(getattr(args, "compute_dtype", "bfloat16"))
             == "bfloat16" else torch.float32)
    seed = int(getattr(args, "random_seed", 0) or 0)
    module = CIFARResNet(depth=int(name.replace("resnet", "")),
                         num_classes=num_classes, dtype=dtype,
                         in_channels=input_shape[-1],
                         generator=torch.Generator().manual_seed(seed))
    return ModelBundle(module=module, input_shape=input_shape,
                       num_classes=num_classes, task=task,
                       input_dtype=torch.float32, name=name)
