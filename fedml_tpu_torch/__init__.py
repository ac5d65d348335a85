"""fedml_tpu_torch — the PyTorch/CUDA port of fedml_tpu.

The same 5-step entry as ``fedml_tpu`` (``fedml_tpu/__init__.py``):

    args = fedml_tpu_torch.init()
    device = fedml_tpu_torch.device.get_device(args)
    dataset = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, output_dim)
    FedMLRunner(args, device, dataset, model).run()

plus the one-liner ``fedml_tpu_torch.run_simulation()``.  Entry points run
on the card unless ``device_type: cpu`` asks for the CPU.  The port imports
torch and numpy, never JAX or ``fedml_tpu``; what it needs from the JAX
package it carries as its own copy.  The ported slice is Parrot FedAvg on
the CIFAR ResNets (see ROADMAP.md for what is still to come).
"""

from __future__ import annotations

import logging
import os
import random
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import constants
from .arguments import Config, load_arguments
from .constants import __version__
from .data import data_loader as _data_loader
from .ml.engine import device  # noqa: F401  (fedml_tpu_torch.device)
from .models import model_hub as model  # noqa: F401  (fedml_tpu_torch.model)
from .runner import FedMLRunner


class _DataNS:
    load = staticmethod(_data_loader.load)


data = _DataNS()


def init(args: Optional[Config] = None, argv: Optional[list] = None,
         **overrides: Any) -> Config:
    """Load the config, seed ``random``, numpy and torch, and set up
    logging."""
    if args is None:
        args = load_arguments(argv=argv, extra=overrides or None)
    elif overrides:
        args.update(overrides)

    seed = int(getattr(args, "random_seed", 0) or 0)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))

    logging.basicConfig(
        level=getattr(logging, str(getattr(args, "log_level", "INFO")).upper(),
                      logging.INFO),
        format="[fedml_tpu_torch %(levelname)s %(asctime)s] %(message)s")
    return args


def run_simulation(backend: str = constants.SIMULATION_BACKEND_SP,
                   args: Optional[Config] = None) -> Dict[str, Any]:
    """One-liner simulation entry."""
    if args is None:
        args = init()
        args.backend = backend
    else:
        args = init(args)
        args.backend = getattr(args, "backend", backend) or backend
    dev = device.get_device(args)
    dataset = data.load(args)
    bundle = model.create(args, dataset[-1])
    return FedMLRunner(args, dev, dataset, bundle).run()


__all__ = [
    "__version__", "init", "run_simulation", "FedMLRunner", "Config",
    "load_arguments", "device", "data", "model", "constants",
]
