"""The device the port runs on.

Port of ``fedml_tpu.device`` (``fedml_tpu/ml/engine/mesh.py::get_device``).
The ``device_type`` config key picks it: ``"cpu"`` asks for the CPU, and
anything else (unset, ``"cuda"``, ``"gpu"``) for the card.  When the card is
wanted and CUDA is not available, ``get_device`` raises: it never falls back
to the CPU.
"""

from __future__ import annotations

from typing import Any

import torch


def get_device(args: Any = None) -> torch.device:
    want = getattr(args, "device_type", None) if args is not None else None
    want = str(want).lower() if want else "cuda"
    if want == "cpu":
        return torch.device("cpu")
    if want not in ("cuda", "gpu"):
        raise ValueError(f"unknown device_type {want!r}; the PyTorch port "
                         f"runs on 'cuda' (also 'gpu', or unset) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the card was asked for (device_type "
            f"{getattr(args, 'device_type', None)!r}) but "
            "torch.cuda.is_available() is false; set device_type: cpu to "
            "run on the CPU")
    # float32 convolutions and matmuls in full float32, as the reference
    # computes them; TF32 would keep about three decimal digits
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())
