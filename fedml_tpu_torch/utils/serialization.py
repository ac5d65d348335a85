"""Message payload sizes.

Port of ``fedml_tpu/utils/serialization.py::estimate_nbytes``, the one
piece of that module the ported cross-silo path uses: the wire-byte
accounting of the INPROC transport, which passes payloads by reference and
never serializes them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def estimate_nbytes(obj: Any) -> int:
    """Wire-size estimate of a message payload without serializing it:
    tensors count ``numel · element_size``, numpy arrays their buffer,
    scalars and strings their natural width, containers a framing constant
    of 16 — the JAX package's counts, so a payload weighs the same in
    either package."""
    if obj is None or isinstance(obj, bool):
        return 1
    if isinstance(obj, (int, float)):
        return 8
    if isinstance(obj, (str, bytes)):
        return len(obj)
    if isinstance(obj, dict):
        return 16 + sum(estimate_nbytes(k) + estimate_nbytes(v)
                        for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return 16 + sum(estimate_nbytes(x) for x in obj)
    if isinstance(obj, torch.Tensor):
        return int(obj.numel() * obj.element_size())
    nbytes = getattr(obj, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    try:
        return int(np.asarray(obj).nbytes)
    except (TypeError, ValueError):  # opaque object: a flat guess
        return 64
