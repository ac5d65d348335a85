"""Round-epilogue kernels: the weighted reduce over the client axis.

Port of ``fedml_tpu/ops/epilogue.py::weighted_reduce`` and its Pallas
``_reduce_kernel``.  The kernel is ``csrc/weighted_reduce.cu`` (CUDA C++ for
``sm_90a``, built and bound by ``ops/cuda_build.py``); its note says what
bounds it and how the design answers that.

Contract (``agg_stacked``'s): ``out = Σ_c (w_c / max(Σw, 1e-12)) · x[c]``,
accumulated in float32 and cast back to the input dtype; a non-float input
gives float32.  Weights need not be normalised; weight 0 masks a client out.

Where it runs: a CUDA tensor launches the kernel, or the wrapper raises on
what the kernel does not take.  A CPU tensor takes the plain version,
``weighted_reduce_reference``; that is the only way to it.

The TPU version makes one ``pallas_call`` per leaf.  Here one call reduces a
whole ``[C, D]`` buffer, and the Parrot engine keeps all leaves of one dtype
in one such buffer, so a round is one launch per dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

#: launches of each CUDA kernel of this module, counted where the wrapper
#: launches it
LAUNCHES = {"weighted_reduce": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("weighted_reduce")
        lib.fedml_weighted_reduce.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fedml_weighted_reduce.restype = ctypes.c_int
        lib.fedml_weighted_reduce_max_clients.argtypes = []
        lib.fedml_weighted_reduce_max_clients.restype = ctypes.c_int
        lib.fedml_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fedml_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _out_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.float32


def weighted_reduce_reference(stacked: torch.Tensor,
                              weights: torch.Tensor) -> torch.Tensor:
    """The plain version: normalised weights, ``tensordot`` in float32,
    then the cast."""
    w = weights.float()
    wn = w / torch.clamp(w.sum(), min=1e-12)
    acc = torch.tensordot(wn, stacked.float(), dims=1)
    return acc.to(_out_dtype(stacked.dtype))


def weighted_reduce(stacked: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean of ``stacked`` ([C, ...]) over its leading client axis
    with ``weights`` ([C]); returns a tensor of shape ``stacked.shape[1:]``."""
    if stacked.device.type == "cpu" and weights.device.type == "cpu":
        return weighted_reduce_reference(stacked, weights)
    if stacked.device.type != "cuda" or weights.device != stacked.device:
        raise ValueError(
            f"weighted_reduce: stacked on {stacked.device} and weights on "
            f"{weights.device}; both must be on the CPU or on one card")
    code = _DTYPE_CODES.get(stacked.dtype)
    if code is None:
        raise TypeError(f"weighted_reduce kernel takes float32, bfloat16 or "
                        f"int32 leaves, not {stacked.dtype}")
    if weights.dtype != torch.float32 or weights.dim() != 1:
        raise TypeError(f"weighted_reduce kernel takes 1-D float32 weights, "
                        f"not {weights.dtype} of shape {tuple(weights.shape)}")
    if stacked.dim() < 1 or stacked.shape[0] != weights.shape[0]:
        raise ValueError(f"weighted_reduce: stacked {tuple(stacked.shape)} "
                         f"does not lead with the {weights.shape[0]} clients "
                         f"of the weights")
    if not (stacked.is_contiguous() and weights.is_contiguous()):
        raise ValueError("weighted_reduce kernel takes contiguous tensors")
    lib = _kernel_lib()
    c = int(stacked.shape[0])
    d = stacked.numel() // c if c else 0
    max_c = lib.fedml_weighted_reduce_max_clients()
    if not 1 <= c <= max_c or d < 1:
        raise ValueError(f"weighted_reduce kernel takes 1..{max_c} clients "
                         f"and non-empty leaves, not [{c}, {d}]")
    out = torch.empty(stacked.shape[1:], dtype=_out_dtype(stacked.dtype),
                      device=stacked.device)
    dev = stacked.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    rc = lib.fedml_weighted_reduce(stacked.data_ptr(), weights.data_ptr(),
                                   out.data_ptr(), c, d, code, dev, stream)
    if rc != 0:
        raise RuntimeError(f"weighted_reduce kernel launch failed: CUDA "
                           f"error {rc} "
                           f"({lib.fedml_cuda_error_string(rc).decode()})")
    LAUNCHES["weighted_reduce"] += 1
    return out
