"""Wire-compression kernels for cross-silo update payloads.

Port of ``fedml_tpu/ops/wire_compression.py``:

* ``quantize_int8_blocked`` and its Pallas ``_quant_kernel`` — symmetric
  per-block int8: each block of ``BLOCK`` values gets the scale
  ``max|x| / 127`` and ``q = clip(round_half_even(x · inv), ±127)`` with
  ``inv = scale > 0 ? 1 / max(scale, 1e-30) : 0`` (it multiplies by the
  inverse, never divides by the scale);
* ``dequantize_int8_blocked`` and its Pallas ``_dequant_kernel`` —
  ``f32(q) · scale`` per block;
* ``topk_select`` and ``scatter_flat``, plain torch (the JAX package uses
  ``jax.lax.top_k`` there, not Pallas).

Both kernels are ``csrc/wire_compression.cu``, CUDA C++ for ``sm_90a``
built and bound by ``ops/cuda_build.py``.  Each takes segments, so that
one launch quantizes or dequantizes a whole model leaf by leaf: the blocks
restart at every segment, as the JAX package's one ``pallas_call`` per
leaf restarts them (``WireCodec.encode_model`` and ``decode_model``).  The
scales of the segments are packed one after another, ``⌈n/BLOCK⌉`` per
segment of ``n`` values, and only those rows go on the wire.  The
quantize reads its segments from a table on the card.  The dequantize
takes one of three launch forms (``dequantize_form``; ``DEQUANT_FORMS``
counts each): ``flat`` for one segment (the uplink, a residual), whose
offsets are launch arguments; ``by_value`` for up to ``ROWS_CAPACITY``
scale rows (the broadcast's 287 leaves: 1,902 rows), each row's first
value packed into the kernel's parameters (``segments_by_value``), so no
device memory is read ahead of the data;
and ``table``, the device table, for layouts past that capacity.

Where it runs: a CUDA tensor launches the kernel, or the wrapper raises on
what the kernel does not take.  CPU tensors take the plain versions,
``quantize_int8_reference`` and ``dequantize_int8_reference`` (the JAX
package's jnp fallback, op for op); that is the only way to them.

The Pallas kernels' ``[32, BLOCK]`` grid tiling, and the dequantize's
regrowth of the 32-row padding, are TPU layout: the CUDA kernels mask a
row that is not full instead.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build

#: values per quantization block (one scale per block)
BLOCK = 512
#: launches of each CUDA kernel of this module, counted where the wrapper
#: launches it (under ``_count_lock``: the cross-silo plane launches them
#: from several client threads)
LAUNCHES = {"quantize": 0, "dequantize": 0}
#: the dequantize's launches by form (``dequantize_form``)
DEQUANT_FORMS = {"flat": 0, "by_value": 0, "table": 0}
#: the most scale rows the dequantize's by-value form takes: one 8 KB
#: kernel parameter (the broadcast's 1,902 rows on ResNet-56 fit)
ROWS_CAPACITY = 2048
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: device copies of segment tables, by (device, lengths): a model's layout
#: repeats every round
_tables: Dict[Tuple[str, Tuple[int, ...]], "_Table"] = {}
_TABLE_CACHE = 64


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load("wire_compression")
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.fedml_quantize_int8.argtypes = [vp, vp, i, ll, vp, vp, i, vp]
            lib.fedml_quantize_int8.restype = i
            lib.fedml_dequantize_int8.argtypes = [vp, vp, vp, i, ll, vp, i,
                                                  vp]
            lib.fedml_dequantize_int8.restype = i
            lib.fedml_dequantize_int8_flat.argtypes = [vp, vp, ll, ll, vp,
                                                       i, vp]
            lib.fedml_dequantize_int8_flat.restype = i
            lib.fedml_dequantize_int8_rows.argtypes = [vp, vp, vp, ll, vp, i,
                                                       vp]
            lib.fedml_dequantize_int8_rows.restype = i
            lib.fedml_dequantize_rows_capacity.argtypes = []
            lib.fedml_dequantize_rows_capacity.restype = i
            lib.fedml_wire_block.argtypes = []
            lib.fedml_wire_block.restype = i
            lib.fedml_cuda_error_string.argtypes = [i]
            lib.fedml_cuda_error_string.restype = ctypes.c_char_p
            if (lib.fedml_wire_block() != BLOCK
                    or lib.fedml_dequantize_rows_capacity()
                    != ROWS_CAPACITY):
                raise RuntimeError("wire_compression: the kernel's block or "
                                   "by-value capacity differs from the "
                                   "wrapper's")
            _lib = lib
        return _lib


def n_blocks(n: int) -> int:
    """Scales of one segment of ``n`` values."""
    return -(-int(n) // BLOCK)


def _lengths(total: int, lengths: Optional[Sequence[int]]) -> Tuple[int, ...]:
    lens = (int(total),) if lengths is None else tuple(lengths)
    if min(lens, default=0) < 0 or sum(lens) != int(total):
        raise ValueError(f"segment lengths {lens[:8]}... must be >= 0 and sum "
                         f"to the {total} values")
    return lens


class _Table(NamedTuple):
    table: torch.Tensor     # [S, 4] int64 on the card
    n_seg: int              # S, the non-empty segments
    rows: int               # scales in all
    total: int              # values in all


def _segment_table(lens: Tuple[int, ...], device: torch.device) -> _Table:
    """The ``[S, 4]`` int64 table (value offset, length, value offset of the
    output, first scale) of the non-empty segments, on ``device``.  Cached
    per layout: a model's layout repeats every round, and the host work
    of building it would cost more than the kernel."""
    key = (str(device), lens)
    cached = _tables.get(key)
    if cached is not None:
        return cached
    entries, off, row = [], 0, 0
    for n in lens:
        n = int(n)
        if n < 0:
            raise ValueError(f"segment length {n} < 0")
        if n:
            entries.append((off, n, off, row))
        off += n
        row += n_blocks(n)
    cached = _Table(torch.tensor(entries or [(0, 0, 0, 0)], dtype=torch.int64,
                                 device=device), len(entries), row, off)
    with _lib_lock:
        if len(_tables) >= _TABLE_CACHE:
            _tables.pop(next(iter(_tables)))
        _tables[key] = cached
    return cached


def segments_by_value(lens: Sequence[int]) -> Optional[np.ndarray]:
    """The segments ``lens`` packed for the dequantize's by-value form:
    uint32 ``[R + 1]``, the first value of each of the R scale rows (the
    blocks restart at every segment) and last the total, so that row r
    holds values ``start[r] .. start[r + 1] − 1``.  None where the layout
    passes the kernel's capacity: more than ``ROWS_CAPACITY`` rows, or
    2^32 values or more."""
    lens = [int(n) for n in lens]
    if min(lens, default=0) < 0:
        raise ValueError(f"segment lengths {lens[:8]}... must be >= 0")
    if (sum(n_blocks(n) for n in lens) > ROWS_CAPACITY
            or sum(lens) > 0xFFFFFFFF):
        return None
    starts, off = [], 0
    for n in lens:
        starts.extend(range(off, off + n, BLOCK))
        off += n
    return np.asarray(starts + [off], dtype=np.uint32)


class _DequantPlan(NamedTuple):
    form: str                       # flat, by_value or table
    rows: int                       # scales in all
    total: int                      # values in all
    start: Optional[np.ndarray]     # the by-value packing, else None


_dq_plans: Dict[Tuple[int, ...], _DequantPlan] = {}


def _dequant_plan(lens: Tuple[int, ...]) -> _DequantPlan:
    """The dequantize's launch for the segments ``lens``, cached per layout:
    a model's layout repeats every round, and walking its leaves on the
    host would cost more than the kernel."""
    plan = _dq_plans.get(lens)
    if plan is None:
        start = None
        if sum(1 for n in lens if int(n)) == 1:
            form = "flat"
        else:
            start = segments_by_value(lens)
            form = "table" if start is None else "by_value"
        plan = _DequantPlan(form, sum(n_blocks(n) for n in lens),
                            sum(int(n) for n in lens), start)
        with _lib_lock:
            if len(_dq_plans) >= _TABLE_CACHE:
                _dq_plans.pop(next(iter(_dq_plans)))
            _dq_plans[lens] = plan
    return plan


def dequantize_form(lens: Sequence[int]) -> str:
    """The dequantize's launch form for the segments ``lens``: ``flat``
    for one non-empty segment, ``by_value`` up to the kernel's capacity,
    else ``table``."""
    return _dequant_plan(tuple(lens)).form


def _check_launch(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({lib.fedml_cuda_error_string(rc).decode()})")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


# ------------------------------------------------------------ plain versions
def quantize_int8_reference(flat: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for one segment: the JAX package's jnp fallback
    (``fedml_tpu/ops/wire_compression.py:89-93``) op for op — pad to whole
    blocks, per-row max-abs, ``amax / 127``, the guarded inverse,
    ``round`` (half to even), ``clamp`` and the cast."""
    d = int(flat.numel())
    rows = n_blocks(d)
    x = torch.zeros(rows * BLOCK, dtype=torch.float32, device=flat.device)
    x[:d] = flat.reshape(-1).float()
    x = x.reshape(rows, BLOCK)
    amax = x.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently from jnp's
    # division; tensor by tensor divides, on either device
    scale = amax / torch.full_like(amax, 127.0)
    inv = torch.where(scale > 0,
                      torch.ones_like(scale)
                      / torch.maximum(scale, scale.new_tensor(1e-30)),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    return q.reshape(-1)[:d], scale.reshape(-1)


def dequantize_int8_reference(q: torch.Tensor, scales: torch.Tensor,
                              d: int) -> torch.Tensor:
    """The plain version for one segment (the jnp fallback,
    ``fedml_tpu/ops/wire_compression.py:130-133``): ``f32(q) · scale`` per
    row, trimmed to ``d``."""
    rows = int(scales.numel())
    qr = torch.zeros(rows * BLOCK, dtype=torch.int8, device=q.device)
    qr[:q.numel()] = q.reshape(-1)
    out = qr.reshape(rows, BLOCK).float() * scales.reshape(rows, 1).float()
    return out.reshape(-1)[:int(d)]


def _split(t: torch.Tensor, sizes: Sequence[int]):
    return torch.split(t, list(sizes)) if sizes else ()


# ------------------------------------------------------------------ wrappers
def quantize_int8_blocked(flat: torch.Tensor,
                          lengths: Optional[Sequence[int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``[D]`` → (int8 ``[D]``, f32 scales).

    ``lengths`` cuts ``flat`` into segments (one per model leaf) whose
    blocks restart at each segment start; by default ``flat`` is one
    segment.  The scales are packed segment by segment, ``⌈n/BLOCK⌉`` each
    — for one segment, ``⌈D/BLOCK⌉``, the rows the JAX package puts on the
    wire."""
    flat = flat.reshape(-1)
    if flat.device.type == "cpu":
        lens = _lengths(flat.numel(), lengths)
        parts = [quantize_int8_reference(x) for x in _split(flat, lens)]
        return (torch.cat([p[0] for p in parts]) if parts else
                torch.zeros(0, dtype=torch.int8),
                torch.cat([p[1] for p in parts]) if parts else
                torch.zeros(0))
    if flat.device.type != "cuda":
        raise ValueError(f"quantize_int8_blocked: {flat.device} is neither "
                         f"the CPU nor a card")
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise TypeError(f"quantize kernel takes a contiguous float32 vector, "
                        f"not {flat.dtype} with strides {flat.stride()}")
    table, n_seg, rows, total = _segment_table(
        (flat.numel(),) if lengths is None else tuple(lengths), flat.device)
    if total != flat.numel():
        raise ValueError(f"segments of {total} values for a vector of "
                         f"{flat.numel()}")
    q = torch.empty(flat.numel(), dtype=torch.int8, device=flat.device)
    scales = torch.empty(rows, dtype=torch.float32, device=flat.device)
    if rows == 0:
        return q, scales
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    rc = lib.fedml_quantize_int8(flat.data_ptr(), table.data_ptr(), n_seg,
                                 rows, q.data_ptr(), scales.data_ptr(),
                                 _device_index(flat), stream)
    _check_launch(rc, lib, "quantize")
    _count("quantize")
    return q, scales


def dequantize_int8_blocked(q: torch.Tensor, scales: torch.Tensor, d: int,
                            lengths: Optional[Sequence[int]] = None
                            ) -> torch.Tensor:
    """(int8 ``[D]``, f32 scales) → f32 ``[d]``: the inverse of
    ``quantize_int8_blocked`` over the same ``lengths``.  On a card ``d``
    must be ``D``; the plain version, like the JAX package's, trims or pads
    a single segment to ``d``."""
    q = q.reshape(-1)
    scales = scales.reshape(-1)
    if q.device.type == "cpu" and scales.device.type == "cpu":
        if lengths is None:
            return dequantize_int8_reference(q, scales, d)
        lens = _lengths(q.numel(), lengths)
        if int(d) != q.numel():
            raise ValueError(f"dequantize over segments gives all "
                             f"{q.numel()} values, not {d}")
        rows = [n_blocks(n) for n in lens]
        if sum(rows) != scales.numel():
            raise ValueError(f"{scales.numel()} scales for segments that "
                             f"need {sum(rows)}")
        parts = [dequantize_int8_reference(qs, ss, n) for qs, ss, n in
                 zip(_split(q, lens), _split(scales, rows), lens)]
        return torch.cat(parts) if parts else torch.zeros(0)
    dev = q.device
    if dev.type != "cuda" or scales.device != dev:
        raise ValueError(f"dequantize_int8_blocked: q on {q.device} and "
                         f"scales on {scales.device}; both must be on the "
                         f"CPU or on one card")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize kernel takes int8 q and float32 scales, "
                        f"not {q.dtype} and {scales.dtype}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize kernel takes contiguous q and scales")
    if int(d) != q.numel():
        raise ValueError(f"dequantize kernel gives all {q.numel()} values, "
                         f"not {d}")
    lens = (q.numel(),) if lengths is None else tuple(lengths)
    form, rows, total, start = _dequant_plan(lens)
    if total != q.numel():
        raise ValueError(f"segments of {total} values for {q.numel()} q")
    if rows != scales.numel():
        raise ValueError(f"{scales.numel()} scales for segments that need "
                         f"{rows}")
    out = torch.empty(q.numel(), dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if form == "flat":
        rc = lib.fedml_dequantize_int8_flat(q.data_ptr(), scales.data_ptr(),
                                            q.numel(), rows, out.data_ptr(),
                                            _device_index(q), stream)
    elif form == "by_value":
        rc = lib.fedml_dequantize_int8_rows(
            q.data_ptr(), scales.data_ptr(), start.ctypes.data, rows,
            out.data_ptr(), _device_index(q), stream)
    else:
        table, n_seg, _, _ = _segment_table(lens, dev)
        rc = lib.fedml_dequantize_int8(q.data_ptr(), scales.data_ptr(),
                                       table.data_ptr(), n_seg, rows,
                                       out.data_ptr(), _device_index(q),
                                       stream)
    _check_launch(rc, lib, "dequantize")
    with _count_lock:
        LAUNCHES["dequantize"] += 1
        DEQUANT_FORMS[form] += 1
    return out


def topk_select(flat: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k(|x|) of a flat f32 update → (values f32 ``[k]``, indices int32
    ``[k]``), largest magnitude first and, among equal magnitudes, the
    lower index first — ``jax.lax.top_k``'s contract, so ties at the k-th
    magnitude select the same coordinates.  A stable descending sort of
    ``|x|`` gives that order on the CPU and on a card alike;
    ``torch.topk`` leaves the order of ties open."""
    k = max(1, min(int(k), int(flat.numel())))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx.to(torch.int32)


def scatter_flat(values: torch.Tensor, indices: torch.Tensor,
                 size: int) -> torch.Tensor:
    """(values ``[k]``, indices ``[k]``) → dense f32 ``[size]`` (the top-k
    inverse)."""
    out = torch.zeros(int(size), dtype=torch.float32, device=values.device)
    out[indices.long()] = values.float()
    return out
