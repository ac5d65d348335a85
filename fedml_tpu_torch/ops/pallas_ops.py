"""The aggregation and serving kernels of ``ops/pallas_ops.py``.

Port of ``fedml_tpu/ops/pallas_ops.py``.  Names, JAX package → port:

* ``_wavg_kernel`` (wrapper ``weighted_average_flat``) → ``csrc/
  pallas_ops.cu`` ``wavg_kernel``, wrapper ``weighted_average_flat``,
  plain version ``weighted_average_flat_reference``: ``[C, D]`` stacked
  client updates and weights ``[C]`` → float32 ``[D]``,
  ``Σ_c (w_c / max(Σw, 1e-12)) · x[c]``; ``agg_stacked_pallas`` reduces a
  whole tree of ``[C, ...]`` leaves in one launch that reads each leaf
  where it lies (``wavg_leaves_kernel``; the JAX wrapper concatenates
  them first) and casts each leaf back to its dtype.  Its launch form
  follows the layout (``weighted_average_plan``): one leaf with values
  takes the flat form, up to ``LEAF_CAPACITY`` leaves and
  ``UNIT_CAPACITY`` units of ``UNIT_COLS`` columns go by value in one
  kernel parameter, larger trees through a table on the card;
  ``WAVG_FORMS`` counts each.  Every form gives the flat form's bits over
  the leaves concatenated;
* ``_qmask_kernel`` (``quantize_mask``) → ``qmask_kernel``, plain version
  ``quantize_mask_reference``: SecAgg's fused quantize and mask add,
  ``uint32(int32(round(x · scale))) + mask`` modulo 2^32;
* ``_int8_mm_kernel`` (``int8_matmul``) → ``int8_mm_tc_kernel`` (the
  tensor cores) or, for decode batches of at most ``gemv_max_m()`` rows,
  ``int8_gemv_kernel`` (the CUDA cores), one launch a product, plain
  version ``int8_matmul_reference``: ``(x @ f32(q)) · s`` for int8 weights
  ``q`` ``[K, N]`` with per-column scales ``s`` ``[N]``.

Contracts, as in the JAX package:

* The weights are normalised once, ``w / max(Σw, 1e-12)`` in float32
  (``normalized_weights``).  The sum is taken in float64 and rounded once,
  so integer weights (sample counts) give ``f32(w) / f32(Σw)``, JAX's
  ``weights / norm`` bit for bit; float32 weights may differ from JAX's
  float32 sum in its last bit.  The columns are then a float32 sum of C
  terms, in client order in the kernel and in cuBLAS's or XLA's order in
  the plain versions: they agree within ``C · 2^-24 · Σ_c |wn_c x_c|``,
  not bit for bit.
* uint32 words travel as ``torch.int32`` tensors with the same bits:
  PyTorch cannot add ``torch.uint32`` tensors, and int32 addition wraps as
  uint32 addition does.  A ``torch.uint32`` mask is taken as its int32
  view and the result comes back in the mask's dtype.  Compare words as
  ``numpy.view(np.uint32)``.
* The fixed-point conversion saturates, as XLA's does: ``round(x · scale)``
  (half to even) past the int32 range becomes ``2^31 − 1`` or ``−2^31``,
  ±inf likewise, and NaN becomes 0.  PyTorch's ``.to(torch.int32)`` does
  not (it gives ``−2^31`` for all of them), so the plain version clamps and
  zeroes NaN itself; the kernel's ``__float2int_rn`` does both.
* ``int8_matmul`` takes x float32 or bfloat16 ``[M, K]`` (read as
  float32), q int8 ``[K, N]`` and s float32 ``[N]``, and returns float32
  ``[M, N]``: the product summed first, then scaled.  The sum's order is
  the kernel's own (K split across the blocks of a cluster, each split in
  order, the splits added in rank order), so it agrees with the plain
  version within ``K · 2^-24 · (|x| @ |q|) · s``, and with itself bit for
  bit from call to call.  On the tensor cores a float32 x enters as three
  bfloat16 parts (``bf16_parts``), each product with q exact, summed in
  float32: an int8 value is exact in bfloat16.

A CUDA tensor launches the kernel or raises, on a dtype, shape, layout or
device the kernel does not take: no path gives way to the plain version.
CPU tensors take the plain versions.  ``LAUNCHES`` counts the launches
where the wrappers make them (``pallas_ops.int8_matmul`` once per
product).  The kernels are built at first use
(``ops/cuda_build.py``), never at import.

The Pallas kernels' 1024-lane blocks and the padding of D and N to them
are TPU layout: the CUDA kernels mask the ragged tail instead.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_unflatten
from . import cuda_build

#: launches of each CUDA kernel of this module, counted where the wrapper
#: launches it (under a lock: SecAgg's silos may mask from threads)
LAUNCHES = {"pallas_ops.weighted_average": 0, "pallas_ops.quantize_mask": 0,
            "pallas_ops.int8_matmul": 0}
#: the weighted average's launches by form (``weighted_average_form``)
WAVG_FORMS = {"flat": 0, "by_value": 0, "table": 0}
#: the by-value form's capacity, one 8 KB kernel parameter
#: (``csrc/pallas_ops.cu`` ``kLeafCapacity``, ``kUnitCapacity``): leaves,
#: and units of ``UNIT_COLS`` output columns, a whole number of the
#: kernel's 128- and 124-column tiles (each unit's first leaf is passed, so
#: that no warp searches the leaves)
LEAF_CAPACITY = 384
UNIT_CAPACITY = 1536
UNIT_COLS = 3968
#: what the tensor-core path multiplies each of ``bf16_parts``' scaled
#: parts of float32 x by, times q: the parts are scaled up by as much
PART_SCALES = (1.0, 2.0 ** -8, 2.0 ** -16)
#: the kernel scales a staged chunk's parts where it holds a nonzero |x|
#: below this (``csrc/pallas_ops.cu`` ``kTinyX``)
TINY_X = 2.0 ** -110
#: SecAgg's default fixed-point scale (``fedml_tpu/ops/pallas_ops.py:109``)
SCALE = 2.0 ** 16
_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_W_CODES = {torch.float32: 0, torch.float64: 2, torch.int32: 3,
            torch.int64: 4}
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load("pallas_ops")
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.fedml_weighted_average.argtypes = [vp, i, vp, i, vp, i, ll,
                                                   i, vp]
            lib.fedml_weighted_average.restype = i
            lib.fedml_wavg_max_clients.argtypes = []
            lib.fedml_wavg_max_clients.restype = i
            lib.fedml_weighted_average_leaves.argtypes = [
                vp, vp, vp, i, vp, i, i, vp, i, vp, i, ll, i, vp]
            lib.fedml_weighted_average_leaves.restype = i
            lib.fedml_weighted_average_table.argtypes = [vp, i, i, vp, i, vp,
                                                         i, ll, i, vp]
            lib.fedml_weighted_average_table.restype = i
            for fn in ("fedml_wavg_leaf_capacity", "fedml_wavg_unit_capacity",
                       "fedml_wavg_unit_cols"):
                getattr(lib, fn).argtypes = []
                getattr(lib, fn).restype = i
            if ((lib.fedml_wavg_leaf_capacity(), lib.fedml_wavg_unit_capacity(),
                 lib.fedml_wavg_unit_cols())
                    != (LEAF_CAPACITY, UNIT_CAPACITY, UNIT_COLS)):
                raise RuntimeError("pallas_ops: the weighted average's "
                                   "by-value capacity differs from the "
                                   "wrapper's")
            lib.fedml_quantize_mask.argtypes = [vp, i, vp, vp,
                                                ctypes.c_float, ll, i, vp]
            lib.fedml_quantize_mask.restype = i
            lib.fedml_int8_gemv_max_m.argtypes = []
            lib.fedml_int8_gemv_max_m.restype = i
            lib.fedml_int8_matmul_plan.argtypes = [i, i, i, i, i, vp]
            lib.fedml_int8_matmul_plan.restype = i
            lib.fedml_int8_matmul.argtypes = [vp, i, ll, vp, vp, vp, i, i,
                                              i, i, vp]
            lib.fedml_int8_matmul.restype = i
            lib.fedml_cuda_error_string.argtypes = [i]
            lib.fedml_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_launch(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({lib.fedml_cuda_error_string(rc).decode()})")


def _on_cpu(what: str, *ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    card; raises when they are split, or on another device type."""
    devs = {t.device for t in ts}
    if len(devs) > 1:
        raise ValueError(f"{what}: operands on {sorted(map(str, devs))}; "
                         f"all must be on the CPU or on one card")
    dev = next(iter(devs))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: {dev} is neither the CPU nor a card")
    return dev.type == "cpu"


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------ weighted average
def normalized_weights(weights: torch.Tensor) -> torch.Tensor:
    """float32 ``[C]``: ``w / max(Σw, 1e-12)``, the sum in float64 rounded
    once to float32 (``fedml_tpu/ops/pallas_ops.py:61-62``; integer
    weights give JAX's bits)."""
    total = weights.double().sum().float()
    return weights.float() / torch.clamp_min(total, 1e-12)


def weighted_average_flat_reference(stacked: torch.Tensor,
                                    weights: torch.Tensor) -> torch.Tensor:
    """The plain version, the JAX package's jnp fallback: ``wn @ f32(x)``."""
    if stacked.dim() != 2 or weights.shape != (stacked.shape[0],):
        raise ValueError(f"weighted_average_flat takes stacked [C, D] and "
                         f"weights [C], not {tuple(stacked.shape)} and "
                         f"{tuple(weights.shape)}")
    return torch.matmul(normalized_weights(weights), stacked.float())


def _check_weights(weights: torch.Tensor, c: int, what: str,
                   operand: str) -> int:
    """The kernel's code for ``weights``' dtype; raises on what the kernel
    does not take."""
    w_code = _W_CODES.get(weights.dtype)
    if w_code is None:
        raise TypeError(f"{what} kernel takes float32, float64, int32 or "
                        f"int64 weights, not {weights.dtype}")
    if weights.shape != (c,) or not weights.is_contiguous():
        raise ValueError(f"{what} kernel takes {operand} and contiguous "
                         f"weights [C], not C = {c} and weights "
                         f"{tuple(weights.shape)}")
    max_c = _kernel_lib().fedml_wavg_max_clients()
    if not 1 <= c <= max_c:
        raise ValueError(f"{what} kernel takes 1..{max_c} clients, not {c}")
    return w_code


def _launch_flat(stacked: torch.Tensor, weights: torch.Tensor, w_code: int,
                 out: torch.Tensor) -> None:
    c, d = stacked.shape
    lib = _kernel_lib()
    rc = lib.fedml_weighted_average(stacked.data_ptr(),
                                    _X_CODES[stacked.dtype],
                                    weights.data_ptr(), w_code,
                                    out.data_ptr(), c, d,
                                    _device_index(stacked), _stream(stacked))
    _check_launch(rc, lib, "weighted_average")
    _count_form("flat")


def _count_form(form: str) -> None:
    with _count_lock:
        LAUNCHES["pallas_ops.weighted_average"] += 1
        WAVG_FORMS[form] += 1


def weighted_average_flat(stacked: torch.Tensor, weights: torch.Tensor
                          ) -> torch.Tensor:
    """``[C, D]`` stacked flat updates, ``[C]`` weights → float32 ``[D]``
    weighted average."""
    if _on_cpu("weighted_average_flat", stacked, weights):
        return weighted_average_flat_reference(stacked, weights)
    if stacked.dtype not in _X_CODES:
        raise TypeError(f"weighted_average kernel takes float32 or bfloat16 "
                        f"updates, not {stacked.dtype}")
    if stacked.dim() != 2 or stacked.shape[1] < 1:
        raise ValueError(f"weighted_average kernel takes stacked [C, D] with "
                         f"D >= 1, not {tuple(stacked.shape)}")
    if not stacked.is_contiguous():
        raise ValueError("weighted_average kernel takes contiguous stacked "
                         "updates")
    w_code = _check_weights(weights, stacked.shape[0], "weighted_average",
                            "stacked [C, D]")
    out = torch.empty(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    _launch_flat(stacked, weights, w_code, out)
    return out


class WavgPlan(NamedTuple):
    """How the tree form reads a layout of leaves (``weighted_average_plan``)."""
    form: str                 # flat, by_value or table
    offsets: Tuple[int, ...]  # each leaf's first output column, last D
    kept: Tuple[int, ...]     # the leaves with columns, in tree order
    first: np.ndarray         # int64 [ceil(D / UNIT_COLS)]: the kept leaf
                              # (index into ``kept``) that holds column
                              # u * UNIT_COLS
    total: int                # D


_wavg_plans: Dict[Tuple[int, ...], WavgPlan] = {}
_PLAN_CACHE = 64


def weighted_average_plan(sizes: Sequence[int]) -> WavgPlan:
    """The tree form's plan for leaves of ``sizes`` columns (values a
    client), in tree order, cached per layout.  The leaves' columns follow
    one another in the output; leaves without columns are left out of the
    kernel's table.  Form: ``flat`` where one leaf has columns, ``by_value``
    up to ``LEAF_CAPACITY`` leaves and ``UNIT_CAPACITY`` units (D below
    2^32), else ``table``."""
    key = tuple(int(n) for n in sizes)
    plan = _wavg_plans.get(key)
    if plan is not None:
        return plan
    if min(key, default=0) < 0:
        raise ValueError(f"leaf sizes {key[:8]}... must be >= 0")
    offsets = tuple(int(v) for v in np.concatenate(
        [[0], np.cumsum(key, dtype=np.int64)]))
    total = offsets[-1]
    kept = tuple(i for i, n in enumerate(key) if n)
    starts = np.asarray([offsets[i] for i in kept], dtype=np.int64)
    units = np.arange(0, total, UNIT_COLS, dtype=np.int64)
    first = np.searchsorted(starts, units, side="right") - 1
    if len(kept) <= 1:
        form = "flat"
    elif (len(kept) <= LEAF_CAPACITY and len(units) <= UNIT_CAPACITY
          and total < 2 ** 32):
        form = "by_value"
    else:
        form = "table"
    plan = WavgPlan(form, offsets, kept, first.astype(np.int64), total)
    with _count_lock:
        if len(_wavg_plans) >= _PLAN_CACHE:
            _wavg_plans.pop(next(iter(_wavg_plans)))
        _wavg_plans[key] = plan
    return plan


def weighted_average_form(sizes: Sequence[int]) -> str:
    """The launch form of the tree form for leaves of ``sizes`` columns:
    ``flat``, ``by_value`` or ``table``."""
    return weighted_average_plan(sizes).form


def _row_fit(ptr: np.ndarray, bf16: np.ndarray, starts: np.ndarray,
             c: int) -> int:
    """How the rows of the leaves sit against the kernel's 4-element chunks
    of the output's columns (``csrc/pallas_ops.cu`` ``RowFit``): 0 where
    every row starts on one, 1 where every row starts on one or halfway, 2
    otherwise.  Row k of leaf l starts ``(ptr_l / its element size −
    starts_l + k · n_l) mod 4`` elements past a chunk."""
    e = (ptr // np.where(bf16 != 0, 2, 4) - starts[:-1]) & 3
    n4 = np.diff(starts) & 3 if c > 1 else np.zeros_like(e)
    if not (e | n4).any():
        return 0
    return 2 if ((e | n4) & 1).any() else 1


def _launch_leaves(plan: WavgPlan, leaves, weights: torch.Tensor,
                   w_code: int, out: torch.Tensor,
                   lib: Optional[ctypes.CDLL] = None) -> None:
    """One launch of the by-value or the table form over ``plan``'s kept
    leaves, through ``lib`` (another build of the same C interface, for
    profiling) or the port's own build."""
    kept = [leaves[i] for i in plan.kept]
    c = int(weights.shape[0])
    ptr = np.fromiter((leaf.data_ptr() for leaf in kept), dtype=np.uint64,
                      count=len(kept))
    bf16 = np.fromiter((leaf.dtype == torch.bfloat16 for leaf in kept),
                       dtype=np.uint8, count=len(kept))
    starts = np.asarray([plan.offsets[i] for i in plan.kept] + [plan.total],
                        dtype=np.int64)
    fit = _row_fit(ptr.view(np.int64), bf16, starts, c)
    lib = lib or _kernel_lib()
    dev, stream = _device_index(weights), _stream(weights)
    if plan.form == "by_value":
        off = starts.astype(np.uint32)
        first = plan.first.astype(np.uint16)
        rc = lib.fedml_weighted_average_leaves(
            ptr.ctypes.data, off.ctypes.data, bf16.ctypes.data, len(kept),
            first.ctypes.data, len(first), fit, weights.data_ptr(), w_code,
            out.data_ptr(), c, plan.total, dev, stream)
    else:
        host = np.concatenate([starts, ptr.view(np.int64),
                               bf16.astype(np.int64), plan.first])
        # through pinned memory, so that the copy joins the stream ahead of
        # the kernel without holding up the host (the caching host
        # allocator keeps the block until the copy has run)
        table = torch.from_numpy(host).pin_memory().to(weights.device,
                                                       non_blocking=True)
        rc = lib.fedml_weighted_average_table(
            table.data_ptr(), len(kept), fit, weights.data_ptr(), w_code,
            out.data_ptr(), c, plan.total, dev, stream)
    _check_launch(rc, lib, f"weighted_average ({plan.form})")
    _count_form(plan.form)


def agg_stacked_pallas(stacked_tree: Any, weights: torch.Tensor) -> Any:
    """The tree form of ``weighted_average_flat``: leaves ``[C, ...]`` →
    their weighted averages, each in its leaf's dtype, equal column for
    column to the flat form over the leaves concatenated.  On the card one
    launch reads every leaf where it lies (``weighted_average_plan``'s
    form) into one float32 ``[D]``; float32 leaves of the result are views
    of it, the others casts."""
    leaves = tree_leaves(stacked_tree)
    if not leaves:
        raise ValueError("agg_stacked_pallas: the tree has no leaves")
    c = int(leaves[0].shape[0]) if leaves[0].dim() else 0
    sizes = [leaf.numel() // c if c else 0 for leaf in leaves]
    if _on_cpu("agg_stacked_pallas", weights, *leaves):
        flat = torch.cat([leaf.reshape(c, -1).float() for leaf in leaves],
                         dim=1)
        return _cut(stacked_tree, leaves,
                    weighted_average_flat_reference(flat, weights),
                    weighted_average_plan(sizes).offsets)
    for leaf in leaves:
        if leaf.dtype not in _X_CODES:
            raise TypeError(f"agg_stacked_pallas kernel takes float32 or "
                            f"bfloat16 leaves, not {leaf.dtype}")
        if leaf.dim() < 1 or leaf.shape[0] != c:
            raise ValueError(f"agg_stacked_pallas kernel takes leaves [C, "
                             f"...] of one C = {c}, not "
                             f"{tuple(leaf.shape)}")
        if not leaf.is_contiguous():
            raise ValueError("agg_stacked_pallas kernel takes contiguous "
                             "leaves")
    w_code = _check_weights(weights, c, "agg_stacked_pallas",
                            "leaves [C, ...]")
    plan = weighted_average_plan(sizes)
    if plan.total < 1:
        raise ValueError("agg_stacked_pallas kernel takes leaves with at "
                         "least one value a client")
    out = torch.empty(plan.total, dtype=torch.float32,
                      device=weights.device)
    if plan.form == "flat":
        _launch_flat(leaves[plan.kept[0]].reshape(c, -1), weights, w_code,
                     out)
    else:
        _launch_leaves(plan, leaves, weights, w_code, out)
    return _cut(stacked_tree, leaves, out, plan.offsets)


def _cut(stacked_tree: Any, leaves, avg: torch.Tensor,
         offsets: Sequence[int]) -> Any:
    """``avg`` cut into the leaves' shapes at ``offsets``, each leaf that
    is not float32 cast to its dtype."""
    out = [avg[offsets[i]:offsets[i + 1]].view(leaf.shape[1:])
           .to(leaf.dtype) for i, leaf in enumerate(leaves)]
    return tree_unflatten(stacked_tree, out)


# -------------------------------------------------------------- quantize-mask
def words(t: torch.Tensor) -> torch.Tensor:
    """A tensor of 32-bit words as ``torch.int32`` (a ``torch.uint32``
    tensor as its int32 view); raises on other dtypes."""
    if t.dtype == torch.int32:
        return t
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    raise TypeError(f"uint32 words travel as int32 (or uint32) tensors, not "
                    f"{t.dtype}")


def fixed_point(x: torch.Tensor, scale: float = SCALE) -> torch.Tensor:
    """int32 ``round(f32(x) · scale)``, half to even, saturating at the
    int32 range and NaN → 0, as XLA's conversion does."""
    r = torch.round(x.float() * scale)
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    return r.double().clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def quantize_mask_reference(x: torch.Tensor, mask: torch.Tensor,
                            scale: float = SCALE) -> torch.Tensor:
    """The plain version, the JAX package's two steps: the fixed-point
    words plus the mask, wrapping modulo 2^32, in the mask's dtype."""
    if x.shape != mask.shape:
        raise ValueError(f"quantize_mask: x {tuple(x.shape)} and mask "
                         f"{tuple(mask.shape)} differ")
    return (fixed_point(x, scale) + words(mask)).view(mask.dtype)


def quantize_mask(x: torch.Tensor, mask: torch.Tensor,
                  scale: float = SCALE) -> torch.Tensor:
    """float ``[D]`` and a uint32 mask ``[D]`` (int32 bits) → masked words
    ``[D]`` in the mask's dtype, in one pass."""
    if _on_cpu("quantize_mask", x, mask):
        return quantize_mask_reference(x, mask, scale)
    m = words(mask)
    code = _X_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"quantize_mask kernel takes float32 or bfloat16 x, "
                        f"not {x.dtype}")
    if x.shape != mask.shape or x.numel() < 1:
        raise ValueError(f"quantize_mask kernel takes x and mask of one "
                         f"non-empty shape, not {tuple(x.shape)} and "
                         f"{tuple(mask.shape)}")
    if not (x.is_contiguous() and m.is_contiguous()):
        raise ValueError("quantize_mask kernel takes contiguous x and mask")
    out = torch.empty_like(m)
    lib = _kernel_lib()
    rc = lib.fedml_quantize_mask(x.data_ptr(), code, m.data_ptr(),
                                 out.data_ptr(), float(np.float32(scale)),
                                 x.numel(), _device_index(x), _stream(x))
    _check_launch(rc, lib, "quantize_mask")
    _count("pallas_ops.quantize_mask")
    return out.view(mask.dtype)


# ------------------------------------------------------- int8 weight product
def bf16_parts(x: torch.Tensor, scaled: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tensor-core path's split of float32 x into three bfloat16 parts,
    as the kernel stages them (``csrc/pallas_ops.cu`` ``split3``): ``hi =
    bf16(x)``, ``mid`` = ``(x − hi) · up`` truncated to bfloat16 (so
    ``hi + mid / up`` never passes x), ``lo`` = the rest times ``up``;
    ``up`` is 2^8 where ``scaled`` (a chunk that holds a nonzero ``|x| <
    TINY_X``), else 1.  Unscaled, ``hi + mid + lo = x`` exactly for finite
    ``|x| >= TINY_X``; scaled, ``hi + mid · 2^-8 + lo · 2^-16 = x``
    (``PART_SCALES``) for every finite x, subnormals included: the scaling
    keeps the parts' bits above bfloat16's least subnormal.  A finite x
    that rounds past bfloat16's largest value takes hi truncated; a
    non-finite x is hi alone (mid and lo 0)."""
    def truncated(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)

    x = x.float()
    up = 1.0 / PART_SCALES[1] if scaled else 1.0
    hi = x.to(torch.bfloat16).float()
    hi = torch.where(torch.isinf(hi) & torch.isfinite(x), truncated(x), hi)
    finite = torch.isfinite(hi)
    r = torch.where(finite, x - hi, torch.zeros_like(x)) * up
    mid = truncated(r)
    lo = ((r - mid) * up).to(torch.bfloat16)
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), lo


def gemv_max_m() -> int:
    """The largest M the int8 product runs on the CUDA cores (the kernel's
    ``kGemvMaxM``); builds the kernels."""
    return _kernel_lib().fedml_int8_gemv_max_m()


def int8_matmul_plan(m: int, k: int, n: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, Any]:
    """How the kernel runs an ``[m, k] @ [k, n]`` product on ``device``,
    for reports: its path, the blocks of a cluster (they split K), K a
    split and the blocks in all."""
    lib = _kernel_lib()
    plan = (ctypes.c_int * 4)()
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    rc = lib.fedml_int8_matmul_plan(m, k, n, _X_CODES[dtype], dev, plan)
    _check_launch(rc, lib, "int8_matmul plan")
    return {"path": {1: "cores", 2: "tensor"}[plan[0]], "splits": plan[1],
            "chunk": plan[2], "blocks": plan[3]}


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """The plain version, the JAX package's jnp fallback:
    ``(f32(x) @ f32(q)) · s``."""
    return torch.matmul(x.float(), q.float()) * s.float()[None, :]


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                ) -> torch.Tensor:
    """x ``[M, K]`` (float32 or bfloat16) @ dequant(q int8 ``[K, N]``,
    s ``[N]``) → float32 ``[M, N]``."""
    if _on_cpu("int8_matmul", x, q, s):
        return int8_matmul_reference(x, q, s)
    code = _X_CODES.get(x.dtype)
    if code is None or q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int8_matmul kernel takes float32 or bfloat16 x, "
                        f"int8 q and float32 s, not {x.dtype}, {q.dtype} and "
                        f"{s.dtype}")
    if (x.dim() != 2 or q.dim() != 2 or s.dim() != 1
            or x.shape[1] != q.shape[0] or s.shape[0] != q.shape[1]
            or min(*x.shape, q.shape[1]) < 1):
        raise ValueError(f"int8_matmul kernel takes non-empty x [M, K], q "
                         f"[K, N] and s [N], not {tuple(x.shape)}, "
                         f"{tuple(q.shape)} and {tuple(s.shape)}")
    if x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"int8_matmul kernel takes x with rows of unit "
                         f"stride, not strides {x.stride()}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("int8_matmul kernel takes contiguous q and s")
    (m, k), n = x.shape, q.shape[1]
    lib = _kernel_lib()
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    rc = lib.fedml_int8_matmul(x.data_ptr(), code, x.stride(0), q.data_ptr(),
                               s.data_ptr(), out.data_ptr(), m, k, n,
                               _device_index(x), _stream(x))
    _check_launch(rc, lib, "int8_matmul")
    _count("pallas_ops.int8_matmul")
    return out
