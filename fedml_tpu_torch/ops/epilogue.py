"""Round-epilogue kernels: the weighted reduce over the client axis, and the
fused server step (reduce → pseudo-gradient → optimizer → cast).

Port of ``fedml_tpu/ops/epilogue.py``:

* ``weighted_reduce`` and its Pallas ``_reduce_kernel`` — the kernel is
  ``csrc/weighted_reduce.cu``;
* ``EpilogueSpec``, ``NONE_SPEC``, ``spec_from_args``, ``init_opt_state``
  and ``fused_epilogue`` with its Pallas ``_mix_kernel``, ``_sgd_kernel``,
  ``_momentum_kernel`` and ``_adam_kernel`` — one kernel template over the
  four channels, ``csrc/fused_epilogue.cu``;
* ``fold_delta`` and its Pallas ``_delta_kernel``, the fed-LLM adapter
  fold — ``csrc/fold_delta.cu``, one launch per adapter dtype over all its
  leaves, in the launch form ``fold_plan`` picks.

Both are CUDA C++ for ``sm_90a``, built and bound by ``ops/cuda_build.py``;
each source's note says what bounds it and how the design answers that.

Contracts (the JAX package's):

* ``weighted_reduce``: ``out = Σ_c (w_c / max(Σw, 1e-12)) · x[c]``,
  accumulated in float32 and cast back to the input dtype; a non-float input
  gives float32.  Weights need not be normalised; weight 0 masks a client
  out.
* ``fold_delta``: ``tree + server_lr · delta`` per leaf, ``(a_f32 +
  lr_f32 · d_f32)`` cast to the leaf's dtype — the product rounded before
  the sum, as the JAX package's jnp fallback rounds it.
* ``fused_epilogue``: the same reduce, cast to the stacked dtype and back to
  float32 (``_acc_tile``'s double rounding), then in float32 one channel —
  ``none``: ``g + s·(acc − g)`` (``mix_global``); ``sgd``/``momentum``/
  ``adam``: the optax step on the pseudo-gradient ``s·(g − acc)`` — and the
  cast to the global's dtype.  A non-float global takes the aggregate as it
  is.  ``s`` is the mixing rate (``server_lr`` of ``fold_buffer``; 1 on the
  Parrot path).

The fused kernel reads its step's scalars from device memory, as the Pallas
kernel reads its ``p_ref``: row ``t`` of a float32 table that ``step_rows``
fills on the host with ``_step``'s own float32 rounding.  Adam's step count
``t`` is a Python int (the per-round path: the kernel takes ``t`` by value)
or lives in a device tensor (``opt_state["t"]``, the fused rounds: the
wrapper advances it on the device and the kernel reads it), so a launch
captured into a CUDA graph takes each replay's own step.  Without a table
the wrapper rounds the step on the host and the kernel reads a one-row
table of it.

Where it runs: a CUDA tensor launches the kernel, or the wrapper raises on
what the kernel does not take.  CPU tensors take the plain versions,
``weighted_reduce_reference`` and ``fused_epilogue_reference``; that is the
only way to them.

The TPU version makes one ``pallas_call`` per leaf.  Here one call covers a
whole ``[C, D]`` buffer, or a column range of one: the Parrot engine keeps
all leaves of one dtype in one buffer, parameters first, so a FedOpt round
is one ``fused_epilogue`` over the parameter columns and one
``weighted_reduce`` over the BatchNorm columns, and copies no slice.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_map, tree_structure, tree_unflatten
from . import cuda_build

_OPT_CODES = {"none": 0, "sgd": 1, "momentum": 2, "adam": 3}
#: launches of each CUDA kernel of this module, counted where the wrapper
#: launches it: ``fused_epilogue`` by optimizer channel
LAUNCHES = {"weighted_reduce": 0, "fold_delta": 0,
            **{f"fused_epilogue.{opt}": 0 for opt in _OPT_CODES}}
#: the fold's launches by launch form (``fold_plan``), counted beside
#: ``LAUNCHES["fold_delta"]``
FOLD_FORMS = {"flat": 0, "table": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_libs: Dict[str, ctypes.CDLL] = {}


class EpilogueSpec(NamedTuple):
    """Static server-optimizer channel of the fused epilogue.

    ``opt``: none | sgd | momentum | adam (yogi and adagrad stay on the
    unfused arm, ``ml/engine/optimizers.build_server_optimizer``).  ``lr``
    is the server optimizer's step size (FedOpt's ``server_lr``); the
    mixing rate is ``fused_epilogue``'s ``server_lr`` argument."""

    opt: str = "none"
    lr: float = 1.0
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


NONE_SPEC = EpilogueSpec()


def spec_from_args(args: Any) -> Optional[EpilogueSpec]:
    """The fused-channel spec for ``args``'s server optimizer, or None when
    the optimizer has no fused mapping (yogi, adagrad) or the fused epilogue
    is switched off (``fused_epilogue: false``)."""
    if not bool(getattr(args, "fused_epilogue", True)):
        return None
    name = str(getattr(args, "server_optimizer", "adam") or "adam").lower()
    lr = float(getattr(args, "server_lr", 1e-3) or 1e-3)
    if name == "adam":
        return EpilogueSpec(opt="adam", lr=lr)
    if name == "sgd":
        mom = getattr(args, "server_momentum", 0.9)
        if mom:
            return EpilogueSpec(opt="momentum", lr=lr, momentum=float(mom))
        return EpilogueSpec(opt="sgd", lr=lr)
    return None


def init_opt_state(global_flat: torch.Tensor, spec: EpilogueSpec
                   ) -> Optional[Dict[str, Any]]:
    """Zero optimizer state for ``spec`` beside the flat global parameters:
    float32 ``m`` (momentum, adam) and ``v`` (adam) of the same length, and
    adam's step count ``t``."""

    def zeros():
        return torch.zeros(global_flat.numel(), dtype=torch.float32,
                           device=global_flat.device)

    if spec.opt == "momentum":
        return {"m": zeros()}
    if spec.opt == "adam":
        return {"m": zeros(), "v": zeros(), "t": 0}
    return None


def _kernel_lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    lib = cuda_build.load(name)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if name == "weighted_reduce":
        lib.fedml_weighted_reduce.argtypes = [vp, ll, vp, vp, i, ll, i, i, vp]
        lib.fedml_weighted_reduce.restype = i
        lib.fedml_weighted_reduce_max_clients.argtypes = []
        lib.fedml_weighted_reduce_max_clients.restype = i
    elif name == "fold_delta":
        f = ctypes.c_float
        lib.fedml_fold_delta_flat.argtypes = [vp, vp, vp, ll, f, i, i, vp]
        lib.fedml_fold_delta_table.argtypes = [vp, vp, vp, vp, i, ll, f, i,
                                               i, vp]
        for fn in (lib.fedml_fold_delta_flat, lib.fedml_fold_delta_table,
                   lib.fedml_fold_delta_chunk,
                   lib.fedml_fold_delta_table_cols):
            fn.restype = i
        for fn in (lib.fedml_fold_delta_chunk,
                   lib.fedml_fold_delta_table_cols):
            fn.argtypes = []
        if lib.fedml_fold_delta_table_cols() != 5:
            raise RuntimeError("fold_delta: the kernel's table differs "
                               "from the wrapper's")
    else:
        lib.fedml_fused_epilogue.argtypes = [vp, ll, vp, i, vp, vp, vp, vp,
                                             ll, i, i, i, vp, ll, ll, vp, i,
                                             vp]
        lib.fedml_fused_epilogue.restype = i
        lib.fedml_fused_epilogue_max_clients.argtypes = []
        lib.fedml_fused_epilogue_max_clients.restype = i
        lib.fedml_fused_epilogue_num_params.argtypes = []
        lib.fedml_fused_epilogue_num_params.restype = i
    lib.fedml_cuda_error_string.argtypes = [i]
    lib.fedml_cuda_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def _out_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.float32


def _norm_weights(weights: torch.Tensor) -> torch.Tensor:
    w = weights.float()
    return w / torch.clamp(w.sum(), min=1e-12)


def _reduce_f32(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return torch.tensordot(_norm_weights(weights), stacked.float(), dims=1)


def _rows(stacked: torch.Tensor, what: str) -> Tuple[int, int, int]:
    """(C, columns, row stride) of ``stacked``: a contiguous ``[C, ...]``
    tensor, or a column range ``x[:, a:b]`` of a row-major ``[C, D]`` one
    (unit column stride, row stride ``D``)."""
    if stacked.dim() < 1:
        raise ValueError(f"{what}: stacked must lead with the client axis")
    c = int(stacked.shape[0])
    if stacked.is_contiguous():
        d = stacked.numel() // c if c else 0
        return c, d, d
    if (stacked.dim() == 2 and stacked.stride(1) == 1
            and stacked.stride(0) >= stacked.shape[1]):
        return c, int(stacked.shape[1]), int(stacked.stride(0))
    raise ValueError(f"{what} kernel takes a contiguous stacked buffer or a "
                     f"column range of one, not strides {stacked.stride()}")


def _check_launch(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({lib.fedml_cuda_error_string(rc).decode()})")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def _on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


# ------------------------------------------------------------ weighted reduce
def weighted_reduce_reference(stacked: torch.Tensor,
                              weights: torch.Tensor) -> torch.Tensor:
    """The plain version: normalised weights, ``tensordot`` in float32,
    then the cast."""
    return _reduce_f32(stacked, weights).to(_out_dtype(stacked.dtype))


def _into(out: Optional[torch.Tensor], value: torch.Tensor) -> torch.Tensor:
    return value if out is None else out.copy_(value.reshape(out.shape))


def weighted_reduce(stacked: torch.Tensor, weights: torch.Tensor, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted mean of ``stacked`` ([C, ...], or a column range ``[C, n]``
    of a ``[C, D]`` buffer) over its leading client axis with ``weights``
    ([C]); returns a tensor of shape ``stacked.shape[1:]``, written into
    ``out`` when given."""
    if _on_cpu(stacked, weights, out):
        return _into(out, weighted_reduce_reference(stacked, weights))
    dev = stacked.device
    if dev.type != "cuda" or weights.device != dev or (
            out is not None and out.device != dev):
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
    if not weights.is_contiguous():
        raise ValueError("weighted_reduce kernel takes contiguous weights")
    c, d, ld = _rows(stacked, "weighted_reduce")
    lib = _kernel_lib("weighted_reduce")
    max_c = lib.fedml_weighted_reduce_max_clients()
    if not 1 <= c <= max_c or d < 1:
        raise ValueError(f"weighted_reduce kernel takes 1..{max_c} clients "
                         f"and non-empty leaves, not [{c}, {d}]")
    want = _out_dtype(stacked.dtype)
    if out is None:
        out = torch.empty(stacked.shape[1:], dtype=want, device=dev)
    elif (out.dtype != want or out.numel() != d
          or not out.is_contiguous()):
        raise ValueError(f"weighted_reduce: out must be a contiguous {want} "
                         f"tensor of {d} elements, not {out.dtype} "
                         f"{tuple(out.shape)}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fedml_weighted_reduce(stacked.data_ptr(), ld, weights.data_ptr(),
                                   out.data_ptr(), c, d, code,
                                   _device_index(stacked), stream)
    _check_launch(rc, lib, "weighted_reduce")
    LAUNCHES["weighted_reduce"] += 1
    return out


# ------------------------------------------------------------ fused epilogue
class _Step(NamedTuple):
    """The kernel's float32 scalars, in the order of ``struct Params``, and
    adam's new step count (an int, or the device tensor that holds it)."""

    s: float
    lr: float
    mu: float
    b1: float
    omb1: float
    b2: float
    omb2: float
    eps: float
    bc1: float
    bc2: float
    t: Any


#: the scalars of one step, a row of the kernel's table
STEP_COLS = len(_Step._fields) - 1


def _f32(x: Any) -> float:
    return float(np.float32(x))


def _scalars(server_lr: Any, spec: EpilogueSpec,
             t: Optional[int]) -> Tuple[float, ...]:
    """Step ``t``'s scalars rounded to float32 on the host the way the JAX
    package rounds them: Python floats (``1.0 − b1`` computed in float64
    first) met by float32 arrays, and adam's bias corrections ``1 − b^t`` in
    float32 (1 without a step count)."""
    bc1 = bc2 = 1.0
    if t is not None:
        tf = np.float32(t)
        bc1 = float(np.float32(1.0) - np.power(np.float32(spec.b1), tf))
        bc2 = float(np.float32(1.0) - np.power(np.float32(spec.b2), tf))
    return (_f32(float(server_lr)), _f32(spec.lr), _f32(spec.momentum),
            _f32(spec.b1), _f32(1.0 - spec.b1), _f32(spec.b2),
            _f32(1.0 - spec.b2), _f32(spec.eps), bc1, bc2)


def _check_spec(spec: EpilogueSpec, opt_state: Optional[Dict[str, Any]]
                ) -> None:
    if spec.opt not in _OPT_CODES:
        raise ValueError(f"unknown epilogue optimizer {spec.opt!r}")
    if spec.opt in ("momentum", "adam") and opt_state is None:
        raise ValueError(f"{spec.opt} epilogue needs opt_state "
                         f"(init_opt_state)")


def _step(server_lr: Any, spec: EpilogueSpec,
          opt_state: Optional[Dict[str, Any]]) -> _Step:
    """Check ``spec`` against ``opt_state`` and round the step's scalars on
    the host (``_scalars``), adam's after ``t`` advances."""
    _check_spec(spec, opt_state)
    t = int(opt_state["t"]) + 1 if spec.opt == "adam" else None
    return _Step(*_scalars(server_lr, spec, t), t)


class StepRows(NamedTuple):
    """The fused kernel's per-step scalars in device memory: ``rows[i]``
    holds step ``i + 1``'s (``_scalars``), for the mixing rate
    ``server_lr`` and ``spec``.  Without a step count (every channel but
    adam) one row serves every step.  ``final``: the last row also holds
    every later step — adam's bias corrections reached 1 in float32 — so
    the kernel's clamp to the last row is exact; otherwise the table covers
    steps ``1 … len(rows)`` only."""

    rows: torch.Tensor
    final: bool
    server_lr: float
    spec: EpilogueSpec

    def covers(self, t: int) -> bool:
        """Whether step ``t``'s row is in the table."""
        return self.final or t <= self.rows.shape[0]


def step_rows(server_lr: Any, spec: EpilogueSpec, n_steps: int,
              device: Any) -> StepRows:
    """The table for steps ``1 … n_steps`` (cut where adam's bias
    corrections reach 1, past which every row is the same), filled on the
    host with ``_step``'s rounding and copied to ``device`` once."""
    if spec.opt not in _OPT_CODES:
        raise ValueError(f"unknown epilogue optimizer {spec.opt!r}")
    if spec.opt != "adam":
        rows, final = [_scalars(server_lr, spec, None)], True
    else:
        rows, final = [], False
        for t in range(1, max(1, int(n_steps)) + 1):
            rows.append(_scalars(server_lr, spec, t))
            if rows[-1][-2:] == (1.0, 1.0):
                final = True
                break
    return StepRows(torch.tensor(rows, dtype=torch.float32, device=device),
                    final, float(server_lr), spec)


#: one-row device tables of steps rounded on the host, by (device, row)
_host_rows: Dict[Tuple[str, Tuple[float, ...]], torch.Tensor] = {}
_HOST_ROWS_CACHE = 64


def _host_row(scalars: Tuple[float, ...], device: torch.device
              ) -> torch.Tensor:
    key = (str(device), tuple(scalars))
    row = _host_rows.get(key)
    if row is None:
        row = torch.tensor([scalars], dtype=torch.float32, device=device)
        if len(_host_rows) >= _HOST_ROWS_CACHE:
            _host_rows.pop(next(iter(_host_rows)))
        _host_rows[key] = row
    return row


def _device_count(spec: EpilogueSpec, opt_state: Optional[Dict[str, Any]]
                  ) -> Optional[torch.Tensor]:
    """Adam's step count where it lives in a tensor, else None."""
    if spec.opt == "adam" and isinstance(opt_state.get("t"), torch.Tensor):
        return opt_state["t"]
    return None


def _check_steps(steps: Optional[StepRows], server_lr: Any,
                 spec: EpilogueSpec) -> StepRows:
    if steps is None:
        raise ValueError("fused_epilogue: a step count in a tensor needs "
                         "the step table (steps=step_rows(...))")
    if steps.spec != spec or steps.server_lr != float(server_lr):
        raise ValueError(f"fused_epilogue: the step table is for "
                         f"server_lr {steps.server_lr} and {steps.spec}, "
                         f"not {float(server_lr)} and {spec}")
    return steps


def _row_of(t: int, steps: StepRows) -> int:
    """The table row the kernel takes for step ``t``."""
    return min(max(int(t), 1), steps.rows.shape[0]) - 1


def _step_source(server_lr: Any, spec: EpilogueSpec,
                 opt_state: Optional[Dict[str, Any]],
                 steps: Optional[StepRows]
                 ) -> Tuple[Optional[torch.Tensor], Optional[int], Any]:
    """Where the step's scalars come from, and adam's new count: ``(table,
    step, new t)``, the kernel taking row ``step`` of the table, or the
    row of the count in device memory where ``step`` is None (the count
    advanced here, in place); no table where none was given with a count on
    the host (the host then rounds the step, ``_step``)."""
    t_dev = _device_count(spec, opt_state)
    if t_dev is None and steps is None:
        return None, 0, None
    rows = _check_steps(steps, server_lr, spec).rows
    if t_dev is not None:
        return rows, None, t_dev.add_(1)
    if spec.opt != "adam":
        return rows, 0, None
    t = int(opt_state["t"]) + 1
    if not steps.covers(t):
        raise ValueError(f"fused_epilogue: the step table covers "
                         f"{rows.shape[0]} steps, not step {t}")
    return rows, t, t


def _new_state(opt: str, opt_state: Optional[Dict[str, Any]], t: Any
               ) -> Optional[Dict[str, Any]]:
    if opt == "momentum":
        return {"m": opt_state["m"]}
    if opt == "adam":
        return {"m": opt_state["m"], "v": opt_state["v"], "t": t}
    return None


def fused_epilogue_reference(global_flat: torch.Tensor,
                             stacked: torch.Tensor, weights: torch.Tensor,
                             server_lr: Any = 1.0,
                             spec: EpilogueSpec = NONE_SPEC,
                             opt_state: Optional[Dict[str, Any]] = None, *,
                             out: Optional[torch.Tensor] = None,
                             steps: Optional[StepRows] = None
                             ) -> Tuple[torch.Tensor,
                                        Optional[Dict[str, Any]]]:
    """The plain version of ``fused_epilogue``, with its signature and its
    in-place state update: the JAX package's jnp fallback
    (``fedml_tpu/ops/epilogue.py:356-372``) op for op.  Given ``steps``,
    the step's scalars are the kernel's row of it; a step count in a tensor
    advances in place."""
    _check_spec(spec, opt_state)
    if not global_flat.dtype.is_floating_point:
        return (_into(out, weighted_reduce_reference(stacked, weights)),
                opt_state)
    rows, step, t = _step_source(server_lr, spec, opt_state, steps)
    if rows is None:
        st = _step(server_lr, spec, opt_state)
    else:
        row = _row_of(int(t) if step is None else step, steps)
        st = _Step(*rows[row].tolist(), t)
    acc = _reduce_f32(stacked, weights).to(_out_dtype(stacked.dtype)).float()
    gf = global_flat.float()
    if spec.opt == "none":
        new = gf + st.s * (acc - gf)
    else:
        grad = st.s * (gf - acc)
        if spec.opt == "sgd":
            new = gf - st.lr * grad
        elif spec.opt == "momentum":
            m = st.mu * opt_state["m"] + grad
            opt_state["m"].copy_(m)
            new = gf - st.lr * m
        else:
            m = st.b1 * opt_state["m"] + st.omb1 * grad
            v = st.b2 * opt_state["v"] + st.omb2 * grad * grad
            opt_state["m"].copy_(m)
            opt_state["v"].copy_(v)
            mhat = m / st.bc1
            vhat = v / st.bc2
            new = gf - st.lr * mhat / (torch.sqrt(vhat) + st.eps)
    return (_into(out, new.to(global_flat.dtype)),
            _new_state(spec.opt, opt_state, st.t))


def fused_epilogue(global_flat: torch.Tensor, stacked: torch.Tensor,
                   weights: torch.Tensor, server_lr: Any = 1.0,
                   spec: EpilogueSpec = NONE_SPEC,
                   opt_state: Optional[Dict[str, Any]] = None, *,
                   out: Optional[torch.Tensor] = None,
                   steps: Optional[StepRows] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """The whole round epilogue in one pass: weighted reduce → ``server_lr``
    mix / pseudo-gradient → optimizer channel → cast back.

    ``global_flat``: the global parameters, ``[P]``; ``stacked``: the
    clients' ``[C, P]``, contiguous or a column range of a ``[C, D]``
    buffer; ``weights``: ``[C]`` float32.  Returns ``(new_global,
    new_state)`` — the state is None for ``none`` and ``sgd``, ``{"m"}``
    for momentum and ``{"m", "v", "t"}`` for adam.

    In place: ``m`` and ``v`` of ``opt_state`` are updated in place (the
    returned state holds the same tensors), and ``out`` — a new tensor when
    omitted — may be ``global_flat`` itself.  Each element is read and
    written by one thread, so no second copy of the state is needed.

    The step's scalars come from ``steps`` (``step_rows`` for this
    ``server_lr`` and ``spec``, covering the step), row ``t``: adam's ``t``
    is a Python int, passed to the kernel by value, or an int64 tensor on
    the card, advanced here in place by a device add and read by the kernel
    from device memory — nothing on the host reads the count, so the launch
    can be captured into a CUDA graph.  Without ``steps`` (a Python ``t``
    or no count) the host rounds the step and copies its row to the card,
    once per distinct row."""
    if _on_cpu(global_flat, stacked, weights, out,
               *(v for v in (opt_state or {}).values()
                 if isinstance(v, torch.Tensor))):
        return fused_epilogue_reference(global_flat, stacked, weights,
                                        server_lr, spec, opt_state, out=out,
                                        steps=steps)
    _check_spec(spec, opt_state)
    if not global_flat.dtype.is_floating_point:
        # mix_global's contract: a non-float global takes the aggregate as
        # it is, uncast, and the optimizer never touches it
        return weighted_reduce(stacked, weights, out=out), opt_state
    dev = stacked.device
    m = v = None
    if spec.opt in ("momentum", "adam"):
        m = opt_state["m"]
    if spec.opt == "adam":
        v = opt_state["v"]
    tensors = {"global": global_flat, "stacked": stacked, "weights": weights,
               "out": out, "m": m, "v": v}
    if dev.type != "cuda" or any(t is not None and t.device != dev
                                 for t in tensors.values()):
        raise ValueError("fused_epilogue: " + ", ".join(
            f"{k} on {t.device}" for k, t in tensors.items() if t is not None)
            + "; all must be on the CPU or on one card")
    x_code = _DTYPE_CODES.get(stacked.dtype)
    g_code = _DTYPE_CODES.get(global_flat.dtype)
    if x_code not in (0, 1) or g_code not in (0, 1):
        raise TypeError(f"fused_epilogue kernel takes float32 or bfloat16 "
                        f"stacked and global, not {stacked.dtype} and "
                        f"{global_flat.dtype}")
    if weights.dtype != torch.float32 or weights.dim() != 1:
        raise TypeError(f"fused_epilogue kernel takes 1-D float32 weights, "
                        f"not {weights.dtype} of shape {tuple(weights.shape)}")
    for k in ("m", "v"):
        if tensors[k] is not None and tensors[k].dtype != torch.float32:
            raise TypeError(f"fused_epilogue kernel takes float32 {k}, not "
                            f"{tensors[k].dtype}")
    if global_flat.dim() != 1 or stacked.dim() != 2:
        raise ValueError(f"fused_epilogue kernel takes a [P] global and a "
                         f"[C, P] stacked buffer, not "
                         f"{tuple(global_flat.shape)} and "
                         f"{tuple(stacked.shape)}")
    c, p, ld = _rows(stacked, "fused_epilogue")
    if out is None:
        out = torch.empty_like(global_flat)
    elif out.dtype != global_flat.dtype:
        raise TypeError(f"fused_epilogue: out is {out.dtype}, the global "
                        f"{global_flat.dtype}")
    for k, t in (("global", global_flat), ("out", out), ("m", m), ("v", v)):
        if t is not None and (tuple(t.shape) != (p,)
                              or not t.is_contiguous()):
            raise ValueError(f"fused_epilogue kernel takes a contiguous [{p}] "
                             f"{k}, not {tuple(t.shape)} with strides "
                             f"{t.stride()}")
    if c != weights.shape[0] or not weights.is_contiguous():
        raise ValueError(f"fused_epilogue: stacked has {c} clients, the "
                         f"contiguous weights must have as many, not "
                         f"{tuple(weights.shape)}")
    lib = _kernel_lib("fused_epilogue")
    max_c = lib.fedml_fused_epilogue_max_clients()
    if not 1 <= c <= max_c or p < 1:
        raise ValueError(f"fused_epilogue kernel takes 1..{max_c} clients "
                         f"and a non-empty global, not [{c}, {p}]")
    if lib.fedml_fused_epilogue_num_params() != STEP_COLS:
        raise RuntimeError("fused_epilogue: the kernel's scalar count "
                           "differs from the wrapper's")
    t_dev = _device_count(spec, opt_state)
    if t_dev is not None and (t_dev.device != dev or t_dev.dim() != 0
                              or t_dev.dtype != torch.int64):
        raise TypeError(f"fused_epilogue kernel takes adam's t as a 0-d "
                        f"int64 tensor on {dev}, not {t_dev.dtype} "
                        f"{tuple(t_dev.shape)} on {t_dev.device}")
    rows, step, new_t = _step_source(server_lr, spec, opt_state, steps)
    if rows is None:
        st = _step(server_lr, spec, opt_state)
        rows, new_t = _host_row(st[:-1], dev), st.t
    if (rows.device != dev or rows.dtype != torch.float32
            or rows.dim() != 2 or rows.shape[1] != STEP_COLS
            or not rows.is_contiguous()):
        raise ValueError(f"fused_epilogue kernel takes a contiguous float32 "
                         f"[n, {STEP_COLS}] step table on {dev}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fedml_fused_epilogue(
        stacked.data_ptr(), ld, weights.data_ptr(), c, global_flat.data_ptr(),
        out.data_ptr(), m.data_ptr() if m is not None else None,
        v.data_ptr() if v is not None else None, p, _OPT_CODES[spec.opt],
        x_code, g_code, rows.data_ptr(), rows.shape[0], step or 0,
        new_t.data_ptr() if step is None else None, _device_index(stacked),
        stream)
    _check_launch(rc, lib, "fused_epilogue")
    LAUNCHES[f"fused_epilogue.{spec.opt}"] += 1
    return out, _new_state(spec.opt, opt_state, new_t)


# ---------------------------------------------------------------- delta fold
#: device copies of fold segment tables (the launch form of layouts that
#: are not flat), by (device, rows): a layout repeats every round
_fold_tables: Dict[Tuple[str, Tuple[Tuple[int, ...], ...]], torch.Tensor] = {}
_FOLD_TABLE_CACHE = 64


def flat_tree(tree: Any, device: Any = None) -> Any:
    """A copy of ``tree`` whose tensor leaves of each dtype are views into
    one new contiguous buffer, in flatten order — the layout the fold
    kernel takes in one launch per dtype.  On ``device`` when given, else
    on the leaves' own."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree_unflatten(tree_structure(tree), [])
    dev = torch.device(device) if device is not None else leaves[0].device
    sizes: Dict[torch.dtype, int] = {}
    for leaf in leaves:
        sizes[leaf.dtype] = sizes.get(leaf.dtype, 0) + leaf.numel()
    bufs = {dt: torch.empty(n, dtype=dt, device=dev)
            for dt, n in sizes.items()}
    offs = {dt: 0 for dt in sizes}
    out = []
    for leaf in leaves:
        n = leaf.numel()
        view = bufs[leaf.dtype][offs[leaf.dtype]:offs[leaf.dtype] + n]
        view = view.view(leaf.shape)
        view.copy_(leaf.detach())
        offs[leaf.dtype] += n
        out.append(view)
    return tree_unflatten(tree_structure(tree), out)


def fold_delta_reference(tree: Any, delta: Any, server_lr: Any) -> Any:
    """The plain version of ``fold_delta``: the JAX package's jnp fallback
    (``fedml_tpu/ops/epilogue.py:449-451``) leaf by leaf — the rate
    rounded to float32, ``a_f32 + lr · d_f32`` as a product then a sum,
    cast to the leaf's dtype."""
    lr = _f32(float(server_lr))
    leaves = [(a.float() + lr * d.float()).to(a.dtype)
              for a, d in zip(tree_leaves(tree), tree_leaves(delta))]
    return tree_unflatten(tree_structure(tree), leaves)


def _segments(leaves: List[torch.Tensor]
              ) -> Tuple[int, List[int], Optional[torch.Tensor]]:
    """(base pointer, element offsets, packed copy) of ``leaves``: their
    shared storage and each leaf's place in it when they are contiguous
    views into one storage (no copy); otherwise one new buffer holding
    them packed, which the caller keeps until the launch."""
    storage = leaves[0].untyped_storage().data_ptr()
    if all(leaf.is_contiguous()
           and leaf.untyped_storage().data_ptr() == storage
           for leaf in leaves):
        return storage, [int(leaf.storage_offset()) for leaf in leaves], None
    packed = torch.cat([leaf.reshape(-1) for leaf in leaves])
    offs, off = [], 0
    for leaf in leaves:
        offs.append(off)
        off += leaf.numel()
    return packed.data_ptr(), offs, packed


class FoldPlan(NamedTuple):
    """One fold launch: ``form`` is ``"flat"`` (one range, ``rows`` its
    one row) or ``"table"`` (a row a leaf, in device memory); each row is
    ``(a_off, d_off, out_off, len, first_chunk)`` in elements and blocks;
    ``n_chunks`` blocks in all."""

    form: str
    rows: Tuple[Tuple[int, int, int, int, int], ...]
    n_chunks: int


def fold_plan(sizes: List[int], a_offs: List[int], d_offs: List[int],
              o_offs: List[int], chunk: int) -> FoldPlan:
    """The fold kernel's launch form for leaves of ``sizes`` values that
    start at these element offsets from the a, d and out pointers, with
    ``chunk`` values a block: one flat range where the leaves tile all
    three back to back in one order (``flat_tree``'s layout, at any
    offset, which is the fed-LLM round's); else one segment a leaf in a
    device table."""
    starts = list(itertools.accumulate([0] + list(sizes[:-1])))
    if all(offs[i] - offs[0] == starts[i] for offs in (a_offs, d_offs, o_offs)
           for i in range(len(sizes))):
        total = sum(sizes)
        return FoldPlan("flat", ((int(a_offs[0]), int(d_offs[0]),
                                  int(o_offs[0]), total, 0),),
                        -(-total // chunk))
    rows, n_chunks = [], 0
    for n, ao, do, oo in zip(sizes, a_offs, d_offs, o_offs):
        rows.append((int(ao), int(do), int(oo), int(n), n_chunks))
        n_chunks += -(-n // chunk)
    return FoldPlan("table", tuple(rows), n_chunks)


def _fold_table(rows: Tuple[Tuple[int, ...], ...],
                device: torch.device) -> torch.Tensor:
    key = (str(device), rows)
    table = _fold_tables.get(key)
    if table is None:
        table = torch.tensor(rows, dtype=torch.int64, device=device)
        if len(_fold_tables) >= _FOLD_TABLE_CACHE:
            _fold_tables.pop(next(iter(_fold_tables)))
        _fold_tables[key] = table
    return table


def _leaf_pairs(tree: Any, other: Any, what: str) -> List[Tuple[Any, Any]]:
    """The leaves of ``tree`` paired with those of ``other`` at the same
    places; raises ``ValueError`` unless the two trees have one structure
    and the paired leaves one shape."""
    pairs: List[Tuple[Any, Any]] = []
    try:
        tree_map(lambda a, b: pairs.append((a, b)), tree, other)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"fold_delta: {what} is another tree than the "
                         f"adapters") from e
    if len(pairs) != len(tree_leaves(other)) or any(
            a.shape != b.shape for a, b in pairs):
        raise ValueError(f"fold_delta: {what} is another tree than the "
                         f"adapters, or its leaves have other shapes")
    return pairs


def fold_delta(tree: Any, delta: Any, server_lr: Any, *,
               out: Any = None) -> Any:
    """``tree + server_lr · delta`` leaf by leaf — the fed-LLM adapter
    fold: ``(a_f32 + lr · d_f32)`` cast to each leaf's dtype, ``lr`` the
    rate rounded to float32.

    ``tree``: adapter leaves, float32 or bfloat16; ``delta``: float32
    leaves of the same shapes, in a tree of the same structure.  Returns a
    tree of that structure whose leaves of one dtype are views into one new
    buffer (``flat_tree``'s layout), or, given ``out`` (a tree of the same
    structure whose leaves of one dtype lie in one buffer, ``tree`` itself
    for a fold in place), writes there and returns it.

    On a card, one kernel launch per adapter dtype covers all its leaves:
    leaves that are contiguous views into one buffer are read where they
    lie, others are first packed into one buffer (a copy).  The launch
    form is ``fold_plan``'s: one flat range where the leaves of a, d and
    out tile their buffers alike (the fed-LLM round's case), else a table
    of the leaves' segments in device memory.  CPU tensors take
    ``fold_delta_reference``; anything else the kernel does not take
    raises."""
    pairs = _leaf_pairs(tree, delta, "the delta")
    a_leaves = [a for a, _ in pairs]
    d_leaves = [d for _, d in pairs]
    o_leaves = None
    if out is not None:
        o_leaves = [o for _, o in _leaf_pairs(tree, out, "out")]
        if any(o.dtype != a.dtype for o, a in zip(o_leaves, a_leaves)):
            raise ValueError("fold_delta: out must have the adapters' "
                             "dtypes")
    every = a_leaves + d_leaves + (o_leaves or [])
    if _on_cpu(*every):
        ref = fold_delta_reference(tree, delta, server_lr)
        if out is None:
            return flat_tree(ref)
        for o, r in zip(o_leaves, tree_leaves(ref)):
            o.copy_(r)
        return out
    if not a_leaves:
        return tree_map(lambda a: a, tree)
    dev = a_leaves[0].device
    if dev.type != "cuda" or any(t.device != dev for t in every):
        raise ValueError(f"fold_delta: leaves on "
                         f"{sorted({str(t.device) for t in every})}; all "
                         f"must be on the CPU or on one card")
    for a in a_leaves:
        if a.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"fold_delta kernel takes float32 or bfloat16 "
                            f"adapters, not {a.dtype}")
    for d in d_leaves:
        if d.dtype != torch.float32:
            raise TypeError(f"fold_delta kernel takes a float32 delta, not "
                            f"{d.dtype}")
    lr = _f32(float(server_lr))
    lib = _kernel_lib("fold_delta")
    stream = torch.cuda.current_stream(dev).cuda_stream
    device_index = _device_index(a_leaves[0])
    results: List[Optional[torch.Tensor]] = list(o_leaves or a_leaves)
    for dtype in dict.fromkeys(a.dtype for a in a_leaves):
        idx = [i for i, a in enumerate(a_leaves)
               if a.dtype == dtype and a.numel()]
        if o_leaves is None:
            for i, a in enumerate(a_leaves):
                if a.dtype == dtype and not a.numel():
                    results[i] = torch.empty_like(a)
        if not idx:
            continue
        sizes = [a_leaves[i].numel() for i in idx]
        a_ptr, a_offs, a_keep = _segments([a_leaves[i] for i in idx])
        d_ptr, d_offs, d_keep = _segments([d_leaves[i] for i in idx])
        if o_leaves is None:
            o_base = torch.empty(sum(sizes), dtype=dtype, device=dev)
            o_ptr = o_base.data_ptr()
            o_offs = list(itertools.accumulate([0] + sizes[:-1]))
        else:
            o_ptr, o_offs, o_keep = _segments([o_leaves[i] for i in idx])
            if o_keep is not None:
                raise ValueError("fold_delta: out leaves of one dtype must "
                                 "be contiguous views into one buffer")
        plan = fold_plan(sizes, a_offs, d_offs, o_offs,
                         lib.fedml_fold_delta_chunk())
        code = _DTYPE_CODES[dtype]
        if plan.form == "flat":
            ao, do, oo, total, _ = plan.rows[0]
            size = a_leaves[idx[0]].element_size()
            rc = lib.fedml_fold_delta_flat(
                a_ptr + ao * size, d_ptr + do * 4, o_ptr + oo * size, total,
                lr, code, device_index, stream)
        else:
            table = _fold_table(plan.rows, dev)
            rc = lib.fedml_fold_delta_table(
                a_ptr, d_ptr, o_ptr, table.data_ptr(), len(plan.rows),
                plan.n_chunks, lr, code, device_index, stream)
        del a_keep, d_keep      # packed copies: freed in stream order
        _check_launch(rc, lib, "fold_delta")
        LAUNCHES["fold_delta"] += 1
        FOLD_FORMS[plan.form] += 1
        if o_leaves is None:
            for i, part in zip(idx, torch.split(o_base, sizes)):
                results[i] = part.view(a_leaves[i].shape)
    if out is not None:
        return out
    it = iter(results)
    return tree_map(lambda _: next(it), tree)
