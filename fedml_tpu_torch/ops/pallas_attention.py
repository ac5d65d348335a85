"""Flash attention: the forward as a CUDA kernel, the backward blockwise.

Port of ``fedml_tpu/ops/pallas_attention.py``, with its public names and
layouts: ``[B, H, T, D]`` for ``flash_attention`` and
``flash_attention_residuals``, ``[B, T, H, D]`` (flax's) for ``flash_mha``.

* The Pallas kernel ``_flash_kernel_residuals`` (body ``_flash_kernel``) is
  ``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a`` built and bound by
  ``ops/cuda_build.py``: bfloat16 on the tensor cores (mma.sync, p kept in
  registers as high and low bfloat16 parts), float32 with FMAs; its source
  note says what bounds it and what the design does about that.  It
  returns ``o`` and the softmax residuals ``l`` (row sum) and ``m`` (row
  max) in float32.
* ``_reference``, ``_reference_residuals`` and ``merge_attention_partials``
  are the JAX package's jnp functions, op for op, in torch.
  ``_reference_residuals`` is the kernel's plain version.
* ``_flash_backward_blockwise`` is jnp in the JAX package, not Pallas; its
  port is plain torch (a loop over key blocks for ``lax.scan``).
* ``_FlashCore`` is the ``jax.custom_vjp`` of ``_flash_core``: the forward
  saves ``(q, k, v, o, l, m)``, the backward is the blockwise recomputation.

Where it runs: a CUDA tensor launches the kernel, or the wrapper raises on
what the kernel does not take (a head dim other than 16, 32, 64 or 128,
another dtype than float32 or bfloat16).  CPU tensors take the plain
version; that is the only way to it.  The JAX package, off the TPU,
returns ``_reference`` from ``flash_attention`` and autodiffs it; the port
runs ``_FlashCore`` on both devices, so the CPU computes what the card
does.

Lengths: ``flash_attention`` pads T to its block sizes and masks the padded
keys with ``t_valid`` (the JAX package's ``:332-345``).  The Pallas grid
needs whole blocks, so ``flash_attention_residuals`` in the JAX package
sends lengths that are not block-aligned, or a causal call with
``Tk != T``, to ``_reference_residuals`` (``:190-191``).  The CUDA kernel
masks a ragged tail itself and takes those lengths too: on the card they
launch the kernel, with the reference's values.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import cuda_build

NEG_INF = -1e30
#: the head dims the CUDA kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
#: launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES = {"flash_attention": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_libs: Dict[str, ctypes.CDLL] = {}

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _ref_scale(d: int, device: torch.device) -> torch.Tensor:
    """``1 / jnp.sqrt(jnp.asarray(d, jnp.float32))``: computed in float32."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                         device=device))


def _reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> torch.Tensor:
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * _ref_scale(q.shape[-1], q.device)
    if causal:
        t = q.shape[2]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _reference_residuals(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, t_valid: Optional[int] = None
                         ) -> Partial:
    """The plain version of the kernel: ``(o, l, m)``, identical math."""
    t, tk = q.shape[2], k.shape[2]
    dev = q.device
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * _ref_scale(q.shape[-1], dev)
    mask = torch.ones((t, tk), dtype=torch.bool, device=dev)
    if t_valid is not None and t_valid < tk:
        mask = mask & (torch.arange(tk, device=dev)[None, :] < t_valid)
    if causal:
        mask = mask & (torch.arange(t, device=dev)[:, None]
                       >= torch.arange(tk, device=dev)[None, :])
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = e.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", e, v.float())
    o = (o / torch.clamp(l[..., None], min=1e-12)).to(q.dtype)
    return o, l, m


def merge_attention_partials(a: Partial, b: Partial) -> Partial:
    """Merge two attention partials (o, l, m) computed over DISJOINT key
    sets for the same queries (o normalized per-partial, l the softmax sum
    in the m-shifted frame, m the row max).  Exact — the flash combine."""
    o_a, l_a, m_a = a
    o_b, l_b, m_b = b
    new_m = torch.maximum(m_a, m_b)
    w_a = l_a * torch.exp(m_a - new_m)
    w_b = l_b * torch.exp(m_b - new_m)
    l = w_a + w_b
    denom = torch.clamp(l, min=1e-12)[..., None]
    o = (o_a.float() * w_a[..., None] + o_b.float() * w_b[..., None]) / denom
    return o.to(o_a.dtype), l, new_m


# ---------------------------------------------------------------- the kernel
def _kernel_lib() -> ctypes.CDLL:
    lib = _libs.get("flash_attention")
    if lib is not None:
        return lib
    lib = cuda_build.load("flash_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.fedml_flash_attention.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i,
                                          i, vp, i, i, ctypes.c_float, i, i,
                                          vp]
    lib.fedml_flash_attention.restype = i
    lib.fedml_cuda_error_string.argtypes = [i]
    lib.fedml_cuda_error_string.restype = ctypes.c_char_p
    _libs["flash_attention"] = lib
    return lib


def _rows_aligned16(x: torch.Tensor) -> bool:
    """Every [.., D] row of ``x`` is contiguous and starts 16-byte aligned,
    as the kernel's tile loads need (a contiguous tensor's rows are: D is
    16, 32, 64 or 128)."""
    per = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % per == 0 for s in x.stride()[:-1]))


def _flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, t_valid: int) -> Partial:
    """Launch the kernel on card tensors; raise on what it does not take."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}"
                         f", v on {v.device}; all must be on the CPU or on "
                         f"one card")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k and v of one dtype, not {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]):
        raise ValueError(f"flash_attention kernel takes q [B, H, T, D] and k,"
                         f" v [B, H, Tk, D], not {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, d = q.shape
    tk = k.shape[2]
    if d not in HEAD_DIMS or min(b, h, t, tk) < 1:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS} and non-empty B, H, T, Tk, not "
                         f"{tuple(q.shape)} with Tk {tk}")
    q, k, v = (x if _rows_aligned16(x) else x.contiguous() for x in (q, k, v))
    o = torch.empty_like(q)        # q's layout: [B, T, H, D] views stay so
    l = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    m = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 12)(*(
        s for x in (q, k, v, o) for s in x.stride()[:3]))
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = float(np.float32(1.0 / float(d) ** 0.5))
    rc = lib.fedml_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(),
        m.data_ptr(), b, h, t, tk, d, ctypes.addressof(strides),
        int(t_valid), int(causal), scale, code,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error"
                           f" {rc} ({lib.fedml_cuda_error_string(rc).decode()}"
                           f")")
    LAUNCHES["flash_attention"] += 1
    return o, l, m


def flash_attention_residuals(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              t_valid: Optional[int] = None) -> Partial:
    """Attention over [B, H, T, D] with its softmax residuals (l, m)
    [B, H, T] in float32, so partial attentions over disjoint key sets merge
    exactly (``merge_attention_partials``).  The key length may differ from
    the query length; keys at or past ``t_valid`` are masked.  The kernel on
    a card, its plain version on the CPU."""
    tk = k.shape[2]
    if t_valid is None:
        t_valid = tk
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return _reference_residuals(q, k, v, causal, t_valid)
    return _flash_forward_cuda(q, k, v, causal, t_valid)


def _flash_backward_blockwise(q, k, v, o, l, m, do, causal: bool,
                              t_valid: int, block_k: int):
    """Exact attention backward with O(T·block_k) score memory: a loop over
    key blocks recomputing p = exp(s − m)/l from the saved softmax
    residuals (FlashAttention-2 backward; the JAX package's ``lax.scan``)."""
    b, h, t, d = q.shape
    tk = k.shape[2]
    if tk % block_k:
        raise ValueError(f"key length {tk} is not a multiple of block_k "
                         f"{block_k}")
    scale = 1.0 / float(d) ** 0.5
    dev = q.device
    qf = q.float()
    do_f = do.float()
    delta = (do_f * o.float()).sum(dim=-1)                      # [B,H,T]
    q_pos = torch.arange(t, device=dev)[:, None]
    dq = torch.zeros((b, h, t, d), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j in range(tk // block_k):
        k_j = k[:, :, j * block_k:(j + 1) * block_k].float()
        v_j = v[:, :, j * block_k:(j + 1) * block_k].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_j) * scale
        k_pos = j * block_k + torch.arange(block_k, device=dev)[None, :]
        mask = k_pos < t_valid
        if causal:
            mask = mask & (q_pos >= k_pos)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        p = p / torch.clamp(l[..., None], min=1e-12)
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, do_f))
        dp = torch.einsum("bhqd,bhkd->bhqk", do_f, v_j)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, k_j) * scale
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale)
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashCore(torch.autograd.Function):
    """Flash attention on block-aligned [B, H, T, D]: the kernel forward
    (the plain version on the CPU) saves the softmax residuals, and the
    blockwise backward recomputes p from them — the JAX package's
    ``_flash_core`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_k: int, t_valid: int):
        o, l, m = flash_attention_residuals(q, k, v, causal=causal,
                                            t_valid=t_valid)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.causal, ctx.t_valid = causal, t_valid
        ctx.block_k = min(block_k, k.shape[2])
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        dq, dk, dv = _flash_backward_blockwise(
            q, k, v, o, l, m, do, causal=ctx.causal, t_valid=ctx.t_valid,
            block_k=ctx.block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Exact attention on [B, H, T, D] via the flash recurrence.

    T is padded to the block size; padded keys are masked out and padded
    query rows sliced off, so any T works.  Differentiable: the forward runs
    the kernel, the backward is the exact blockwise recomputation
    (``_flash_backward_blockwise``)."""
    t = q.shape[2]
    block_q = min(block_q, max(t, 1))
    block_k = min(block_k, max(t, 1))
    t_pad = -(-t // block_q) * block_q
    t_pad = -(-t_pad // block_k) * block_k
    pad = t_pad - t
    if pad:
        pads = (0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(x, pads) for x in (q, k, v))
    out = _FlashCore.apply(q, k, v, causal, block_k, t)
    return out[:, :, :t, :] if pad else out


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """[B, T, H, D] (flax layout) convenience wrapper around
    ``flash_attention``: the transposes are views, and the kernel reads
    and writes through them."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)
