"""Multi-client 2-D convolution: the forward and weight-gradient kernels.

Port of ``fedml_tpu/ops/pallas_mc_conv.py``.  K clients each convolve
their own batch with their own weights, SAME padding: x is channels-last
per client, ``[K, B, H, W, Ci]``, w is ``[K, kh, kw, Ci, Co]`` and the
output ``[K, B, OH, OW, Co]`` (the JAX package's layouts).

Names, JAX package → port:

* ``_fwd_kernel`` (Pallas; wrapper ``_mc_conv_fwd``) → ``csrc/mc_conv.cu``
  ``fwd_mma_kernel`` / ``fwd_wgmma_kernel`` (bfloat16) and ``fwd_kernel``
  (float32), wrapper ``mc_conv_fwd``, plain version
  ``mc_conv_fwd_reference``;
* ``_wgrad_kernel`` (wrapper ``_mc_conv_wgrad``) → ``wgrad_mma_kernel`` /
  ``wgrad_wgmma_kernel`` (bfloat16, the pixel splits of a client added in
  a thread-block cluster) and ``wgrad_kernel`` (float32), each with a
  split sum where a client's pixels need more blocks than a cluster holds,
  wrapper ``mc_conv_wgrad``, plain version ``mc_conv_wgrad_reference``;
* ``mc_conv`` (a ``jax.custom_vjp``) → ``mc_conv``, the autograd Function
  ``MCConv``;
* ``conv_for_clients(impl=...)``: ``"pallas"`` (or None on a TPU) →
  ``None`` or ``"kernel"``: the kernels on CUDA tensors, their plain
  versions on CPU tensors (which is what ``"interpret"`` gave the JAX
  tests); ``"xla"`` (the vmapped lax conv, the baseline the kernel must
  beat, one grouped conv once XLA lowers it) → ``"library"``: one
  grouped ``F.conv2d`` (groups = K).

Contracts, as in the JAX package:

* SAME padding is asymmetric: ``ph = max((OH − 1)·sh + kh − H, 0)``, low
  ``ph // 2``, high the rest, so a 3×3 stride-2 conv on 32×32 pads (0, 1).
  PyTorch's ``padding=`` is symmetric, so the library paths pad with
  ``F.pad`` first; the kernels mask the halo by index arithmetic and write
  no padded copy of x.
* Types: x and w share one dtype, float32 or bfloat16; anything else
  raises, on the CPU as on the card.  The products accumulate in float32;
  the forward returns x's dtype, the weight gradient float32.
* The backward (``_mc_bwd_rule``) casts g to x's dtype; dw comes from the
  wgrad kernel, cast to w's dtype; for stride (1, 1) and odd kh and kw, dx
  is the forward kernel on g with ``w.flip(1, 2).transpose(3, 4)``, cast
  to x's dtype; every other conv (strided, or an even kernel) takes the
  library conv's input gradient, one grouped call per conv with the same
  asymmetric padding, as the JAX package leaves those to XLA.  In
  ResNet-56 that is 4 of its 57 convs: the 3×3 stride-2 conv and the 1×1
  stride-2 shortcut that open stages 2 and 3.

A CUDA tensor launches the kernel or raises: no path gives way to a plain
or library version.  ``LAUNCHES`` counts kernel launches where the
wrappers make them; ``LIBRARY_CALLS["dx"]`` counts the library input
gradients of the backward, ``LIBRARY_CALLS["fwd"]`` the library arm's
grouped convs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

#: launches of the CUDA kernels, counted where the wrappers launch them
#: (``mc_conv.wgrad``: one per weight gradient, its split sum included)
LAUNCHES = {"mc_conv.fwd": 0, "mc_conv.wgrad": 0}
#: the library's grouped calls: the backward's input gradients of strided
#: or even-kernel convs (``dx``) and ``impl="library"``'s convs (``fwd``)
LIBRARY_CALLS = {"dx": 0, "fwd": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_libs: Dict[str, ctypes.CDLL] = {}

Stride = Tuple[int, int]


def same_padding(h: int, w: int, kh: int, kw: int,
                 stride: Stride) -> Tuple[int, int, Tuple[int, int],
                                          Tuple[int, int]]:
    """``(OH, OW, (top, bottom), (left, right))`` of a SAME conv, as
    ``lax.conv_general_dilated(padding="SAME")`` pads."""
    sh, sw = stride
    oh, ow = -(-h // sh), -(-w // sw)
    ph = max((oh - 1) * sh + kh - h, 0)
    pw = max((ow - 1) * sw + kw - w, 0)
    return oh, ow, (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)


def _stride(stride: Sequence[int]) -> Stride:
    s = tuple(int(v) for v in stride)
    if len(s) != 2 or min(s) < 1:
        raise ValueError(f"mc_conv: stride must be two positive ints, not "
                         f"{stride!r}")
    return s


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """x [K, B, H, W, Ci] and w [K, kh, kw, Ci, Co] of one dtype, float32
    or bfloat16."""
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"mc_conv takes x and w of one dtype, float32 or "
                        f"bfloat16, not {x.dtype} and {w.dtype}")
    if (x.dim() != 5 or w.dim() != 5 or x.shape[0] != w.shape[0]
            or x.shape[4] != w.shape[3] or min(x.shape) < 1
            or min(w.shape) < 1):
        raise ValueError(f"mc_conv takes x [K, B, H, W, Ci] and w "
                         f"[K, kh, kw, Ci, Co], not {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises when they are split
    between the CPU and a card, or across cards."""
    devs = {t.device for t in ts}
    if len(devs) > 1:
        raise ValueError(f"mc_conv: operands on {sorted(map(str, devs))}; "
                         f"all must be on the CPU or on one card")
    return next(iter(devs)).type == "cpu"


# ---------------------------------------------------------- plain versions
def _taps(xp: torch.Tensor, kh: int, kw: int, oh: int, ow: int,
          stride: Stride):
    """The (dy, dx) windows of a padded [K, B, Hp, Wp, C] tensor, each
    [K, B, OH, OW, C], in tap order (dy major)."""
    sh, sw = stride
    for dy in range(kh):
        for dx in range(kw):
            yield xp[:, :, dy:dy + sh * (oh - 1) + 1:sh,
                     dx:dx + sw * (ow - 1) + 1:sw, :]


def _padded_f32(x: torch.Tensor, kh: int, kw: int, stride: Stride):
    _, _, h, w, _ = x.shape
    oh, ow, (pt, pb), (pl, pr) = same_padding(h, w, kh, kw, stride)
    return F.pad(x.float(), (0, 0, pl, pr, pt, pb)), oh, ow


def mc_conv_fwd_reference(x: torch.Tensor, w: torch.Tensor,
                          stride: Sequence[int] = (1, 1)) -> torch.Tensor:
    """The forward kernel's plain version: the im2col patches
    [K, M, kh·kw·Ci] and one float32 product per client with
    [K, kh·kw·Ci, Co], cast to x's dtype (the Pallas kernel's arithmetic)."""
    _check(x, w)
    stride = _stride(stride)
    k, b, _, _, ci = x.shape
    _, kh, kw, _, co = w.shape
    xp, oh, ow = _padded_f32(x, kh, kw, stride)
    patches = torch.cat(list(_taps(xp, kh, kw, oh, ow, stride)), dim=-1)
    out = torch.bmm(patches.reshape(k, b * oh * ow, kh * kw * ci),
                    w.float().reshape(k, kh * kw * ci, co))
    return out.reshape(k, b, oh, ow, co).to(x.dtype)


def mc_conv_wgrad_reference(x: torch.Tensor, g: torch.Tensor, kh: int,
                            kw: int, stride: Sequence[int] = (1, 1)
                            ) -> torch.Tensor:
    """The weight-gradient kernel's plain version: per tap, the float32
    product of the shifted xᵀ [K, Ci, M] with g [K, M, Co], as
    [K, kh, kw, Ci, Co] float32."""
    stride = _stride(stride)
    _check_wgrad(x, g, kh, kw, stride)
    k, b, _, _, ci = x.shape
    co = g.shape[4]
    xp, oh, ow = _padded_f32(x, kh, kw, stride)
    gf = g.float().reshape(k, b * oh * ow, co)
    taps = [torch.bmm(t.reshape(k, b * oh * ow, ci).transpose(1, 2), gf)
            for t in _taps(xp, kh, kw, oh, ow, stride)]
    return torch.stack(taps, dim=1).reshape(k, kh, kw, ci, co)


def _check_wgrad(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                 stride: Stride) -> None:
    if x.dtype not in _DTYPE_CODES or g.dtype != x.dtype:
        raise TypeError(f"mc_conv_wgrad takes x and g of one dtype, float32 "
                        f"or bfloat16, not {x.dtype} and {g.dtype}")
    if x.dim() != 5 or g.dim() != 5 or min(x.shape) < 1 or kh < 1 or kw < 1:
        raise ValueError(f"mc_conv_wgrad takes x [K, B, H, W, Ci] and g "
                         f"[K, B, OH, OW, Co], not {tuple(x.shape)} and "
                         f"{tuple(g.shape)}")
    k, b, h, w, _ = x.shape
    oh, ow, _, _ = same_padding(h, w, kh, kw, stride)
    if tuple(g.shape[:4]) != (k, b, oh, ow) or g.shape[4] < 1:
        raise ValueError(f"mc_conv_wgrad: g {tuple(g.shape)} is not the "
                         f"[K, B, OH, OW, Co] = [{k}, {b}, {oh}, {ow}, Co] "
                         f"of x {tuple(x.shape)} under a {kh}x{kw} stride "
                         f"{stride} conv")


# ---------------------------------------------------------------- kernels
def _kernel_lib() -> ctypes.CDLL:
    lib = _libs.get("mc_conv")
    if lib is not None:
        return lib
    lib = cuda_build.load("mc_conv")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.fedml_mc_conv_fwd.argtypes = [vp, vp, vp] + [i] * 16 + [vp]
    lib.fedml_mc_conv_fwd.restype = i
    lib.fedml_mc_conv_wgrad_splits.argtypes = [i] * 16
    lib.fedml_mc_conv_wgrad_splits.restype = i
    lib.fedml_mc_conv_wgrad.argtypes = [vp, vp, vp, i, vp] + [i] * 16 + [vp]
    lib.fedml_mc_conv_wgrad.restype = i
    lib.fedml_cuda_error_string.argtypes = [i]
    lib.fedml_cuda_error_string.restype = ctypes.c_char_p
    _libs["mc_conv"] = lib
    return lib


def _raise_on(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({lib.fedml_cuda_error_string(abs(rc)).decode()})")


def _launch_args(x: torch.Tensor, kh: int, kw: int, co: int,
                 stride: Stride):
    """The geometry the C interface takes after the pointers:
    K, B, H, W, Ci, OH, OW, Co, kh, kw, sh, sw, top pad, left pad."""
    k, b, h, w, ci = x.shape
    oh, ow, (pt, _), (pl, _) = same_padding(h, w, kh, kw, stride)
    limit = 2 ** 31 - 1
    if max(b * h * w * ci, b * oh * ow * co, kh * kw * ci * co) > limit:
        raise ValueError(f"mc_conv kernel: one client's tensors must index "
                         f"with 32-bit offsets, not x {tuple(x.shape)} to "
                         f"{co} channels")
    return (k, b, h, w, ci, oh, ow, co, kh, kw, stride[0], stride[1], pt, pl)


def _device_and_stream(t: torch.Tensor):
    dev = t.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous from a 16-byte aligned address, as the kernels'
    16-byte loads need (a contiguous view at an odd offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_cuda(x: torch.Tensor, w: torch.Tensor, stride: Stride
              ) -> torch.Tensor:
    x, w = _aligned16(x), _aligned16(w)
    _, kh, kw, _, co = w.shape
    geom = _launch_args(x, kh, kw, co, stride)
    y = torch.empty((geom[0], geom[1], geom[5], geom[6], co), dtype=x.dtype,
                    device=x.device)
    lib = _kernel_lib()
    device, stream = _device_and_stream(x)
    rc = lib.fedml_mc_conv_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                               *geom, _DTYPE_CODES[x.dtype], device, stream)
    _raise_on(rc, lib, "mc_conv forward")
    LAUNCHES["mc_conv.fwd"] += 1
    return y


def _wgrad_cuda(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                stride: Stride) -> torch.Tensor:
    x, g = _aligned16(x), _aligned16(g)
    k, _, _, _, ci = x.shape
    co = g.shape[4]
    geom = _launch_args(x, kh, kw, co, stride)
    lib = _kernel_lib()
    device, stream = _device_and_stream(x)
    splits = lib.fedml_mc_conv_wgrad_splits(*geom, _DTYPE_CODES[x.dtype],
                                            device)
    _raise_on(min(splits, 0), lib, "mc_conv weight-gradient plan")
    dw = torch.empty((k, kh, kw, ci, co), dtype=torch.float32,
                     device=x.device)
    part = (torch.empty((splits,) + tuple(dw.shape), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    rc = lib.fedml_mc_conv_wgrad(
        x.data_ptr(), g.data_ptr(), part.data_ptr() if part is not None
        else None, splits, dw.data_ptr(), *geom, _DTYPE_CODES[x.dtype],
        device, stream)
    _raise_on(rc, lib, "mc_conv weight-gradient")
    LAUNCHES["mc_conv.wgrad"] += 1
    return dw


def mc_conv_fwd(x: torch.Tensor, w: torch.Tensor,
                stride: Sequence[int] = (1, 1)) -> torch.Tensor:
    """[K, B, H, W, Ci] ⊛ [K, kh, kw, Ci, Co] → [K, B, OH, OW, Co], SAME
    padding, in x's dtype: the kernel on a card, its plain version on the
    CPU."""
    _check(x, w)
    stride = _stride(stride)
    if _on_cpu(x, w):
        return mc_conv_fwd_reference(x, w, stride)
    return _fwd_cuda(x, w, stride)


def mc_conv_wgrad(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                  stride: Sequence[int] = (1, 1)) -> torch.Tensor:
    """d/dw of ``mc_conv_fwd``: x [K, B, H, W, Ci] and the cotangent
    g [K, B, OH, OW, Co] → [K, kh, kw, Ci, Co] float32: the kernel on a
    card, its plain version on the CPU."""
    stride = _stride(stride)
    _check_wgrad(x, g, kh, kw, stride)
    if _on_cpu(x, g):
        return mc_conv_wgrad_reference(x, g, kh, kw, stride)
    return _wgrad_cuda(x, g, kh, kw, stride)


# ------------------------------------------------------------ the library
def _library_conv(x: torch.Tensor, w: torch.Tensor, stride: Stride
                  ) -> torch.Tensor:
    """The K clients' SAME convs as one grouped ``F.conv2d`` (groups = K):
    x [K, B, H, W, Ci] padded with ``F.pad`` first and laid out as a
    channels-last [B, K·Ci, Hp, Wp], w as [K·Co, Ci, kh, kw]; the
    channels-last [B, K·Co, OH, OW] result viewed as [K, B, OH, OW, Co].
    ``LIBRARY_CALLS["fwd"]`` counts the call."""
    k, b, h, wd, ci = x.shape
    _, kh, kw, _, co = w.shape
    _, _, (pt, pb), (pl, pr) = same_padding(h, wd, kh, kw, stride)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    hp, wp = xp.shape[2], xp.shape[3]
    xg = xp.permute(1, 2, 3, 0, 4).reshape(b, hp, wp, k * ci
                                           ).permute(0, 3, 1, 2)
    wg = w.permute(0, 4, 1, 2, 3).reshape(k * co, kh, kw, ci
                                          ).permute(0, 3, 1, 2)
    y = F.conv2d(xg, wg, stride=stride, groups=k)
    LIBRARY_CALLS["fwd"] += 1
    oh, ow = y.shape[2], y.shape[3]
    return y.permute(0, 2, 3, 1).reshape(b, oh, ow, k, co
                                         ).permute(3, 0, 1, 2, 4)


def _library_dx(x_shape: torch.Size, w: torch.Tensor, g: torch.Tensor,
                stride: Stride) -> torch.Tensor:
    """dx of a SAME conv by the library: one grouped
    ``torch.nn.grad.conv2d_input`` (groups = K) on the padded input's
    shape, cropped to x's.  g is [K, B, OH, OW, Co] in x's dtype."""
    k, b, h, wd, ci = x_shape
    _, kh, kw, _, co = w.shape
    oh, ow, (pt, pb), (pl, pr) = same_padding(h, wd, kh, kw, stride)
    hp, wp = h + pt + pb, wd + pl + pr
    g2 = g.permute(1, 0, 4, 2, 3).reshape(b, k * co, oh, ow)
    w2 = w.to(g.dtype).permute(0, 4, 3, 1, 2).reshape(k * co, ci, kh, kw)
    dxp = torch.nn.grad.conv2d_input((b, k * ci, hp, wp), w2, g2,
                                     stride=stride, groups=k)
    LIBRARY_CALLS["dx"] += 1
    return (dxp.reshape(b, k, ci, hp, wp)[:, :, :, pt:pt + h, pl:pl + wd]
            .permute(1, 0, 3, 4, 2).contiguous())


# ------------------------------------------------------- the entry points
class MCConv(torch.autograd.Function):
    """``mc_conv``'s custom VJP: the forward kernel, and a backward whose
    dw is the wgrad kernel and whose dx is the forward kernel on flipped
    weights (stride 1, odd kernels) or the library's input gradient."""

    @staticmethod
    def forward(ctx, x, w, stride: Stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return mc_conv_fwd(x, w, stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride = ctx.stride
        kh, kw = w.shape[1], w.shape[2]
        g = gy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = mc_conv_wgrad(x, g, kh, kw, stride).to(w.dtype)
        if ctx.needs_input_grad[0]:
            if stride == (1, 1) and kh % 2 == 1 and kw % 2 == 1:
                # SAME forward and backward paddings coincide only for odd
                # stride-1 kernels: dx = conv(g, flip(w)ᵀ)
                w_flip = w.flip(1, 2).transpose(3, 4).contiguous()
                dx = mc_conv_fwd(g, w_flip, (1, 1)).to(x.dtype)
            else:
                dx = _library_dx(x.shape, w, g, stride).to(x.dtype)
        return dx, dw, None


def mc_conv(x: torch.Tensor, w: torch.Tensor,
            stride: Sequence[int] = (1, 1)) -> torch.Tensor:
    """Multi-client conv: x [K, B, H, W, Ci], per-client kernels
    w [K, kh, kw, Ci, Co], SAME padding → [K, B, OH, OW, Co];
    differentiable in x and w."""
    _check(x, w)
    return MCConv.apply(x, w, _stride(stride))


def conv_for_clients(x: torch.Tensor, w: torch.Tensor,
                     stride: Sequence[int] = (1, 1),
                     impl: Optional[str] = None) -> torch.Tensor:
    """Dispatcher for the K-clients conv:

    * ``impl=None`` or ``"kernel"`` → ``mc_conv``: the CUDA kernels on a
      card, their plain versions on the CPU (the JAX ``"pallas"`` and
      ``"interpret"`` arms);
    * ``impl="library"`` → one grouped ``F.conv2d`` over the K clients,
      padded as SAME pads (the JAX ``"xla"`` arm, which XLA lowers to one
      grouped conv), kept as the measured baseline; it runs only when
      asked.
    """
    _check(x, w)
    stride = _stride(stride)
    if impl in (None, "kernel"):
        return mc_conv(x, w, stride)
    if impl == "library":
        return _library_conv(x, w, stride)
    raise ValueError(f"conv_for_clients: unknown impl {impl!r} (known: None,"
                     f" 'kernel', 'library')")
