"""The port's multi-client conv (``ops/pallas_mc_conv.py``, kernels B13 and
B14) against the JAX package's ``fedml_tpu.ops.pallas_mc_conv``.

The same numpy inputs (``np.random.default_rng``) go through JAX's
``mc_conv(x, w, stride, True)`` — its Pallas kernels in interpret mode, as
``tests/test_mc_conv.py`` runs them — and the port's ``mc_conv`` on CPU
tensors, which takes the kernels' plain versions
(``mc_conv_fwd_reference``, ``mc_conv_wgrad_reference``); the forward,
and dx and dw through ``jax.vjp`` against ``torch.autograd``.  The cases
are ``tests/test_mc_conv.py``'s five, bfloat16 variants of its stride-1
and stride-2 cases, a stem-like case with Ci = 3 and a single client.  The
CUDA kernels are held to the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerances, tighter than the JAX test's own (forward ``atol`` 1e-4,
gradients 1e-3):

* float32 forward and dx: ``atol = rtol = 1e-5``.  Both sides sum the
  same products (at most 144 here) in another order; the error of such a
  sum is below √terms · ulp · Σ|terms| ≈ 12 · 1.2e-7 · 10 ≈ 1.4e-5 at
  these magnitudes, and is 2.2e-6 at most in fact.
* float32 dw: ``atol = 1e-4, rtol = 1e-5``: sums over the batch's output
  pixels (up to 256 terms), with |dw| up to 60.
* bfloat16 (outputs and gradients in bfloat16; dw is cast to w's dtype as
  ``_mc_bwd_rule`` casts it): one bfloat16 step, ``rtol = 2**-7`` with
  ``atol = 1e-5`` for values near 0 — the float32 sums under the cast may
  differ in their last bit and round to neighbouring bfloat16 values.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import pallas_mc_conv as jax_mc
from fedml_tpu_torch.ops import pallas_mc_conv as mc

#: (K, B, H, W, Ci, Co, kh, kw, stride, dtype)
CASES = {
    "s1": (3, 4, 8, 8, 16, 16, 3, 3, (1, 1), "float32"),
    "s2": (2, 4, 8, 8, 16, 32, 3, 3, (2, 2), "float32"),
    "shortcut_1x1_s2": (2, 4, 8, 8, 16, 32, 1, 1, (2, 2), "float32"),
    "odd_spatial": (2, 2, 5, 7, 8, 8, 3, 3, (1, 1), "float32"),
    "even_kernel": (2, 2, 6, 6, 8, 8, 2, 2, (1, 1), "float32"),
    "s1_bf16": (3, 4, 8, 8, 16, 16, 3, 3, (1, 1), "bfloat16"),
    "s2_bf16": (2, 4, 8, 8, 16, 32, 3, 3, (2, 2), "bfloat16"),
    "stem_ci3": (2, 2, 8, 8, 3, 16, 3, 3, (1, 1), "float32"),
    "one_client": (1, 3, 8, 8, 16, 16, 3, 3, (1, 1), "float32"),
}
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-5, rtol=2.0 ** -7)}
DW_TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
          "bfloat16": TOL["bfloat16"]}


def _inputs(name):
    k, b, h, w_, ci, co, kh, kw, stride, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    x = rng.standard_normal((k, b, h, w_, ci)).astype(np.float32)
    w = (rng.standard_normal((k, kh, kw, ci, co)) * 0.1).astype(np.float32)
    oh, ow = -(-h // stride[0]), -(-w_ // stride[1])
    g = rng.standard_normal((k, b, oh, ow, co)).astype(np.float32)
    return x, w, g


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX's (y, dx, dw) in float32 numpy, the Pallas kernels interpreted."""
    stride, dtype = CASES[name][8], getattr(jnp, CASES[name][9])
    x, w, g = _inputs(name)
    y, vjp = jax.vjp(lambda a, b: jax_mc.mc_conv(a, b, stride, True),
                     jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    dx, dw = vjp(jnp.asarray(g, dtype))
    return tuple(np.asarray(jnp.asarray(t, jnp.float32)) for t in (y, dx, dw))


def _port_run(name):
    stride, dtype = CASES[name][8], getattr(torch, CASES[name][9])
    x, w, g = (torch.from_numpy(a).to(dtype) for a in _inputs(name))
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = mc.mc_conv(x, w, stride)
    dx, dw = torch.autograd.grad(y, (x, w), g)
    return y, dx, dw


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    y, _, _ = _port_run(name)
    y_jax = _jax_run(name)[0]
    assert y.dtype == getattr(torch, CASES[name][9])
    assert tuple(y.shape) == y_jax.shape
    np.testing.assert_allclose(y.detach().float().numpy(), y_jax,
                               **TOL[CASES[name][9]])


@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match_jax(name):
    _, dx, dw = _port_run(name)
    _, dx_jax, dw_jax = _jax_run(name)
    dtype = CASES[name][9]
    assert dx.dtype == dw.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(dx.float().numpy(), dx_jax, **TOL[dtype])
    np.testing.assert_allclose(dw.float().numpy(), dw_jax, **DW_TOL[dtype])


@pytest.mark.parametrize("name", ["s1", "s2"])
def test_library_matches_jax_xla(name):
    """``impl="library"`` (one F.conv2d per client, SAME pads first)
    against the JAX ``impl="xla"`` arm, and against the plain kernel path."""
    stride = CASES[name][8]
    x, w, _ = _inputs(name)
    want = np.asarray(jax_mc.conv_for_clients(jnp.asarray(x), jnp.asarray(w),
                                              stride, impl="xla"))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = mc.conv_for_clients(xt, wt, stride, impl="library")
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])
    np.testing.assert_allclose(
        mc.conv_for_clients(xt, wt, stride).numpy(), want, **TOL["float32"])


@pytest.mark.parametrize("name,library_dx", [("s1", 0), ("s2", 1),
                                             ("shortcut_1x1_s2", 1),
                                             ("even_kernel", 1)])
def test_dx_route_follows_the_bwd_rule(name, library_dx):
    """Stride-1 odd convs take dx from the forward path on flipped weights;
    strided and even-kernel convs from one library input gradient.  The CPU
    launches no kernel."""
    before = dict(mc.LAUNCHES), mc.LIBRARY_CALLS["dx"]
    _port_run(name)
    assert mc.LIBRARY_CALLS["dx"] == before[1] + library_dx
    assert mc.LAUNCHES == before[0]


def test_dx_skipped_when_x_needs_no_grad():
    stride = CASES["s2"][8]
    x, w, g = (torch.from_numpy(a) for a in _inputs("s2"))
    w.requires_grad_(True)
    before = mc.LIBRARY_CALLS["dx"]
    y = mc.mc_conv(x, w, stride)
    (dw,) = torch.autograd.grad(y, (w,), g)
    assert mc.LIBRARY_CALLS["dx"] == before
    np.testing.assert_allclose(dw.numpy(), _jax_run("s2")[2],
                               **DW_TOL["float32"])


def test_wgrad_wrapper_matches_jax_kernel():
    """``mc_conv_wgrad`` alone against JAX's ``_mc_conv_wgrad`` (interpret):
    the float32 output of the kernel itself, before the cast to w's dtype."""
    x, _, g = _inputs("s2_bf16")
    kh, kw, stride = 3, 3, (2, 2)
    want = np.asarray(jax_mc._mc_conv_wgrad(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), kh, kw,
        stride=stride, interpret=True))
    got = mc.mc_conv_wgrad(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(g).to(torch.bfloat16), kh, kw,
                           stride)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **DW_TOL["float32"])


@pytest.mark.parametrize("h,k,s,pads", [(32, 3, 1, (1, 1)), (32, 3, 2, (0, 1)),
                                        (32, 1, 2, (0, 0)), (32, 2, 1, (0, 1)),
                                        (5, 3, 1, (1, 1)), (7, 3, 2, (1, 1))])
def test_same_padding_is_lax_same(h, k, s, pads):
    """Asymmetric SAME pads, low = total // 2, as lax pads them: the 3x3
    stride-2 conv on 32x32 pads (0, 1), not (1, 1)."""
    oh, ow, ph, pw = mc.same_padding(h, h, k, k, (s, s))
    assert (oh, ow) == (-(-h // s),) * 2
    assert ph == pw == pads


@pytest.mark.parametrize("xd,wd", [(torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.float32),
                                   (torch.float16, torch.float16),
                                   (torch.float64, torch.float64)])
@pytest.mark.parametrize("entry", ["mc_conv", "library", "fwd"])
def test_dtypes_it_does_not_take_raise(xd, wd, entry):
    x = torch.zeros(2, 1, 4, 4, 8, dtype=xd)
    w = torch.zeros(2, 3, 3, 8, 8, dtype=wd)
    with pytest.raises(TypeError, match="one dtype"):
        if entry == "mc_conv":
            mc.mc_conv(x, w)
        elif entry == "library":
            mc.conv_for_clients(x, w, impl="library")
        else:
            mc.mc_conv_fwd(x, w)


def test_shapes_and_impls_it_does_not_take_raise():
    x = torch.zeros(2, 1, 4, 4, 8)
    with pytest.raises(ValueError, match=r"\[K, B, H, W, Ci\]"):
        mc.mc_conv(x[0], torch.zeros(2, 3, 3, 8, 8))
    with pytest.raises(ValueError, match=r"\[K, B, H, W, Ci\]"):
        mc.mc_conv(x, torch.zeros(3, 3, 3, 8, 8))
    with pytest.raises(ValueError, match="stride"):
        mc.mc_conv(x, torch.zeros(2, 3, 3, 8, 8), (0, 1))
    with pytest.raises(ValueError, match="unknown impl"):
        mc.conv_for_clients(x, torch.zeros(2, 3, 3, 8, 8), impl="xla")
    with pytest.raises(ValueError, match="g .* is not"):
        mc.mc_conv_wgrad(x, torch.zeros(2, 1, 2, 2, 8), 3, 3, (1, 1))
