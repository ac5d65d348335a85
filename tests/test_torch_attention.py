"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go to ``fedml_tpu.ops.pallas_attention`` and to its
port.  On the CPU the port runs the kernel's plain version
(``_reference_residuals``) forward and its blockwise backward; the JAX
package is run two ways: its jnp path (what it computes off the TPU) and
its Pallas kernel in interpret mode (``interpret=True``), whose gradient is
the custom VJP's blockwise backward.

Cases: causal and not, T of 80 (one block, nothing padded) and 200 (padded
to 256, the padded keys masked by ``t_valid``), head dims 16 (the
functional LM's default width: dim 64 over 4 heads), 32 and 64, float32
and bfloat16; a non-causal residual call with ``Tk != T``; the
merge of two partials.

Tolerances, with their reasons:

* float32 against the jnp path, ``atol=rtol=1e-5``: the same operations,
  the products summed in another order;
* float32 against the interpret-mode kernel, ``atol=rtol=2e-5`` (the JAX
  package's own tolerance for the kernel against its reference): the
  kernel adds the softmax over key blocks with rescaling, the plain
  version in one pass;
* bfloat16 outputs, ``atol=rtol=1e-2``: both compute in float32 and round
  once to bfloat16 (relative step 2^-8 ≈ 0.004), and float32 results a few
  ulps apart round one step apart;
* gradients in float32, ``atol=rtol=1e-4`` against autodiff of the plain
  softmax and ``2e-5`` against the same blockwise algorithm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import pallas_attention as jpa
from fedml_tpu_torch.ops import pallas_attention as pa

F32 = dict(atol=1e-5, rtol=1e-5)
KERNEL = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)
GRAD = dict(atol=1e-4, rtol=1e-4)
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}
CASES = [(causal, t, d, dt) for causal in (True, False) for t in (80, 200)
         for d in (16, 32, 64) for dt in ("f32", "bf16")]


def _qkv(seed, t, d, dt, tk=None, b=2, h=2):
    """(jax arrays, torch tensors) of q [b, h, t, d] and k, v [b, h, tk, d]
    from one numpy draw, in the case's dtype on both sides."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, h, t, d), rng.randn(b, h, tk or t, d),
            rng.randn(b, h, tk or t, d)]
    _, jdt, tdt = DTYPES[dt]
    j = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrs]
    p = [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs]
    return j, p


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


@pytest.mark.parametrize("causal,t,d,dt", CASES)
def test_forward_matches_jax_reference(causal, t, d, dt):
    (jq, jk, jv), (q, k, v) = _qkv(t + d, t, d, dt)
    tol = F32 if dt == "f32" else BF16
    o = pa.flash_attention(q, k, v, causal=causal)
    assert o.dtype == q.dtype and o.shape == q.shape
    _close(o, jpa._reference(jq, jk, jv, causal), tol, "flash_attention")
    for tv in (None, t - 7):
        got = pa.flash_attention_residuals(q, k, v, causal=causal,
                                           t_valid=tv)
        want = jpa._reference_residuals(jq, jk, jv, causal, tv)
        for g, w, name in zip(got, want, "olm"):
            assert g.dtype == (q.dtype if name == "o" else torch.float32)
            _close(g, w, tol if name == "o" else F32, name)
    # flax layout [B, T, H, D]
    o_mha = pa.flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal)
    want = jpa.flash_mha(*(x.transpose(0, 2, 1, 3) for x in (jq, jk, jv)),
                         causal=causal)
    _close(o_mha, want, tol, "flash_mha")


@pytest.mark.parametrize("causal,t,d", [(c, t, d) for c in (True, False)
                                        for t in (80, 200)
                                        for d in (16, 32, 64)])
def test_forward_matches_interpret_kernel(causal, t, d):
    """Against the Pallas kernel itself: ``flash_attention`` (T = 200 pads
    to 256 and masks), and ``flash_attention_residuals`` at blocks of 40,
    which divide both lengths so the JAX package runs its kernel."""
    (jq, jk, jv), (q, k, v) = _qkv(t * d, t, d, "f32")
    _close(pa.flash_attention(q, k, v, causal=causal),
           jpa.flash_attention(jq, jk, jv, causal=causal, interpret=True),
           KERNEL, "flash_attention")
    got = pa.flash_attention_residuals(q, k, v, causal=causal, t_valid=t - 9)
    want = jpa.flash_attention_residuals(jq, jk, jv, causal=causal,
                                         block_q=40, block_k=40,
                                         interpret=True, t_valid=t - 9)
    for g, w, name in zip(got, want, "olm"):
        _close(g, w, KERNEL, name)


def test_bf16_matches_interpret_kernel():
    (jq, jk, jv), (q, k, v) = _qkv(5, 80, 64, "bf16")
    _close(pa.flash_attention(q, k, v, causal=True),
           jpa.flash_attention(jq, jk, jv, causal=True, interpret=True),
           BF16)


def test_residuals_with_another_key_length_and_merge():
    """Non-causal partials over Tk = 160 keys for T = 80 queries, split in
    two halves and merged, equal the whole; each partial equals the JAX
    package's (its kernel at block 80, interpret mode)."""
    (jq, jk, jv), (q, k, v) = _qkv(9, 80, 64, "f32", tk=160)
    whole = pa.flash_attention_residuals(q, k, v, causal=False)
    _close(whole[0], jpa._reference_residuals(jq, jk, jv, False)[0], F32)
    parts, jparts = [], []
    for sl in (slice(0, 80), slice(80, 160)):
        parts.append(pa.flash_attention_residuals(
            q, k[:, :, sl], v[:, :, sl], causal=False))
        jparts.append(jpa.flash_attention_residuals(
            jq, jk[:, :, sl], jv[:, :, sl], causal=False, interpret=True))
        for g, w in zip(parts[-1], jparts[-1]):
            _close(g, w, KERNEL)
    merged = pa.merge_attention_partials(*parts)
    want = jpa.merge_attention_partials(*jparts)
    for g, w in zip(merged, want):
        _close(g, w, KERNEL)
    _close(merged[0], whole[0], KERNEL, "merged vs whole")


def _port_grads(q, k, v, do, causal, fn):
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v, causal)
    return torch.autograd.grad(out, (q, k, v), do)


@pytest.mark.parametrize("causal,t,d", [(True, 80, 64), (False, 80, 32),
                                        (True, 200, 32), (False, 200, 64)])
def test_blockwise_backward_three_ways(causal, t, d):
    """The port's gradient (its blockwise backward) against (1) the JAX
    package's ``_flash_backward_blockwise`` called on the same residuals,
    (2) ``jax.grad`` of ``flash_attention(..., interpret=True)`` and (3)
    autodiff of the port's plain softmax."""
    (jq, jk, jv), (q, k, v) = _qkv(t + 3 * d, t, d, "f32")
    rng = np.random.RandomState(t * d + 1)
    do_np = rng.randn(*q.shape).astype(np.float32)
    do = torch.from_numpy(do_np)
    grads = _port_grads(q, k, v, do, causal, pa.flash_attention)

    # (1) the blockwise backward itself, on padded inputs and residuals
    block = min(128, t)
    pad = -(-t // block) * block - t
    padded = [jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)))
              for x in (jq, jk, jv, jnp.asarray(do_np))]
    o, l, m = jpa._reference_residuals(*padded[:3], causal, t)
    want = jpa._flash_backward_blockwise(*padded[:3], o, l, m, padded[3],
                                         causal=causal, t_valid=t,
                                         block_k=block)
    tq, tk_, tv = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                   for x in (q, k, v))
    po, pl, pm = pa.flash_attention_residuals(tq, tk_, tv, causal, t)
    direct = pa._flash_backward_blockwise(
        tq, tk_, tv, po, pl, pm, torch.nn.functional.pad(do, (0, 0, 0, pad)),
        causal=causal, t_valid=t, block_k=block)
    for g, w, name in zip(direct, want, ("dq", "dk", "dv")):
        _close(g, w, KERNEL, f"blockwise {name}")
        _close(g[:, :, :t], w[:, :, :t], KERNEL, name)

    # (2) jax.grad through the custom VJP with the interpret-mode kernel
    jgrads = jax.grad(
        lambda a, b, c: jnp.sum(jpa.flash_attention(
            a, b, c, causal=causal, interpret=True) * jnp.asarray(do_np)),
        argnums=(0, 1, 2))(jq, jk, jv)
    for g, w, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        _close(g, w, KERNEL, f"jax.grad {name}")

    # (3) autodiff of the plain path
    plain = _port_grads(q, k, v, do, causal, pa._reference)
    for g, w, name in zip(grads, plain, ("dq", "dk", "dv")):
        _close(g, w, GRAD, f"plain {name}")


def test_bf16_gradients_come_back_in_bf16():
    (_, _, _), (q, k, v) = _qkv(11, 80, 64, "bf16")
    do = torch.ones(q.shape, dtype=torch.bfloat16)
    grads = _port_grads(q, k, v, do, True, pa.flash_attention)
    plain = _port_grads(q.float(), k.float(), v.float(), do.float(), True,
                        pa._reference)
    for g, w in zip(grads, plain):
        assert g.dtype == torch.bfloat16
        _close(g, w, dict(atol=3e-2, rtol=3e-2))


def test_cpu_path_launches_no_kernel():
    (_, _, _), (q, k, v) = _qkv(2, 80, 64, "f32")
    before = dict(pa.LAUNCHES)
    pa.flash_attention(q, k, v)
    assert pa.LAUNCHES == before

