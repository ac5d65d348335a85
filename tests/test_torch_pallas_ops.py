"""The port's ``ops/pallas_ops.py`` (kernels B7, B8 and B9) and
``serving/quantization.py`` against the JAX package's
``fedml_tpu.ops.pallas_ops`` and ``fedml_tpu.serving.quantization``.

The same numpy inputs (``np.random.default_rng``) go through the JAX
wrappers with their Pallas kernels in interpret mode (``interpret=True``,
as ``tests/test_pallas_ops.py`` runs them) and through the port's wrappers
on CPU tensors, which take the plain versions.  The CUDA kernels are held
to the plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.  Sizes are the JAX tests': ``[10, 3000]``,
the ``{6×17×5, 6×9}`` tree, D = 777 and ``[4, 48] @ [48, 700]``.

Tolerances, by what each side computes:

* Kernel 7 (weighted average): both sides sum C float32 products in
  orders of their own (XLA's dot, PyTorch's matmul), so they agree within
  the float32 bound of such a sum, ``C · 2^-24 · Σ_c |wn_c x_c|`` per
  element; the largest difference seen is 4.3 · 2^-24 of that sum, at
  C = 10 (float32 weights, whose normaliser may differ from JAX's float32
  sum in its last bit).  The normalised weights of integer sample counts
  are JAX's bit for bit.
* Kernel 8 (quantize-mask): bit for bit, on values past the int32 range
  (±40000 · 2^16), ±inf, NaN, exact halves ``2^-17·(2k+1)`` and masks near
  2^32 − 1 whose add wraps.
* Kernel 9 (int8 product): sums of K float32 products in another order,
  ``K · 2^-24 · (|x| @ |q|) · s`` per element; the largest difference
  seen is 1.8 · 2^-24 of ``(|x| @ |q|) · s``, at K = 48.
* ``quantize_matrix_int8``, ``dequantize_matrix`` and
  ``quantize_lm_params``: bit for bit (a max, one correctly rounded
  division per scale and per weight, a half-to-even rounding, a clamp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ml.aggregator.agg_operator import agg_stacked as jax_agg
from fedml_tpu.ops import pallas_ops as jpo
from fedml_tpu.parallel.seq_parallel import init_lm_params
from fedml_tpu.serving import quantization as jq
from fedml_tpu_torch.ml.aggregator.agg_operator import agg_stacked
from fedml_tpu_torch.ops import pallas_ops as po
from fedml_tpu_torch.serving import quantization as q8

U = 2.0 ** -24


def _t(a):
    """numpy → torch (bfloat16 numpy from JAX comes as its float32 value)."""
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """float32 numpy → (the JAX bfloat16 array, the torch bfloat16 tensor)
    of the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, _t(np.asarray(j, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------- kernel 7
#: (C, D, weights kind, dtype)
WAVG_CASES = {
    "jax_test": (10, 3000, "float", "float32"),
    "zero_weights": (10, 3000, "some_zero", "float32"),
    "all_zero_weights": (4, 777, "zero", "float32"),
    "one_client": (1, 777, "float", "float32"),
    "int_weights": (10, 3000, "int", "float32"),
    "bf16": (6, 777, "float", "bfloat16"),
    "ragged": (3, 1027, "int", "float32"),
}


def _wavg_inputs(name):
    c, d, kind, _ = WAVG_CASES[name]
    rng = np.random.default_rng(sorted(WAVG_CASES).index(name))
    x = rng.standard_normal((c, d)).astype(np.float32)
    if kind == "int":
        w = rng.integers(1, 600, c).astype(np.int32)
    elif kind == "zero":
        w = np.zeros(c, np.float32)
    else:
        w = rng.random(c).astype(np.float32)
        if kind == "some_zero":
            w[::3] = 0.0
    return x, w


def _wavg_bound(wn, x):
    """C · 2^-24 · Σ_c |wn_c x_c| per column."""
    return x.shape[0] * U * (np.abs(wn.astype(np.float64))
                             @ np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("name", sorted(WAVG_CASES))
def test_weighted_average_flat_matches_jax(name):
    x, w = _wavg_inputs(name)
    if WAVG_CASES[name][3] == "bfloat16":
        xj, xt = _bf16(x)
        x = np.asarray(xj, np.float32)
    else:
        xj, xt = jnp.asarray(x), _t(x)
    want = np.asarray(jpo.weighted_average_flat(xj, jnp.asarray(w),
                                                interpret=True))
    got = po.weighted_average_flat(xt, _t(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    wn = po.normalized_weights(_t(w)).numpy()
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= _wavg_bound(wn, x)).all(), float(err.max())
    if WAVG_CASES[name][2] == "zero":
        assert not got.any() and not want.any()


@pytest.mark.parametrize("kind", ["int", "float"])
def test_normalized_weights_match_jax(kind):
    """Integer sample counts give JAX's normalised weights bit for bit;
    float32 weights within one float32 step (JAX sums in float32, the port
    in float64 rounded once)."""
    rng = np.random.default_rng(5)
    w = (rng.integers(1, 5000, 10).astype(np.int32) if kind == "int"
         else rng.random(10).astype(np.float32))
    wj = jnp.asarray(w)
    want = np.asarray((wj / jnp.maximum(jnp.sum(wj), 1e-12))
                      .astype(jnp.float32))
    got = po.normalized_weights(_t(w)).numpy()
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2 * U, atol=0)


def _tree(dtype):
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((6, 17, 5)).astype(np.float32),
            "b": rng.standard_normal((6, 9)).astype(np.float32)}
    w = (rng.random(6) * 10).astype(np.float32)
    jt = {k: jnp.asarray(v, dtype) for k, v in tree.items()}
    tt = {k: _t(np.asarray(v, np.float32)).to(getattr(torch, dtype))
          for k, v in jt.items()}
    return jt, tt, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_agg_stacked_pallas_matches_jax(dtype):
    """The tree form, one reduce over the concatenated leaves, each leaf
    cast back: against JAX's ``agg_stacked_pallas`` in interpret mode and
    the port's ``agg_stacked`` (kernel 1's path); bfloat16 leaves within
    one bfloat16 step (float32 sums whose last bits differ may round to
    neighbouring bfloat16 values)."""
    jt, tt, w = _tree(dtype)
    want = jpo.agg_stacked_pallas(jt, jnp.asarray(w), interpret=True)
    got = po.agg_stacked_pallas(tt, _t(w))
    kernel1 = agg_stacked(tt, _t(w))
    assert sorted(got) == ["b", "w"]
    for k in tt:
        assert got[k].dtype == tt[k].dtype
        assert tuple(got[k].shape) == tuple(tt[k].shape[1:])
        g = got[k].float().numpy()
        want_k = np.asarray(jnp.asarray(want[k], jnp.float32))
        if dtype == "float32":
            x = np.asarray(jt[k]).reshape(6, -1)
            bound = _wavg_bound(po.normalized_weights(_t(w)).numpy(),
                                x).reshape(g.shape)
            assert (np.abs(g - want_k) <= bound).all()
            assert (np.abs(g - kernel1[k].numpy()) <= bound).all()
        else:
            np.testing.assert_allclose(g, want_k, rtol=2.0 ** -7, atol=1e-6)
            np.testing.assert_allclose(g, kernel1[k].float().numpy(),
                                       rtol=2.0 ** -7, atol=1e-6)
    # and the JAX package's own tree reduce agrees with both
    ref = jax_agg(jt, jnp.asarray(w))
    np.testing.assert_allclose(
        got["w"].float().numpy(), np.asarray(jnp.asarray(ref["w"],
                                                         jnp.float32)),
        rtol=2.0 ** -7 if dtype == "bfloat16" else 1e-5, atol=1e-5)


# ---------------------------------------------------------------- kernel 8
def _qmask_inputs(d=777):
    """x: random values, then ±40000 (past int32 once scaled), ±inf, NaN,
    exact halves 2^-17·(2k+1) (ties to even after scaling), and values
    that round to ±2^31 − 1 and −2^31; masks: random, then words near
    2^32 − 1 whose add wraps."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(d).astype(np.float32)
    special = np.array([40000.0, -40000.0, np.inf, -np.inf, np.nan,
                        32767.99, -32768.0, 32768.0, 0.0, -0.0],
                       np.float32)
    halves = (2.0 ** -17 * (2 * np.arange(-20, 20) + 1)).astype(np.float32)
    x[:special.size] = special
    x[special.size:special.size + halves.size] = halves
    mask = rng.integers(0, 2 ** 32, size=d, dtype=np.uint32)
    mask[:64] = np.uint32(2 ** 32 - 1) - np.arange(64, dtype=np.uint32)
    return x, mask


def _words_np(t):
    return po.words(t).numpy().view(np.uint32)


def test_quantize_mask_matches_jax_bit_for_bit():
    from fedml_tpu.core.mpc.secagg import mask_model, quantize

    x, mask = _qmask_inputs()
    fused = np.asarray(jpo.quantize_mask(jnp.asarray(x), jnp.asarray(mask),
                                         interpret=True))
    two_step = np.asarray(mask_model(quantize({"x": jnp.asarray(x)})["x"],
                                     jnp.asarray(mask)))
    np.testing.assert_array_equal(fused, two_step)
    got = po.quantize_mask(_t(x), _t(mask.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_words_np(got), fused)
    # a torch.uint32 mask comes back as uint32 words
    got_u = po.quantize_mask(_t(x), _t(mask.view(np.int32)).view(torch.uint32))
    assert got_u.dtype == torch.uint32
    np.testing.assert_array_equal(_words_np(got_u), fused)


@pytest.mark.parametrize("scale", [2.0 ** 16, 1000.0])
def test_fixed_point_saturates_as_xla_does(scale):
    x, _ = _qmask_inputs()
    want = np.asarray(jnp.round(jnp.asarray(x) * scale).astype(jnp.int32))
    got = po.fixed_point(_t(x), scale).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2] == 2 ** 31 - 1 and got[3] == -2 ** 31 and got[4] == 0
    if scale == 2.0 ** 16:
        assert got[0] == 2 ** 31 - 1 and got[1] == -2 ** 31


def test_quantize_mask_takes_bfloat16_x():
    x, mask = _qmask_inputs()
    xj, xt = _bf16(x)
    want = np.asarray(jpo.quantize_mask(xj, jnp.asarray(mask),
                                        interpret=True))
    got = po.quantize_mask(xt, _t(mask.view(np.int32)))
    np.testing.assert_array_equal(_words_np(got), want)


# ---------------------------------------------------------------- kernel 9
#: (M, K, N, x dtype)
MM_CASES = {
    "jax_test": (4, 48, 700, "float32"),
    "decode_m1": (1, 48, 700, "float32"),
    "bf16_x": (4, 48, 700, "bfloat16"),
    "tile_aligned": (16, 64, 128, "float32"),
}


def _mm_inputs(name):
    m, k, n, _ = MM_CASES[name]
    rng = np.random.default_rng(sorted(MM_CASES).index(name) + 6)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("name", sorted(MM_CASES))
def test_int8_matmul_matches_jax(name):
    x, w = _mm_inputs(name)
    qs = jq.quantize_matrix_int8(jnp.asarray(w))
    if MM_CASES[name][3] == "bfloat16":
        xj, xt = _bf16(x)
    else:
        xj, xt = jnp.asarray(x), _t(x)
    want = np.asarray(jpo.int8_matmul(xj, qs["q"], qs["s"], interpret=True))
    ported = q8.quantize_matrix_int8(_t(w))
    got = po.int8_matmul(xt, ported["q"], ported["s"])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    xf = np.abs(np.asarray(jnp.asarray(xj, jnp.float32), np.float64))
    qa = np.abs(np.asarray(qs["q"], np.float64))
    bound = x.shape[1] * U * (xf @ qa) * np.asarray(qs["s"], np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= bound).all(), float((err - bound).max())
    # the quantization tracks the dense matrix, as the JAX test asserts
    assert float(np.abs(w - q8.dequantize_matrix(ported).numpy()).max()) \
        < 0.05


# ------------------------------------------------------------ quantization
def _quant_matrix(shape, seed):
    """A matrix with a zero column (scale 1e-12), a column whose values land
    on .5 after scaling, and a column of one large value."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = (rng.integers(-126, 127, shape[0]) + 0.5).astype(np.float32)
    w[0, 1] = 127.0
    w[:, 2] = 1e-30
    w[3, 2] = 1e30
    return w


@pytest.mark.parametrize("shape", [(48, 700), (768, 3072)])
def test_quantize_matrix_int8_bit_for_bit(shape):
    w = _quant_matrix(shape, shape[0])
    want = jq.quantize_matrix_int8(jnp.asarray(w))
    got = q8.quantize_matrix_int8(_t(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(q8.dequantize_matrix(got).numpy(),
                                  np.asarray(jq.dequantize_matrix(want)))


def test_quantize_lm_params_bit_for_bit():
    params = init_lm_params(jax.random.PRNGKey(0), vocab=50, dim=32,
                            layers=2, heads=4, max_len=16)
    want = jq.quantize_lm_params(params)
    tparams = jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), params)
    got = q8.quantize_lm_params(tparams)
    assert sorted(got) == sorted(want) and len(got["blocks"]) == 2
    np.testing.assert_array_equal(got["embed"].numpy(),
                                  np.asarray(want["embed"]))
    for gb, wb in zip(got["blocks"], want["blocks"]):
        assert sorted(gb) == sorted(wb)
        for k in q8._MATMUL_KEYS:
            for part in ("q", "s"):
                np.testing.assert_array_equal(gb[k][part].numpy(),
                                              np.asarray(wb[k][part]))
        np.testing.assert_array_equal(gb["ln1"]["scale"].numpy(),
                                      np.asarray(wb["ln1"]["scale"]))


# ------------------------------------------------------------ the wrappers
def test_cpu_wrappers_launch_no_kernel():
    """CPU tensors take the plain versions: no launch is counted."""
    before = dict(po.LAUNCHES)
    x, w = _wavg_inputs("jax_test")
    po.weighted_average_flat(_t(x), _t(w))
    xq, mask = _qmask_inputs()
    po.quantize_mask(_t(xq), _t(mask.view(np.int32)))
    xm, wm = _mm_inputs("jax_test")
    qs = q8.quantize_matrix_int8(_t(wm))
    po.int8_matmul(_t(xm), qs["q"], qs["s"])
    assert po.LAUNCHES == before


def test_wrappers_refuse_mixed_devices_and_bad_words():
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="on the CPU or on one card"):
        po.quantize_mask(torch.zeros(4), meta.to(torch.int32))
    with pytest.raises(TypeError, match="int32"):
        po.quantize_mask(torch.zeros(4), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="neither the CPU nor a card"):
        po.int8_matmul(meta.reshape(1, 4), meta.to(torch.int8).reshape(4, 1),
                       torch.zeros(1, device="meta"))
