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
  are JAX's bit for bit.  The tree form's plan (``weighted_average_plan``:
  its launch form on either side of the by-value capacity, the leaves'
  offsets, the units' first leaves) is held exactly; its trees make every
  D mod 4 and every row offset occur.
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


#: leaf sizes (values a client) for the tree form's plan, and its form
PLAN_CASES = {
    "one_leaf_among_empty": ([0, 777, 0], "flat"),
    "at_leaf_capacity": ([3] * po.LEAF_CAPACITY, "by_value"),
    "one_leaf_under": ([3] * (po.LEAF_CAPACITY - 1), "by_value"),
    "one_leaf_over": ([3] * (po.LEAF_CAPACITY + 1), "table"),
    "at_unit_capacity": ([po.UNIT_CAPACITY * po.UNIT_COLS - 5, 5],
                         "by_value"),
    "one_unit_over": ([po.UNIT_CAPACITY * po.UNIT_COLS - 5, 6], "table"),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_weighted_average_plan_chooses_the_form(name):
    """One leaf with values goes flat; up to the by-value capacity (leaves
    and units of ``UNIT_COLS`` columns, one 8 KB kernel parameter) by
    value; past it, the device table."""
    sizes, form = PLAN_CASES[name]
    assert po.weighted_average_form(sizes) == form
    assert po.weighted_average_plan(sizes).total == sum(sizes)


def test_weighted_average_plan_fits_resnet56_by_value():
    """The ResNet-56 variable tree (287 leaves, 860,026 values) goes by
    value in one launch."""
    sizes = [16, 32, 64, 432, 512, 640, 2048, 2304, 4608, 9216, 18432,
             36864, 10]
    counts = [76, 76, 76, 1, 1, 1, 1, 18, 1, 17, 1, 17, 1]
    layout = [n for n, k in zip(sizes, counts) for _ in range(k)]
    assert len(layout) == 287 and sum(layout) == 860026
    plan = po.weighted_average_plan(layout)
    assert plan.form == "by_value" and len(plan.first) == 217


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_average_plan_offsets_and_units(seed):
    """The leaves follow one another in the output; the kept leaves are
    those with values; unit u's first leaf holds column u · UNIT_COLS
    (3,968: 31 warp tiles of 128 columns, or 32 of 124)."""
    rng = np.random.default_rng(seed)
    sizes = [int(n) for n in rng.integers(0, 3 * po.UNIT_COLS, 40)]
    sizes[::7] = [0] * len(sizes[::7])
    sizes += [1, 2, 3]
    plan = po.weighted_average_plan(sizes)
    assert plan.offsets == tuple(np.concatenate([[0], np.cumsum(sizes)]))
    assert plan.kept == tuple(i for i, n in enumerate(sizes) if n)
    assert len(plan.first) == -(-sum(sizes) // po.UNIT_COLS)
    for u, k in enumerate(plan.first):
        leaf = plan.kept[k]
        col = u * po.UNIT_COLS
        assert plan.offsets[leaf] <= col < plan.offsets[leaf + 1]


#: (leaf pointers, bfloat16 flags, output offsets, C) -> the kernel's
#: RowFit: every row on a 4-element chunk of the output (0), on one or
#: halfway (1), anywhere (2)
FIT_CASES = {
    "aligned": ([512, 1024], [0, 0], [0, 16, 32], 10, 0),
    "half_offset": ([512, 1032], [0, 0], [0, 16, 32], 10, 1),
    "odd_offset": ([512, 1028], [0, 0], [0, 16, 32], 10, 2),
    "even_rows": ([512, 1024], [0, 0], [0, 10, 20], 10, 1),
    "odd_rows": ([512, 1024], [0, 0], [0, 16, 33], 10, 2),
    "odd_rows_one_client": ([512, 1024], [0, 0], [0, 16, 33], 1, 0),
    "bf16_half": ([512, 1028], [0, 1], [0, 16, 32], 10, 1),
}


@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_row_fit_of_leaves(name):
    """Row k of leaf l starts (ptr_l / element size − offset_l + k · n_l)
    mod 4 elements past a chunk; the fit is the worst of them."""
    ptr, bf16, starts, c, fit = FIT_CASES[name]
    assert po._row_fit(np.asarray(ptr, np.int64), np.asarray(bf16, np.uint8),
                       np.asarray(starts, np.int64), c) == fit


def _offset_tree(c, dtype, rng):
    """Leaves of 1-7, 33, 130 and 1,027 values a client in shapes of one
    to three dimensions: every D mod 4 and every start mod 4 of a leaf's
    rows in the concatenation."""
    sizes = [1, 2, 3, 4, 5, 6, 7, 130, 33, 1027, 3, 2]
    shapes = [(n,) if i % 3 == 0 else (1, n) if i % 3 == 1 else (n, 1, 1)
              for i, n in enumerate(sizes)]
    tree = {f"l{i:02d}": rng.standard_normal((c,) + shape)
            .astype(np.float32) for i, shape in enumerate(shapes)}
    jt = {k: jnp.asarray(v, dtype) for k, v in tree.items()}
    tt = {k: _t(np.asarray(v, np.float32)).to(getattr(torch, dtype))
          for k, v in jt.items()}
    return jt, tt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 8])
def test_agg_stacked_pallas_at_every_offset_matches_jax(c, dtype):
    """Trees whose leaves make every D mod 4 and every row offset occur:
    each leaf against JAX's ``agg_stacked_pallas`` in interpret mode within
    ``C · 2^-24 · Σ_c |wn_c x_c|``, bfloat16 leaves within one bfloat16
    step of it."""
    rng = np.random.default_rng(10 * c + len(dtype))
    jt, tt = _offset_tree(c, dtype, rng)
    w = rng.integers(1, 600, c).astype(np.int32)
    want = jpo.agg_stacked_pallas(jt, jnp.asarray(w), interpret=True)
    got = po.agg_stacked_pallas(tt, _t(w))
    wn = po.normalized_weights(_t(w)).numpy()
    assert sorted(got) == sorted(tt)
    for k in tt:
        assert got[k].dtype == tt[k].dtype
        assert tuple(got[k].shape) == tuple(tt[k].shape[1:])
        g = got[k].float().numpy()
        want_k = np.asarray(jnp.asarray(want[k], jnp.float32))
        x = np.asarray(jnp.asarray(jt[k], jnp.float32)).reshape(c, -1)
        if dtype == "float32":
            bound = _wavg_bound(wn, x).reshape(g.shape)
            assert (np.abs(g - want_k) <= bound).all(), k
        else:
            np.testing.assert_allclose(g, want_k, rtol=2.0 ** -7, atol=1e-6)


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


def _part_values(kind):
    """float32 values for the tensor-core path's split: seeded magnitudes
    over the whole normal range, seeded magnitudes below 2^-100 (where
    unscaled bfloat16 parts would lose bits, subnormals included), or edge
    values (the largest finite float, values that round past bfloat16's
    largest, powers of two, halfway cases between bfloat16 neighbours,
    2^-110, the least normal and subnormal floats, signed zeros)."""
    if kind in ("seeded", "tiny"):
        rng = np.random.default_rng(11 if kind == "seeded" else 12)
        sign = rng.choice([-1.0, 1.0], 200_000)
        lo, hi = (-110, 127) if kind == "seeded" else (-149, -100)
        return (sign * rng.uniform(1.0, 2.0, 200_000)
                * np.exp2(rng.integers(lo, hi, 200_000))).astype(np.float32)
    f32 = np.finfo(np.float32)
    bf16_max = float(np.asarray(jnp.asarray(3.0e38, jnp.bfloat16)
                                .astype(jnp.float32)))
    edge = [f32.max, -f32.max, 3.4e38, 3.3961e38, bf16_max, 2.0 ** 127,
            1.0, -1.0, 1.0 + 2.0 ** -8, 1.0 + 2.0 ** -8 + 2.0 ** -23,
            1.0 - 2.0 ** -24, 2.0 ** -110, -(2.0 ** -110), f32.tiny, 0.0,
            -0.0, 1.0 + 2.0 ** -16 + 2.0 ** -23, np.pi, -np.e, 2.0 ** -149,
            -(2.0 ** -149), f32.tiny - 2.0 ** -149, 1e-40, -1e-33,
            2.0 ** -125 + 2.0 ** -148, (1.0 + 2.0 ** -8) * 2.0 ** -126]
    return np.asarray(edge, np.float32)


@pytest.mark.parametrize("kind", ["seeded", "tiny", "edges"])
@pytest.mark.parametrize("scaled", [False, True])
def test_bf16_parts_restore_float32_x_exactly(kind, scaled):
    """The parts at their scales add up to x, to the bit: scaled, for every
    finite x; unscaled, for 0 and finite |x| >= 2^-110 (the values of a
    chunk the kernel does not scale).  Each part is a bfloat16 value and
    finite; non-finite x is hi alone."""
    x = _part_values(kind)
    if not scaled:
        x = x[(x == 0) | (np.abs(x) >= po.TINY_X)]
    hi, mid, lo = po.bf16_parts(_t(x), scaled)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    scales = po.PART_SCALES if scaled else (1.0, 1.0, 1.0)
    parts = [p.float().numpy().astype(np.float64) * sc
             for p, sc in zip((hi, mid, lo), scales)]
    np.testing.assert_array_equal(parts[0] + parts[1] + parts[2],
                                  x.astype(np.float64))
    assert all(np.isfinite(p).all() for p in parts)
    # mid and lo sit within one bfloat16 step (2^-7 relative) of the part
    # above (scaled: where that part is at least 2^-110; below, a part can
    # be 0 with the next one not), and hi + mid lies between hi and x (no
    # partial sum passes x)
    for big, small in ((parts[0], parts[1]), (parts[1], parts[2])):
        near = np.abs(big) >= (po.TINY_X if scaled else 0.0)
        assert (np.abs(small[near]) <= np.abs(big[near]) * 2.0 ** -7).all()
    head = parts[0] + parts[1]
    xd = x.astype(np.float64)
    assert (np.minimum(parts[0], xd) <= head).all()
    assert (head <= np.maximum(parts[0], xd)).all()
    specials = _t(np.asarray([np.inf, -np.inf, np.nan], np.float32))
    hi, mid, lo = po.bf16_parts(specials, scaled)
    assert torch.equal(hi[:2].float(), specials[:2]) and hi[2].isnan()
    assert not mid.float().any() and not lo.float().any()


@pytest.mark.parametrize("name", sorted(MM_CASES))
def test_bf16_parts_product_matches_jax(name):
    """The tensor-core path's arithmetic, unscaled and scaled: each bf16
    part of x times q at the part's scale is exact, so the three parts'
    products summed give x @ q; held to the JAX kernel at the float32
    bound of a sum of K terms."""
    x, w = _mm_inputs(name)
    qs = jq.quantize_matrix_int8(jnp.asarray(w))
    want = np.asarray(jpo.int8_matmul(jnp.asarray(x), qs["q"], qs["s"],
                                      interpret=True))
    q = np.asarray(qs["q"], np.float64)
    bound = x.shape[1] * U * (np.abs(x.astype(np.float64)) @ np.abs(q)) \
        * np.asarray(qs["s"], np.float64)
    for scaled, scales in ((False, (1.0, 1.0, 1.0)), (True, po.PART_SCALES)):
        got = sum(p.float().numpy().astype(np.float64) @ (q * sc)
                  for p, sc in zip(po.bf16_parts(_t(x), scaled), scales))
        got = (got.astype(np.float32) * np.asarray(qs["s"])
               ).astype(np.float64)
        assert (np.abs(got - want) <= bound).all(), scaled


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
