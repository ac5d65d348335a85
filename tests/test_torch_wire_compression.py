"""The port's wire codec against the JAX package's, bit for bit.

The same numpy inputs go through ``fedml_tpu.ops.wire_compression`` — the
Pallas ``_quant_kernel`` and ``_dequant_kernel`` in interpret mode
(``interpret=True``) and the jnp fallback (``interpret=None`` on the CPU) —
and through the port's wrappers on CPU tensors, which take the plain
versions.  Quantized values, scales and dequantized values must be equal
bit for bit: the codec's arithmetic is a max, one correctly rounded
division, one product, a half-to-even rounding and a clamp per value, so
the two frameworks have nothing to round differently.  The CUDA kernels
are held against the plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

The ``WireCodec`` payloads (int8, bf16, topk, topk8), the error-feedback
residual, the full-model encode and decode and the wire's flat order are
held to the JAX package's the same way, on trees whose keys sort
differently as strings than as numbers (``BasicBlock_10`` before
``BasicBlock_2``).  The codec tests' top-k inputs have no ties in
``|x|``; ``test_topk_ties_select_what_jax_selects`` holds the ties apart:
4,096 values of four magnitudes, where ``jax.lax.top_k`` takes the lower
index first among equal magnitudes and so must the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.cv import CIFARResNet as JaxResNet
from fedml_tpu.ops import wire_compression as jwc
from fedml_tpu.utils import compression as jcomp
from fedml_tpu.utils.serialization import estimate_nbytes as jax_nbytes
from fedml_tpu_torch.ml.engine.model_bundle import FlatVariables
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.ops import wire_compression as wc
from fedml_tpu_torch.utils import compression as comp
from fedml_tpu_torch.utils.serialization import estimate_nbytes
from fedml_tpu_torch.utils.tree import tree_leaves
from fedml_tpu_torch.utils.weights import from_flax_variables, tree_from_module

SIZES = [1, 511, 512, 513, 32 * 512 + 7, 100_000]


def _vector(d):
    """float32 [d] whose 512-value rows cycle through: random, all zero,
    values on .5 after scaling (max 127, so scale 1), max below 1e-30,
    above 1e30, all negative."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal(d).astype(np.float32)
    for r in range(-(-d // wc.BLOCK)):
        row = slice(r * wc.BLOCK, min(d, (r + 1) * wc.BLOCK))
        n = row.stop - row.start
        kind = (r + d) % 6
        if kind == 1:
            x[row] = 0.0
        elif kind == 2:
            v = rng.integers(-126, 127, n).astype(np.float32) + 0.5
            v[rng.integers(n)] = 127.0
            x[row] = v
        elif kind == 3:
            x[row] *= np.float32(1e-33)
        elif kind == 4:
            x[row] *= np.float32(1e35)
        elif kind == 5:
            x[row] = -np.abs(x[row])
    return x


def _np(t):
    """A JAX array or a torch tensor as numpy, bfloat16 as its raw bits."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _same_bits(got, want, what):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert g.dtype.itemsize == w.dtype.itemsize, (what, g.dtype, w.dtype)
    assert g.tobytes() == w.tobytes(), (
        what, int(np.sum(g.view(np.uint8) != w.view(np.uint8))))


@pytest.mark.parametrize("d", SIZES)
def test_quantize_and_dequantize_match_jax_jnp_bit_for_bit(d):
    """The jnp fallback (``interpret=None`` on the CPU): q, scales and the
    dequantized values, bit for bit."""
    x = _vector(d)
    want_q, want_s = jwc.quantize_int8_blocked(jnp.asarray(x))
    got_q, got_s = wc.quantize_int8_blocked(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.numel() == -(-d // wc.BLOCK)
    _same_bits(got_q, want_q, "q")
    _same_bits(got_s, want_s, "scales")
    _same_bits(wc.dequantize_int8_blocked(got_q, got_s, d),
               jwc.dequantize_int8_blocked(want_q, want_s, d), "dequantized")


@pytest.mark.parametrize("d", SIZES)
def test_quantize_and_dequantize_match_the_pallas_kernels(d):
    """The Pallas kernels in interpret mode: q bit for bit, and the
    dequantize bit for bit on the same (q, scales).  The scales may differ
    in the last bit: in interpret mode XLA computes the kernel's
    ``amax / 127.0`` as ``amax · (1/127)``, which rounds differently from
    the division in one row of 17,000 here (a row of
    ``32·512 + 7``); the port divides, as the jnp fallback does (the
    previous test)."""
    x = _vector(d)
    want_q, want_s = jwc.quantize_int8_blocked(jnp.asarray(x),
                                               interpret=True)
    got_q, got_s = wc.quantize_int8_blocked(torch.from_numpy(x))
    _same_bits(got_q, want_q, "q")
    ulps = np.abs(_np(got_s).view(np.int32).astype(np.int64)
                  - np.asarray(want_s).view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()
    amax = np.abs(np.pad(x, (0, got_s.numel() * wc.BLOCK - d))
                  ).reshape(-1, wc.BLOCK).max(axis=1)
    off = ulps > 0
    assert np.array_equal(np.asarray(want_s)[off],
                          amax[off] * np.float32(1.0 / 127.0))
    _same_bits(wc.dequantize_int8_blocked(got_q, got_s, d),
               jwc.dequantize_int8_blocked(jnp.asarray(got_q.numpy()),
                                           jnp.asarray(got_s.numpy()), d,
                                           interpret=True), "dequantized")


def _non_finite_vector():
    """Four rows of random values with a NaN; +inf; -inf; a NaN and +inf."""
    x = np.random.default_rng(4).standard_normal(4 * wc.BLOCK).astype(
        np.float32)
    x[3] = np.nan
    x[wc.BLOCK + 7] = np.inf
    x[2 * wc.BLOCK + 9] = -np.inf
    x[3 * wc.BLOCK + 1], x[3 * wc.BLOCK + 2] = np.nan, np.inf
    return x


def _same_bits_or_nan(got, want, what):
    """Equal bits, where a NaN matches a NaN of any payload."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.dtype, w.dtype)
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), what
    assert g[~nan].tobytes() == w[~nan].tobytes(), what


@pytest.mark.parametrize("interpret", [None, True], ids=["jnp", "pallas"])
def test_non_finite_rows_decode_to_nan_as_in_jax(interpret):
    """A row with a NaN or an infinity (a diverged update): q all 0, the
    scale NaN or inf, the row decoded to NaN — in the JAX package's jnp
    fallback and Pallas kernel alike, and in the port."""
    x = _non_finite_vector()
    want_q, want_s = jwc.quantize_int8_blocked(jnp.asarray(x),
                                               interpret=interpret)
    got_q, got_s = wc.quantize_int8_blocked(torch.from_numpy(x))
    _same_bits(got_q, want_q, "q")
    _same_bits_or_nan(got_s, want_s, "scales")
    assert not got_q.any()
    assert np.isnan(_np(got_s)[[0, 3]]).all()
    assert np.isinf(_np(got_s)[[1, 2]]).all()
    got = wc.dequantize_int8_blocked(got_q, got_s, x.size)
    _same_bits_or_nan(got, jwc.dequantize_int8_blocked(
        jnp.asarray(got_q.numpy()), jnp.asarray(got_s.numpy()), x.size,
        interpret=interpret), "dequantized")
    assert got.isnan().all()


def test_the_special_rows_come_out_as_the_contract_says():
    """Half to even on .5 values, zero rows at scale 0, tiny rows to 0."""
    x = _vector(6 * wc.BLOCK)        # d % 6 == 0: row r is kind r
    q, s = wc.quantize_int8_blocked(torch.from_numpy(x))
    q = q.reshape(6, wc.BLOCK).numpy()
    halves = x[2 * wc.BLOCK:3 * wc.BLOCK]
    assert float(s[2]) == 1.0
    assert np.array_equal(q[2], np.round(halves).astype(np.int8))
    assert np.any(np.abs(halves - np.trunc(halves)) == 0.5)
    assert float(s[1]) == 0.0 and not q[1].any()
    assert 0 < float(s[3]) < 1e-30 and not q[3].any()
    assert float(s[4]) > 1e30 and np.abs(q[4]).max() == 127
    assert q[5].max() <= 0


def test_segments_restart_the_blocks_like_one_call_per_leaf():
    rng = np.random.default_rng(3)
    lengths = [700, 3, 0, 512, 1029]
    x = rng.standard_normal(sum(lengths)).astype(np.float32) * 4
    q, s = wc.quantize_int8_blocked(torch.from_numpy(x), lengths)
    off, qs, ss = 0, [], []
    for n in lengths:
        jq, js = jwc.quantize_int8_blocked(jnp.asarray(x[off:off + n]))
        qs.append(np.asarray(jq))
        ss.append(np.asarray(js))
        off += n
    _same_bits(q, np.concatenate(qs), "q")
    _same_bits(s, np.concatenate(ss), "scales")
    out = wc.dequantize_int8_blocked(q, s, q.numel(), lengths)
    _same_bits(out, np.concatenate([
        np.asarray(jwc.dequantize_int8_blocked(jnp.asarray(a), jnp.asarray(b),
                                               a.shape[0]))
        for a, b in zip(qs, ss)]), "dequantized")


#: segment layouts for the wire kernels' by-value packing: ResNet-56's 287
#: leaves (1,902 scale rows), a ragged layout with empty segments, and the
#: fed-LLM path's rank-4 adapter leaves (A [d_in, 4] and B [4, d_out] of
#: each of BERT-tiny's five targets)
BY_VALUE_LAYOUTS = {
    "resnet56_leaves": None,
    "ragged": [700, 3, 0, 512, 1029, 1, 0, 5000],
    "adapters": [n for d_in, d_out in [(128, 90), (128, 512), (512, 128),
                                       (128, 512), (512, 128)]
                 for n in (4 * d_in, 4 * d_out)],
}

#: layouts of one non-empty segment, which the wire kernels take flat:
#: part of a row, whole rows, alone or among empty segments
FLAT_LAYOUTS = {
    "one_segment": [5000],
    "one_among_empty": [0, 5000, 0],
    "one_full_row": [512],
    "one_value": [1],
    "two_rows_then_empty": [1024, 0],
}


@pytest.mark.parametrize("layout",
                         sorted(BY_VALUE_LAYOUTS) + sorted(FLAT_LAYOUTS))
def test_segments_by_value_match_the_segment_table(layout):
    """The by-value packing gives each scale row the values the device
    table's segment gives it: row r of segment s starts at in_off + 512 i
    and ends at the next row's start, the segment's end.  Both wire
    kernels take such a layout by value, or flat where it holds one
    non-empty segment, whose rows start at 0, 512, ..."""
    flat = layout in FLAT_LAYOUTS
    lens = (FLAT_LAYOUTS if flat else BY_VALUE_LAYOUTS)[layout]
    if lens is None:
        lens = [t.numel() for t in tree_leaves(tree_from_module(
            CIFARResNet(depth=56, num_classes=10)))]
    start = wc.segments_by_value(lens).astype(np.int64)
    table = wc._segment_table(tuple(lens), torch.device("cpu"))
    assert start.size == table.rows + 1 and start[-1] == table.total
    for in_off, n, out_off, row in table.table.numpy():
        assert in_off == out_off
        rows = wc.n_blocks(n)
        np.testing.assert_array_equal(start[row:row + rows],
                                      in_off + wc.BLOCK * np.arange(rows))
        assert start[row + rows] == in_off + n
    if flat:
        np.testing.assert_array_equal(
            start, np.append(np.arange(0, table.total, wc.BLOCK),
                             table.total))
    want = "flat" if flat else "by_value"
    assert wc.quantize_form(lens) == want
    assert wc.dequantize_form(lens) == want


@pytest.mark.parametrize("past", ["rows", "values"])
def test_dequantize_form_switches_at_the_by_value_capacity(past):
    """One segment is flat; up to the capacity the segments go by value;
    one scale row more, or 2^32 values, go through the device table."""
    cap = wc.ROWS_CAPACITY
    lens = {"rows": [wc.BLOCK] * (cap - 1) + [7],
            "values": [2 ** 31, 2 ** 31 - 1]}[past]
    more = {"rows": lens + [1],
            "values": [2 ** 31, 2 ** 31]}[past]
    if past == "rows":
        assert wc.dequantize_form(lens) == "by_value"
        assert wc.segments_by_value(lens).size == cap + 1
    assert wc.segments_by_value(more) is None
    assert wc.quantize_form(more) == "table"
    assert wc.dequantize_form(more) == "table"
    assert wc.dequantize_form([0, sum(more), 0]) == "flat"


def test_topk_and_scatter_match_jax():
    x = np.random.default_rng(5).permutation(4000).astype(np.float32)
    x = (x + 1) * np.where(np.arange(4000) % 3, 1, -1).astype(np.float32)
    want_v, want_i = jwc.topk_select(jnp.asarray(x), 400)
    got_v, got_i = wc.topk_select(torch.from_numpy(x), 400)
    _same_bits(got_v, want_v, "values")
    _same_bits(got_i, want_i, "indices")
    _same_bits(wc.scatter_flat(got_v, got_i, 4000),
               jwc.scatter_flat(want_v, want_i, 4000), "scatter")


def _tied_delta(seed=7):
    """4,096 float32 values of four magnitudes with random signs: about
    1,000 ties at every magnitude, so the k-th largest |x| of ``topk:0.1``
    (k = 409) falls inside a run of ties."""
    rng = np.random.default_rng(seed)
    mags = np.array([0.5, 0.25, 2.0 ** -6, 2.0 ** -10], np.float32)
    sign = np.where(rng.random(4096) < 0.5, -1.0, 1.0).astype(np.float32)
    return mags[rng.integers(0, 4, 4096)] * sign


@pytest.mark.parametrize("spec", ["topk:0.1", "topk8:0.1"])
def test_topk_ties_select_what_jax_selects(spec):
    """On ties at the k-th magnitude the port selects the coordinates JAX
    selects, in JAX's order (largest first, the lower index first among
    equals): indices, values and the error-feedback residual bit for bit,
    over three encodes that carry the residual."""
    x = _tied_delta()
    want_v, want_i = jwc.topk_select(jnp.asarray(x), 409)
    got_v, got_i = wc.topk_select(torch.from_numpy(x), 409)
    _same_bits(got_i, want_i, "tied indices")
    _same_bits(got_v, want_v, "tied values")
    ref = {"w": np.zeros(4096, np.float32)}
    jax_codec, port_codec = jcomp.WireCodec(spec), comp.WireCodec(spec)
    for step in range(3):
        update = {"w": _tied_delta(8 + step)}
        want = jax_codec.encode_delta(_jax_tree(update), _jax_tree(ref))
        got = port_codec.encode_delta(_torch_tree(update), _torch_tree(ref))
        _same_payload(got, want, f"{spec} tied step {step}")
        _same_bits(port_codec._residual, jax_codec._residual,
                   f"{spec} tied residual after {step + 1}")


# -------------------------------------------------------------- WireCodec
def _np_tree(seed, scale=1.0):
    """A variables-like tree whose string and numeric key orders differ,
    with magnitudes spread log-uniformly over four decades."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        n = int(np.prod(shape))
        v = 10.0 ** rng.uniform(-3, 1, n) * np.where(rng.random(n) < 0.5,
                                                      -1, 1)
        return (v * scale).astype(np.float32).reshape(shape)

    return {"params": {"BasicBlock_10": {"kernel": leaf(3, 3, 8, 8)},
                       "BasicBlock_2": {"kernel": leaf(3, 3, 4, 8),
                                        "bias": leaf(8)},
                       "Dense_0": {"kernel": leaf(60, 10), "bias": leaf(10)}},
            "batch_stats": {"BatchNorm_0": {"mean": leaf(16),
                                            "var": leaf(16)}}}


def _jax_tree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _torch_tree(t):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), t)


def _same_payload(got, want, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], (str, int, float, list)):
            assert got[k] == want[k], (what, k)
        else:
            _same_bits(got[k], want[k], f"{what}.{k}")


@pytest.mark.parametrize("spec", ["int8", "bf16", "topk:0.1", "topk8:0.1"])
def test_wire_codec_payloads_and_residual_match_jax(spec):
    ref = _np_tree(0)
    jax_codec, port_codec = jcomp.WireCodec(spec), comp.WireCodec(spec)
    for step in range(3):
        update = jax.tree_util.tree_map(
            lambda r, d: r + d, ref, _np_tree(10 + step, scale=0.05))
        if spec.startswith("topk"):
            # the precondition of a top-k comparison: no ties in |delta|
            # among the k + 1 largest (the selection and its order)
            delta = (comp._flatten(_torch_tree(update))[0]
                     - comp._flatten(_torch_tree(ref))[0])
            if port_codec._residual is not None:
                delta = delta + port_codec._residual
            k = max(1, int(delta.numel() * 0.1))
            top = torch.sort(delta.abs(), descending=True).values[:k + 1]
            assert bool((top[:-1] > top[1:]).all()), "ties in |delta|"
        want = jax_codec.encode_delta(_jax_tree(update), _jax_tree(ref))
        got = port_codec.encode_delta(_torch_tree(update), _torch_tree(ref))
        _same_payload(got, want, f"{spec} step {step}")
        assert estimate_nbytes(got) == jax_nbytes(want)
        _same_bits(port_codec._residual, jax_codec._residual,
                   f"{spec} residual after {step + 1}")
        _same_bits(comp.decode_delta_flat(got), jcomp.decode_delta_flat(want),
                   f"{spec} decoded")
        back = comp.decode_delta(got, _torch_tree(ref))
        want_back = jcomp.decode_delta(want, _jax_tree(ref))
        for g, w in zip(tree_leaves(back),
                        jax.tree_util.tree_leaves(want_back)):
            _same_bits(g, w, f"{spec} reconstructed leaf")


def _resnet8_trees():
    """JAX's ResNet-8 variables, the port's model holding the same
    variables (carried by ``utils/weights.py``), and its wire tree."""
    variables = JaxResNet(depth=8, num_classes=10, dtype=jnp.float32).init(
        jax.random.PRNGKey(3), jnp.zeros((2, 32, 32, 3)), train=False)
    module = CIFARResNet(depth=8, num_classes=10)
    from_flax_variables(jax.tree_util.tree_map(np.asarray, variables), module)
    return variables, module, tree_from_module(module)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_encode_and_decode_model_match_jax_on_resnet8(kind):
    variables, _, tree = _resnet8_trees()
    want_leaves, _ = jax.tree_util.tree_flatten(variables)
    got_leaves = tree_leaves(tree)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        _same_bits(g, w, "carried leaf")
    want = jcomp.WireCodec.encode_model(variables, kind)
    got = comp.WireCodec.encode_model(tree, kind)
    assert comp.WireCodec.is_encoded_model(got)
    marker = lambda x: isinstance(x, dict) and "__wq__" in x  # noqa: E731
    got_marks = tree_leaves(got, is_leaf=marker)
    want_marks = jax.tree_util.tree_leaves(want, is_leaf=marker)
    assert len(got_marks) == len(want_marks) == len(want_leaves)
    for g, w in zip(got_marks, want_marks):
        _same_payload(g, {k: (list(v) if k == "shape" else v)
                          for k, v in w.items()}, f"{kind} marker")
    assert estimate_nbytes(got) == jax_nbytes(want)
    back = tree_leaves(comp.WireCodec.decode_model(got))
    want_back = jax.tree_util.tree_leaves(jcomp.WireCodec.decode_model(want))
    for g, w in zip(back, want_back):
        _same_bits(g, w, f"{kind} decoded leaf")


def test_the_wire_flat_order_is_jax_not_flat_variables():
    """``_flatten`` walks JAX's order — keys sorted as strings
    (``batch_stats`` before ``params``, ``BasicBlock_10`` before
    ``BasicBlock_2``), leaves raveled in the flax layouts, no padding.
    ``FlatVariables`` lays a module out parameters first, in module order,
    padded: another order, which the wire never uses."""
    t = _np_tree(7)
    got, _ = comp._flatten(_torch_tree(t))
    _same_bits(got, jcomp._flatten(_jax_tree(t))[0], "flat order")
    p = t["params"]
    order = [t["batch_stats"]["BatchNorm_0"]["mean"],
             t["batch_stats"]["BatchNorm_0"]["var"],
             p["BasicBlock_10"]["kernel"], p["BasicBlock_2"]["bias"],
             p["BasicBlock_2"]["kernel"], p["Dense_0"]["bias"],
             p["Dense_0"]["kernel"]]
    _same_bits(got, np.concatenate([a.ravel() for a in order]), "sorted")

    variables, module, tree = _resnet8_trees()
    got, _ = comp._flatten(tree)
    _same_bits(got, jcomp._flatten(variables)[0], "ResNet-8 flat order")
    flat = FlatVariables(module).flat[torch.float32]
    assert flat.numel() > got.numel()       # FLAT_ALIGN padding
    assert not torch.equal(flat[:got.numel()], got)
