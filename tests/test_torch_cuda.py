"""The CUDA kernels against their plain PyTorch versions, on the card: the
weighted reduce, the fused epilogue, the flash-attention forward, the
int8 wire codec's quantize and dequantize and top-k selection on ties, and
the fed-LLM adapter fold (bit for bit), one fed-LLM round on the card
against the same round on the CPU, and the multi-client conv's forward and
weight-gradient kernels (forward, dx and dw; within the float32 error of
sums in another order, √terms · 2^-23 · Σ|terms|, and one bfloat16 step).  Every test here needs an NVIDIA card
and ``nvcc``: the kernel has no CPU mode, so they skip elsewhere.  The file imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in ``tests/test_torch_epilogue.py``: float32 at
``atol=rtol=2e-6`` (sums in another order), bfloat16 at one bfloat16 step.
"""

import math

import pytest
import torch

from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.ops import epilogue
from fedml_tpu_torch.ops import pallas_attention as attn
from fedml_tpu_torch.ops import wire_compression as wc
from fedml_tpu_torch.utils.compression import WireCodec
from fedml_tpu_torch.utils.tree import tree_leaves, tree_map
from fedml_tpu_torch.utils.weights import tree_from_module

F32_TOL = dict(atol=2e-6, rtol=2e-6)
BF16_TOL = dict(atol=1e-6, rtol=2.0 ** -8)

# (C, D, dtype, weights): the CPU cases of test_torch_epilogue.py, ragged
# widths on both the 16-byte and the one-column path, 1024 clients, and the
# ResNet-56 flat buffer of the Parrot round
CASES = {
    "f32": (5, 910, torch.float32, "pos"),
    "bf16": (5, 910, torch.bfloat16, "pos"),
    "masked": (6, 910, torch.float32, "masked"),
    "all_zero": (4, 910, torch.float32, "zero"),
    "int32": (5, 9, torch.int32, "pos"),
    "one_client": (1, 9, torch.float32, "pos"),
    "ragged": (3, 1027, torch.float32, "pos"),
    "ragged_bf16": (3, 1031, torch.bfloat16, "pos"),
    "c1024": (1024, 4099, torch.float32, "pos"),
    "resnet56": (10, 860032, torch.float32, "pos"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(name, card):
    c, d, dtype, kind = CASES[name]
    gen = torch.Generator().manual_seed(len(name))
    if dtype == torch.int32:
        x = torch.randint(0, 50, (c, d), generator=gen, dtype=dtype)
    else:
        x = torch.randn(c, d, generator=gen).to(dtype)
    w = torch.rand(c, generator=gen) * 2.5 + 0.5
    if kind == "masked":
        w[[1, 4]] = 0.0
    elif kind == "zero":
        w.zero_()
    x, w = x.to(card), w.to(card)
    before = epilogue.LAUNCHES["weighted_reduce"]
    got = epilogue.weighted_reduce(x, w)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["weighted_reduce"] == before + 1
    ref = epilogue.weighted_reduce_reference(x, w)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    w = torch.ones(3, device=card)
    with pytest.raises(TypeError):
        epilogue.weighted_reduce(torch.zeros(3, 4, device=card,
                                             dtype=torch.float16), w)
    with pytest.raises(ValueError):
        epilogue.weighted_reduce(torch.zeros(4, 3, device=card).t(), w)
    with pytest.raises(ValueError):
        epilogue.weighted_reduce(torch.zeros(2, 4, device=card), w)
    with pytest.raises(TypeError):
        epilogue.weighted_reduce(torch.zeros(3, 4, device=card), w.double())


@pytest.mark.gpu
def test_weighted_reduce_takes_a_column_range(card):
    """The BatchNorm columns [P, D) of the round's [10, 860,032] buffer:
    row stride 860,032, 4,256 columns, written into a slice of the new
    global."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(10, 860032, generator=gen).to(card)
    w = (torch.rand(10, generator=gen) + 0.5).to(card)
    cols = x[:, 855776:]
    out = torch.zeros(860032, device=card)
    got = epilogue.weighted_reduce(cols, w, out=out[855776:])
    torch.cuda.synchronize()
    assert got.data_ptr() == out[855776:].data_ptr()
    torch.testing.assert_close(got, epilogue.weighted_reduce_reference(
        cols.contiguous(), w), **F32_TOL)
    assert bool((out[:855776] == 0).all())


def _card_payloads(card, n=3):
    gen = torch.Generator().manual_seed(11)
    return [(float(10 + c), {"params": {"Dense_0": {
        "kernel": torch.randn(60, 10, generator=gen).to(card),
        "bias": torch.randn(10, generator=gen).to(card)}}})
        for c in range(n)]


@pytest.mark.gpu
def test_cross_silo_funnel_launches_the_kernel_once(card):
    """Payloads on the card: one weighted-reduce launch for the round,
    the plain sample-weighted mean's values."""
    pairs = _card_payloads(card)
    before = epilogue.LAUNCHES["weighted_reduce"]
    got = FedMLAggOperator.agg(Config(), pairs)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["weighted_reduce"] == before + 1
    total = sum(n for n, _ in pairs)
    for i, leaf in enumerate(tree_leaves(got)):
        want = sum(n / total * tree_leaves(t)[i] for n, t in pairs)
        torch.testing.assert_close(leaf, want, **F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "tree"])
def test_cross_silo_funnel_raises_on_payloads_that_do_not_stack(fault,
                                                                  card):
    """On a card no kernel takes payloads that do not stack into one
    ``[C, D]`` buffer per dtype, so the funnel raises instead of averaging
    them leaf by leaf in plain PyTorch."""
    pairs = _card_payloads(card)
    dense = pairs[1][1]["params"]["Dense_0"]
    if fault == "dtype":
        dense["kernel"] = dense["kernel"].bfloat16()
    elif fault == "shape":
        dense["kernel"] = dense["kernel"][:59]
    elif fault == "device":
        dense["kernel"] = dense["kernel"].cpu()
    else:
        dense["extra"] = dense["bias"].clone()
    before = epilogue.LAUNCHES["weighted_reduce"]
    with pytest.raises(ValueError, match="do not stack"):
        FedMLAggOperator.agg(Config(), pairs)
    assert epilogue.LAUNCHES["weighted_reduce"] == before


# (opt, C, P, stacked dtype, global dtype, weights, s, t): every channel
# on float32 and bfloat16 stacked buffers; masked and all-zero weights; one
# client and 1,024; a ragged P on the one-column path; adam at t = 1 (zero
# state) and t = 5 (random state); s != 1 for mix and sgd; and the FedOpt
# round's parameter columns of a [10, 860,032] buffer (row stride 860,032)
FUSED_CASES = {
    **{f"{o}_f32": (o, 5, 910, torch.float32, torch.float32, "pos", 0.7, 5)
       for o in ("none", "sgd", "momentum", "adam")},
    **{f"{o}_bf16": (o, 5, 910, torch.bfloat16, torch.float32, "pos", 0.7, 5)
       for o in ("none", "sgd", "momentum", "adam")},
    "adam_bf16_global": ("adam", 5, 910, torch.bfloat16, torch.bfloat16,
                         "pos", 1.0, 5),
    "sgd_masked": ("sgd", 6, 910, torch.float32, torch.float32, "masked",
                   1.0, 0),
    "momentum_all_zero": ("momentum", 4, 910, torch.float32, torch.float32,
                          "zero", 1.0, 0),
    "adam_one_client": ("adam", 1, 9, torch.float32, torch.float32, "pos",
                        1.0, 5),
    "mix_c1024": ("none", 1024, 4099, torch.float32, torch.float32, "pos",
                  0.5, 0),
    "adam_ragged": ("adam", 3, 1027, torch.float32, torch.float32, "pos",
                    1.0, 5),
    "adam_t1": ("adam", 5, 910, torch.float32, torch.float32, "pos", 1.0, 0),
    "adam_round": ("adam", 10, 855776, torch.float32, torch.float32, "pos",
                   1.0, 0),
}


def _fused_inputs(name, card):
    opt, c, p, xdt, gdt, kind, s, t = FUSED_CASES[name]
    gen = torch.Generator().manual_seed(len(name))
    ld = 860032 if name == "adam_round" else p
    x = torch.randn(c, ld, generator=gen).to(xdt)[:, :p]
    g = torch.randn(p, generator=gen).to(gdt)
    w = torch.rand(c, generator=gen) * 2.5 + 0.5
    if kind == "masked":
        w[[1, 4]] = 0.0
    elif kind == "zero":
        w.zero_()
    st = None
    if opt == "momentum":
        st = {"m": torch.randn(p, generator=gen)}
    elif opt == "adam":
        st = {"m": torch.randn(p, generator=gen) * (t > 0),
              "v": torch.rand(p, generator=gen) * (t > 0), "t": t}
    move = {k: v.to(card) if isinstance(v, torch.Tensor) else v
            for k, v in (st or {}).items()} or None
    spec = epilogue.EpilogueSpec(opt=opt, lr=0.1)
    return x.to(card), g.to(card), w.to(card), s, spec, move


def _clone(st):
    return None if st is None else {
        k: v.clone() if isinstance(v, torch.Tensor) else v
        for k, v in st.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_epilogue_matches_plain_version(name, card):
    """Tolerance ``atol = rtol = 2e-6``: the kernel and the plain version
    sum the clients in another order (a float32 ulp of the reduce), and
    round every other operation alike (the source is built without fma
    contraction).  A bfloat16 global at one bfloat16 step."""
    x, g, w, s, spec, st = _fused_inputs(name, card)
    key = f"fused_epilogue.{spec.opt}"
    before = epilogue.LAUNCHES[key]
    got, got_st = epilogue.fused_epilogue(g, x, w, s, spec, _clone(st))
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES[key] == before + 1
    ref, ref_st = epilogue.fused_epilogue_reference(g, x, w, s, spec,
                                                    _clone(st))
    assert got.dtype == ref.dtype == g.dtype and got.shape == ref.shape
    tol = BF16_TOL if g.dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    if ref_st is not None:
        for k in ("m", "v"):
            if k in ref_st:
                torch.testing.assert_close(got_st[k], ref_st[k], **F32_TOL)
        assert got_st.get("t") == ref_st.get("t")


@pytest.mark.gpu
def test_fused_epilogue_updates_in_place(card):
    """out may be the global itself, and m, v are updated in place."""
    x, g, w, s, spec, st = _fused_inputs("adam_f32", card)
    ref, ref_st = epilogue.fused_epilogue_reference(g, x, w, s, spec,
                                                    _clone(st))
    m_ptr = st["m"].data_ptr()
    got, got_st = epilogue.fused_epilogue(g, x, w, s, spec, st, out=g)
    torch.cuda.synchronize()
    assert got.data_ptr() == g.data_ptr()
    assert got_st["m"].data_ptr() == m_ptr and got_st["t"] == 6
    torch.testing.assert_close(got, ref, **F32_TOL)
    torch.testing.assert_close(st["v"], ref_st["v"], **F32_TOL)


@pytest.mark.gpu
def test_fused_epilogue_refuses_what_it_does_not_take(card):
    g = torch.zeros(8, device=card)
    x = torch.zeros(3, 8, device=card)
    w = torch.ones(3, device=card)
    adam = epilogue.EpilogueSpec(opt="adam")
    st = {"m": torch.zeros(8, device=card), "v": torch.zeros(8, device=card),
          "t": 0}
    with pytest.raises(TypeError):       # float16 stacked
        epilogue.fused_epilogue(g, x.half(), w)
    with pytest.raises(TypeError):       # float64 weights
        epilogue.fused_epilogue(g, x, w.double())
    with pytest.raises(TypeError):       # bfloat16 state
        epilogue.fused_epilogue(g, x, w, 1.0, adam,
                                dict(st, m=st["m"].bfloat16()))
    with pytest.raises(ValueError):      # weights on the CPU
        epilogue.fused_epilogue(g, x, w.cpu())
    with pytest.raises(ValueError):      # a transposed stacked buffer
        epilogue.fused_epilogue(g, torch.zeros(8, 3, device=card).t(), w)
    with pytest.raises(ValueError):      # a strided global
        epilogue.fused_epilogue(torch.zeros(16, device=card)[::2], x, w)
    with pytest.raises(ValueError):      # state of another length
        epilogue.fused_epilogue(g, x, w, 1.0, adam,
                                dict(st, v=torch.zeros(7, device=card)))
    with pytest.raises(ValueError):      # clients and weights disagree
        epilogue.fused_epilogue(g, x, torch.ones(2, device=card))


# ------------------------------------------------------------ flash attention
#: (atol, rtol) of the flash kernel against _reference_residuals: float32
#: sums in another order (the kernel's FMAs over key tiles, the plain
#: version's cuBLAS products) — the JAX package's own tolerance for its
#: kernel; a bfloat16 o at one to two bfloat16 steps (2^-8 relative) after
#: rounding float32 results that differ in their last bits
FLASH_F32 = dict(atol=2e-5, rtol=2e-5)
FLASH_BF16 = dict(atol=1e-2, rtol=1e-2)


def _flash_inputs(b, h, t, d, dtype, card, tk=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, n, d, generator=gen).to(dtype).to(card)
            for n in (t, tk or t, tk or t)]


def _check_partial(got, ref, dtype):
    for g, r, name in zip(got, ref, "olm"):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        tol = FLASH_BF16 if (name == "o" and dtype == torch.bfloat16) \
            else FLASH_F32
        torch.testing.assert_close(g.float(), r.float(), msg=name, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", attn.HEAD_DIMS)
@pytest.mark.parametrize("t", [80, 200, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_version(causal, t, d, dtype, card):
    q, k, v = _flash_inputs(2, 2, t, d, dtype, card, seed=t + d)
    for t_valid in (t, t - 13):
        before = attn.LAUNCHES["flash_attention"]
        got = attn.flash_attention_residuals(q, k, v, causal, t_valid)
        torch.cuda.synchronize()
        assert attn.LAUNCHES["flash_attention"] == before + 1
        _check_partial(got, attn._reference_residuals(q, k, v, causal,
                                                      t_valid), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("tk", [160, 37])
def test_flash_kernel_with_another_key_length(tk, card):
    """Non-causal residuals over Tk != T keys, aligned and ragged."""
    q, k, v = _flash_inputs(3, 2, 80, 64, torch.float32, card, tk=tk)
    got = attn.flash_attention_residuals(q, k, v, causal=False)
    torch.cuda.synchronize()
    _check_partial(got, attn._reference_residuals(q, k, v, False),
                   torch.float32)


@pytest.mark.gpu
def test_flash_kernel_reads_and_writes_through_strides(card):
    """flash_mha hands the kernel [B, T, H, D] tensors as [B, H, T, D]
    views: no copy, and o comes back in the same layout."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(4, 80, 2, 64, generator=gen).bfloat16().to(card)
               for _ in range(3))
    got = attn.flash_mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.is_contiguous()
    ref = attn._reference(*(x.transpose(1, 2) for x in (q, k, v)), True)
    torch.testing.assert_close(got.float(), ref.transpose(1, 2).float(),
                               **FLASH_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_misaligned_rows(dtype, card):
    """Rows that do not start 16-byte aligned (a slice one element into a
    wider tensor): the wrapper copies them, and the kernel gives the plain
    version's values."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 2, 80, 65, generator=gen).to(dtype).to(card)
               [..., 1:] for _ in range(3))
    got = attn.flash_attention_residuals(q, k, v, True)
    torch.cuda.synchronize()
    _check_partial(got, attn._reference_residuals(q, k, v, True), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [80, 200])
def test_flash_attention_gradients_on_the_card(t, card):
    """The autograd path on the card (kernel forward, blockwise backward)
    against the same path on the CPU (plain forward, blockwise backward)."""
    cpu = _flash_inputs(2, 2, t, 64, torch.float32, "cpu", seed=t)
    do = torch.randn(2, 2, t, 64, generator=torch.Generator().manual_seed(1))
    grads = {}
    for dev in ("cpu", card):
        xs = [x.to(dev).requires_grad_(True) for x in cpu]
        out = attn.flash_attention(*xs, causal=True)
        grads[str(dev)] = [out] + list(torch.autograd.grad(
            out, xs, do.to(dev)))
    for g, c in zip(grads[str(card)], grads["cpu"]):
        torch.testing.assert_close(g.detach().cpu(), c.detach(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(1, 2, 8, 48, device=card)
    with pytest.raises(ValueError):      # head dim 48
        attn.flash_attention_residuals(q, q, q)
    h = torch.zeros(1, 2, 8, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):       # float16
        attn.flash_attention_residuals(h, h, h)
    f = torch.zeros(1, 2, 8, 64, device=card)
    with pytest.raises(TypeError):       # mixed dtypes
        attn.flash_attention_residuals(f, f.bfloat16(), f.bfloat16())
    with pytest.raises(ValueError):      # k on the CPU
        attn.flash_attention_residuals(f, f.cpu(), f)
    with pytest.raises(ValueError):      # k, v of other shapes
        attn.flash_attention_residuals(f, f, torch.zeros(1, 2, 9, 64,
                                                         device=card))


# ------------------------------------------------------------ wire codec
def _wire_vector(d, seed=0):
    """float32 [d] whose 512-value rows cycle through random, all zero,
    values on .5 after scaling, max below 1e-30, above 1e30, all negative
    (``tests/test_torch_wire_compression.py``'s cases), a NaN among random
    values, and +inf and -inf among random values."""
    gen = torch.Generator().manual_seed(d + seed)
    x = torch.randn(d, generator=gen)
    for r in range(-(-d // wc.BLOCK)):
        lo, hi = r * wc.BLOCK, min(d, (r + 1) * wc.BLOCK)
        kind = (r + d) % 8
        if kind == 1:
            x[lo:hi] = 0.0
        elif kind == 2:
            v = torch.randint(-126, 127, (hi - lo,), generator=gen) + 0.5
            v[0] = 127.0
            x[lo:hi] = v
        elif kind == 3:
            x[lo:hi] *= 1e-33
        elif kind == 4:
            x[lo:hi] *= 1e35
        elif kind == 5:
            x[lo:hi] = -x[lo:hi].abs()
        elif kind == 6:
            x[lo + (hi - lo) // 2] = float("nan")
        elif kind == 7:
            x[lo] = float("inf")
            x[hi - 1] = -float("inf")
    return x


def _bits_equal(got, want):
    """Equal bits, where a NaN matches a NaN of any payload (the card and
    the CPU make NaNs of different signs)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.cpu(), want.cpu()
    if want.is_floating_point():
        nan = want.isnan()
        assert torch.equal(got.isnan(), nan)
        got, want = got[~nan], want[~nan]
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _resnet56_lengths():
    """One segment per leaf of ResNet-56's wire tree (287), in wire
    order: the broadcast's segment table."""
    tree = tree_from_module(CIFARResNet(depth=56, num_classes=10))
    return [leaf.numel() for leaf in tree_leaves(tree)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 511, 512, 513, 32 * 512 + 7, 100_000,
                               860_026])
def test_wire_kernels_match_plain_versions_bit_for_bit(d, card):
    x = _wire_vector(d)
    before = dict(wc.LAUNCHES)
    q, s = wc.quantize_int8_blocked(x.to(card))
    out = wc.dequantize_int8_blocked(q, s, d)
    torch.cuda.synchronize()
    assert wc.LAUNCHES["quantize"] == before["quantize"] + 1
    assert wc.LAUNCHES["dequantize"] == before["dequantize"] + 1
    want_q, want_s = wc.quantize_int8_reference(x)
    _bits_equal(q, want_q)
    _bits_equal(s, want_s)
    _bits_equal(out, wc.dequantize_int8_reference(want_q, want_s, d))
    # the plain version gives the same bits on the card (it divides by a
    # tensor: PyTorch's CUDA division by a scalar multiplies instead)
    card_q, card_s = wc.quantize_int8_reference(x.to(card))
    _bits_equal(card_q, want_q)
    _bits_equal(card_s, want_s)


@pytest.mark.gpu
def test_wire_kernels_keep_nan_and_inf_rows_visible(card):
    """Rows with a NaN, an infinity, or both: q all 0, the scale NaN (a
    NaN in the row) or inf, every value decoded NaN — the plain versions'
    results, so a diverged update is not sent as a finite one."""
    x = torch.randn(4 * wc.BLOCK, generator=torch.Generator().manual_seed(3))
    x[3] = float("nan")
    x[wc.BLOCK + 7] = float("inf")
    x[2 * wc.BLOCK + 9] = -float("inf")
    x[3 * wc.BLOCK + 1], x[3 * wc.BLOCK + 2] = float("nan"), float("inf")
    q, s = wc.quantize_int8_blocked(x.to(card))
    out = wc.dequantize_int8_blocked(q, s, x.numel())
    torch.cuda.synchronize()
    assert not q.any()
    assert s[0].isnan() and s[3].isnan()
    assert s[1].isinf() and s[2].isinf()
    assert out.isnan().all()
    want_q, want_s = wc.quantize_int8_reference(x)
    _bits_equal(q, want_q)
    _bits_equal(s, want_s)
    _bits_equal(out, wc.dequantize_int8_reference(want_q, want_s, x.numel()))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["resnet56_leaves", "ragged"])
def test_wire_kernels_take_a_segment_table_in_one_launch(layout, card):
    lengths = (_resnet56_lengths() if layout == "resnet56_leaves"
               else [700, 3, 0, 512, 1029, 1, 5000])
    x = _wire_vector(sum(lengths), seed=1)
    before = dict(wc.LAUNCHES)
    q, s = wc.quantize_int8_blocked(x.to(card), lengths)
    out = wc.dequantize_int8_blocked(q, s, q.numel(), lengths)
    torch.cuda.synchronize()
    assert wc.LAUNCHES["quantize"] == before["quantize"] + 1
    assert wc.LAUNCHES["dequantize"] == before["dequantize"] + 1
    want_q, want_s = wc.quantize_int8_blocked(x, lengths)
    _bits_equal(q, want_q)
    _bits_equal(s, want_s)
    _bits_equal(out, wc.dequantize_int8_blocked(want_q, want_s, q.numel(),
                                                lengths))


@pytest.mark.gpu
def test_wire_kernels_take_rows_that_are_not_aligned(card):
    """A vector starting 4 bytes into its buffer: no row is 16-byte
    aligned, so every row takes the masked scalar path."""
    x = _wire_vector(5 * 512 + 1, seed=2)
    base = torch.zeros(x.numel() + 1, device=card)
    base[1:] = x.to(card)
    q, s = wc.quantize_int8_blocked(base[1:])
    qbase = torch.zeros(q.numel() + 1, dtype=torch.int8, device=card)
    qbase[1:] = q
    out = wc.dequantize_int8_blocked(qbase[1:], s, q.numel())
    torch.cuda.synchronize()
    want_q, want_s = wc.quantize_int8_reference(x)
    _bits_equal(q, want_q)
    _bits_equal(s, want_s)
    _bits_equal(out, wc.dequantize_int8_reference(want_q, want_s,
                                                  x.numel()))


@pytest.mark.gpu
def test_encode_and_decode_model_on_the_card_match_the_cpu(card):
    """A whole model's broadcast: one quantize and one dequantize launch,
    the same bits as the CPU's encode and decode."""
    tree = tree_from_module(CIFARResNet(depth=8, num_classes=10))
    on_card = tree_map(lambda t: t.to(card), tree)
    before = dict(wc.LAUNCHES)
    enc = WireCodec.encode_model(on_card)
    dec = WireCodec.decode_model(enc)
    torch.cuda.synchronize()
    assert wc.LAUNCHES["quantize"] == before["quantize"] + 1
    assert wc.LAUNCHES["dequantize"] == before["dequantize"] + 1
    want = WireCodec.decode_model(WireCodec.encode_model(tree))
    for g, w in zip(tree_leaves(dec), tree_leaves(want)):
        _bits_equal(g, w)


@pytest.mark.gpu
def test_wire_kernels_refuse_what_they_do_not_take(card):
    with pytest.raises(TypeError):
        wc.quantize_int8_blocked(torch.zeros(600, dtype=torch.float64,
                                             device=card))
    with pytest.raises(TypeError):
        wc.quantize_int8_blocked(torch.zeros(600, dtype=torch.bfloat16,
                                             device=card))
    q, s = wc.quantize_int8_blocked(torch.ones(600, device=card))
    with pytest.raises(ValueError):
        wc.dequantize_int8_blocked(q, s, 599)
    with pytest.raises(ValueError):
        wc.dequantize_int8_blocked(q, s[:1], 600)
    with pytest.raises(ValueError):
        wc.dequantize_int8_blocked(q, s.cpu(), 600)
    with pytest.raises(ValueError):
        wc.quantize_int8_blocked(torch.ones(600, device=card), [300, 200])


# ------------------------------------------------ top-k ties (the wire codec)
def _tied_delta(seed=7):
    """4,096 float32 values of four magnitudes with random signs: the k-th
    largest |x| of ``topk:0.1`` falls inside a run of ties."""
    gen = torch.Generator().manual_seed(seed)
    mags = torch.tensor([0.5, 0.25, 2.0 ** -6, 2.0 ** -10])
    sign = torch.where(torch.rand(4096, generator=gen) < 0.5, -1.0, 1.0)
    return mags[torch.randint(0, 4, (4096,), generator=gen)] * sign


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["topk:0.1", "topk8:0.1"])
def test_topk_ties_select_on_the_card_what_the_cpu_selects(spec, card):
    """On ties the card selects the CPU's coordinates in the CPU's order
    (the CPU is held to ``jax.lax.top_k`` by the CPU tests): indices,
    values and the error-feedback residual bit for bit over three
    encodes."""
    x = _tied_delta()
    got_v, got_i = wc.topk_select(x.to(card), 409)
    want_v, want_i = wc.topk_select(x, 409)
    _bits_equal(got_i, want_i)
    _bits_equal(got_v, want_v)
    ref = {"w": torch.zeros(4096)}
    on_card, on_cpu = WireCodec(spec), WireCodec(spec)
    for step in range(3):
        update = {"w": _tied_delta(8 + step)}
        got = on_card.encode_delta(tree_map(lambda t: t.to(card), update),
                                   tree_map(lambda t: t.to(card), ref))
        want = on_cpu.encode_delta(update, ref)
        for k in ("idx", "values", "values_q", "scales"):
            if k in want:
                _bits_equal(got[k], want[k])
        _bits_equal(on_card._residual, on_cpu._residual)


# ------------------------------------------------------ the adapter fold (B6)
#: (d_in, d_out) of TinyTransformerLM's five LoRA targets
LORA_TARGETS = [(128, 90), (128, 512), (512, 128), (128, 512), (512, 128)]


def _adapter_tree(rank, dtype, card, seed, misalign=0):
    """The BERT-tiny adapter table at ``rank`` (10 leaves) and a float32
    delta of the same shapes, each a tree of views into one buffer;
    ``misalign`` starts the adapters' buffer that many values in, so no
    leaf is 16-byte aligned."""
    gen = torch.Generator().manual_seed(seed)
    shapes = []
    for i, (d_in, d_out) in enumerate(LORA_TARGETS):
        shapes += [(f"t{i}", "a", (d_in, rank)), (f"t{i}", "b", (rank, d_out))]
    total = sum(math.prod(s) for _, _, s in shapes)
    a_buf = (torch.randn(total + misalign, generator=gen) * 0.01).to(dtype)
    d_buf = torch.randn(total, generator=gen) * 1e-3
    a_buf, d_buf = a_buf.to(card), d_buf.to(card)
    a, d, off = {}, {}, 0
    for path, k, shape in shapes:
        n = math.prod(shape)
        a.setdefault(path, {})[k] = a_buf[misalign + off:
                                          misalign + off + n].view(shape)
        d.setdefault(path, {})[k] = d_buf[off:off + n].view(shape)
        off += n
    return a, d


FOLD_CASES = {
    f"{name}_{dt_name}_lr{lr}": (rank, dt, lr, mis)
    for name, rank, mis in (("rank4", 4, 0), ("rank3", 3, 0),
                            ("misaligned", 4, 1))
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))
    for lr in (0.0, 1.0, 0.37)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_fold_delta_matches_plain_version_bit_for_bit(name, card):
    """Kernel B6 against ``fold_delta_reference`` on the same card tensors:
    rank 4 (BERT-tiny's 10 leaves, 11,112 values), rank 3 (leaves that are
    no multiples of 4) and a buffer whose leaves start misaligned, float32
    and bfloat16 adapters, ``server_lr`` 0, 1 and 0.37 — one launch, equal
    bits."""
    rank, dtype, lr, mis = FOLD_CASES[name]
    a, d = _adapter_tree(rank, dtype, card, seed=len(name), misalign=mis)
    before = epilogue.LAUNCHES["fold_delta"]
    got = epilogue.fold_delta(a, d, lr)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["fold_delta"] == before + 1
    want = epilogue.fold_delta_reference(a, d, lr)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        _bits_equal(g, w)


@pytest.mark.gpu
def test_fold_delta_in_place_and_mixed_dtypes(card):
    """``out`` = the adapters folds in place; a tree of float32 and
    bfloat16 leaves takes one launch per dtype; leaves that are not views
    of one buffer are packed first and still folded in one launch."""
    a, d = _adapter_tree(4, torch.float32, card, seed=1)
    want = epilogue.fold_delta_reference(a, d, 0.37)
    before = epilogue.LAUNCHES["fold_delta"]
    same = epilogue.fold_delta(a, d, 0.37, out=a)
    torch.cuda.synchronize()
    assert same is a and epilogue.LAUNCHES["fold_delta"] == before + 1
    for g, w in zip(tree_leaves(a), tree_leaves(want)):
        _bits_equal(g, w)
    mixed = {"x": {"a": a["t0"]["a"].clone(),
                   "b": a["t0"]["b"].to(torch.bfloat16)},
             "y": {"a": a["t1"]["a"].clone(), "b": a["t1"]["b"].clone()}}
    dm = {"x": d["t0"], "y": d["t1"]}
    before = epilogue.LAUNCHES["fold_delta"]
    got = epilogue.fold_delta(mixed, dm, 1.0)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["fold_delta"] == before + 2
    for g, w in zip(tree_leaves(got),
                    tree_leaves(epilogue.fold_delta_reference(mixed, dm,
                                                              1.0))):
        _bits_equal(g, w)


@pytest.mark.gpu
def test_fold_delta_refuses_what_it_does_not_take(card):
    """What the kernel does not take raises — it is never folded in plain
    PyTorch on the card, and nothing is launched."""
    a, d = _adapter_tree(4, torch.float32, card, seed=2)
    before = epilogue.LAUNCHES["fold_delta"]
    with pytest.raises(TypeError):
        epilogue.fold_delta(tree_map(lambda t: t.half(), a), d, 1.0)
    with pytest.raises(TypeError):
        epilogue.fold_delta(a, tree_map(lambda t: t.bfloat16(), d), 1.0)
    with pytest.raises(ValueError):
        epilogue.fold_delta(a, tree_map(lambda t: t.cpu(), d), 1.0)
    with pytest.raises(ValueError):
        epilogue.fold_delta(a, {"t0": d["t0"]}, 1.0)
    with pytest.raises(ValueError):
        epilogue.fold_delta(a, d, 1.0,
                            out=tree_map(lambda t: t.clone(), a))
    assert epilogue.LAUNCHES["fold_delta"] == before


def _fed_llm_round(device):
    """One fed-LLM round over INPROC — 2 silos, the full-width
    TinyTransformerLM at dropout 0 in float32, rank 4, seq 32, batch 4 —
    through the five-step entry on ``device``, from the same seeded
    variables: the final adapters, the metrics and the launch counts."""
    import fedml_tpu_torch
    from fedml_tpu_torch.ml.engine.model_bundle import TASK_LM, ModelBundle
    from fedml_tpu_torch.models.nlp import TinyTransformerLM

    args = fedml_tpu_torch.init(Config(
        dataset="shakespeare", model="transformer",
        training_type="cross_silo", backend="INPROC", role="simulated",
        client_num_in_total=2, client_num_per_round=2, comm_round=1,
        epochs=1, batch_size=4, learning_rate=3e-3, data_scale=0.05,
        frequency_of_the_test=1, random_seed=0, fed_llm=True, lora_rank=4,
        fed_llm_seq_len=32, compute_dtype="float32",
        run_id=f"cuda_fed_llm_{device.type}", device_type=device.type))
    dataset = fedml_tpu_torch.data.load(args)
    bundle = ModelBundle(TinyTransformerLM(
        dropout=0.0, generator=torch.Generator().manual_seed(0)), (80,), 90,
        task=TASK_LM, input_dtype=torch.int32)
    counts = (epilogue.LAUNCHES["fold_delta"],
              epilogue.LAUNCHES["weighted_reduce"],
              attn.LAUNCHES["flash_attention"])
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, bundle)
    metrics = runner.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launched = (epilogue.LAUNCHES["fold_delta"] - counts[0],
                epilogue.LAUNCHES["weighted_reduce"] - counts[1],
                attn.LAUNCHES["flash_attention"] - counts[2])
    final = runner.runner.server.aggregator.get_global_model_params()
    return final, metrics, launched


@pytest.mark.gpu
def test_fed_llm_round_on_the_card_matches_the_cpu(card):
    """One round card vs CPU from the same seeded model and adapters.  The
    silos' adam moves every factor element by about lr per step whatever
    its gradient's size, so an element whose gradient is at the level of
    the two devices' summation-order noise can move another way: every
    element within 2·lr·steps (0.006 × 31 steps), at least 99 % within
    1e-4, the eval loss at ``rtol=1e-4``.  The card round launches the fold
    once, the weighted reduce once and the flash kernel once per layer of
    every forward pass at dropout 0: each training step's and each eval
    batch's."""
    from fedml_tpu_torch.train.fed_llm.trainer import FED_LLM_TOKENS

    got, g_m, launched = _fed_llm_round(card)
    want, c_m, _ = _fed_llm_round(torch.device("cpu"))
    diffs = torch.cat([(g.cpu() - w).abs().reshape(-1) for g, w in
                       zip(tree_leaves(got), tree_leaves(want))])
    assert float(diffs.max()) <= 2 * 3e-3 * 31, float(diffs.max())
    assert float((diffs <= 1e-4).float().mean()) >= 0.99
    torch.testing.assert_close(g_m["test_loss"], c_m["test_loss"],
                               rtol=1e-4, atol=0)
    n_eval = -(-int(c_m["test_total"]) // (80 * 4))
    steps = sum(FED_LLM_TOKENS.for_run("cuda_fed_llm_cuda").values()) \
        // (32 * 4)
    assert launched == (1, 1, 2 * (steps + n_eval)), launched


# ------------------------------------------------ the multi-client conv
#: (K, B, H, W, Ci, Co, kh, kw, stride): tests/test_mc_conv.py's cases, a
#: stem-like Ci of 3 and a Co of 12 (the kernels' scalar paths), and two of
#: ResNet-56's shapes at 10 clients of batch 32
MC_CASES = {
    "s1": (3, 4, 8, 8, 16, 16, 3, 3, (1, 1)),
    "s2": (2, 4, 8, 8, 16, 32, 3, 3, (2, 2)),
    "shortcut_1x1_s2": (2, 4, 8, 8, 16, 32, 1, 1, (2, 2)),
    "odd_spatial": (2, 2, 5, 7, 8, 8, 3, 3, (1, 1)),
    "even_kernel": (2, 2, 6, 6, 8, 8, 2, 2, (1, 1)),
    "stem_ci3": (2, 4, 8, 8, 3, 16, 3, 3, (1, 1)),
    "co12": (2, 2, 6, 6, 8, 12, 3, 3, (1, 1)),
    "resnet56_16_16_s1": (10, 32, 32, 32, 16, 16, 3, 3, (1, 1)),
    "resnet56_16_32_s2": (10, 32, 32, 32, 16, 32, 3, 3, (2, 2)),
}


def _mc_inputs(name, dtype, card):
    k, b, h, w_, ci, co, kh, kw, stride = MC_CASES[name]
    gen = torch.Generator().manual_seed(sorted(MC_CASES).index(name))
    x = torch.randn(k, b, h, w_, ci, generator=gen)
    w = torch.randn(k, kh, kw, ci, co, generator=gen) * (ci * kh * kw) ** -0.5
    oh, ow = -(-h // stride[0]), -(-w_ // stride[1])
    g = torch.randn(k, b, oh, ow, co, generator=gen)
    return tuple(t.to(dtype).to(card) for t in (x, w, g)) + (stride,)


def _assert_sums_close(got, ref, abs_terms, n, label):
    """Sums of ``n`` float32 products in another order: within
    √n · 2^-23 · Σ|terms| (``abs_terms``), plus one bfloat16 step of the
    reference where the output is bfloat16."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, label
    g, r = got.float(), ref.float()
    assert bool(torch.isfinite(g).all()), label
    tol = math.sqrt(n) * 2.0 ** -23 * abs_terms.float() + 1e-30
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * r.abs()
    excess = float(((g - r).abs() - tol).max())
    assert excess <= 0, f"{label}: {excess:.3g} past the tolerance"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(MC_CASES))
def test_mc_conv_kernels_match_plain_versions(name, dtype, card):
    """Forward, dx and dw on the card against the plain versions on the
    same inputs.  dx of a stride-1 odd conv is the forward kernel on
    flipped weights; the others take the library input gradient, held here
    against autograd through the per-client library conv in float32, with
    cuDNN's TF32 off as the port's ``get_device`` sets it."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        _check_mc_conv_case(name, dtype, card)


def _check_mc_conv_case(name, dtype, card):
    from fedml_tpu_torch.ops import pallas_mc_conv as mc

    x, w, g, stride = _mc_inputs(name, dtype, card)
    _, kh, kw, ci, co = w.shape
    before = dict(mc.LAUNCHES)
    y = mc.mc_conv_fwd(x, w, stride)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["mc_conv.fwd"] == before["mc_conv.fwd"] + 1
    _assert_sums_close(y, mc.mc_conv_fwd_reference(x, w, stride),
                       mc.mc_conv_fwd_reference(x.abs(), w.abs(), stride)
                       .float(), kh * kw * ci, f"{name} forward")

    dw = mc.mc_conv_wgrad(x, g, kh, kw, stride)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["mc_conv.wgrad"] == before["mc_conv.wgrad"] + 1
    n = g.numel() // (g.shape[0] * co)
    _assert_sums_close(dw, mc.mc_conv_wgrad_reference(x, g, kh, kw, stride),
                       mc.mc_conv_wgrad_reference(x.abs(), g.abs(), kh, kw,
                                                  stride), n, f"{name} dw")
    assert torch.equal(dw, mc.mc_conv_wgrad(x, g, kh, kw, stride)), \
        f"{name}: dw differs from run to run"

    xr = x.detach().clone().requires_grad_(True)
    wr = w.detach().clone().requires_grad_(True)
    dx, dw_auto = torch.autograd.grad(mc.mc_conv(xr, wr, stride), (xr, wr), g)
    assert torch.equal(dw_auto, dw.to(dtype))
    if stride == (1, 1) and kh % 2 == 1:
        w_flip = w.flip(1, 2).transpose(3, 4)
        _assert_sums_close(dx, mc.mc_conv_fwd_reference(g, w_flip),
                           mc.mc_conv_fwd_reference(g.abs(), w_flip.abs())
                           .float(), kh * kw * co, f"{name} dx")
    else:
        xf = x.float().requires_grad_(True)
        (dx_f32,) = torch.autograd.grad(
            mc.conv_for_clients(xf, w.float(), stride, impl="library"), xf,
            g.float())
        abs_terms = mc._library_dx(x.shape, w.abs().float(),
                                   g.abs().float(), stride)
        _assert_sums_close(dx, dx_f32.to(dtype), abs_terms, kh * kw * co,
                           f"{name} library dx")


@pytest.mark.gpu
def test_mc_conv_refuses_what_it_does_not_take(card):
    from fedml_tpu_torch.ops import pallas_mc_conv as mc

    before = dict(mc.LAUNCHES)
    x = torch.zeros(2, 1, 4, 4, 8, device=card)
    w = torch.zeros(2, 3, 3, 8, 8, device=card)
    with pytest.raises(TypeError, match="one dtype"):
        mc.mc_conv_fwd(x.half(), w.half())
    with pytest.raises(TypeError, match="one dtype"):
        mc.mc_conv_wgrad(x.double(), x.double(), 3, 3)
    with pytest.raises(ValueError, match=r"\[K, B, H, W, Ci\]"):
        mc.mc_conv_fwd(x[0], w)
    with pytest.raises(ValueError, match="on the CPU or on one card"):
        mc.mc_conv_fwd(x, w.cpu())
    assert mc.LAUNCHES == before
