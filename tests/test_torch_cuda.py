"""The CUDA kernels against their plain PyTorch versions, on the card: the
weighted reduce, the fused epilogue and the flash-attention forward.  Every test here needs an NVIDIA card and ``nvcc``: the kernel has no
CPU mode, so they skip elsewhere.  The file imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in ``tests/test_torch_epilogue.py``: float32 at
``atol=rtol=2e-6`` (sums in another order), bfloat16 at one bfloat16 step.
"""

import pytest
import torch

from fedml_tpu_torch.ops import epilogue
from fedml_tpu_torch.ops import pallas_attention as attn

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
