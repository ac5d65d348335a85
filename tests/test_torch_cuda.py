"""The CUDA weighted-reduce kernel against its plain PyTorch version, on the
card.  Every test here needs an NVIDIA card and ``nvcc``: the kernel has no
CPU mode, so they skip elsewhere.  The file imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in ``tests/test_torch_epilogue.py``: float32 at
``atol=rtol=2e-6`` (sums in another order), bfloat16 at one bfloat16 step.
"""

import pytest
import torch

from fedml_tpu_torch.ops import epilogue

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
