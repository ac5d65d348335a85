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
