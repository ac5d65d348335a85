"""The port's weighted reduce against the JAX package's Pallas kernel.

The same numpy trees go through ``fedml_tpu.ops.epilogue.weighted_reduce``
with the Pallas ``_reduce_kernel`` in interpret mode (as
``tests/test_epilogue.py`` runs it) and through the port's wrapper on CPU
tensors, which takes the plain version.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.

Tolerances: float32 at ``atol=rtol=2e-6`` — both accumulate in float32,
in another order.  bfloat16 at one bfloat16 step (``rtol=2**-8``, plus
``atol=1e-6`` near zero): the float32 sums may differ in the last bit, and
a bit on the rounding boundary moves the bfloat16 result by one step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import epilogue as jax_ep
from fedml_tpu_torch.ml.aggregator.agg_operator import agg_stacked
from fedml_tpu_torch.ops import epilogue

F32_TOL = dict(atol=2e-6, rtol=2e-6)
BF16_TOL = dict(atol=1e-6, rtol=2.0 ** -8)


def _tree(c, dtype, seed, with_int=False, ragged=False):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(c, 7, 130)), "b": rng.normal(size=(c, 9)),
            "s": rng.normal(size=(c,))}
    if ragged:
        tree["r"] = rng.normal(size=(c, 1027))
    tree = {k: jnp.asarray(v, dtype) for k, v in tree.items()}
    if with_int:
        tree["steps"] = jnp.asarray(rng.integers(0, 50, size=(c,)),
                                    jnp.int32)
    return tree


def _to_torch(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:   # exact through float32
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _weights(c, seed=1):
    return np.random.default_rng(seed).uniform(0.5, 3.0, c).astype(
        np.float32)


def _case(name):
    """(tree, weights) for each case the kernel must take."""
    if name == "f32":
        return _tree(5, jnp.float32, 13), _weights(5)
    if name == "bf16":
        return _tree(5, jnp.bfloat16, 13), _weights(5)
    if name == "masked":
        w = _weights(6)
        w[[1, 4]] = 0.0
        return _tree(6, jnp.float32, 14), w
    if name == "all_zero":
        return _tree(4, jnp.float32, 15), np.zeros(4, np.float32)
    if name == "int_leaf":
        return _tree(5, jnp.float32, 16, with_int=True), _weights(5)
    if name == "one_client":
        return _tree(1, jnp.float32, 17), _weights(1)
    if name == "ragged":
        return _tree(3, jnp.float32, 18, ragged=True), _weights(3)
    if name == "many_clients":
        return _tree(96, jnp.float32, 19), _weights(96)
    raise KeyError(name)


CASES = ["f32", "bf16", "masked", "all_zero", "int_leaf", "one_client",
         "ragged", "many_clients"]


@pytest.mark.parametrize("name", CASES)
def test_weighted_reduce_matches_pallas_interpret(name):
    tree, w = _case(name)
    want = jax_ep.weighted_reduce(tree, jnp.asarray(w), prefer_pallas=True,
                                  interpret=True)
    before = epilogue.LAUNCHES["weighted_reduce"]
    wt = torch.from_numpy(w)
    for k, leaf in tree.items():
        got = epilogue.weighted_reduce(_to_torch(leaf), wt)
        ref = jnp.asarray(want[k])
        want_dtype = (torch.bfloat16 if ref.dtype == jnp.bfloat16
                      else torch.float32)
        assert got.dtype == want_dtype, k
        assert tuple(got.shape) == tuple(ref.shape), k
        tol = BF16_TOL if want_dtype == torch.bfloat16 else F32_TOL
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   err_msg=k, **tol)
    # the CPU path is the plain version; no kernel launched
    assert epilogue.LAUNCHES["weighted_reduce"] == before


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flat_buffer_reduce_equals_per_leaf(dtype):
    """agg_stacked over one [C, D] buffer holding every leaf (the Parrot
    layout) gives each leaf's JAX result in its slice."""
    tree, w = _tree(5, dtype, 21, ragged=True), _weights(5)
    want = jax_ep.weighted_reduce(tree, jnp.asarray(w), prefer_pallas=True,
                                  interpret=True)
    leaves = [_to_torch(v).reshape(5, -1) for v in tree.values()]
    flat = torch.cat(leaves, dim=1)
    torch_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    out = agg_stacked({torch_dtype: flat}, torch.from_numpy(w))[torch_dtype]
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL
    off = 0
    for k, leaf in zip(tree, leaves):
        n = leaf.shape[1]
        np.testing.assert_allclose(
            out[off:off + n].float().numpy(),
            np.asarray(want[k], np.float32).reshape(-1), err_msg=k, **tol)
        off += n


@pytest.mark.parametrize("stacked_dev,weights_dev", [("meta", "meta"),
                                                     ("cpu", "meta"),
                                                     ("meta", "cpu")])
def test_wrapper_refuses_other_devices(stacked_dev, weights_dev):
    """Only CPU tensors take the plain version; anything not on the CPU
    goes to the kernel's checks and is refused, never computed."""
    with pytest.raises(ValueError, match="both must be on the CPU"):
        epilogue.weighted_reduce(torch.zeros(3, 4, device=stacked_dev),
                                 torch.ones(3, device=weights_dev))
