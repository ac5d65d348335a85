"""Parity of the port's CIFAR ResNet with the JAX package's.

The same numpy inputs and the same variables (JAX's initialisation, carried
across by ``fedml_tpu_torch.utils.weights``) go through both models; logits,
the masked loss, the train-mode BatchNorm statistics and the parameter
gradients must agree.

Tolerances: the port in float32 at ``atol=rtol=1e-4`` against the JAX
model run in float64 — the exact value of the reference's arithmetic, off
which the port's float32 result differs only by float32 rounding.  The JAX
package's own float32 run on the CPU is no finer yardstick: its gradients
are off its float64 ones by up to 3e-3 at depth 8 and its train-mode logits
by 3e-4 at depth 20 (the fast-variance BatchNorm, E[x²] − E[x]², cancels),
while the port in float64 agrees with it in float64 to 3e-8.  Gradients are
held at depth 8 only: at depth 20 these inputs make the gradient
ill-conditioned, and any float32 run is off the float64 gradient by up to
6e-3 (the port) or 1.8e-2 (the JAX package).  bfloat16
compute at ``atol=rtol=0.05`` on logits, loss and statistics: both frameworks round every conv output to bfloat16 (8 bits of
mantissa, relative step 2^-8 ≈ 0.004) but accumulate inside each conv in a
different order, so one-ulp flips compound over the layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ml.engine.model_bundle import masked_loss as jax_masked_loss
from fedml_tpu.models.cv import CIFARResNet as JaxResNet
from fedml_tpu_torch.ml.engine.model_bundle import ModelBundle, masked_loss
from fedml_tpu_torch.models import model_hub
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.utils.weights import from_flax_variables, to_flax_variables

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def _inputs(seed, n=8, n_pad=3):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=n).astype(np.int64)
    mask = np.ones(n, np.float32)
    # padded rows as make_batches writes them: zero input, zero label
    x[n - n_pad:] = 0.0
    y[n - n_pad:] = 0
    mask[n - n_pad:] = 0.0
    return x, y, mask


def _jax_model(depth, dtype, x):
    module = JaxResNet(depth=depth, num_classes=10, dtype=dtype)
    variables = module.init({"params": jax.random.PRNGKey(depth)},
                            jnp.asarray(x[:2]), train=False)
    return module, jax.tree_util.tree_map(np.asarray, dict(variables))


def _port_model(depth, dtype, np_vars):
    model = CIFARResNet(depth=depth, num_classes=10, dtype=dtype)
    from_flax_variables(np_vars, model)
    return model


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(got, want, tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


def _jax_side_f64(depth, np_vars, x, y, mask):
    """``_jax_side`` with the JAX model computing in float64."""
    module = JaxResNet(depth=depth, num_classes=10, dtype=jnp.float64)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     np_vars)
        out = _jax_side(module, v64, x.astype(np.float64), y, mask)
        return jax.tree_util.tree_map(np.asarray, out)


def _jax_side(module, np_vars, x, y, mask):
    def loss_fn(params):
        logits, mutated = module.apply(
            {"params": params, "batch_stats": np_vars["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        loss = jax_masked_loss("classification", logits, jnp.asarray(y),
                               jnp.asarray(mask))
        return loss, (logits, mutated["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(np_vars["params"])
    eval_logits = jax.jit(lambda v: module.apply(v, jnp.asarray(x),
                                                 train=False))(np_vars)
    return (np.asarray(logits), float(loss), stats, grads,
            np.asarray(eval_logits))


def _port_side(model, x, y, mask):
    xt, yt, mt = (torch.from_numpy(x), torch.from_numpy(y),
                  torch.from_numpy(mask))
    eval_logits = model(xt, train=False).detach().numpy()
    logits = model(xt, train=True)
    loss = masked_loss("classification", logits, yt, mt)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    # the gradients in the flax layout: through a twin module's variables
    twin = CIFARResNet(depth=model.depth, num_classes=10)
    with torch.no_grad():
        for p, g in zip(twin.parameters(), grads):
            p.copy_(g)
    return (logits.detach().numpy(), float(loss.detach()),
            to_flax_variables(model)["batch_stats"],
            to_flax_variables(twin)["params"], eval_logits)


@pytest.mark.parametrize("depth", [8, 20])
def test_resnet_f32_matches_jax(depth):
    x, y, mask = _inputs(depth)
    _, np_vars = _jax_model(depth, jnp.float32, x)
    j_logits, j_loss, j_stats, j_grads, j_eval = _jax_side_f64(
        depth, np_vars, x, y, mask)
    p_logits, p_loss, p_stats, p_grads, p_eval = _port_side(
        _port_model(depth, torch.float32, np_vars), x, y, mask)
    np.testing.assert_allclose(p_eval, j_eval, **F32_TOL)
    np.testing.assert_allclose(p_logits, j_logits, **F32_TOL)
    np.testing.assert_allclose(p_loss, j_loss, **F32_TOL)
    _assert_tree_close(p_stats, j_stats, F32_TOL)
    if depth == 8:
        _assert_tree_close(p_grads, j_grads, F32_TOL)


@pytest.mark.parametrize("depth", [8, 20])
def test_resnet_bf16_matches_jax(depth):
    x, y, mask = _inputs(depth + 1)
    module, np_vars = _jax_model(depth, jnp.bfloat16, x)
    j_logits, j_loss, j_stats, _, j_eval = _jax_side(
        module, np_vars, x, y, mask)
    p_logits, p_loss, p_stats, _, p_eval = _port_side(
        _port_model(depth, torch.bfloat16, np_vars), x, y, mask)
    np.testing.assert_allclose(p_eval, j_eval, **BF16_TOL)
    np.testing.assert_allclose(p_logits, j_logits, **BF16_TOL)
    np.testing.assert_allclose(p_loss, j_loss, **BF16_TOL)
    _assert_tree_close(p_stats, j_stats, BF16_TOL)


def test_weights_roundtrip_is_exact():
    x, _, _ = _inputs(0)
    _, np_vars = _jax_model(20, jnp.float32, x)
    back = to_flax_variables(_port_model(20, torch.float32, np_vars))
    _assert_tree_close(back, np_vars, dict(atol=0, rtol=0))


def test_weights_reject_a_tree_of_another_depth():
    x, _, _ = _inputs(0)
    _, np_vars = _jax_model(8, jnp.float32, x)
    with pytest.raises(ValueError, match="does not fit"):
        _port_model(20, torch.float32, np_vars)


def test_stride2_same_padding_is_low_zero_high_one():
    # flax SAME on a 3x3 stride-2 conv pads (0, 1): a window starting at
    # row/col 0, not -1 — checked on one conv of the port against lax
    from fedml_tpu_torch.models.cv import Conv

    rng = np.random.RandomState(3)
    x = rng.rand(2, 8, 8, 4).astype(np.float32)
    k = rng.rand(3, 3, 4, 5).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = Conv(4, 5, 3, 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)


def test_model_hub_names_known_options():
    from fedml_tpu_torch.arguments import Config

    with pytest.raises(ValueError, match="resnet20, resnet32, resnet56"):
        model_hub.create(Config(model="mobilenet", dataset="cifar10"))
    bundle = model_hub.create(Config(model="resnet56", dataset="cifar10"))
    assert isinstance(bundle, ModelBundle)
    assert bundle.module.dtype == torch.bfloat16
    n = sum(p.numel() for p in bundle.module.parameters())
    n_stats = sum(b.numel() for b in bundle.module.buffers())
    # ResNet-56 at CIFAR-10 width: 173 params leaves, 114 batch_stats leaves
    assert (n, n_stats) == (855770, 4256)
    assert len(list(bundle.module.parameters())) == 173
    assert len(list(bundle.module.buffers())) == 114


@pytest.mark.parametrize("sigmoid", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logistic_regression_matches_jax(dtype, sigmoid):
    """``model_hub.create("lr")`` on ``synthetic`` (60 features, 10
    classes) against ``fedml_tpu.models.cv.LogisticRegression`` from the
    same variables: logits, the masked loss and its gradients.  float32 at
    ``F32_TOL`` (one matmul in another order); bfloat16 at ``BF16_TOL``
    (both round inputs and weights to bfloat16, then sum in another
    order)."""
    from fedml_tpu.models.cv import LogisticRegression as JaxLR
    from fedml_tpu_torch.arguments import Config

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    bundle = model_hub.create(Config(model="lr", dataset="synthetic",
                                     compute_dtype=dtype,
                                     lr_sigmoid_outputs=sigmoid))
    assert bundle.input_shape == (60,) and bundle.num_classes == 10
    rng = np.random.RandomState(7)
    x = rng.randn(12, 60).astype(np.float32)
    y = rng.randint(0, 10, 12)
    mask = np.array([1.0] * 9 + [0.0] * 3, np.float32)
    jmodel = JaxLR(10, dtype=jdt, sigmoid_output=sigmoid)
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x))
    from_flax_variables(jax.tree_util.tree_map(np.asarray, variables),
                        bundle.module)

    def jloss(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(x))
        return jax_masked_loss("classification", logits, jnp.asarray(y),
                               jnp.asarray(mask)), logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(
        jloss, has_aux=True)(variables["params"])
    logits = bundle.apply(torch.from_numpy(x), train=True)
    loss = bundle.loss(logits, torch.from_numpy(y), torch.from_numpy(mask))
    loss.backward()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits, np.float32), **tol)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **tol)
    dense = bundle.module.Dense_0
    np.testing.assert_allclose(
        dense.weight.grad.numpy().T,
        np.asarray(want_grads["Dense_0"]["kernel"], np.float32), **tol)
    np.testing.assert_allclose(
        dense.bias.grad.numpy(),
        np.asarray(want_grads["Dense_0"]["bias"], np.float32), **tol)
