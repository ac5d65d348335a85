"""The port's FedAvg local update and eval step against the JAX package's.

One client, one epoch of SGD on a ResNet (depth 8) from the same variables
and the same padded batches: two full batches, a partly padded one (its
zero rows enter the BatchNorm statistics, not the loss) and a fully padded
one (a no-op on parameters and BatchNorm state).

Tolerance: the port in float32 at ``atol=rtol=1e-4`` against the JAX engine
run in float64, the exact value of the reference's arithmetic: the JAX
package's own float32 gradients on the CPU are off by up to 3e-3
(``tests/test_torch_model.py``), which SGD carries into the parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fedml_tpu.arguments import Config as JaxConfig
from fedml_tpu.ml.engine import local_update as jax_lu
from fedml_tpu.ml.engine.model_bundle import ModelBundle as JaxBundle
from fedml_tpu.models.cv import CIFARResNet as JaxResNet
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.ml.engine import local_update as lu
from fedml_tpu_torch.ml.engine.model_bundle import FlatVariables, ModelBundle
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.utils.weights import from_flax_variables, to_flax_variables

TOL = dict(atol=1e-4, rtol=1e-4)
BS, NB, N_REAL = 8, 4, 19        # batches: full, full, 3 real, all padding


def _client(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(N_REAL, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, size=N_REAL).astype(np.int64))


def _cfg(cls):
    return cls(federated_optimizer="FedAvg", epochs=1, learning_rate=0.05,
               client_optimizer="sgd")


def _jax_run(np_vars, x, y):
    """JAX local update + eval in float64: (variables, metrics, eval)."""
    with jax.enable_x64(True):
        bundle = JaxBundle(JaxResNet(depth=8, num_classes=10,
                                     dtype=jnp.float64),
                           (32, 32, 3), 10, input_dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     np_vars)
        batches = jax_lu.make_batches(x, y, BS, NB, jnp.float64)
        new_vars, _, metrics = jax.jit(
            jax_lu.build_local_update(bundle, _cfg(JaxConfig)))(
                v64, batches, jax.random.PRNGKey(0))
        ev = jax.jit(jax_lu.build_eval_step(bundle))(new_vars, batches)
        as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        return as_np(dict(new_vars)), as_np(metrics), as_np(ev)


def _port_setup(np_vars):
    model = CIFARResNet(depth=8, num_classes=10)
    bundle = ModelBundle(model, (32, 32, 3), 10)
    flat = FlatVariables(model)
    from_flax_variables(np_vars, model)
    return bundle, flat


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np_vars():
    module = JaxResNet(depth=8, num_classes=10, dtype=jnp.float32)
    v = module.init({"params": jax.random.PRNGKey(3)},
                    jnp.zeros((2, 32, 32, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, dict(v))


def test_local_update_and_eval_match_jax():
    np_vars = _np_vars()
    x, y = _client()
    j_vars, j_metrics, j_eval = _jax_run(np_vars, x, y)

    bundle, flat = _port_setup(np_vars)
    batches = lu.make_batches(x, y, BS, NB)
    metrics = lu.build_local_update(bundle, _cfg(Config))(flat, batches)
    got = _leaves(to_flax_variables(bundle.module))
    want = _leaves(j_vars)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # the padded batch is skipped: 3 steps, 19 samples
    assert metrics["local_steps"] == 3 == int(j_metrics["local_steps"])
    assert float(metrics["n_samples"]) == N_REAL == float(
        j_metrics["n_samples"])
    for k in ("train_loss", "train_acc"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   err_msg=k, **TOL)
    ev = lu.build_eval_step(bundle)(batches)
    for k in ("loss_sum", "correct", "n"):
        np.testing.assert_allclose(float(ev[k]), float(j_eval[k]),
                                   err_msg=k, **TOL)


def test_fully_padded_batches_leave_state_unchanged():
    """Validity given by the caller or read from the mask: the same
    result, and all-padding batches change nothing."""
    np_vars = _np_vars()
    x, y = _client(1)
    bundle, flat = _port_setup(np_vars)
    start = flat.snapshot()
    batches = lu.make_batches(x, y, BS, NB)
    update = lu.build_local_update(bundle, _cfg(Config))
    m_host = update(flat, batches, [True, True, True, False])
    after_host = flat.snapshot()
    flat.load(start)
    m_mask = update(flat, batches)
    for dt in after_host:
        torch.testing.assert_close(flat.flat[dt], after_host[dt], atol=0,
                                   rtol=0)
    assert m_host["local_steps"] == m_mask["local_steps"] == 3
    # a client with only padding: nothing moves
    flat.load(start)
    empty = {k: v[3:] for k, v in batches.items()}
    m = update(flat, empty)
    assert m["local_steps"] == 0 and float(m["n_samples"]) == 0.0
    for dt in start:
        assert torch.equal(flat.flat[dt], start[dt])


def test_make_batches_matches_jax():
    x, y = _client(2)
    got = lu.make_batches(x, y, BS, NB)
    want = jax_lu.make_batches(x, y, BS, NB)
    for k in ("x", "y", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
