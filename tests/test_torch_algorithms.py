"""One client's local update in each arm of the federated optimizers —
FedProx, FedDyn, SCAFFOLD, Mime and FedNova — in both of the port's bodies
(host-skip and gated), against the JAX package's ``build_local_update``.

The inputs are seeded numpy arrays: the client's 19 samples in batches of
8 (two full, a partly padded one, one of padding only), and the arm's
state (SCAFFOLD's ``c_global`` and ``c_local``, FedDyn's ``feddyn_lambda``,
Mime's ``server_momentum``), shaped like ``params`` with values of about
0.01 — Mime's at 1, so that the server momentum dominates its blend.  Both
sides start from the JAX package's initial variables.

Tolerances:

* logistic regression (``lr`` on synthetic data, 60 features, 10 classes)
  at 1e-5 absolute and relative, on the variables, the metrics and every
  ``algo_out``: both sides compute in float32, with sums in another order;
* ResNet depth 8 at ``tests/test_torch_parrot.py``'s 1e-3 on the variables
  and ``rtol=1e-4`` on the metrics, the JAX side run in float64 (scoped
  ``jax.enable_x64``) as ``tests/test_torch_local_update.py`` runs it: the
  JAX package's float32 gradients on the CPU are off their float64 values
  by up to 3e-3 (its fast-variance BatchNorm), more than Mime's
  ``full_grad`` (a gradient, no SGD step scaling it) could be held to in
  float32 against float32.  SCAFFOLD's
  ``c_local`` and ``c_delta`` and FedNova's ``nova_d`` are parameter
  differences divided by ``τ·lr`` (here 3 steps at 0.05), so their bound
  is the variables' scaled by ``1/(τ·lr)``: 1e-3 / 0.15 = 6.7e-3.  Mime's
  ``full_grad`` is a mean of gradients, which the variables see scaled by
  ``lr``: its bound is theirs over ``lr``, 1e-3 / 0.05 = 2e-2.  That room
  is used: on the partly padded batch (3 real rows and 5 of zeros, whose
  BatchNorm statistics are ill-conditioned) the port's float32 gradient is
  off the float64 one by up to 7.7e-3 (the port in float64 agrees with
  JAX's to 1e-8), 2.5e-3 in the mean of the three batches.  FedDyn's
  ``feddyn_lambda`` (``α·`` the parameters' move, α = 0.01) at 1e-5.

Then the gated body against the host-skip one per arm, bit for bit:
variables, metrics and ``algo_out``, over two epochs of a grid with padded
batches in the middle and at the end.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu.arguments import Config as JaxConfig
from fedml_tpu.ml.engine import local_update as jax_lu
from fedml_tpu.ml.engine.model_bundle import ModelBundle as JaxBundle
from fedml_tpu.models.cv import CIFARResNet as JaxResNet
import fedml_tpu_torch
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.ml.engine import local_update as lu
from fedml_tpu_torch.ml.engine.model_bundle import FlatVariables, ModelBundle
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.utils.weights import (
    flat_from_params_tree,
    from_flax_variables,
    params_tree_from_flat,
    to_flax_variables,
)

ARMS = ["FedProx", "FedDyn", "SCAFFOLD", "Mime", "FedNova"]
BS, NB, N_REAL = 8, 4, 19
LR = 0.05
TAU = 3
RESNET_TOL = 1e-3
#: per model and output, the absolute bound (the relative one: 1e-5 for
#: lr, none for the ResNet)
OUT_TOL = {
    "lr": {"c_local": 1e-5, "c_delta": 1e-5, "nova_d": 1e-5,
           "feddyn_lambda": 1e-5, "full_grad": 1e-5},
    "resnet8": {"c_local": RESNET_TOL / (TAU * LR),
                "c_delta": RESNET_TOL / (TAU * LR),
                "nova_d": RESNET_TOL / (TAU * LR),
                "feddyn_lambda": 1e-5, "full_grad": RESNET_TOL / LR},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread (see ``tests/test_torch_fused_rounds.py``:
    beside other test processes, a thread pool per process oversubscribes
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfg(cls, arm):
    return cls(federated_optimizer=arm, epochs=1, learning_rate=LR,
               client_optimizer="sgd", fedprox_mu=0.1, feddyn_alpha=0.01,
               server_momentum=0.9, model="lr", dataset="synthetic",
               compute_dtype="float32")


def _client(model, seed=0):
    rng = np.random.RandomState(seed)
    shape = (60,) if model == "lr" else (32, 32, 3)
    return (rng.rand(N_REAL, *shape).astype(np.float32),
            rng.randint(0, 10, size=N_REAL).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _jax_bundle(model):
    if model == "lr":
        args = fedml_tpu.init(JaxConfig(model="lr", dataset="synthetic",
                                        compute_dtype="float32"))
        return fedml_tpu.model.create(args, 10)
    return JaxBundle(JaxResNet(depth=8, num_classes=10, dtype=jnp.float32),
                     (32, 32, 3), 10)


def _np_vars(model):
    v = _jax_bundle(model).init_variables(jax.random.PRNGKey(3))
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _algo_state(arm, params, seed=1):
    """The arm's state trees shaped like ``params`` (numpy)."""
    rng = np.random.RandomState(seed)

    def like(scale):
        return jax.tree_util.tree_map(
            lambda a: (scale * rng.randn(*a.shape)).astype(np.float32),
            params)

    if arm == "SCAFFOLD":
        return {"c_global": like(0.01), "c_local": like(0.01)}
    if arm == "FedDyn":
        return {"feddyn_lambda": like(0.01)}
    if arm == "Mime":
        return {"server_momentum": like(1.0)}
    return {}


@functools.lru_cache(maxsize=None)
def _jax_run(model, arm):
    """The JAX local update, float32 for lr and float64 for the ResNet:
    (variables, algo_out, metrics), numpy trees."""
    np_vars = _np_vars(model)
    x, y = _client(model)
    state = _algo_state(arm, np_vars["params"])
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    if model == "lr":
        batches = jax_lu.make_batches(x, y, BS, NB)
        new_vars, out, metrics = jax.jit(jax_lu.build_local_update(
            _jax_bundle(model), _cfg(JaxConfig, arm)))(
                np_vars, batches, jax.random.PRNGKey(0),
                jax.tree_util.tree_map(jnp.asarray, state) or None)
        return as_np(dict(new_vars)), as_np(out), as_np(metrics)
    with jax.enable_x64(True):
        bundle = JaxBundle(JaxResNet(depth=8, num_classes=10,
                                     dtype=jnp.float64),
                           (32, 32, 3), 10, input_dtype=jnp.float64)
        f64 = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), t)
        batches = jax_lu.make_batches(x, y, BS, NB, jnp.float64)
        new_vars, out, metrics = jax.jit(jax_lu.build_local_update(
            bundle, _cfg(JaxConfig, arm)))(
                f64(np_vars), batches, jax.random.PRNGKey(0),
                f64(state) or None)
        return as_np(dict(new_vars)), as_np(out), as_np(metrics)


def _port_bundle(model):
    if model == "lr":
        return fedml_tpu_torch.model.create(
            Config(model="lr", dataset="synthetic", compute_dtype="float32"),
            10)
    return ModelBundle(CIFARResNet(depth=8, num_classes=10), (32, 32, 3), 10)


def _port_run(model, arm, gated, np_vars, batches, valid, epochs=1):
    """The port's local update from ``np_vars``: (module variables as a
    flax tree, metrics, algo_out as numpy trees)."""
    bundle = _port_bundle(model)
    flat = FlatVariables(bundle.module)
    from_flax_variables(np_vars, bundle.module)
    state = {k: flat_from_params_tree(jax.tree_util.tree_map(
        torch.from_numpy, t), flat)
        for k, t in _algo_state(arm, np_vars["params"]).items()}
    cfg = _cfg(Config, arm)
    cfg.epochs = epochs
    update = lu.build_local_update(bundle, cfg, gated=gated)
    if gated:
        m = update(flat, batches, torch.tensor(valid), algo_state=state)
    else:
        m = update(flat, batches, list(valid), algo_state=state)
    out = {k: (params_tree_from_flat(v, flat) if isinstance(v, dict) else v)
           for k, v in m.pop("algo_out").items()}
    out = jax.tree_util.tree_map(lambda t: t.numpy(), out)
    return to_flax_variables(bundle.module), m, out, flat


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


CASES = [(m, a) for m in ("lr", "resnet8") for a in ARMS]


@pytest.mark.parametrize("gated", [False, True], ids=["host-skip", "gated"])
@pytest.mark.parametrize("model,arm", CASES,
                         ids=[f"{m}-{a}" for m, a in CASES])
def test_local_update_arm_matches_jax(model, arm, gated):
    j_vars, j_out, j_metrics = _jax_run(model, arm)
    x, y = _client(model)
    batches = lu.make_batches(x, y, BS, NB)
    got, metrics, out, _ = _port_run(model, arm, gated, _np_vars(model),
                                     batches, [True, True, True, False])
    tol = (dict(atol=1e-5, rtol=1e-5) if model == "lr"
           else dict(atol=RESNET_TOL, rtol=0))
    mtol = 1e-5 if model == "lr" else 1e-4
    want = _leaves(j_vars)
    g = _leaves(got)
    assert g.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(g[k], want[k], err_msg=k, **tol)
    assert int(metrics["local_steps"]) == TAU == int(j_metrics["local_steps"])
    for k in ("train_loss", "train_acc", "n_samples"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=mtol, err_msg=k)
    assert set(out) == set(j_out)
    assert bool(out) == (arm != "FedProx")
    for name in j_out:
        if name == "tau":
            assert float(out[name]) == float(j_out[name]) == TAU
            continue
        o, w = _leaves(out[name]), _leaves(j_out[name])
        assert o.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(
                o[k], w[k], atol=OUT_TOL[model][name],
                rtol=1e-5 if model == "lr" else 0, err_msg=f"{name} {k}")
        # the output is not trivially zero
        assert max(np.abs(v).max() for v in w.values()) > 0
    # the variables moved
    init = _leaves(_np_vars(model))
    assert any(np.abs(g[k] - init[k]).max() > 0 for k in init)


@pytest.mark.parametrize("arm", ARMS)
def test_gated_body_equals_host_skip_bit_for_bit(arm):
    """Two epochs of a ResNet-8 over a grid with padded batches in the
    middle and at the end, and a partly padded one: the gated body's
    variables, metrics and ``algo_out`` equal the host-skip body's."""
    bs, nb = 8, 5
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(nb, bs, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, size=(nb, bs)).astype(np.int64))
    mask = torch.ones(nb, bs)
    mask[1] = 0.0
    mask[2, 5:] = 0.0
    mask[4] = 0.0
    batches = {"x": x, "y": y, "mask": mask}
    valid = (mask > 0).any(dim=1).tolist()
    np_vars = _np_vars("resnet8")
    runs = [_port_run("resnet8", arm, gated, np_vars, batches, valid,
                      epochs=2) for gated in (False, True)]
    (v0, m0, o0, f0), (v1, m1, o1, f1) = runs
    for dt in f0.flat:
        assert torch.equal(f0.flat[dt], f1.flat[dt])
    for k in ("train_loss", "train_acc", "n_samples"):
        assert torch.equal(m0[k], m1[k]), k
    assert m0["local_steps"] == int(m1["local_steps"]) == 6
    assert set(o0) == set(o1) and bool(o0) == (arm != "FedProx")
    for name in o0:
        a, b = _leaves(o0[name]), _leaves(o1[name])
        for k in a:
            assert np.array_equal(a[k], b[k]), (name, k)


def test_unknown_algorithm_and_mime_compat_raise():
    bundle = _port_bundle("lr")
    cfg = _cfg(Config, "Mime")
    cfg.mime_ref_compat = True
    with pytest.raises(NotImplementedError, match="mime_ref_compat"):
        lu.build_local_update(bundle, cfg)
    with pytest.raises(NotImplementedError, match="A9"):
        lu.build_local_update(bundle, _cfg(Config, "FedGKT"))
    # an arm given no state names what it needs
    flat = FlatVariables(bundle.module)
    x, y = _client("lr")
    update = lu.build_local_update(bundle, _cfg(Config, "SCAFFOLD"))
    with pytest.raises(ValueError, match="c_global"):
        update(flat, lu.make_batches(x, y, BS, NB))
