"""The port's Parrot rounds in the arms of FedProx, FedNova, SCAFFOLD, FedDyn
and Mime, against the JAX package's ``ParrotAPI``.

(a) Two uniform per-round rounds per arm, at ``tests/test_torch_parrot.py``'s
``_args`` (synthetic CIFAR-10, ResNet depth 8, 4 clients, 2 a round with
the reference's ``np.random.seed(round)`` draws, float32 compute), both
sides starting from the JAX package's initial variables: the global
variables within 1e-3 and ``train_loss``/``test_loss``/``test_acc`` at
``rtol=1e-4``, as that file holds FedAvg (the JAX package's float32
gradients on the CPU are off their float64 values by up to 3e-3, which
each SGD step scales by the learning rate).  The server state against the
JAX package's, by what it is made of: SCAFFOLD's ``c_locals`` and
``c_global`` are parameter moves over ``τ·lr``, so the variables' bound
over ``τ·lr`` with τ the fewest steps of a client (2 at 0.05 here: 1e-2);
FedDyn's ``lambdas`` and ``h``, ``α`` (0.01) times parameter moves, at the
bound times ``α``; Mime's momentum, ``(1 − β)`` times a mean of gradients
(``tests/test_torch_algorithms.py``: a gradient's bound is the variables'
over ``lr``), at the bound over ``lr`` times ``1 − β``, 2e-3.  The rows of
clients that have not trained stay zero.

(b) One bucketed SCAFFOLD run of ``tests/test_parrot.py``'s
``test_bucketed_hetero_rounds_converge`` shape (12 clients, 6 a round in 3
size strata, logistic regression on synthetic data): it learns, and the
per-client state stays consistent — ``c_global`` is the sum of the
``c_locals`` rows over ``N`` (the server adds ``Σ c_delta / N`` as the rows
change by ``c_delta``), to float32 rounding (1e-6).

(c) The fused rounds (uncaptured on the CPU) against the JAX package's
``run_rounds_fused`` for SCAFFOLD and FedDyn: 2 rounds of logistic
regression on synthetic data with every client in every round (the two
frameworks draw their orders from other bits); the globals at 1e-5 (both
sides in float32, sums in another order), the losses at ``rtol=1e-5``, and
the tables as in (a) from that bound.

(d) SCAFFOLD's resume from a chunk-boundary checkpoint: fused rounds in
chunks of 2, 2 of 4 clients a round; a fresh API restores the checkpoint
of round 1 (through the file) in place and runs the second chunk with the
straight run's seed: the globals, ``c_locals``, ``c_global`` and the
losses equal the straight run's, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu.arguments import Config as JaxConfig
from fedml_tpu.data import data_loader as jax_loader
from fedml_tpu.ml.engine.model_bundle import ModelBundle as JaxBundle
from fedml_tpu.models.cv import CIFARResNet as JaxResNet
from fedml_tpu.simulation.parrot.parrot_api import ParrotAPI as JaxParrot
import fedml_tpu_torch
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.data import data_loader
from fedml_tpu_torch.ml.engine.model_bundle import ModelBundle
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.simulation.parrot.parrot_api import ParrotAPI
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
from fedml_tpu_torch.utils.weights import flax_params_from_flat

CPU = torch.device("cpu")
ARMS = ["FedProx", "FedNova", "SCAFFOLD", "FedDyn", "Mime"]
LR = 0.05
ALPHA, BETA = 0.01, 0.9


def _state_tol(name, api, tol):
    """The bound on server state ``name`` from the variables' ``tol`` (see
    the module's docstring)."""
    lr = float(api.args.learning_rate)
    tau = min(-(-api.local_num_dict[c] // api.bs) for c in range(api.n_total))
    return {"c_locals": tol / (tau * lr), "c_global": tol / (tau * lr),
            "lambdas": tol * ALPHA, "h": tol * ALPHA,
            "momentum": tol / lr * (1 - BETA)}[name]


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


def _args(cls, tmp_path, **kw):
    base = dict(dataset="cifar10", backend="parrot", partition_method="hetero",
                client_num_in_total=4, client_num_per_round=2, comm_round=2,
                epochs=1, batch_size=16, learning_rate=LR,
                frequency_of_the_test=1, data_scale=0.02,
                compute_dtype="float32", enable_tracking=False,
                device_type="cpu", data_cache_dir=str(tmp_path))
    base.update(kw)
    return cls(**base)


def _jax_bundle():
    return JaxBundle(JaxResNet(depth=8, num_classes=10, dtype=jnp.float32),
                     (32, 32, 3), 10)


def _port_bundle():
    return ModelBundle(CIFARResNet(depth=8, num_classes=10), (32, 32, 3), 10)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(tmp_path, arm, **kw):
    """The JAX and the port API on one config, the port from the JAX
    package's initial variables: (JAX API, port API, initial variables)."""
    jargs = _args(JaxConfig, tmp_path, federated_optimizer=arm,
                  parrot_aot_cache=False, **kw)
    japi = JaxParrot(jargs, None, jax_loader.load(jargs), _jax_bundle())
    init = jax.tree_util.tree_map(np.array, dict(japi.global_vars))
    args = _args(Config, tmp_path, federated_optimizer=arm, **kw)
    api = ParrotAPI(args, CPU, data_loader.load(args), _port_bundle(),
                    initial_variables=init)
    return japi, api, init


def _check_globals(japi, api, init, tol=1e-3):
    got = _leaves(api.global_flax_variables())
    want = _leaves(dict(japi.global_vars))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                   err_msg=k)
    assert any(np.abs(got[k] - _leaves(init)[k]).max() > 0 for k in got)


def _check_state(japi, api, tol=1e-3):
    """The port's server state (per dtype group over the parameter
    columns) against the JAX package's trees shaped like ``params``."""
    names = [k for k in api.server_state if k != "opt_state"]
    assert sorted(names) == sorted(k for k in japi.server_state
                                   if k != "opt_state")
    for name in names:
        mine = api.server_state[name]
        ref = japi.server_state[name]
        bound = _state_tol(name, api, tol)
        rows = next(iter(mine.values())).dim() == 2
        for i in range(api.n_total if rows else 1):
            got = _leaves(flax_params_from_flat(
                {dt: t[i] if rows else t for dt, t in mine.items()},
                api.vars))
            want = _leaves(jax.tree_util.tree_map(
                lambda a: a[i] if rows else a, ref))
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=bound,
                                           rtol=0, err_msg=f"{name}[{i}] {k}")
        assert any(bool(t.abs().max() > 0) for t in mine.values()), name


@pytest.mark.parametrize("arm", ARMS)
def test_two_uniform_rounds_match_jax(arm, tmp_path):
    japi, api, init = _pair(tmp_path, arm)
    japi.train()
    api.train()
    _check_globals(japi, api, init)
    assert len(api.metrics_history) == len(japi.metrics_history) == 2
    for mine, ref in zip(api.metrics_history, japi.metrics_history):
        assert mine["round"] == ref["round"]
        for k in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_allclose(mine[k], ref[k], rtol=1e-4,
                                       err_msg=k)
    _check_state(japi, api)
    if arm in ("SCAFFOLD", "FedDyn"):
        # the rows of the clients that neither round sampled stay zero
        table = api.server_state["c_locals" if arm == "SCAFFOLD"
                                 else "lambdas"][torch.float32]
        trained = {int(c) for r in range(2) for c in
                   api._client_sampling(r)}
        for c in range(api.n_total):
            assert bool(table[c].abs().max() > 0) == (c in trained)


def test_bucketed_scaffold_rounds_learn_and_keep_the_tables(tmp_path):
    args = fedml_tpu_torch.init(Config(
        dataset="synthetic", model="lr", backend="parrot",
        federated_optimizer="SCAFFOLD", comm_round=6,
        client_num_in_total=12, client_num_per_round=6, data_scale=0.4,
        partition_alpha=0.3, hetero_buckets=3, epochs=1, batch_size=16,
        learning_rate=0.1, frequency_of_the_test=1, compute_dtype="float32",
        enable_tracking=False, device_type="cpu",
        data_cache_dir=str(tmp_path)))
    dataset = fedml_tpu_torch.data.load(args)
    runner = fedml_tpu_torch.FedMLRunner(
        args, CPU, dataset, fedml_tpu_torch.model.create(args, dataset[-1]))
    api = runner.runner
    assert api.buckets is not None and len(api.buckets) >= 2
    assert sum(b["k"] for b in api.buckets) == api.k
    nbs = [b["nb"] for b in api.buckets]
    assert nbs == sorted(nbs)
    m = runner.run()
    assert np.isfinite(m["test_loss"]) and m["test_acc"] > 0.15
    c_locals = api.server_state["c_locals"][torch.float32]
    c_global = api.server_state["c_global"][torch.float32]
    assert 6 < int((c_locals.abs().amax(dim=1) > 0).sum()) <= 12
    np.testing.assert_allclose(c_global.numpy(),
                               c_locals.sum(dim=0).numpy() / 12.0,
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("arm", ["SCAFFOLD", "FedDyn"])
def test_fused_rounds_match_jax(arm, tmp_path):
    kw = dict(dataset="synthetic", model="lr", client_num_per_round=4,
              data_scale=0.1, learning_rate=0.1)
    jargs = _args(JaxConfig, tmp_path, federated_optimizer=arm,
                  parrot_aot_cache=False, **kw)
    jdata = jax_loader.load(jargs)
    japi = JaxParrot(jargs, None, jdata,
                     fedml_tpu.model.create(jargs, jdata[-1]))
    init = jax.tree_util.tree_map(np.array, dict(japi.global_vars))
    args = _args(Config, tmp_path, federated_optimizer=arm, **kw)
    data = data_loader.load(args)
    api = ParrotAPI(args, CPU, data, fedml_tpu_torch.model.create(
        args, data[-1]), initial_variables=init)
    japi.FUSED_CHUNK_ROUNDS = api.FUSED_CHUNK_ROUNDS = 2
    jrm = japi.run_rounds_fused(2)
    rm = api.run_rounds_fused(2)
    np.testing.assert_allclose(rm["train_loss"],
                               np.asarray(jrm["train_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(rm["samples"], np.asarray(jrm["samples"]))
    _check_globals(japi, api, init, tol=1e-5)
    _check_state(japi, api, tol=1e-5)


def test_fused_scaffold_resume_equals_a_straight_run(tmp_path):
    ck = tmp_path / "ckpt"
    kw = dict(dataset="synthetic", model="lr", federated_optimizer="SCAFFOLD",
              comm_round=4, client_num_per_round=2, data_scale=0.1,
              learning_rate=0.1, fused_rounds=True)

    def fresh():
        args = _args(Config, tmp_path, **kw)
        dataset = data_loader.load(args)
        api = ParrotAPI(args, CPU, dataset,
                        fedml_tpu_torch.model.create(args, dataset[-1]))
        api.FUSED_CHUNK_ROUNDS = 2
        return api

    straight = fresh()
    first = straight.run_rounds_fused(2, rng=11)
    RoundCheckpointer(str(ck)).save(1, straight._checkpoint_state(1))
    second = straight.run_rounds_fused(2, rng=12)

    resumed = fresh()
    resumed.run_rounds_fused(1, rng=5)      # its device state exists
    tables = resumed.server_state
    ptrs = {k: v[torch.float32].data_ptr() for k, v in tables.items()}
    resumed._restore_state(RoundCheckpointer(str(ck)).restore())
    again = resumed.run_rounds_fused(2, rng=12)
    assert {k: v[torch.float32].data_ptr() for k, v in tables.items()} == ptrs
    np.testing.assert_array_equal(again["train_loss"], second["train_loss"])
    assert not np.array_equal(first["train_loss"], second["train_loss"])
    for dt, f in straight.global_vars.items():
        assert torch.equal(resumed.global_vars[dt], f)
    for name in ("c_locals", "c_global"):
        for dt, t in straight.server_state[name].items():
            assert torch.equal(resumed.server_state[name][dt], t), name
    assert bool(straight.server_state["c_global"][torch.float32].abs().max()
                > 0)
    # a FedAvg checkpoint has no control variates
    other = fresh()
    plain = dict(straight._checkpoint_state(3), server_state={})
    with pytest.raises(ValueError, match="c_global"):
        other._restore_state(plain)
