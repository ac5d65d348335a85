"""The port's SP simulation (``simulation/sp/fed_api.FedSimAPI``) against
the JAX package's, and against the port's own Parrot rounds.

(a) For each of the seven federated optimizers the SP runs (FedAvg, FedOpt
with its default server adam, FedProx, FedNova, SCAFFOLD, FedDyn, Mime),
the ``make_args`` defaults of ``tests/conftest.py`` (synthetic data,
logistic regression, 4 clients all in every round, 3 rounds, an eval
each), both sides starting from the JAX package's initial variables; and
4 of 8 clients a round for SCAFFOLD and FedDyn, whose per-client state
then waits between a client's rounds.  Held: the global variables, every
per-client state table (SCAFFOLD's ``c_locals`` and ``c_global``, FedDyn's
``feddyn_lambdas`` and ``feddyn_h``, Mime's momentum) and each eval's
``test_loss``, at ``tests/test_parrot.py``'s tolerances (``atol=rtol=1e-5``
on the variables, ``rtol=1e-5`` on the loss): both sides compute in
float32 and differ in the order of their sums.

(b) The port's SP against the port's Parrot rounds, per optimizer, as
``tests/test_parrot.py::test_parrot_matches_sp_exactly`` holds the JAX
package's two (data_scale 0.1, 3 rounds; the same tolerances).

(c) ``FedMLAggOperator``'s pair paths, as ``tests/test_aggregation.py``'s
``test_agg_operator_scaffold_and_mime_pair_paths``, and against the JAX
package's operator on seeded trees.

(d) The SP options still to come raise, naming their port item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.ml.aggregator.agg_operator import FedMLAggOperator as JaxAgg
from fedml_tpu.runner import FedMLRunner as JaxRunner
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.ml.aggregator.agg_operator import (
    FedMLAggOperator,
    uniform_average,
)
from fedml_tpu_torch.simulation.sp.fed_api import FedSimAPI

from conftest import make_args

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)
OPTIMIZERS = ["FedAvg", "FedOpt", "FedProx", "FedNova", "SCAFFOLD", "FedDyn",
              "Mime"]


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


def _port_args(**kw):
    return fedml_tpu_torch.init(Config(**dict(vars(make_args(**kw)),
                                              device_type="cpu")))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, what):
    g = jax.tree_util.tree_flatten_with_path(_np(got))[0]
    w = jax.tree_util.tree_flatten_with_path(_np(want))[0]
    assert [jax.tree_util.keystr(k) for k, _ in g] == [
        jax.tree_util.keystr(k) for k, _ in w], what
    for (k, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, err_msg=f"{what} "
                                   f"{jax.tree_util.keystr(k)}", **TOL)


def _torch_np(tree):
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


SP_CASES = [(opt, {}) for opt in OPTIMIZERS] + [
    (opt, dict(client_num_in_total=8, client_num_per_round=4))
    for opt in ("SCAFFOLD", "FedDyn")]


@pytest.mark.parametrize("opt,kw", SP_CASES,
                         ids=[o + ("-4 of 8" if kw else "")
                              for o, kw in SP_CASES])
def test_sp_matches_jax(opt, kw):
    jargs = fedml_tpu.init(make_args(federated_optimizer=opt, **kw))
    jdata = fedml_tpu.data.load(jargs)
    jrunner = JaxRunner(jargs, None, jdata,
                        fedml_tpu.model.create(jargs, jdata[-1]))
    japi = jrunner.runner
    init = _np(dict(japi.global_vars))
    jrunner.run()

    args = _port_args(federated_optimizer=opt, **kw)
    data = fedml_tpu_torch.data.load(args)
    api = FedSimAPI(args, CPU, data, fedml_tpu_torch.model.create(
        args, data[-1]), initial_variables=init)
    api.train()

    _close(_torch_np(api.global_vars), dict(japi.global_vars), "globals")
    assert len(api.metrics_history) == len(japi.metrics_history) == 3
    for mine, ref in zip(api.metrics_history, japi.metrics_history):
        assert mine["round"] == ref["round"]
        np.testing.assert_allclose(mine["test_loss"], ref["test_loss"],
                                   rtol=1e-5)
    if opt == "SCAFFOLD":
        assert sorted(api.c_locals) == sorted(japi.c_locals)
        # 4 of 8 clients a round: 3 rounds reach more clients than one
        assert len(api.c_locals) > 4 if kw else len(api.c_locals) == 4
        for cid in japi.c_locals:
            _close(_torch_np(api.c_locals[cid]), japi.c_locals[cid],
                   f"c_locals[{cid}]")
        _close(_torch_np(api.c_global), japi.c_global, "c_global")
    if opt == "FedDyn":
        assert sorted(api.feddyn_lambdas) == sorted(japi.feddyn_lambdas)
        for cid in japi.feddyn_lambdas:
            _close(_torch_np(api.feddyn_lambdas[cid]),
                   japi.feddyn_lambdas[cid], f"feddyn_lambdas[{cid}]")
        _close(_torch_np(api.feddyn_h), japi.feddyn_h, "feddyn_h")
    if opt == "Mime":
        _close(_torch_np(api.mime_momentum), japi.mime_momentum,
               "mime_momentum")
    # every round trained real samples and moved the model
    assert all(r["samples_trained"] > 0 for r in api.round_history)
    assert any(np.abs(a - b).max() > 0 for a, b in zip(
        jax.tree_util.tree_leaves(_torch_np(api.global_vars)),
        jax.tree_util.tree_leaves(init)))


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_port_sp_matches_port_parrot(opt):
    def run(backend):
        args = _port_args(backend=backend, federated_optimizer=opt,
                          data_scale=0.1)
        data = fedml_tpu_torch.data.load(args)
        runner = fedml_tpu_torch.FedMLRunner(
            args, CPU, data, fedml_tpu_torch.model.create(args, data[-1]))
        return runner.run(), runner.runner

    m_sp, sp = run("sp")
    m_pr, pr = run("parrot")
    assert type(sp).__name__ == "FedSimAPI"
    assert type(pr).__name__ == "ParrotAPI"
    np.testing.assert_allclose(m_sp["test_loss"], m_pr["test_loss"],
                               rtol=1e-5)
    _close(_torch_np(sp.global_vars), pr.global_flax_variables(),
           "globals")


def _tree(v, dtype=jnp.float32):
    return {"w": jnp.full((3,), v, dtype), "b": jnp.full((2,), v, dtype)}


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def test_agg_operator_scaffold_and_mime_pair_paths():
    pairs = [(2.0, (_tree(1.0), _tree(10.0))),
             (2.0, (_tree(3.0), _tree(30.0)))]
    tpairs = [(n, (_t(a), _t(b))) for n, (a, b) in pairs]
    args = Config(federated_optimizer="SCAFFOLD", client_num_in_total=4)
    params_avg, c_avg = FedMLAggOperator.agg(args, tpairs)
    np.testing.assert_allclose(params_avg["w"].numpy(), 2.0, atol=1e-6)
    # control variates average uniformly over client_num_in_total
    np.testing.assert_allclose(c_avg["w"].numpy(), 10.0, atol=1e-6)
    args = Config(federated_optimizer="Mime")
    params_avg, grads_avg = FedMLAggOperator.agg(args, tpairs)
    np.testing.assert_allclose(grads_avg["w"].numpy(), 20.0, atol=1e-6)
    # payloads that are not pairs take one weighted reduction
    avg = FedMLAggOperator.agg(args, [(1.0, _t(_tree(1.0))),
                                      (3.0, _t(_tree(5.0)))])
    np.testing.assert_allclose(avg["b"].numpy(), 4.0, atol=1e-6)


@pytest.mark.parametrize("opt", ["SCAFFOLD", "Mime"])
def test_pair_paths_match_jax_on_seeded_trees(opt):
    rng = np.random.RandomState(4)

    def tree():
        return {"a": {"k": rng.randn(5, 3).astype(np.float32)},
                "b": rng.randn(7).astype(np.float32)}

    pairs = [(float(n), (tree(), tree())) for n in (3, 1, 6)]
    jargs = make_args(federated_optimizer=opt, client_num_in_total=10)
    want = JaxAgg.agg(jargs, [(n, (jax.tree_util.tree_map(jnp.asarray, a),
                                   jax.tree_util.tree_map(jnp.asarray, b)))
                              for n, (a, b) in pairs])
    args = Config(federated_optimizer=opt, client_num_in_total=10)
    got = FedMLAggOperator.agg(args, [(n, (_t(a), _t(b)))
                                      for n, (a, b) in pairs])
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        _close(_torch_np(g), w, opt)


def test_uniform_average_plain_and_stacked_agree():
    trees = [{"x": torch.full((4,), float(v))} for v in (1.0, 2.0, 6.0)]
    out = uniform_average(trees, denom=6.0)
    np.testing.assert_allclose(out["x"].numpy(), 1.5, rtol=1e-7)
    ragged = trees[:2] + [{"x": torch.full((4,), 6.0, dtype=torch.float64)}]
    np.testing.assert_allclose(uniform_average(ragged, 6.0)["x"].numpy(),
                               1.5, rtol=1e-7)


@pytest.mark.parametrize("override,item", [
    (dict(scaffold_ref_bug_compat=True, federated_optimizer="SCAFFOLD"),
     "A9"),
    (dict(fedavg_ref_chain_compat=True), "A9"),
    (dict(feddyn_ref_bug_compat=True), "A9"),
    (dict(robust_agg="median"), "A9"),
    (dict(contribution_alg="LOO"), "A13"),
    (dict(federated_optimizer="HierarchicalFL"), "A9"),
    (dict(federated_optimizer="FedGKT"), "A9"),
    (dict(federated_optimizer="FedAvg_seq"), "A9"),
    (dict(backend="mesh"), "A16"),
    (dict(backend="hyperscale"), "A14")],
    ids=lambda v: str(v) if isinstance(v, str) else next(iter(v)) + "="
    + str(next(iter(v.values()))))
def test_unported_sp_options_raise_naming_their_item(override, item):
    args = _port_args(**override)
    data = fedml_tpu_torch.data.load(args)
    with pytest.raises(NotImplementedError, match=item):
        fedml_tpu_torch.FedMLRunner(
            args, CPU, data, fedml_tpu_torch.model.create(args, data[-1]))


def test_sp_five_step_entry_on_the_cpu():
    args = fedml_tpu_torch.init(Config(**dict(
        vars(make_args(comm_round=2, frequency_of_the_test=5)),
        device_type="cpu", backend="sp", federated_optimizer="FedProx")))
    device = fedml_tpu_torch.device.get_device(args)
    assert device == CPU
    dataset = fedml_tpu_torch.data.load(args)
    bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, bundle)
    out = runner.run()
    # evals at round 0 and at the last round
    assert [m["round"] for m in runner.runner.metrics_history] == [0, 1]
    assert 0.0 <= out["test_acc"] <= 1.0 and np.isfinite(out["test_loss"])
