"""The port's Parrot rounds against the JAX package's ``ParrotAPI``.

(a) Two rounds of the uniform per-round path (synthetic CIFAR-10, ResNet
depth 8, 4 clients, 2 per round, float32 compute), both sides starting from
the JAX package's initial variables and sampling with the reference's
``np.random.seed(round)``: the global variables and the recorded
``train_loss``/``test_loss``/``test_acc`` must agree.  Tolerances: 1e-3
absolute on variables and 1e-4 relative on the metrics — the JAX package's
float32 gradients on the CPU are off their float64 values by up to 3e-3
(``tests/test_torch_model.py``), which each SGD step scales by the learning
rate into the parameters.

(b) The rotating-window gather of a capped size bucket, given the same
window starts (drawn with ``jax.random.randint`` from the JAX key): the
batch grids and masks must be identical.

(c) Two uniform FedOpt rounds, set up as (a): server Adam on the fused arm
and on the unfused (optax) arm, and server SGD with momentum 0.9 on the
fused arm from a non-zero momentum carried over from the JAX state.
BatchNorm statistics take the plain weighted mean and are held at FedAvg's
1e-3, and so is SGD with momentum, whose step is linear in the
pseudo-gradient.  Adam is not: it divides the pseudo-gradient by its own
RMS, so every component moves by about ``server_lr`` whatever its size,
and one that lies below the two frameworks' float32 training noise
(FedAvg's parity: up to 8e-5) can flip sign and move the other way.  So
Adam's parameters are held to three things: every element within
``2·server_lr`` per round of the JAX package's (the most a flipped sign can
cost); the rounds' moves agreeing in sign on at least 99.5 % of the
elements (0.2 % flip on these inputs); and the moves differing by at most
10 % in L2 norm (the flipped elements make about 7 %).  The metrics at
``rtol = 1e-4``, as in (a).  The server state carried back (adam's ``m``,
``v`` or optax's ``mu``, ``nu``; the momentum ``m``) is held in L2 norm
relative to the JAX package's: within 10 % for Adam, whose second round
steps from globals the flipped signs moved, and 5 % for momentum.  An
elementwise bound would not do: the median |m| of Adam is about 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Config as JaxConfig
from fedml_tpu.data import data_loader as jax_loader
from fedml_tpu.ml.engine.model_bundle import ModelBundle as JaxBundle
from fedml_tpu.models.cv import CIFARResNet as JaxResNet
from fedml_tpu.simulation.parrot.parrot_api import ParrotAPI as JaxParrot
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.data import data_loader
from fedml_tpu_torch.ml.engine.model_bundle import ModelBundle
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.ops import epilogue
from fedml_tpu_torch.simulation.parrot.parrot_api import ParrotAPI
from fedml_tpu_torch.utils.weights import opt_state_from_jax, opt_state_to_jax

CPU = torch.device("cpu")


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
                epochs=1, batch_size=16, learning_rate=0.05,
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


def test_two_uniform_rounds_match_jax(tmp_path):
    jargs = _args(JaxConfig, tmp_path)
    japi = JaxParrot(jargs, None, jax_loader.load(jargs), _jax_bundle())
    init = jax.tree_util.tree_map(np.array, dict(japi.global_vars))
    japi.train()

    args = _args(Config, tmp_path)
    api = ParrotAPI(args, CPU, data_loader.load(args), _port_bundle(),
                    initial_variables=init)
    assert api.buckets is None
    api.train()

    got = _leaves(api.global_flax_variables())
    want = _leaves(dict(japi.global_vars))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, rtol=0,
                                   err_msg=k)
    assert len(api.metrics_history) == len(japi.metrics_history) == 2
    for mine, ref in zip(api.metrics_history, japi.metrics_history):
        assert mine["round"] == ref["round"]
        for k in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_allclose(mine[k], ref[k], rtol=1e-4,
                                       err_msg=k)
    # the variables moved, and every round trained real samples
    assert any(np.abs(got[k] - _leaves(init)[k]).max() > 0 for k in got)
    assert all(r["samples_trained"] > 0 for r in api.round_history)


def test_rotating_window_gather_matches_jax(tmp_path):
    kw = dict(client_num_in_total=12, client_num_per_round=3,
              data_scale=0.05, batch_size=8, hetero_buckets=3,
              hetero_bucket_cap=0.5)
    jargs = _args(JaxConfig, tmp_path, **kw)
    japi = JaxParrot(jargs, None, jax_loader.load(jargs), _jax_bundle())
    args = _args(Config, tmp_path, **kw)
    api = ParrotAPI(args, CPU, data_loader.load(args), _port_bundle())
    capped = [i for i, b in enumerate(api.buckets) if b["nb"] < b["nb_full"]]
    assert capped, "the config must cap at least one bucket"
    for i in capped:
        b = api.buckets[i]
        n = int(b["gids"].shape[0])
        rows = np.arange(n)
        key = jax.random.PRNGKey(7 + i)
        want = japi._gather_batches_windowed(
            japi.device_data, jnp.asarray(rows), japi.device_data["bidx"][i],
            japi.device_data["bsizes"][i], b["nb"], key)
        # the draw inside _gather_batches_windowed, before its % n_i
        start = jax.random.randint(key, (n, 1), 0, jnp.int32(1 << 30),
                                   dtype=jnp.int32)
        got = api._gather_batches_windowed(
            api.device_data, torch.from_numpy(rows), b["idx"], b["sizes"],
            b["nb"], torch.from_numpy(np.array(start)))
        for k in ("x", "y", "mask"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(
            got["valid"].numpy(), np.asarray(want["mask"]).any(axis=2))


def test_bucketed_round_reduces_once_per_dtype(tmp_path, monkeypatch):
    """The bucketed round trains q clients per stratum into the stacked
    buffers and aggregates them with one reduce per dtype group."""
    args = _args(Config, tmp_path, client_num_in_total=12,
                 client_num_per_round=3, data_scale=0.05, batch_size=8,
                 hetero_buckets=3, hetero_bucket_cap=0.8, comm_round=2)
    api = ParrotAPI(args, CPU, data_loader.load(args), _port_bundle())
    calls = []
    real = epilogue.weighted_reduce_reference

    def spy(stacked, weights):
        calls.append((tuple(stacked.shape), weights.clone()))
        return real(stacked, weights)

    start = {dt: f.clone() for dt, f in api.global_vars.items()}
    monkeypatch.setattr(epilogue, "weighted_reduce_reference", spy)
    api.train()
    d = api.vars.flat[torch.float32].numel()
    assert [c[0] for c in calls] == [(3, d), (3, d)]
    sizes = api.n_samples
    for _, w in calls:   # full sample counts of the sampled clients
        assert all(float(x) in set(sizes.tolist()) for x in w)
    assert not torch.equal(api.global_vars[torch.float32],
                           start[torch.float32])
    assert np.isfinite([r["train_loss"] for r in api.round_history]).all()


def _moves(got, want, init, coll):
    """How far each element of collection ``coll`` moved from ``init``,
    in the port's run and in the JAX package's."""
    keys = [k for k in want if k.startswith(f"['{coll}']")]

    def cat(t):
        return np.concatenate([t[k].ravel() for k in keys])

    return cat(got) - cat(init), cat(want) - cat(init)


FEDOPT_ARMS = {
    "adam_fused": dict(server_optimizer="adam"),
    "adam_optax": dict(server_optimizer="adam", fused_epilogue=False),
    "momentum_fused": dict(server_optimizer="sgd", server_lr=0.5,
                           server_momentum=0.9),
}


#: the carried-back moments' L2 distance from the JAX package's, relative to
#: the JAX package's norm (on these inputs: adam m 3.3 %, v 1.0 %; momentum
#: m 0.8 %); a moment lost or never written back is off by about 100 %
STATE_RTOL = {"adam_fused": 0.1, "adam_optax": 0.1, "momentum_fused": 0.05}


@pytest.mark.parametrize("arm", sorted(FEDOPT_ARMS))
def test_two_fedopt_rounds_match_jax(arm, tmp_path):
    kw = dict(FEDOPT_ARMS[arm], federated_optimizer="FedOpt")
    jargs = _args(JaxConfig, tmp_path, **kw)
    japi = JaxParrot(jargs, None, jax_loader.load(jargs), _jax_bundle())
    init = jax.tree_util.tree_map(np.array, dict(japi.global_vars))
    if arm == "momentum_fused":
        rng = np.random.default_rng(5)
        japi.server_state["opt_state"] = {"m": jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape) * 1e-3,
                                  jnp.float32), init["params"])}
    start_state = jax.tree_util.tree_map(
        np.array, japi.server_state["opt_state"])
    japi.train()

    args = _args(Config, tmp_path, **kw)
    api = ParrotAPI(args, CPU, data_loader.load(args), _port_bundle(),
                    initial_variables=init)
    api.server_state["opt_state"] = opt_state_from_jax(start_state, api.vars)
    api.train()

    got = _leaves(api.global_flax_variables())
    want = _leaves(dict(japi.global_vars))
    assert got.keys() == want.keys()
    p_got, p_want = _moves(got, want, _leaves(init), "params")
    s_got, s_want = _moves(got, want, _leaves(init), "batch_stats")
    np.testing.assert_allclose(s_got, s_want, atol=1e-3, rtol=0)
    if arm == "momentum_fused":
        np.testing.assert_allclose(p_got, p_want, atol=1e-3, rtol=0)
    else:
        lr, rounds = float(args.server_lr), int(args.comm_round)
        np.testing.assert_allclose(p_got, p_want, atol=2 * lr * rounds,
                                   rtol=0)
        assert np.mean(np.sign(p_got) == np.sign(p_want)) >= 0.995
        assert (np.linalg.norm(p_got - p_want)
                <= 0.1 * np.linalg.norm(p_want))
    assert np.abs(p_want).max() > 0
    for mine, ref in zip(api.metrics_history, japi.metrics_history):
        for k in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_allclose(mine[k], ref[k], rtol=1e-4,
                                       err_msg=k)

    # the server state: fused {m, v, t} or optax's fields, carried back
    mine = opt_state_to_jax(api.server_state["opt_state"], api.vars)
    ref = japi.server_state["opt_state"]
    if not isinstance(ref, dict):
        fields = {}
        for part in ref:
            fields.update(part._asdict())
        ref = fields
    assert set(mine) == set(ref)
    for k in ("t", "count"):
        if k in ref:
            assert int(mine[k]) == int(ref[k]) == 2
    moments = sorted(set(ref) - {"t", "count"})
    assert moments
    for k in moments:
        a, b = (np.concatenate([v.ravel() for v in _leaves(t).values()])
                for t in (mine[k], ref[k]))
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= STATE_RTOL[arm], (k, rel)


@pytest.mark.parametrize("bad", [dict(federated_optimizer="FedProx"),
                                 dict(robust_agg="median"),
                                 dict(federated_optimizer="FedNova")])
def test_unported_options_raise(bad, tmp_path):
    args = _args(Config, tmp_path, **bad)
    with pytest.raises(NotImplementedError):
        ParrotAPI(args, CPU, data_loader.load(args), _port_bundle())


def test_five_step_entry_runs_on_the_cpu_when_asked(tmp_path):
    import fedml_tpu_torch

    args = fedml_tpu_torch.init(_args(
        Config, tmp_path, model="resnet20", comm_round=1,
        hetero_buckets=2, hetero_bucket_cap=0.8))
    device = fedml_tpu_torch.device.get_device(args)
    assert device == CPU
    dataset = fedml_tpu_torch.data.load(args)
    bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    out = fedml_tpu_torch.FedMLRunner(args, device, dataset, bundle).run()
    assert 0.0 <= out["test_acc"] <= 1.0 and np.isfinite(out["test_loss"])


def test_the_card_is_never_replaced_by_the_cpu(tmp_path):
    import fedml_tpu_torch

    for want in (None, "cuda", "gpu"):
        args = _args(Config, tmp_path, device_type=want)
        if torch.cuda.is_available():
            assert fedml_tpu_torch.device.get_device(args).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="is_available"):
                fedml_tpu_torch.device.get_device(args)
    with pytest.raises(ValueError, match="tpu"):
        fedml_tpu_torch.device.get_device(_args(Config, tmp_path,
                                                device_type="tpu"))


@pytest.mark.parametrize("kw", [dict(backend="sp"), dict(backend="mesh"),
                                dict(training_type="cross_silo")])
def test_runner_names_what_is_not_ported(kw, tmp_path):
    import fedml_tpu_torch

    args = _args(Config, tmp_path, **kw)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        fedml_tpu_torch.FedMLRunner(args, CPU, data_loader.load(args),
                                    _port_bundle())


# ------------------------------------------- config 3: BERT-tiny, Shakespeare
def _lm_args(cls, tmp_path, **kw):
    """BASELINE config 3 (``tests/test_baseline_configs.py:40-50``) at 4
    clients, 2 rounds, batch 8, data_scale 0.05: FedOpt, server adam at
    ``server_lr`` 0.1, lr 0.05, Dirichlet(0.5) by first token; float32
    compute so the two frameworks compare at float32 rounding."""
    base = dict(dataset="fed_shakespeare", model="bert_tiny",
                federated_optimizer="FedOpt", server_optimizer="adam",
                server_lr=0.1, learning_rate=0.05, client_num_in_total=4,
                client_num_per_round=4, comm_round=2, batch_size=8,
                data_scale=0.05)
    base.update(kw)
    return _args(cls, tmp_path, **base)


def test_config3_fedopt_bert_tiny_matches_jax(tmp_path):
    """Three rounds of Parrot FedOpt on ``TinyTransformerLM(dropout=0.0)``
    (swapped in on both sides: the two frameworks draw dropout from other
    bits) from the JAX package's initial variables and server state.
    Adam is held as in ``test_two_fedopt_rounds_match_jax``: every element
    within 2·server_lr per round, at least 99.5 % of the moves in the same
    sign (here 99.97 %), the moves within 10 % in L2 (here 0.014 %); the
    token metrics at ``rtol=1e-4``; the clients weighted by sequence
    count.  The third round is where server adam at 0.1 overshoots at this
    size: the training loss rises in both packages alike."""
    from fedml_tpu.models.nlp import TinyTransformerLM as JaxLM
    from fedml_tpu_torch.ml.engine.model_bundle import TASK_LM
    from fedml_tpu_torch.models.nlp import TinyTransformerLM

    jargs = _lm_args(JaxConfig, tmp_path, comm_round=3)
    japi = JaxParrot(jargs, None, jax_loader.load(jargs),
                     JaxBundle(JaxLM(dropout=0.0), (80,), 90, task="lm",
                               input_dtype=jnp.int32))
    init = jax.tree_util.tree_map(np.array, dict(japi.global_vars))
    start_state = jax.tree_util.tree_map(
        np.array, japi.server_state["opt_state"])
    japi.train()

    args = _lm_args(Config, tmp_path, comm_round=3)
    dataset = data_loader.load(args)
    api = ParrotAPI(args, CPU, dataset,
                    ModelBundle(TinyTransformerLM(dropout=0.0), (80,), 90,
                                task=TASK_LM, input_dtype=torch.int32),
                    initial_variables=init)
    api.server_state["opt_state"] = opt_state_from_jax(start_state, api.vars)
    assert api.device_data["x"].dtype == torch.int32
    api.train()

    # weights count sequences, metrics count tokens
    assert api.n_samples.tolist() == [float(dataset[4][c]) for c in range(4)]
    assert api.round_history[0]["samples_trained"] == 80 * dataset[0]
    got = _leaves(api.global_flax_variables())
    want = _leaves(dict(japi.global_vars))
    assert got.keys() == want.keys()
    p_got, p_want = _moves(got, want, _leaves(init), "params")
    lr, rounds = float(args.server_lr), int(args.comm_round)
    np.testing.assert_allclose(p_got, p_want, atol=2 * lr * rounds, rtol=0)
    assert np.mean(np.sign(p_got) == np.sign(p_want)) >= 0.995
    assert np.linalg.norm(p_got - p_want) <= 0.1 * np.linalg.norm(p_want)
    assert len(api.metrics_history) == len(japi.metrics_history) == 3
    for mine, ref in zip(api.metrics_history, japi.metrics_history):
        for k in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_allclose(mine[k], ref[k], rtol=1e-4,
                                       err_msg=k)
    assert int(api.server_state["opt_state"][torch.float32]["t"]) == 3


def test_config3_at_dropout_01_trains(tmp_path):
    """The config's own model (dropout 0.1, bfloat16 compute, built by the
    model hub) through the five-step entry: the training loss falls from
    round 0 to round 1, the token accuracy lies in [0, 1], and there are no
    BatchNorm columns, so the FedOpt server step is the fused adam launch
    alone.  (A third round overshoots, in both packages: see
    ``test_config3_fedopt_bert_tiny_matches_jax``.)"""
    import fedml_tpu_torch

    args = fedml_tpu_torch.init(_lm_args(Config, tmp_path,
                                         compute_dtype="bfloat16"))
    dataset = fedml_tpu_torch.data.load(args)
    bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    assert bundle.module.dropout == 0.1
    runner = fedml_tpu_torch.FedMLRunner(args, CPU, dataset, bundle)
    out = runner.run()
    losses = [r["train_loss"] for r in runner.runner.round_history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert 0.0 <= out["test_acc"] <= 1.0 and np.isfinite(out["test_loss"])
    vars_ = runner.runner.vars
    assert vars_.stats_range(torch.float32).start == \
        vars_.stats_range(torch.float32).stop
