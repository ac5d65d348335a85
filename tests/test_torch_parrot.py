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

CPU = torch.device("cpu")


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


@pytest.mark.parametrize("bad", [dict(federated_optimizer="FedOpt"),
                                 dict(robust_agg="median"),
                                 dict(fused_rounds=True)])
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
