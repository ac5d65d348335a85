"""The port's cross-silo plane against the JAX package's.

Both packages run synchronous FedAvg over INPROC through their public
entry (``FedMLRunner(args, device, dataset, bundle).run()``) on the CPU,
at the JAX tests' own cross-silo size (``tests/test_cross_silo.py``:
logistic regression on ``synthetic``, 3 silos, 3 rounds, ``data_scale``
0.3), from the same initial variables (JAX's initialisation, carried into
the port's model by ``utils/weights.py``), once with raw uploads and once
with the int8 wire codec.

Tolerances: the final global variables at ``atol=1e-6`` — the two
frameworks sum the logistic regression's matmul and the aggregation in
another order, which moves float32 results by ulps (6e-8 measured); the
int8 codec quantizes the same values on both sides, and one step of its
quantization (about 1e-3 here) would exceed the tolerance.  ``test_loss``
at ``rtol=1e-6``; ``test_acc`` within one of its 150 test samples, where
two logits could sit within float32 rounding of each other.  Wire bytes
are counted the same way in both packages and must be equal.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.ml.aggregator.agg_operator import FedMLAggOperator as JaxAgg
from fedml_tpu.ml.trainer.default_trainer import DefaultServerAggregator
from fedml_tpu.runner import FedMLRunner as JaxRunner
from fedml_tpu.utils import compression as jax_comp
from fedml_tpu_torch.ml.aggregator.agg_operator import (
    FedMLAggOperator,
    weighted_average,
)
from fedml_tpu_torch.ops import epilogue
from fedml_tpu_torch.utils.compression import WIRE_BYTES, WireCodec
from fedml_tpu_torch.utils.serialization import estimate_nbytes
from fedml_tpu_torch.utils.tree import tree_leaves
from fedml_tpu_torch.utils.weights import from_flax_variables

CPU = torch.device("cpu")
COMMON = dict(dataset="synthetic", model="lr", client_num_in_total=3,
              client_num_per_round=3, comm_round=3, epochs=1, batch_size=16,
              learning_rate=0.1, frequency_of_the_test=1, data_scale=0.3,
              enable_tracking=False, compute_dtype="float32",
              training_type="cross_silo", backend="INPROC", role="simulated")


def _jax_run(run_id, **kw):
    """The JAX package's run, from ``PRNGKey(0)`` variables (what its
    ``init_server`` draws); the final global model and metrics."""
    args = fedml_tpu.init(fedml_tpu.Config(**COMMON, run_id=run_id, **kw))
    dataset = fedml_tpu.data.load(args)
    bundle = fedml_tpu.model.create(args, dataset[-1])
    init = bundle.init_variables(jax.random.PRNGKey(0))
    agg = DefaultServerAggregator(bundle, args)
    agg.set_model_params(init)
    metrics = JaxRunner(args, None, dataset, bundle,
                        server_aggregator=agg).run()
    return init, agg.get_model_params(), metrics


def _port_run(run_id, init=None, **kw):
    """The port's run through its five-step entry on the CPU, from ``init``
    (a JAX variables tree) when given."""
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
        **dict(COMMON, run_id=run_id, device_type="cpu", **kw)))
    device = fedml_tpu_torch.device.get_device(args)
    dataset = fedml_tpu_torch.data.load(args)
    bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    if init is not None:
        from_flax_variables(jax.tree_util.tree_map(np.asarray, init),
                            bundle.module)
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, bundle)
    metrics = runner.run()
    return runner.runner.server, metrics


@pytest.fixture(scope="module")
def runs():
    """Both packages, raw and int8: {codec: (jax final, jax metrics, port
    server, port metrics, jax run id, port run id)}."""
    out = {}
    for codec, wire in (("raw", None), ("int8", "int8")):
        jid, pid = f"tcs_jax_{codec}", f"tcs_port_{codec}"
        init, j_final, j_metrics = _jax_run(jid, wire_compression=wire)
        server, p_metrics = _port_run(pid, init, wire_compression=wire)
        out[codec] = (j_final, j_metrics, server, p_metrics, jid, pid)
    return out


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_cross_silo_run_matches_jax(codec, runs):
    j_final, j_metrics, server, p_metrics, _, _ = runs[codec]
    p_final = server.aggregator.get_global_model_params()
    want = jax.tree_util.tree_leaves(j_final)
    got = tree_leaves(p_final)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    assert [h["round"] for h in server.round_history] == [0, 1, 2]
    assert np.isfinite(p_metrics["test_loss"])
    np.testing.assert_allclose(p_metrics["test_loss"],
                               j_metrics["test_loss"], rtol=1e-6)
    assert p_metrics["test_total"] == j_metrics["test_total"]
    assert abs(p_metrics["test_acc"] - j_metrics["test_acc"]) \
        <= 1.0 / p_metrics["test_total"] + 1e-12
    assert p_metrics["test_acc"] > 0.2


def test_int8_uplink_is_over_3x_smaller_and_bytes_match_jax(runs):
    counts = {}
    for codec in ("raw", "int8"):
        *_, jid, pid = runs[codec]
        for direction in ("up", "down"):
            got = WIRE_BYTES.value(pid, direction, codec)
            want = jax_comp.WIRE_BYTES.labels(
                run_id=jid, direction=direction, codec=codec).value
            assert got > 0 and got == want, (codec, direction, got, want)
            counts[codec, direction] = got
    # 9 uploads each: an int8 payload is about 1/4 of float32, plus scales
    assert counts["raw", "up"] / counts["int8", "up"] > 3.0, counts


# (config override, the port item its NotImplementedError names)
UNPORTED = [
    (dict(backend="GRPC"), "A11"),
    (dict(backend="MQTT_S3"), "A11"),
    (dict(reliable=True), "A11"),
    (dict(async_agg=True), "A11"),
    (dict(hier_regions=2), "A11"),
    (dict(scenario="hierarchical"), "A11"),
    (dict(round_timeout_s=5.0), "A11"),
    (dict(round_deadline_s=5.0), "A11"),
    (dict(heartbeat_interval_s=0.2), "A11"),
    (dict(over_provision=1), "A11"),
    (dict(checkpoint_dir="ckpt"), "A11"),
    (dict(resume_from="latest"), "A11"),
    (dict(drain_file="drain"), "A11"),
    (dict(resize_file="resize"), "A11"),
    (dict(admission_control=True), "A11"),
    (dict(enable_compression=True), "A11"),
    (dict(robust_agg="median"), "A9"),
    (dict(federated_optimizer="SCAFFOLD"), "A9"),
    (dict(federated_optimizer="FedOpt"), "A9"),
    (dict(federated_optimizer="SA"), "A13"),
    (dict(federated_optimizer="LSA"), "A13"),
    (dict(enable_dp=True), "A13"),
    (dict(enable_fhe=True), "A13"),
    (dict(enable_attack=True), "A13"),
    (dict(enable_defense=True), "A13"),
    (dict(enable_contribution=True), "A13"),
    # the fed-LLM plane itself is ported (tests/test_torch_fed_llm.py);
    # its functional-LM model is A15's remainder
    (dict(fed_llm=True, model="functional_lm"), "A15"),
    (dict(flight_recorder=True), "A18"),
    (dict(run_ledger=True), "A18"),
    (dict(slo_rules="slo.yaml"), "A18"),
]


@pytest.mark.parametrize("override,item", UNPORTED,
                         ids=[next(iter(o)) + "=" + str(next(iter(o.values())))
                              for o, _ in UNPORTED])
def test_unported_options_raise_naming_their_port_item(override, item):
    with pytest.raises(NotImplementedError, match=item):
        _port_run(f"tcs_unported_{next(iter(override))}", **override)


def test_the_entry_runs_on_the_card_unless_asked_for_the_cpu():
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
        **dict(COMMON, run_id="tcs_card", comm_round=1)))
    dataset = fedml_tpu_torch.data.load(args)
    bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    if torch.cuda.is_available():
        assert fedml_tpu_torch.device.get_device(args).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        fedml_tpu_torch.device.get_device(args)
    # a runner given no device picks the card, and so raises here too
    with pytest.raises(RuntimeError, match="is_available"):
        fedml_tpu_torch.FedMLRunner(args, None, dataset, bundle).run()


def test_silo_threads_share_the_bundle_without_lost_updates():
    """More silos than cores, on threads switching every 10 µs: the byte
    count of every upload adds up, and no silo's training bleeds into
    another's through the shared module — the run is bit for bit the same
    twice, since aggregation goes in index order whatever the threads'
    interleaving."""
    n = (os.cpu_count() or 4) + 4
    kw = dict(client_num_in_total=n, client_num_per_round=n, comm_round=2,
              wire_compression="int8")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        finals = []
        for i in range(2):
            server, metrics = _port_run(f"tcs_threads_{i}", **kw)
            final = server.aggregator.get_global_model_params()
            finals.append(tree_leaves(final))
            one = estimate_nbytes(WireCodec("int8").encode_delta(final,
                                                                 final))
            assert WIRE_BYTES.value(f"tcs_threads_{i}", "up", "int8") \
                == 2 * n * one
            assert np.isfinite(metrics["test_loss"])
    finally:
        sys.setswitchinterval(old)
    for a, b in zip(*finals):
        assert torch.equal(a, b)


# ------------------------------------------------------------- aggregation
def _pairs(seed, c=4, zero=False):
    rng = np.random.default_rng(seed)
    ns = [0.0] * c if zero else [float(n) for n in rng.integers(5, 60, c)]
    return [(n, {"params": {"Dense_0": {
        "kernel": rng.standard_normal((60, 10)).astype(np.float32),
        "bias": rng.standard_normal(10).astype(np.float32)}}})
        for n in ns]


def _torch_pairs(pairs):
    return [(n, jax.tree_util.tree_map(torch.from_numpy, t))
            for n, t in pairs]


@pytest.mark.parametrize("zero", [False, True], ids=["weighted", "zero_total"])
@pytest.mark.parametrize("fused", [True, False], ids=["stacked", "leafwise"])
def test_fedavg_aggregation_matches_jax(fused, zero):
    """Both arms of ``_reduce`` (stacked into ``[C, D]`` for one
    weighted-reduce launch, and ``weighted_average`` leaf by leaf) against
    the JAX package's funnel; a zero total takes uniform weights.  float32
    at ``atol=rtol=2e-6``: the same sums in another order."""
    pairs = _pairs(1, zero=zero)
    args = fedml_tpu_torch.Config(fused_epilogue=fused)
    jax_args = fedml_tpu.Config(fused_epilogue=fused)
    before = epilogue.LAUNCHES["weighted_reduce"]
    got = FedMLAggOperator.agg(args, _torch_pairs(pairs))
    want = JaxAgg.agg(jax_args, pairs)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=2e-6)
    if zero:
        mean = np.mean([p["params"]["Dense_0"]["bias"] for _, p in pairs],
                       axis=0)
        np.testing.assert_allclose(got["params"]["Dense_0"]["bias"].numpy(),
                                   mean, rtol=2e-6, atol=2e-6)
    # on CPU tensors the wrapper takes the plain version: no launch
    assert epilogue.LAUNCHES["weighted_reduce"] == before
    if not fused:
        plain = weighted_average(_torch_pairs(pairs))
        for g, w in zip(tree_leaves(plain), tree_leaves(got)):
            assert torch.equal(g, w)


def test_payloads_that_do_not_stack_go_leaf_by_leaf_on_the_cpu():
    """A payload whose kernel is int32 where the others' are float32 does
    not stack into one ``[C, D]`` buffer per dtype: on the CPU both
    packages take ``weighted_average`` leaf by leaf (on a card the port
    raises, ``tests/test_torch_cuda.py``).  float32 at ``atol=rtol=2e-6``."""
    pairs = _pairs(2)
    n, tree = pairs[2]
    dense = tree["params"]["Dense_0"]
    kernel = np.round(dense["kernel"] * 100).astype(np.int32)
    jax_pairs = pairs[:2] + [(n, {"params": {"Dense_0": {
        "kernel": kernel, "bias": dense["bias"]}}})] + pairs[3:]
    torch_pairs = _torch_pairs(jax_pairs)
    before = epilogue.LAUNCHES["weighted_reduce"]
    got = FedMLAggOperator.agg(fedml_tpu_torch.Config(), torch_pairs)
    want = JaxAgg.agg(fedml_tpu.Config(), jax_pairs)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=2e-6,
                                   atol=2e-6)
    for g, w in zip(tree_leaves(weighted_average(torch_pairs)),
                    tree_leaves(got)):
        assert torch.equal(g, w)
    assert epilogue.LAUNCHES["weighted_reduce"] == before
