"""The port's fed-LLM plane (``fedml_tpu_torch/train/fed_llm``) against the
JAX package's (``fedml_tpu/train/fed_llm``): cross-silo LoRA SFT over
INPROC where only adapter trees cross the wire.

Both packages run the JAX suite's fed-LLM setup (``tests/test_fed_llm.py``:
shakespeare, the full-width ``TinyTransformerLM``, 2 silos, LoRA rank 4,
``fed_llm_seq_len`` 32, batch 4, lr 3e-3) through their five-step entry on
the CPU, cut to 2 rounds at ``data_scale`` 0.1, at dropout 0 in float32
(the two frameworks draw dropout from other bits), from the JAX server's
base variables and initial adapters carried across (the base into the
port's module, the adapters through the trainers' ``init_lora``), with raw
uploads and with the int8 wire codec.

Tolerances: the final global adapters at ``atol=2e-5`` (two rounds of 24
adam steps per silo on float32 gradients summed in another order; measured
under 3e-6) and ``server_loss_history`` at ``rtol=1e-5``; the wire bytes,
counted the same way in both packages, equal.  With the int8 codec an
upload value that the two frameworks' training puts on either side of an
int8 rounding boundary decodes one int8 step apart (measured: 1 of 11,112),
so there every value within ``2e-5`` + one step of the largest upload
scale, and 99.9 % of them within ``2e-5``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.ml.engine.model_bundle import ModelBundle as JaxBundle
from fedml_tpu.models.nlp import TinyTransformerLM as JaxLM
from fedml_tpu.runner import FedMLRunner as JaxRunner
from fedml_tpu.train.fed_llm import FedLLMAggregator as JaxAggregator
from fedml_tpu.utils import compression as jax_comp
from fedml_tpu_torch.ml.engine.model_bundle import TASK_LM, ModelBundle
from fedml_tpu_torch.models.nlp import TinyTransformerLM
from fedml_tpu_torch.ops import epilogue
from fedml_tpu_torch.train import fed_llm
from fedml_tpu_torch.train.fed_llm import (
    FedLLMAggregator,
    FedLLMTrainer,
    parse_lora_targets,
    validate_fed_llm_args,
)
from fedml_tpu_torch.train.fed_llm.trainer import (
    FED_LLM_TOKENS,
    FED_LLM_TRAIN_SECONDS,
)
from fedml_tpu_torch.train.llm import trainer as llm_trainer
from fedml_tpu_torch.train.llm.lora import apply_lora
from fedml_tpu_torch.utils.compression import WIRE_BYTES
from fedml_tpu_torch.utils.serialization import estimate_nbytes
from fedml_tpu_torch.utils.tree import tree_leaves, tree_map
from fedml_tpu_torch.utils.weights import (
    adapters_from_jax,
    from_flax_variables,
    tree_from_module,
)

CPU = torch.device("cpu")
VOCAB = 90
ROUNDS = 2
COMMON = dict(
    dataset="shakespeare", model="transformer", training_type="cross_silo",
    backend="INPROC", role="simulated", client_num_in_total=2,
    client_num_per_round=2, comm_round=ROUNDS, epochs=1, batch_size=4,
    learning_rate=3e-3, data_scale=0.1, frequency_of_the_test=1,
    random_seed=0, fed_llm=True, lora_rank=4, fed_llm_seq_len=32,
    compute_dtype="float32", enable_tracking=False)


def _jax_run(run_id, wire):
    """The JAX package's federation on a dropout-0 float32 model: its final
    global adapters, metrics, and the server's base variables and initial
    adapters (what every JAX silo starts from)."""
    args = fedml_tpu.init(fedml_tpu.Config(**COMMON, run_id=run_id,
                                           wire_compression=wire))
    dataset = fedml_tpu.data.load(args)
    bundle = JaxBundle(JaxLM(dropout=0.0, dtype=jnp.float32), (80,), VOCAB,
                       task="lm", input_dtype=jnp.int32)
    agg = JaxAggregator(bundle, args)
    variables = jax.tree_util.tree_map(np.asarray, agg._ref.variables)
    adapters = jax.tree_util.tree_map(np.asarray, agg._ref.lora)
    metrics = JaxRunner(args, None, dataset, bundle,
                        server_aggregator=agg).run()
    final = jax.tree_util.tree_map(np.asarray, agg.get_model_params())
    return variables, adapters, final, metrics


def _port_bundle():
    return ModelBundle(TinyTransformerLM(dropout=0.0), (80,), VOCAB,
                       task=TASK_LM, input_dtype=torch.int32)


def _port_run(run_id, variables=None, adapters=None, bundle=None, **kw):
    """The port's federation through its five-step entry on the CPU; the
    server manager, the metrics and the bundle.  ``variables`` go into the
    module (the seeded base every trainer copies), ``adapters`` replace the
    trainers' seeded draw."""
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
        **dict(COMMON, run_id=run_id, device_type="cpu", **kw)))
    device = fedml_tpu_torch.device.get_device(args)
    dataset = fedml_tpu_torch.data.load(args)
    if bundle is None:
        bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    if variables is not None:
        from_flax_variables(variables, bundle.module)
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, bundle)
    if adapters is None:
        return runner.runner.server, runner.run(), bundle, runner
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(llm_trainer, "init_lora",
                   lambda params, **kw: adapters_from_jax(
                       adapters, kw.get("device")))
        metrics = runner.run()
    return runner.runner.server, metrics, bundle, runner


@pytest.fixture(scope="module")
def runs():
    """{codec: (jax final adapters, jax metrics, port server, port metrics,
    port bundle, jax run id, port run id)}."""
    out = {}
    for codec, wire in (("raw", None), ("int8", "int8")):
        jid, pid = f"tfl_jax_{codec}", f"tfl_port_{codec}"
        variables, adapters, j_final, j_metrics = _jax_run(jid, wire)
        _, p_metrics, bundle, runner = _port_run(
            pid, variables, adapters, bundle=_port_bundle(),
            wire_compression=wire)
        out[codec] = (j_final, j_metrics, runner.runner.server, p_metrics,
                      bundle, jid, pid)
    return out


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_federation_matches_jax(codec, runs):
    j_final, j_metrics, server, p_metrics, _, _, _ = runs[codec]
    got = server.aggregator.get_global_model_params()
    assert sorted(got) == sorted(j_final) and len(got) == 5
    step = 0.0
    if codec == "int8":
        # each decoded upload minus the round's reference is its int8
        # delta, whose largest value is 127 of its largest scale
        ref = tree_leaves(server._round_ref)
        step = max(float((u - r).abs().max()) for up in
                   server.aggregator.model_dict.values()
                   for u, r in zip(tree_leaves(up), ref)) / 127.0
    diffs = np.concatenate([np.abs(got[p][k].numpy() - j_final[p][k]).ravel()
                            for p in j_final for k in ("a", "b")])
    assert diffs.max() <= 2e-5 + step, (diffs.max(), step)
    assert np.mean(diffs <= 2e-5) >= (0.999 if codec == "int8" else 1.0)
    hist = p_metrics["server_loss_history"]
    assert len(hist) == ROUNDS
    np.testing.assert_allclose(hist, j_metrics["server_loss_history"],
                               rtol=1e-5)
    np.testing.assert_allclose(p_metrics["test_acc"], j_metrics["test_acc"],
                               atol=1.0 / p_metrics["test_total"] + 1e-12)
    assert p_metrics["adapter_params"] == j_metrics["adapter_params"] == 11112
    assert [h["round"] for h in server.round_history] == list(range(ROUNDS))
    # two rounds learn: the server's eval loss falls
    assert hist[-1] < hist[0]


def test_wire_bytes_match_jax_and_the_uplink_shrinks_over_20x(runs):
    """Every direction's adapter payload bytes equal the JAX package's, raw
    and int8; the raw uplink (adapter trees only) is over 20x smaller than
    the full model's variables, the JAX suite's floor."""
    for codec in ("raw", "int8"):
        *_, bundle, jid, pid = runs[codec]
        for direction in ("up", "down"):
            got = WIRE_BYTES.value(pid, direction, codec)
            want = jax_comp.WIRE_BYTES.labels(
                run_id=jid, direction=direction, codec=codec).value
            assert got > 0 and got == want, (codec, direction, got, want)
    bundle, pid = runs["raw"][4], runs["raw"][6]
    full = estimate_nbytes(tree_from_module(bundle.module))
    per_upload = WIRE_BYTES.value(pid, "up", "raw") / (2 * ROUNDS)
    assert full / per_upload >= 20.0, full / per_upload
    assert WIRE_BYTES.value(runs["int8"][6], "up", "int8") < \
        WIRE_BYTES.value(pid, "up", "raw")


def test_silo_counters_count_tokens_and_seconds(runs):
    """``FED_LLM_TOKENS``: each silo's packed tokens (whole batches of 4 ×
    32) once per round; ``FED_LLM_TRAIN_SECONDS`` positive."""
    server, pid = runs["raw"][2], runs["raw"][6]
    tokens = FED_LLM_TOKENS.for_run(pid)
    assert sorted(tokens) == ["0", "1"]
    for silo, n in tokens.items():
        assert n > 0 and n % (ROUNDS * 4 * 32) == 0
        assert FED_LLM_TRAIN_SECONDS.value(pid, silo) > 0
    assert sum(h["samples"] for h in server.round_history) > 0


def test_sync_round_is_the_central_adapter_average():
    """``tests/test_fed_llm.py``'s parity case in port form: one round ==
    averaging the silos' trained adapters centrally, weights 1 and 3, within
    1e-5; server and silo bases bit-identical; the cached merge is
    ``apply_lora(base, new)``."""
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
        **dict(COMMON, run_id="tfl_parity", device_type="cpu")))
    dataset = fedml_tpu_torch.data.load(args)
    bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    ag = FedLLMAggregator(bundle, args, CPU)
    gl = ag.get_model_params()
    tr = FedLLMTrainer(bundle, args, CPU)
    for a, b in zip(tree_leaves(ag.base_params()),
                    tree_leaves(tr.llm.variables["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(gl), tree_leaves(tr.get_model_params())):
        assert torch.equal(a, b)
    ups = []
    for cid in (0, 1):
        t = FedLLMTrainer(bundle, args, CPU)
        t.set_model_params(gl)
        assert all(x.data_ptr() != y.data_ptr() for x, y in
                   zip(tree_leaves(t.get_model_params()), tree_leaves(gl)))
        t.train(dataset[5][cid])
        ups.append(t.get_model_params())
    new = ag.aggregate([(1.0, ups[0]), (3.0, ups[1])])
    exp = tree_map(lambda g, a, b: g + (1.0 * (a - g) + 3.0 * (b - g)) / 4.0,
                   gl, ups[0], ups[1])
    for a, b in zip(tree_leaves(new), tree_leaves(exp)):
        assert float((a - b).abs().max()) < 1e-5
    # the global before the round is untouched, the new one another buffer
    assert tree_leaves(new)[0].untyped_storage().data_ptr() != \
        tree_leaves(gl)[0].untyped_storage().data_ptr()
    ag.set_model_params(new)
    merged = ag._merged_params()
    ref = apply_lora(ag.base_params(), new, ag.cfg.lora_alpha)
    for a, b in zip(tree_leaves(merged), tree_leaves(ref)):
        assert float((a - b).abs().max()) < 1e-5
    # a global set from elsewhere is re-merged through the fold at lr 0
    ag.set_model_params(tree_map(lambda t: t.clone(), new))
    remerged = ag._merged_params()
    for a, b in zip(tree_leaves(remerged), tree_leaves(ref)):
        assert torch.equal(a, b)
    # eval puts the seeded base back into the shared module
    before = tree_leaves(tree_from_module(bundle.module))
    m = ag.test(dataset[3])
    assert math.isfinite(m["test_loss"]) and m["adapter_params"] == 11112
    for a, b in zip(before, tree_leaves(tree_from_module(bundle.module))):
        assert torch.equal(a, b)


# -- start-up validation (the JAX suite's 7-case table) ---------------------
BAD = [{"lora_rank": 0}, {"lora_rank": "four"},
       {"lora_alpha": 0.0}, {"lora_alpha": -2.0},
       {"fed_llm_seq_len": 1},
       {"fed_llm_strategy": "tp"},
       {"lora_targets": "(unclosed"}]


@pytest.mark.parametrize("bad", BAD, ids=[next(iter(b)) + "=" +
                                          str(next(iter(b.values())))
                                          for b in BAD])
def test_bad_flags_fail_at_startup(bad):
    args = fedml_tpu_torch.Config(**dict(COMMON, **bad))
    with pytest.raises(ValueError):
        validate_fed_llm_args(args)
    with pytest.raises(ValueError):
        fedml_tpu_torch.init(args)
    # the JAX package refuses the same flags
    with pytest.raises(ValueError):
        fedml_tpu.train.fed_llm.validate_fed_llm_args(
            fedml_tpu.Config(**dict(COMMON, **bad)))


def test_lora_targets_parsing():
    assert parse_lora_targets(None) is None
    assert parse_lora_targets("") is None
    assert parse_lora_targets("  ,  ") is None
    assert parse_lora_targets("mlp, head$") == ("mlp", "head$")
    with pytest.raises(ValueError, match="malformed lora_targets"):
        parse_lora_targets("([bad")


def test_targets_that_match_nothing_raise():
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
        **dict(COMMON, lora_targets="nothing_here", device_type="cpu")))
    bundle = fedml_tpu_torch.model.create(args, VOCAB)
    with pytest.raises(ValueError, match="no LoRA targets"):
        FedLLMAggregator(bundle, args, CPU)


def test_silo_rejects_undersized_partition():
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
        **dict(COMMON, run_id="tfl_tiny", device_type="cpu")))
    tr = FedLLMTrainer(fedml_tpu_torch.model.create(args, VOCAB), args, CPU)
    x = np.zeros((1, 80), np.int64)  # 80 tokens < 32*4 + 1
    with pytest.raises(ValueError, match="too small"):
        tr.train((x, x))


# (config override, the port item its NotImplementedError names)
UNPORTED = [
    (dict(async_agg=True), "A11"),
    (dict(robust_agg="trimmed_mean:0.34"), "A9"),
    (dict(fed_llm_serve_eval=True), "A17"),
    (dict(fed_llm_strategy="dp"), "A16"),
    (dict(fed_llm_strategy="fsdp"), "A16"),
    (dict(model="functional_lm"), "A15"),
]


@pytest.mark.parametrize("override,item", UNPORTED,
                         ids=[next(iter(o)) + "=" + str(next(iter(o.values())))
                              for o, _ in UNPORTED])
def test_unported_options_raise_naming_their_item(override, item):
    with pytest.raises(NotImplementedError, match=item):
        _port_run(f"tfl_unported_{next(iter(override))}", **override)


def test_the_entry_runs_on_the_card_unless_asked_for_the_cpu():
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
        **dict(COMMON, run_id="tfl_card", comm_round=1)))
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
    # and so do the plane's own pieces built without one
    with pytest.raises(RuntimeError, match="is_available"):
        FedLLMTrainer(bundle, args)
    assert fed_llm.__all__ and epilogue.LAUNCHES["fold_delta"] == 0
