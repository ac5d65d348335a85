"""The port's LLM trainer (``fedml_tpu_torch/train/llm/trainer.py``) and its
optimizer pieces (``ml/engine/optimizers.py``) against the JAX package's.

* ``pack_sequences`` equal to JAX's.
* ``make_lr`` against optax's schedules (the JAX package's ``make_lr``) at a
  grid of steps, ``rtol=1e-6``: both evaluate in float32, and numpy's and
  XLA's ``cos`` may differ by an ulp.
* One to three steps of the clip → adamw chain (and of MultiSteps over it)
  against optax on the same gradients, ``atol=1e-7, rtol=1e-6``: the same
  float32 operations in the same order; the global norm sums the leaves in
  another order, and XLA's ``sqrt`` and ``pow`` may differ by an ulp.
* ``LLMTrainer.train`` on the full-width ``TinyTransformerLM`` at dropout 0
  in float32, from the JAX trainer's base variables and adapters carried
  across, 2 epochs of 5 batches of 4 × 32 tokens: adapters within
  ``atol=2e-5`` (measured 3e-6: the forward and backward sum in another
  order, and adam carries that over 10 steps; every move the same sign)
  and the loss history within ``rtol=1e-5``; with gradient accumulation
  and the cosine schedule as well; greedy ``generate`` the same tokens;
  full-parameter training (``use_lora: false``) at adam's tolerance.
* The JAX suite's own learning checks (``tests/test_llm.py``), on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.ml.engine import optimizers as jopt
from fedml_tpu.ml.engine.model_bundle import ModelBundle as JaxBundle
from fedml_tpu.models.nlp import TinyTransformerLM as JaxLM
from fedml_tpu.train.llm import trainer as jtrainer
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.ml.engine import optimizers as opt
from fedml_tpu_torch.ml.engine.model_bundle import TASK_LM, ModelBundle
from fedml_tpu_torch.models import model_hub
from fedml_tpu_torch.models.nlp import TinyTransformerLM
from fedml_tpu_torch.train.llm import trainer as ptrainer
from fedml_tpu_torch.train.llm.trainer import LLMTrainConfig, LLMTrainer

CPU = torch.device("cpu")
OPT_TOL = dict(atol=1e-7, rtol=1e-6)
TRAIN_KW = dict(seq_len=32, batch_size=4, epochs=2, learning_rate=3e-3,
                lora_rank=4)
ACCUM_KW = dict(grad_accum_steps=2, lr_schedule="cosine", warmup_steps=3,
                lr_decay_steps=20)


class NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("n", [129, 1000, 32 * 4 * 5 + 1, 4097])
def test_pack_sequences_matches_jax(n):
    stream = np.random.RandomState(n).randint(0, 90, size=n)
    got = ptrainer.pack_sequences(stream, 32, 4)
    want = jtrainer.pack_sequences(stream, 32, 4)
    for k in ("x", "y", "mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["x"].shape[1:] == (4, 32)
    np.testing.assert_array_equal(got["y"][0, 0, :-1], got["x"][0, 0, 1:])
    assert ptrainer.format_prompt("a", "b") == jtrainer.format_prompt("a",
                                                                      "b")


SCHEDULES = [
    dict(lr_schedule="cosine", warmup_steps=10, lr_decay_steps=100),
    dict(lr_schedule="cosine", warmup_steps=0, lr_decay_steps=50),
    dict(lr_schedule="cosine", warmup_steps=30, lr_decay_steps=20),
    dict(lr_schedule="linear", warmup_steps=4, lr_decay_steps=20),
    dict(lr_schedule="linear", warmup_steps=0, lr_decay_steps=40),
]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=[f"{k['lr_schedule']}_w{k['warmup_steps']}_d"
                              f"{k['lr_decay_steps']}" for k in SCHEDULES])
def test_make_lr_matches_optax_schedules(kw):
    cfg = NS(learning_rate=0.1, **kw)
    got, want = opt.make_lr(cfg), jopt.make_lr(cfg)
    steps = list(range(0, 130, 3)) + [4, 10, 20, 30, 31, 100, 1000]
    g = np.array([got(s) for s in steps], np.float32)
    w = np.array([float(want(jnp.int32(s))) for s in steps], np.float32)
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9)


def test_make_lr_constant_and_unknown():
    assert opt.make_lr(NS(learning_rate=0.1)) == 0.1 == jopt.make_lr(
        NS(learning_rate=0.1))
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        opt.make_lr(NS(learning_rate=0.1, lr_schedule="nope"))


def _leaves(seed, scale):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in ((128, 4), (4, 90), (7,))]


@pytest.mark.parametrize("accum,sched", [(1, "constant"), (1, "linear"),
                                         (2, "cosine"), (3, "constant")])
@pytest.mark.parametrize("gscale", [0.01, 3.0], ids=["kept", "clipped"])
def test_clip_adamw_steps_match_optax(accum, sched, gscale):
    """``clip_by_global_norm(1.0)`` → ``adamw(lr)`` (in ``MultiSteps`` when
    ``accum`` > 1) over 2·accum steps; ``gscale`` 3.0 puts the global norm
    above 1, so the clip acts."""
    cfg = NS(learning_rate=3e-3, lr_schedule=sched, warmup_steps=1,
             lr_decay_steps=10)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(jopt.make_lr(cfg)))
    if accum > 1:
        tx = optax.MultiSteps(tx, accum)
    params0 = _leaves(0, 0.02)
    jp = [jnp.asarray(p) for p in params0]
    state = tx.init(jp)
    mine = opt.LLMOptimizer(opt.make_lr(cfg), grad_clip=1.0,
                            accum_steps=accum)
    pp = [torch.from_numpy(p.copy()) for p in params0]
    pstate = mine.init(pp)
    for step in range(2 * accum):
        grads = _leaves(10 + step, gscale)
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        mine.step(pp, [torch.from_numpy(g) for g in grads], pstate)
        for g, w in zip(pp, jp):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPT_TOL)
    assert pstate["count"] == 2


def test_clip_by_global_norm_matches_optax():
    for scale in (0.01, 3.0):
        grads = _leaves(4, scale)
        want, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        got = opt.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                      1.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPT_TOL)


def _pair(**extra):
    """The JAX trainer on a dropout-0 float32 full-width TinyTransformerLM,
    and the port's trainer from its base variables and adapters."""
    cfg = dict(TRAIN_KW, **extra)
    jb = JaxBundle(JaxLM(dropout=0.0, dtype=jnp.float32), (80,), 90,
                   task="lm", input_dtype=jnp.int32)
    jt = jtrainer.LLMTrainer(jb, jtrainer.LLMTrainConfig(**cfg),
                             rng=jax.random.PRNGKey(0))
    pb = ModelBundle(TinyTransformerLM(dropout=0.0), (80,), 90, task=TASK_LM,
                     input_dtype=torch.int32)
    pt = LLMTrainer(pb, LLMTrainConfig(**cfg), device=CPU,
                    variables=jax.tree_util.tree_map(np.asarray,
                                                     jt.variables),
                    adapters=jax.tree_util.tree_map(np.asarray, jt.lora))
    return jt, pt


@pytest.mark.parametrize("extra", [{}, ACCUM_KW], ids=["adamw", "accum_cosine"])
def test_train_matches_jax_at_dropout_0(extra):
    jt, pt = _pair(**extra)
    start = {p: {k: v.clone() for k, v in ab.items()}
             for p, ab in pt.lora.items()}
    tokens = np.random.RandomState(0).randint(0, 90, size=32 * 4 * 5 + 1)
    want = jt.train(tokens)
    got = pt.train(tokens)
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=1e-5)
    assert len(got["loss_history"]) == 2
    for p in jt.lora:
        for k in ("a", "b"):
            g = pt.lora[p][k].numpy()
            w = np.asarray(jt.lora[p][k])
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0,
                                       err_msg=f"{p}/{k}")
            moved = g - start[p][k].numpy()
            assert np.all(np.sign(moved) == np.sign(w - start[p][k].numpy()))
    # greedy decoding picks the same tokens from the same merged model
    np.testing.assert_array_equal(pt.generate(tokens[:10], max_new=6),
                                  jt.generate(tokens[:10], max_new=6))


def test_full_parameter_training_matches_jax():
    """``use_lora: false`` trains every parameter with the same chain.
    Adam moves each element by about lr a step whatever its gradient's
    size, so elements whose gradient sits at float32 summation noise can
    move another way: every element within 2·lr·steps, at least 99.9 %
    within 1e-5 (measured 99.95 % over 485,466), the loss at
    ``rtol=1e-5``."""
    kw = dict(seq_len=32, batch_size=4, epochs=1, learning_rate=3e-3,
              use_lora=False)
    jb = JaxBundle(JaxLM(dropout=0.0, dtype=jnp.float32), (80,), 90,
                   task="lm", input_dtype=jnp.int32)
    jt = jtrainer.LLMTrainer(jb, jtrainer.LLMTrainConfig(**kw),
                             rng=jax.random.PRNGKey(0))
    pb = ModelBundle(TinyTransformerLM(dropout=0.0), (80,), 90, task=TASK_LM,
                     input_dtype=torch.int32)
    pt = LLMTrainer(pb, LLMTrainConfig(**kw), device=CPU,
                    variables=jax.tree_util.tree_map(np.asarray,
                                                     jt.variables))
    assert pt.lora == {}
    tokens = np.random.RandomState(0).randint(0, 90, size=32 * 4 * 3 + 1)
    want, got = jt.train(tokens), pt.train(tokens)
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=1e-5)
    from fedml_tpu_torch.train.llm.lora import leaves_with_path

    ref = {tuple(k.key for k in p): np.asarray(v) for p, v in
           jax.tree_util.tree_leaves_with_path(jt.variables["params"])}
    diffs = np.concatenate([np.abs(v.numpy() - ref[p]).ravel() for p, v in
                            leaves_with_path(pt.variables["params"])])
    assert diffs.size == sum(v.size for v in ref.values())
    assert diffs.max() <= 2 * 3e-3 * 3
    assert np.mean(diffs <= 1e-5) >= 0.999


def _hub_bundle():
    return model_hub.create(Config(model="transformer", dataset="shakespeare",
                                   compute_dtype="float32"), 90)


def test_sft_lora_reduces_loss_and_generates():
    """``tests/test_llm.py::test_sft_lora_reduces_loss`` on the port: the
    config's own model (dropout 0.1), 3 epochs, then greedy generation of
    5 tokens after a 10-token prompt."""
    from fedml_tpu_torch.data.datasets import shakespeare_sequences

    xt, _, _, _ = shakespeare_sequences(seq_len=64, n_train=64, n_test=8)
    stream = np.concatenate([x for x in xt])
    trainer = LLMTrainer(_hub_bundle(), LLMTrainConfig(
        seq_len=32, batch_size=4, epochs=3, learning_rate=3e-3, lora_rank=4),
        device=CPU)
    out = trainer.train(stream)
    assert out["loss_history"][-1] < out["loss_history"][0]
    gen = trainer.generate(stream[:10], max_new=5)
    assert len(gen) == 15
    sampled = trainer.generate(stream[:10], max_new=5, temperature=0.8)
    assert len(sampled) == 15 and all(0 <= t < 90 for t in sampled)


def test_grad_accum_and_cosine_schedule_learn():
    """``tests/test_llm.py::test_llm_trainer_grad_accum_and_cosine_schedule``
    on the port: accumulation over 2 batches and the cosine schedule run end
    to end and learn."""
    tokens = np.random.RandomState(0).randint(0, 90, size=6000)
    cfg = LLMTrainConfig(seq_len=32, batch_size=4, epochs=3,
                         learning_rate=3e-3, lora_rank=4, grad_accum_steps=2,
                         lr_schedule="cosine", warmup_steps=5,
                         lr_decay_steps=60)
    out = LLMTrainer(_hub_bundle(), cfg, device=CPU).train(tokens)
    assert out["loss_history"][-1] < out["loss_history"][0]


@pytest.mark.parametrize("kw,item", [
    (dict(strategy="dp"), "A16"), (dict(strategy="fsdp"), "A16"),
    (dict(pretrained_path="model.npz"), "A15"),
    (dict(checkpoint_dir="ckpt"), "A11")])
def test_unported_options_raise_naming_their_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        LLMTrainer(_hub_bundle(), LLMTrainConfig(**kw), device=CPU)


def test_unknown_strategy_and_task_raise():
    with pytest.raises(ValueError, match="unknown llm strategy"):
        LLMTrainer(_hub_bundle(), LLMTrainConfig(strategy="tp"), device=CPU)
    lr = model_hub.create(Config(model="lr", dataset="synthetic"), 10)
    with pytest.raises(ValueError, match="language-model"):
        LLMTrainer(lr, LLMTrainConfig(), device=CPU)


def test_the_trainer_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert LLMTrainer(_hub_bundle(), LLMTrainConfig()).device.type == \
            "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        LLMTrainer(_hub_bundle(), LLMTrainConfig())
