"""Parity of the port's transformer language model with the JAX package's.

The same tokens and the same variables (JAX's initialisation, carried
across by ``fedml_tpu_torch.utils.weights``) go through
``fedml_tpu.models.nlp.TinyTransformerLM`` and its port at dropout 0:
logits, the masked token loss and the parameter gradients must agree, on
the flash attention path (every pass at dropout 0) and, block by block, on
the flax attention path (``use_flash=False``).  At dropout 0.1 the two
frameworks draw different bits, so the masks are checked for their
structure and rate.

Tolerances: float32 at ``atol=rtol=1e-4`` (on logits and loss 2e-5 would
do; the gradients pass through two frameworks' softmax backwards, the
port's blockwise); bfloat16 at ``atol=rtol=0.05`` on logits and loss: both
round every projection to bfloat16 (relative step 2^-8 ≈ 0.004) but
accumulate in another order and round the tanh gelu at other places, so
one-step flips compound over the two blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from fedml_tpu.ml.engine.model_bundle import masked_loss as jax_masked_loss
from fedml_tpu.models import nlp as jnlp
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.ml.engine.model_bundle import TASK_LM, masked_loss
from fedml_tpu_torch.models import model_hub, nlp
from fedml_tpu_torch.utils.weights import from_flax_variables, to_flax_variables

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tokens(seed, b=4, t=80, n_pad=1):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 90, size=(b, t)).astype(np.int32)
    y = rng.randint(0, 90, size=(b, t)).astype(np.int64)
    mask = np.ones(b, np.float32)
    mask[b - n_pad:] = 0.0
    return x, y, mask


def _jax_lm(dt, seed=0, max_len=128, dropout=0.0):
    module = jnlp.TinyTransformerLM(dtype=DTYPES[dt][0], max_len=max_len,
                                    dropout=dropout)
    v = module.init({"params": jax.random.PRNGKey(seed)},
                    jnp.zeros((2, 80), jnp.int32))
    return module, jax.tree_util.tree_map(np.asarray, dict(v))


def _port_lm(dt, np_vars, max_len=128, dropout=0.0):
    model = nlp.TinyTransformerLM(dtype=DTYPES[dt][1], max_len=max_len,
                                  dropout=dropout)
    from_flax_variables(np_vars, model)
    return model


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lm_logits_loss_and_grads_match_flax(dt):
    module, np_vars = _jax_lm(dt)
    x, y, mask = _tokens(1)
    tol = F32_TOL if dt == "f32" else BF16_TOL

    def jloss(params):
        logits = module.apply({"params": params}, jnp.asarray(x), train=True)
        return jax_masked_loss("lm", logits, jnp.asarray(y),
                               jnp.asarray(mask)), logits

    (j_loss, j_logits), j_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(np_vars["params"])
    j_eval = module.apply(np_vars, jnp.asarray(x), train=False)

    model = _port_lm(dt, np_vars)
    xt = torch.from_numpy(x)
    p_eval = model(xt, train=False)
    logits = model(xt, train=True)
    assert logits.dtype == torch.float32 and logits.shape == (4, 80, 90)
    loss = masked_loss(TASK_LM, logits, torch.from_numpy(y),
                       torch.from_numpy(mask))
    np.testing.assert_allclose(p_eval.detach().numpy(), np.asarray(j_eval),
                               **tol)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               **tol)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **tol)
    if dt == "bf16":
        return
    grads = torch.autograd.grad(loss, list(model.parameters()))
    twin = nlp.TinyTransformerLM(max_len=128, dropout=0.0)
    with torch.no_grad():
        for p, g in zip(twin.parameters(), grads):
            p.copy_(g)
    got, want = _leaves(to_flax_variables(twin)["params"]), _leaves(j_grads)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("use_flash", [True, False])
def test_block_matches_flax_on_both_attention_paths(use_flash):
    """One ``TransformerBlock`` (dim 128, 2 heads, causal) in float32 at
    dropout 0, forward and input gradient, with flax's block switched the
    same way."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 80, 128).astype(np.float32)
    g = rng.randn(3, 80, 128).astype(np.float32)
    jblock = jnlp.TransformerBlock(128, 2, causal=True, dropout=0.0,
                                   use_flash=use_flash)
    v = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, dict(v))

    def fwd_bwd(a, ct):
        out, vjp = jax.vjp(lambda z: jblock.apply(v, z, train=True), a)
        return out, vjp(ct)[0]

    j_out, j_dx = jax.jit(fwd_bwd)(jnp.asarray(x), jnp.asarray(g))

    block = nlp.TransformerBlock(128, 2, causal=True, dropout=0.0,
                                 use_flash=use_flash)
    from_flax_variables(v, block)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = block(xt, train=True)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **F32_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(j_dx), **F32_TOL)


def test_the_two_attention_paths_agree():
    """The flash path masks with -1e30 and p = 0, the flax path with the
    dtype's minimum: the same softmax on the rows the causal mask allows."""
    _, np_vars = _jax_lm("f32", seed=4)
    model = _port_lm("f32", np_vars)
    x = torch.from_numpy(_tokens(4)[0])
    flash = model(x, train=False)
    for blk in model.blocks:
        blk.use_flash = False
    plain = model(x, train=False)
    np.testing.assert_allclose(plain.detach().numpy(),
                               flash.detach().numpy(), atol=2e-5, rtol=2e-5)


def test_flashable_switch(monkeypatch):
    """``nlp.py:98-101``: flash on eval passes and on training at dropout 0;
    the flax path on training with attention dropout."""
    calls = []
    real = nlp.flash_mha

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(nlp, "flash_mha", spy)
    x = torch.from_numpy(_tokens(5)[0])
    gen = torch.Generator().manual_seed(0)
    for dropout, train, want in ((0.1, False, 2), (0.1, True, 0),
                                 (0.0, True, 2), (0.0, False, 2)):
        calls.clear()
        nlp.TinyTransformerLM(max_len=128, dropout=dropout)(
            x, train=train, rng=gen)
        assert len(calls) == want, (dropout, train)
    with pytest.raises(ValueError, match="dropout generator"):
        nlp.TinyTransformerLM(max_len=128)(x, train=True)


def test_attention_dropout_mask_structure():
    """At rate 0.1: one keep mask [1, 1, T, T] for every batch element and
    head, kept weights scaled by 1/0.9, about 10 % dropped — as flax's
    ``broadcast_dropout`` mask, which is drawn from other bits."""
    rng = np.random.RandomState(6)
    q = rng.randn(3, 80, 2, 64).astype(np.float32)
    k = rng.randn(3, 80, 2, 64).astype(np.float32)
    gen = torch.Generator().manual_seed(1)
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    w0 = nlp.dot_product_attention_weights(qt, kt)
    w1 = nlp.dot_product_attention_weights(qt, kt, dropout_rate=0.1,
                                           deterministic=False, rng=gen)
    jw0 = fnn.dot_product_attention_weights(jnp.asarray(q), jnp.asarray(k))
    jw1 = fnn.dot_product_attention_weights(
        jnp.asarray(q), jnp.asarray(k), dropout_rate=0.1,
        deterministic=False, dropout_rng=jax.random.PRNGKey(1))
    np.testing.assert_allclose(w0.numpy(), np.asarray(jw0), atol=1e-6)
    for plain, dropped in ((w0.numpy(), w1.numpy()),
                           (np.asarray(jw0), np.asarray(jw1))):
        ratio = dropped / plain
        kept = ratio > 0
        np.testing.assert_allclose(ratio[kept], 1 / 0.9, rtol=1e-6)
        assert (kept == kept[:1, :1]).all()          # shared by batch, heads
        assert 0.08 <= 1.0 - kept[0, 0].mean() <= 0.12


def test_embedding_dropout_is_elementwise():
    gen = torch.Generator().manual_seed(2)
    x = torch.ones(4, 80, 128)
    y = nlp.dropout(x, 0.1, True, gen)
    kept = y > 0
    assert torch.allclose(y[kept], torch.tensor(1 / 0.9))
    assert 0.08 <= 1.0 - kept.float().mean() <= 0.12
    assert not torch.equal(kept[0], kept[1])
    assert torch.equal(nlp.dropout(x, 0.1, False, gen), x)


def test_weights_roundtrip_is_exact():
    _, np_vars = _jax_lm("f32", seed=7, max_len=512)
    back = to_flax_variables(_port_lm("f32", np_vars, max_len=512))
    got, want = _leaves(back), _leaves(np_vars)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_model_hub_builds_bert_tiny():
    bundle = model_hub.create(Config(model="bert_tiny",
                                     dataset="fed_shakespeare"), 90)
    assert bundle.task == TASK_LM and bundle.input_dtype == torch.int32
    assert bundle.input_shape == (80,)
    model = bundle.module
    assert model.dtype == torch.bfloat16 and model.dropout == 0.1
    # vocab 90, dim 128, 2 layers, 2 heads, max_len 512: the flax tree's size
    n = sum(p.numel() for p in model.parameters())
    _, np_vars = _jax_lm("f32", max_len=512)
    assert n == sum(a.size for a in jax.tree_util.tree_leaves(np_vars))
    assert n == 485466
    for name in ("transformer", "bert-tiny"):
        assert isinstance(model_hub.create(Config(
            model=name, dataset="shakespeare")).module, nlp.TinyTransformerLM)
    for name, item in (("rnn", "A10"), ("vit", "A10"),
                       ("functional_lm", "A15")):
        with pytest.raises(NotImplementedError, match=item):
            model_hub.create(Config(model=name, dataset="fed_shakespeare"))
