"""The port's LoRA transform (``fedml_tpu_torch/train/llm/lora.py``) against
the JAX package's (``fedml_tpu/train/llm/lora.py``).

Both walk the same parameter tree — the full-width ``TinyTransformerLM``
(vocab 90, dim 128, 2 layers, 2 heads) with JAX's initial variables
carried into the port's module by ``utils/weights.py`` — and must pick the
same targets with the same adapter shapes; ``apply_lora`` with JAX's
adapters carried across must give JAX's merged parameters within
``atol=1e-6`` (the rank-4 products ``a@b`` sum four terms in another
order).  The draws of ``init_lora`` are torch's, so only their
distribution is held: ``a`` at standard deviation 0.01, ``b`` zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu.train.llm import lora as jlora
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.ml.engine.model_bundle import TASK_LM, masked_loss
from fedml_tpu_torch.models import model_hub
from fedml_tpu_torch.train.llm import lora
from fedml_tpu_torch.utils.tree import tree_leaves
from fedml_tpu_torch.utils.weights import (
    adapters_from_jax,
    adapters_to_jax,
    from_flax_variables,
    named_tensors_from_tree,
    tree_from_module,
)

TOL = dict(atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def models():
    """JAX's full-width transformer variables and the port's module holding
    them: (jax params, port module, port params tree)."""
    jbundle = fedml_tpu.model.create(fedml_tpu.Config(
        model="transformer", dataset="shakespeare", compute_dtype="float32"),
        90)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jbundle.init_variables(jax.random.PRNGKey(0))))
    bundle = model_hub.create(Config(model="transformer",
                                     dataset="shakespeare",
                                     compute_dtype="float32"), 90)
    from_flax_variables(variables, bundle.module)
    return (variables["params"], bundle.module,
            tree_from_module(bundle.module)["params"])


def _jax_adapters(jparams, rank, seed=3, perturb=True):
    """JAX's adapters for ``jparams`` — with ``b`` moved off zero so the
    merge changes the kernels."""
    ad = jlora.init_lora(jax.tree_util.tree_map(jnp.asarray, jparams),
                         rank=rank, rng=jax.random.PRNGKey(seed))
    if perturb:
        rng = np.random.default_rng(seed)
        ad = {p: {"a": np.asarray(v["a"]),
                  "b": rng.standard_normal(v["b"].shape).astype(np.float32)
                  * np.float32(0.02)} for p, v in ad.items()}
    return jax.tree_util.tree_map(np.asarray, ad)


@pytest.mark.parametrize("rank", [1, 3, 4, 8])
def test_targets_and_shapes_match_jax(models, rank):
    jparams, _, params = models
    want = jlora.init_lora(jax.tree_util.tree_map(jnp.asarray, jparams),
                           rank=rank)
    got = lora.init_lora(params, rank=rank, seed=0)
    assert list(got) == sorted(want)
    for p in want:
        assert tuple(got[p]["a"].shape) == tuple(want[p]["a"].shape)
        assert tuple(got[p]["b"].shape) == tuple(want[p]["b"].shape)
        assert got[p]["a"].dtype == torch.float32
    # the five Dense kernels; the 3-D attention kernels are never targets
    assert len(got) == 5
    assert not any("MultiHeadDotProductAttention" in p for p in got)
    assert lora.count_trainable(got) == jlora.count_trainable(want)


def test_count_trainable_is_11112_at_rank_4(models):
    _, _, params = models
    assert lora.count_trainable(lora.init_lora(params, rank=4)) == 11112


@pytest.mark.parametrize("targets", [
    (r".*Dense_1/kernel",), (r".*block.*dense_0.*",), (r"nothing",)])
def test_custom_targets_match_jax(models, targets):
    """``re.fullmatch`` ignoring case, 2-D kernels only."""
    jparams, _, params = models
    want = jlora.init_lora(jax.tree_util.tree_map(jnp.asarray, jparams),
                           rank=2, targets=targets)
    got = lora.init_lora(params, rank=2, targets=targets)
    assert list(got) == sorted(want)


def test_init_draws_and_flat_layout(models):
    """``a ~ N(0, 0.01²)`` per leaf, ``b = 0``, every factor a view into one
    float32 buffer (the fold kernel's layout); the same seed gives the same
    adapters, another seed others."""
    _, _, params = models
    ad = lora.init_lora(params, rank=8, seed=5)
    a = torch.cat([v["a"].reshape(-1) for v in ad.values()])
    assert abs(float(a.std()) - 0.01) < 0.001 and abs(float(a.mean())) < 1e-3
    assert all(not bool(v["b"].any()) for v in ad.values())
    storages = {leaf.untyped_storage().data_ptr() for leaf in tree_leaves(ad)}
    assert len(storages) == 1
    again = lora.init_lora(params, rank=8, seed=5)
    other = lora.init_lora(params, rank=8, seed=6)
    for x, y, z in zip(tree_leaves(ad), tree_leaves(again),
                       tree_leaves(other)):
        assert torch.equal(x, y)
    assert not torch.equal(tree_leaves(ad)[0], tree_leaves(other)[0])


@pytest.mark.parametrize("rank,alpha", [(4, 16.0), (3, 16.0), (8, 4.0)])
def test_apply_lora_with_jax_adapters_matches_jax(models, rank, alpha):
    jparams, _, params = models
    jad = _jax_adapters(jparams, rank)
    want = jlora.apply_lora(jax.tree_util.tree_map(jnp.asarray, jparams),
                            jax.tree_util.tree_map(jnp.asarray, jad), alpha)
    got = lora.apply_lora(params, adapters_from_jax(jad), alpha)
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    got_leaves = dict(lora.leaves_with_path(got))
    assert len(got_leaves) == len(want_leaves)
    moved = 0
    for path, w in want_leaves.items():
        key = tuple(p.key for p in path)
        g = got_leaves[key].numpy()
        np.testing.assert_allclose(g, np.asarray(w), err_msg=str(key), **TOL)
        moved += "/".join(key) in jad
    assert moved == 5


def test_b_zero_is_the_identity(models):
    """With ``b = 0`` the merge leaves every kernel as it is, bit for bit,
    and the leaves that are no targets are the same tensors."""
    _, _, params = models
    ad = lora.init_lora(params, rank=4, seed=1)
    merged = lora.apply_lora(params, ad, 16.0)
    for (path, p), (_, m) in zip(lora.leaves_with_path(params),
                                 lora.leaves_with_path(merged)):
        assert torch.equal(p, m), path
        if "/".join(path) not in ad:
            assert m is p
    assert lora.merge_lora(params, {}) is params


def test_adapters_cross_both_ways(models):
    jparams, _, _ = models
    jad = _jax_adapters(jparams, 4)
    back = adapters_to_jax(adapters_from_jax(jad))
    for p in jad:
        for k in ("a", "b"):
            assert back[p][k].tobytes() == jad[p][k].tobytes()


def test_the_gradient_reaches_only_the_factors(models):
    """The merged tree's named tensors drive the module through
    ``functional_call``; the loss's gradient lands on ``a`` and ``b`` of
    every target and on nothing of the module."""
    _, module, params = models
    ad = lora.init_lora(params, rank=4, seed=2)
    live = {p: {k: v.detach().requires_grad_() for k, v in ab.items()}
            for p, ab in ad.items()}
    merged = lora.apply_lora(params, live, 16.0)
    named = named_tensors_from_tree({"params": merged}, module)
    assert set(named) == {n for n, _ in module.named_parameters()}
    x = torch.randint(0, 90, (2, 16), generator=torch.Generator()
                      .manual_seed(0), dtype=torch.int32)
    logits = torch.func.functional_call(module, named, (x,),
                                        {"train": False})
    loss = masked_loss(TASK_LM, logits, x.long())
    loss.backward()
    for ab in live.values():
        assert ab["a"].grad is not None and ab["b"].grad is not None
        assert bool(ab["b"].grad.any())
    assert all(p.grad is None for p in module.parameters())
