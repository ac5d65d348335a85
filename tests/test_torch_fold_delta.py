"""The port's adapter fold (``ops/epilogue.fold_delta``, kernel B6) against
the JAX package's ``fedml_tpu.ops.epilogue.fold_delta``.

The same numpy adapters and deltas — the BERT-tiny rank-4 adapter table
(10 leaves, 11,112 values) and a rank-3 one whose leaves are no multiples
of 4 — go through the JAX fold's jnp fallback (``prefer_pallas=False``,
what runs off the TPU), its Pallas ``_delta_kernel`` in interpret mode
(``prefer_pallas=True, interpret=True``, as ``tests/test_epilogue.py``
runs it) and the port's wrapper on CPU tensors, which takes the plain
version ``fold_delta_reference``.  The CUDA kernel is held to the plain
version on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerances, by what each side computes:

* against the jnp fallback: equal bits, for float32 and bfloat16 adapters
  at ``server_lr`` 0, 1 and 0.37 — both round ``lr·d`` to float32, then
  the sum, then cast;
* against interpret mode: equal bits at ``server_lr`` 0 and 1, where the
  product is exact; at 0.37 interpret mode contracts ``a + lr·d`` into one
  fma (ROADMAP Queue C, "fma in interpret mode"), whose one rounding
  differs from the product's and the sum's by less than one float32 ulp
  of the largest of ``|a|``, ``|lr·d|`` and the result — the bound for
  float32 adapters (relative to the result alone it is more where ``a``
  and ``lr·d`` cancel); bfloat16 adapters within one bfloat16 step (an
  ulp of difference before the cast can cross a rounding midpoint).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import epilogue as jax_ep
from fedml_tpu_torch.ops import epilogue
from fedml_tpu_torch.train.fed_llm.delta_round import (
    make_delta_round,
    zeros_like_adapters,
)
from fedml_tpu_torch.train.llm.lora import apply_lora
from fedml_tpu_torch.utils.tree import tree_leaves

#: (path, d_in, d_out) of TinyTransformerLM's five LoRA targets
TARGETS = [("Dense_0/kernel", 128, 90),
           ("TransformerBlock_0/Dense_0/kernel", 128, 512),
           ("TransformerBlock_0/Dense_1/kernel", 512, 128),
           ("TransformerBlock_1/Dense_0/kernel", 128, 512),
           ("TransformerBlock_1/Dense_1/kernel", 512, 128)]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _np_pair(rank, seed):
    """(adapters, delta) as numpy trees: the adapters random at the scale
    of trained factors, the delta a round's aggregate (some zeros)."""
    rng = np.random.default_rng(seed)
    ad, dl = {}, {}
    for path, d_in, d_out in TARGETS:
        ad[path] = {"a": rng.standard_normal((d_in, rank)) * 0.01,
                    "b": rng.standard_normal((rank, d_out)) * 0.003}
        dl[path] = {"a": rng.standard_normal((d_in, rank)) * 1e-3,
                    "b": rng.standard_normal((rank, d_out)) * 1e-3}
        dl[path]["b"][0] = 0.0
    cast = lambda t: {p: {k: v.astype(np.float32) for k, v in ab.items()}
                      for p, ab in t.items()}
    return cast(ad), cast(dl)


def _jax(tree, jdt):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)


def _torch(tree, tdt):
    return {p: {k: torch.from_numpy(v).to(tdt) for k, v in ab.items()}
            for p, ab in tree.items()}


def _bits(t):
    """float32 values of a leaf (exact for bfloat16) as numpy."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _port(ad, dl, dt, lr):
    return epilogue.fold_delta(_torch(ad, DTYPES[dt][2]),
                               _torch(dl, torch.float32), lr)


@pytest.mark.parametrize("lr", [0.0, 1.0, 0.37])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rank", [4, 3])
def test_plain_version_matches_the_jnp_fallback_bit_for_bit(rank, dt, lr):
    ad, dl = _np_pair(rank, seed=rank)
    jdt = DTYPES[dt][1]
    want = jax_ep.fold_delta(_jax(ad, jdt), _jax(dl, jnp.float32), lr,
                             prefer_pallas=False)
    before = epilogue.LAUNCHES["fold_delta"]
    got = _port(ad, dl, dt, lr)
    assert epilogue.LAUNCHES["fold_delta"] == before
    assert sorted(got) == sorted(want)
    for p in want:
        for k in ("a", "b"):
            assert got[p][k].dtype == DTYPES[dt][2]
            g, w = _bits(got[p][k]), _bits(want[p][k])
            assert g.tobytes() == w.tobytes(), (p, k, np.abs(g - w).max())


@pytest.mark.parametrize("lr", [0.0, 1.0, 0.37])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_version_against_the_pallas_kernel_in_interpret_mode(dt, lr):
    ad, dl = _np_pair(4, seed=11)
    jdt = DTYPES[dt][1]
    want = jax_ep.fold_delta(_jax(ad, jdt), _jax(dl, jnp.float32), lr,
                             prefer_pallas=True, interpret=True)
    got = _port(ad, dl, dt, lr)
    a_in = _jax(ad, jdt)
    for p in want:
        for k in ("a", "b"):
            g, w = _bits(got[p][k]), _bits(want[p][k])
            if lr in (0.0, 1.0):
                assert g.tobytes() == w.tobytes(), (p, k)
            elif dt == "f32":
                big = np.maximum(np.maximum(np.abs(_bits(a_in[p][k])),
                                            np.abs(np.float32(lr)
                                                   * dl[p][k])), np.abs(w))
                assert np.all(np.abs(g - w) <= np.spacing(big)), (p, k)
            else:
                step = np.maximum(np.abs(w), 1e-30) * 2.0 ** -7
                assert np.all(np.abs(g - w) <= step), (p, k)


def test_the_wrapper_folds_in_place_and_keeps_the_layout():
    """``out`` = the adapters folds in place; without ``out`` the result is
    a new tree whose leaves are views into one buffer per dtype, never the
    input's storage."""
    ad, dl = _np_pair(4, seed=2)
    a, d = _torch(ad, torch.float32), _torch(dl, torch.float32)
    a_flat = epilogue.flat_tree(a)
    new = epilogue.fold_delta(a_flat, d, 0.5)
    storages = {t.untyped_storage().data_ptr() for t in tree_leaves(new)}
    assert len(storages) == 1
    assert storages.isdisjoint(
        {t.untyped_storage().data_ptr() for t in tree_leaves(a_flat)})
    ref = epilogue.fold_delta_reference(a, d, 0.5)
    same = epilogue.fold_delta(a_flat, d, 0.5, out=a_flat)
    assert same is a_flat
    for x, y, z in zip(tree_leaves(new), tree_leaves(ref),
                       tree_leaves(a_flat)):
        assert torch.equal(x, y) and torch.equal(z, y)


def test_the_wrapper_refuses_mismatched_trees():
    ad, dl = _np_pair(4, seed=3)
    a, d = _torch(ad, torch.float32), _torch(dl, torch.float32)
    d.pop(next(iter(d)))
    with pytest.raises(ValueError, match="tree"):
        epilogue.fold_delta(a, d, 1.0)


def test_flat_tree_lays_each_dtype_out_in_one_buffer():
    tree = {"b": torch.arange(6.0).reshape(2, 3),
            "a": {"x": torch.ones(5, dtype=torch.bfloat16),
                  "y": torch.zeros(3, dtype=torch.bfloat16)},
            "c": torch.full((7,), 2.0)}
    flat = epilogue.flat_tree(tree)
    leaves = tree_leaves(flat)
    for x, y in zip(leaves, tree_leaves(tree)):
        assert torch.equal(x, y) and x.dtype == y.dtype
    f32 = [t for t in leaves if t.dtype == torch.float32]
    bf16 = [t for t in leaves if t.dtype == torch.bfloat16]
    assert len({t.untyped_storage().data_ptr() for t in f32}) == 1
    assert len({t.untyped_storage().data_ptr() for t in bf16}) == 1
    # flatten order: "b" before "c" in the float32 buffer
    assert [t.storage_offset() for t in f32] == [0, 6]


@pytest.mark.parametrize("lr", [1.0, 0.0])
def test_delta_round_folds_merges_and_never_aliases(lr):
    """``delta_round`` = ``fold_delta`` then ``apply_lora``: the returned
    adapters are a new buffer (the global stays readable), the merge is
    ``apply_lora`` of them, and at ``server_lr`` 0 the fold is the
    identity."""
    ad, dl = _np_pair(4, seed=5)
    gl = epilogue.flat_tree(_torch(ad, torch.float32))
    keep = [t.clone() for t in tree_leaves(gl)]
    rng = np.random.default_rng(0)
    base = {"Dense_0": {"kernel": torch.from_numpy(
        rng.standard_normal((128, 90)).astype(np.float32))}}
    for path, d_in, d_out in TARGETS[1:]:
        blk, dense, _ = path.split("/")
        base.setdefault(blk, {})[dense] = {"kernel": torch.from_numpy(
            rng.standard_normal((d_in, d_out)).astype(np.float32))}
    step = make_delta_round(16.0)
    delta = _torch(dl, torch.float32) if lr else zeros_like_adapters(gl)
    new, merged = step(gl, base, delta, lr)
    for x, y in zip(tree_leaves(gl), keep):
        assert torch.equal(x, y)
    assert {t.untyped_storage().data_ptr() for t in tree_leaves(new)} \
        .isdisjoint({t.untyped_storage().data_ptr() for t in tree_leaves(gl)})
    want = epilogue.fold_delta_reference(gl, delta, lr)
    for x, y in zip(tree_leaves(new), tree_leaves(want)):
        assert torch.equal(x, y)
    if not lr:
        for x, y in zip(tree_leaves(new), keep):
            assert torch.equal(x, y)
    for x, y in zip(tree_leaves(merged),
                    tree_leaves(apply_lora(base, new, 16.0))):
        assert torch.equal(x, y)


#: the fold kernel's values a block (``fedml_fold_delta_chunk``)
CHUNK = 512


def _offsets(tree):
    """Each leaf's element offset in its buffer, as the wrapper reads it."""
    return epilogue._segments(tree_leaves(tree))[1]


def test_fold_plan_of_the_fed_llm_round_is_one_flat_range():
    """flat_tree's adapters, zeros_like_adapters' delta and a new output
    buffer (the fed-LLM round's fold): one range over all 11,112 values,
    22 blocks of 512."""
    ad, _ = _np_pair(4, seed=6)
    a = epilogue.flat_tree(_torch(ad, torch.float32))
    d = zeros_like_adapters(a)
    sizes = [t.numel() for t in tree_leaves(a)]
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    plan = epilogue.fold_plan(sizes, _offsets(a), _offsets(d), starts,
                              CHUNK)
    assert plan == epilogue.FoldPlan("flat", ((0, 0, 0, 11112, 0),), 22)


@pytest.mark.parametrize("layout,form", [
    ("misaligned", "flat"), ("in_place", "flat"),
    ("out_elsewhere", "table"), ("gaps", "table"),
    ("many_leaves_with_gaps", "table"), ("many_leaves_back_to_back", "flat")])
def test_fold_plan_picks_the_launch_form(layout, form):
    """Hand-built layouts: a buffer that starts misaligned (one range at its
    offset), a fold in place, out in another buffer at other relative
    offsets, leaves with gaps between them, and 200 leaves with gaps in a
    and d or back to back in all three."""
    sizes = [1000, 37, 4, 512]
    starts = [0, 1000, 1037, 1041]
    a, d, o = [3 + s for s in starts], starts, starts
    if layout == "in_place":
        o = a
    elif layout == "out_elsewhere":
        o = [553, 516, 512, 0]          # the leaves in reverse order
    elif layout == "gaps":
        a = [0, 1008, 1048, 1056]
    elif layout.startswith("many_leaves"):
        sizes = [3] * 200
        o = [3 * i for i in range(200)]
        a = d = o if layout.endswith("back_to_back") else [
            5 * i for i in range(200)]
    plan = epilogue.fold_plan(sizes, a, d, o, CHUNK)
    assert plan.form == form
    if form == "flat":
        assert plan.rows == ((a[0], d[0], o[0], sum(sizes), 0),)
        assert plan.n_chunks == -(-sum(sizes) // CHUNK)
    else:
        firsts = [0] + [sum(-(-n // CHUNK) for n in sizes[:i + 1])
                        for i in range(len(sizes) - 1)]
        assert plan.rows == tuple(zip(a, d, o, sizes, firsts))
        assert plan.n_chunks == sum(-(-n // CHUNK) for n in sizes)
