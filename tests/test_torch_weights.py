"""The flat-variables layout contract and the FedOpt state carry-over.

``FlatVariables`` keeps the parameters (the JAX ``params`` collection) in
columns ``[0, P)`` of each dtype's buffer and the BatchNorm statistics
(``batch_stats``) from ``P`` on, with ``P`` padded to ``FLAT_ALIGN``; the
FedOpt arm and the weight carry-over rely on it.  The server state crosses
between the packages exactly (numpy float32 both ways, no arithmetic), so
the round trips are held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.models.cv import CIFARResNet as JaxResNet
from fedml_tpu.ops import epilogue as jax_ep
from fedml_tpu_torch.ml.engine.model_bundle import FLAT_ALIGN, FlatVariables
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.utils.weights import (
    flat_from_flax_params,
    from_flax_variables,
    opt_state_from_jax,
    opt_state_to_jax,
)


def _jax_vars(depth=8):
    module = JaxResNet(depth=depth, num_classes=10, dtype=jnp.float32)
    v = module.init({"params": jax.random.PRNGKey(depth)},
                    jnp.zeros((2, 32, 32, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _size(tree):
    return sum(int(np.size(a)) for a in jax.tree_util.tree_leaves(tree))


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32), tree)


def _assert_trees_equal(got, want):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(k) for k, _ in g] == \
        [jax.tree_util.keystr(k) for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("depth,want_p,want_d",
                         [(8, 78048, 78720), (56, 855776, 860032)])
def test_params_prefix_and_stats_suffix(depth, want_p, want_d):
    """Parameters fill [0, n) and zero padding [n, P); the statistics fill
    [P, P + s); P is n padded to FLAT_ALIGN, so both ranges start 16-byte
    aligned (ResNet-56: 855,770 → 855,776, and D stays 860,032)."""
    np_vars = _jax_vars(depth)
    n, s = _size(np_vars["params"]), _size(np_vars["batch_stats"])
    model = CIFARResNet(depth=depth, num_classes=10)
    flat = FlatVariables(model)
    ones = {"params": jax.tree_util.tree_map(np.ones_like, np_vars["params"]),
            "batch_stats": jax.tree_util.tree_map(
                lambda a: np.full_like(a, 2.0), np_vars["batch_stats"])}
    from_flax_variables(ones, model)
    buf = flat.flat[torch.float32]
    p = flat.param_cols[torch.float32]
    assert (p, buf.numel()) == (want_p, want_d)
    assert p % FLAT_ALIGN == 0 and p - FLAT_ALIGN < n <= p
    assert flat.params_range(torch.float32) == slice(0, p)
    assert flat.stats_range(torch.float32) == slice(p, want_d)
    assert bool((buf[:n] == 1).all()) and bool((buf[n:p] == 0).all())
    assert bool((buf[p:p + s] == 2).all()) and bool((buf[p + s:] == 0).all())
    assert flat.param_dtypes() == [torch.float32]
    assert sum(leaf.numel for leaf in flat.layout if leaf.is_param) == n


def test_flat_params_follow_the_layout():
    np_vars = _jax_vars()
    model = CIFARResNet(depth=8, num_classes=10)
    flat = FlatVariables(model)
    from_flax_variables(np_vars, model)
    cols = flat.params_range(torch.float32)
    got = flat_from_flax_params(np_vars["params"], flat)[torch.float32]
    assert torch.equal(got, flat.flat[torch.float32][cols])


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_fused_state_round_trip(opt):
    np_vars = _jax_vars()
    flat = FlatVariables(CIFARResNet(depth=8, num_classes=10))
    st = jax_ep.init_opt_state(np_vars["params"],
                               jax_ep.EpilogueSpec(opt=opt))
    st = dict(st, m=_random_like(st["m"], 1))
    if opt == "adam":
        st = dict(st, v=_random_like(st["v"], 2), t=np.int32(7))
    st = jax.tree_util.tree_map(np.asarray, st)
    port = opt_state_from_jax(st, flat)
    group = port[torch.float32]
    assert group["m"].dtype == torch.float32
    assert group["m"].numel() == flat.param_cols[torch.float32]
    if opt == "adam":
        assert group["t"] == 7
    _assert_trees_equal(opt_state_to_jax(port, flat), st)


def test_stateless_channel_round_trip():
    flat = FlatVariables(CIFARResNet(depth=8, num_classes=10))
    port = opt_state_from_jax(None, flat)
    assert port == {torch.float32: None}
    assert opt_state_to_jax(port, flat) is None


@pytest.mark.parametrize("name,tx", [
    ("adam", optax.adam(1e-3)), ("yogi", optax.yogi(1e-3)),
    ("adagrad", optax.adagrad(1e-3)),
    ("sgd_momentum", optax.sgd(1e-3, momentum=0.9))])
def test_optax_state_round_trip(name, tx):
    np_vars = _jax_vars()
    flat = FlatVariables(CIFARResNet(depth=8, num_classes=10))
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, np_vars["params"]))
    rng = np.random.default_rng(3)
    state = jax.tree_util.tree_map(
        lambda a: (np.asarray(5, np.int32) if np.ndim(a) == 0 else
                   rng.normal(size=np.shape(a)).astype(np.float32)), state)
    port = opt_state_from_jax(state, flat)
    fields = {}
    for part in state:
        fields.update(part._asdict())
    assert set(port[torch.float32]) == set(fields)
    back = opt_state_to_jax(port, flat)
    _assert_trees_equal(back, fields)
