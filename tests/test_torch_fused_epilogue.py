"""The port's fused round epilogue, async fold and server optimizers against
the JAX package.

The same numpy inputs go through ``fedml_tpu.ops.epilogue.fused_epilogue``
with its Pallas kernels in interpret mode (as ``tests/test_epilogue.py``
runs them) and through the port's wrapper on CPU tensors, which takes the
plain version, ``fused_epilogue_reference``.  The port takes every leaf of
one dtype as one flat buffer: the leaves are concatenated into the
parameter columns of a wider stacked buffer (the BatchNorm columns follow),
so the wrapper sees a column range with a row stride, as on the Parrot
path.  The CUDA kernel itself is held against the plain version on the card
by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerances:

* ``atol = rtol = 2e-6`` on the new global and the optimizer state, for
  every channel with float32 and bfloat16 stacked buffers and a float32
  global: both reduce in float32 in another order, and the Pallas kernels
  in interpret mode contract ``a·b + c`` into one fma where the port rounds
  twice — a float32 ulp or two.
* A bfloat16 global at the same tolerance against the JAX package's jnp
  fallback, which rounds as the port does: against the interpret-mode
  kernels a value within one float32 ulp of a bfloat16 rounding midpoint
  lands one bfloat16 step apart (the fma above).
* The server optimizers against optax at ``rtol = 1e-6, atol = 1e-7``:
  the same float32 operations in the same order, but XLA's ``sqrt``,
  ``rsqrt`` and ``pow`` on the CPU may differ from PyTorch's by an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fedml_tpu
from fedml_tpu.ml.aggregator import agg_operator as jax_agg
from fedml_tpu.ml.engine.optimizers import (
    build_server_optimizer as jax_server_optimizer,
)
from fedml_tpu.ops import epilogue as jax_ep
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.ml.aggregator.agg_operator import fold_buffer, mix_global
from fedml_tpu_torch.ml.engine.optimizers import (
    apply_updates,
    build_server_optimizer,
)
from fedml_tpu_torch.ops import epilogue

TOL = dict(atol=2e-6, rtol=2e-6)
OPT_TOL = dict(atol=1e-7, rtol=1e-6)
OPTS = ["none", "sgd", "momentum", "adam"]
LEAVES = ("w", "b", "s")
STATS = 37     # BatchNorm-like columns after the parameter columns


def _tree(c, dtype, seed, lead=True, with_int=False):
    """A model-shaped tree (``tests/test_epilogue.py``'s leaves: a matrix,
    a bias and a scalar), with a leading client axis when ``lead``."""
    rng = np.random.default_rng(seed)
    pre = (c,) if lead else ()
    tree = {"w": rng.normal(size=pre + (7, 130)),
            "b": rng.normal(size=pre + (9,)),
            "s": rng.normal(size=pre)}
    tree = {k: jnp.asarray(v, dtype) for k, v in tree.items()}
    if with_int:
        tree["steps"] = jnp.asarray(rng.integers(0, 50, size=pre), jnp.int32)
    return tree


def _t(a):
    """A JAX array as a torch tensor of the same dtype (bfloat16 exactly,
    through float32)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _weights(c, seed=1):
    return np.random.default_rng(seed).uniform(0.5, 3.0, c).astype(
        np.float32)


def _flat(tree):
    return torch.cat([_t(tree[k]).reshape(-1) for k in LEAVES])


def _stacked_cols(tree, c, seed):
    """The stacked leaves as the parameter columns of a [C, P + STATS]
    buffer; returns the column range [C, P]."""
    cols = torch.cat([_t(tree[k]).reshape(c, -1) for k in LEAVES], dim=1)
    stats = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(c, STATS)).astype(np.float32)).to(cols.dtype)
    return torch.cat([cols, stats], dim=1)[:, :cols.shape[1]]


def _split(flat, like):
    out, off = {}, 0
    for k in LEAVES:
        n = int(np.prod(like[k].shape))
        out[k] = flat[off:off + n].float().numpy().reshape(like[k].shape)
        off += n
    return out


def _jax_state(opt, g, seed):
    """A non-zero JAX state for ``opt`` (adam at t = 4)."""
    if opt in ("none", "sgd"):
        return None
    rng = np.random.default_rng(seed)
    st = {"m": {k: jnp.asarray(rng.normal(size=g[k].shape), jnp.float32)
                for k in LEAVES}}
    if opt == "adam":
        st["v"] = {k: jnp.asarray(rng.normal(size=g[k].shape) ** 2,
                                  jnp.float32) for k in LEAVES}
        st["t"] = jnp.asarray(4, jnp.int32)
    return st


def _port_state(st):
    if st is None:
        return None
    out = {k: _flat(st[k]) for k in ("m", "v") if k in st}
    if "t" in st:
        out["t"] = int(st["t"])
    return out


def _assert_state(got, want, like):
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for k in ("m", "v"):
        if k in want:
            g = _split(got[k], like)
            for leaf in LEAVES:
                np.testing.assert_allclose(g[leaf], np.asarray(want[k][leaf]),
                                           err_msg=f"{k}/{leaf}", **TOL)
    if "t" in want:
        assert got["t"] == int(want["t"])


def _assert_global(got, want, like):
    g = _split(got, like)
    for k in LEAVES:
        np.testing.assert_allclose(g[k], np.asarray(want[k], np.float32),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("stacked_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("opt", OPTS)
def test_fused_epilogue_matches_pallas_interpret(opt, stacked_dtype):
    c = 5
    stacked = _tree(c, stacked_dtype, 17)
    g = _tree(c, jnp.float32, 18, lead=False)
    w = _weights(c)
    st = _jax_state(opt, g, 19)
    want, want_st = jax_ep.fused_epilogue(
        g, stacked, jnp.asarray(w), 0.7, jax_ep.EpilogueSpec(opt=opt, lr=0.1),
        st, prefer_pallas=True, interpret=True)
    before = dict(epilogue.LAUNCHES)
    cols = _stacked_cols(stacked, c, 20)
    assert cols.stride(0) == cols.shape[1] + STATS
    got, got_st = epilogue.fused_epilogue(
        _flat(g), cols, torch.from_numpy(w), 0.7,
        epilogue.EpilogueSpec(opt=opt, lr=0.1), _port_state(st))
    assert got.dtype == torch.float32
    _assert_global(got, want, g)
    _assert_state(got_st, want_st, g)
    # the CPU path is the plain version; no kernel launched
    assert epilogue.LAUNCHES == before


@pytest.mark.parametrize("opt", OPTS)
def test_bf16_global_matches_jnp_fallback(opt):
    c = 4
    stacked = _tree(c, jnp.bfloat16, 21)
    g = _tree(c, jnp.bfloat16, 22, lead=False)
    w = _weights(c, 2)
    st = _jax_state(opt, g, 23)
    want, want_st = jax_ep.fused_epilogue(
        g, stacked, jnp.asarray(w), 0.7, jax_ep.EpilogueSpec(opt=opt, lr=0.1),
        st, prefer_pallas=False)
    out = torch.empty(sum(int(np.prod(g[k].shape)) for k in LEAVES),
                      dtype=torch.bfloat16)
    got, got_st = epilogue.fused_epilogue(
        _flat(g), _stacked_cols(stacked, c, 24), torch.from_numpy(w), 0.7,
        epilogue.EpilogueSpec(opt=opt, lr=0.1), _port_state(st), out=out)
    assert got is out and got.dtype == torch.bfloat16
    _assert_global(got, want, g)
    _assert_state(got_st, want_st, g)


@pytest.mark.parametrize("opt", OPTS)
def test_four_step_trajectory_matches_jax(opt):
    """``tests/test_epilogue.py``'s multi-step round trip: the state (and
    adam's ``t`` and bias corrections) threads through four calls on both
    sides, from ``init_opt_state``."""
    steps, c = 4, 5
    g = _tree(c, jnp.float32, 30, lead=False)
    jspec = jax_ep.EpilogueSpec(opt=opt, lr=0.05)
    pspec = epilogue.EpilogueSpec(opt=opt, lr=0.05)
    jst = jax_ep.init_opt_state(g, jspec)
    cur, pcur = g, _flat(g)
    pst = epilogue.init_opt_state(pcur, pspec)
    _assert_state(pst, jst, g)
    for k in range(steps):
        stacked, w = _tree(c, jnp.float32, 40 + k), _weights(c, 50 + k)
        cur, jst = jax_ep.fused_epilogue(cur, stacked, jnp.asarray(w), 0.8,
                                         jspec, jst, prefer_pallas=True,
                                         interpret=True)
        pcur, pst = epilogue.fused_epilogue(
            pcur, _stacked_cols(stacked, c, 60 + k), torch.from_numpy(w),
            0.8, pspec, pst)
        _assert_global(pcur, cur, g)
        _assert_state(pst, jst, g)
    if opt == "adam":
        assert pst["t"] == steps


CONFIGS = [dict(server_optimizer="adam", server_lr=0.01),
           dict(server_optimizer="sgd", server_lr=0.5, server_momentum=0.9),
           dict(server_optimizer="sgd", server_lr=0.5, server_momentum=0.0),
           dict(server_optimizer="yogi"),
           dict(server_optimizer="adagrad"),
           dict(server_optimizer="adam", fused_epilogue=False),
           dict()]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: str(c))
def test_spec_from_args_matches_jax(cfg):
    want = jax_ep.spec_from_args(fedml_tpu.Config(**cfg))
    got = epilogue.spec_from_args(Config(**cfg))
    if want is None:
        assert got is None
    else:
        assert tuple(got) == tuple(want)


def test_unknown_channel_raises():
    g = torch.ones(2)
    with pytest.raises(ValueError, match="unknown epilogue optimizer"):
        epilogue.fused_epilogue(g, torch.ones(2, 2), torch.ones(2), 1.0,
                                epilogue.EpilogueSpec(opt="rmsprop"))


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_stateful_channel_needs_state(opt):
    with pytest.raises(ValueError, match="needs opt_state"):
        epilogue.fused_epilogue(torch.ones(2), torch.ones(3, 2),
                                torch.ones(3), 1.0,
                                epilogue.EpilogueSpec(opt=opt))


def test_non_float_global_takes_the_aggregate():
    """``mix_global``'s contract: an int global leaf takes the float32
    aggregate as it is; the optimizer never touches it."""
    stacked = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    w = torch.tensor([1.0, 2.0, 1.0])
    st = {"m": torch.zeros(4), "v": torch.zeros(4), "t": 3}
    got, got_st = epilogue.fused_epilogue(
        torch.zeros(4, dtype=torch.int32), stacked, w, 0.5,
        epilogue.EpilogueSpec(opt="adam"), st)
    assert got.dtype == torch.float32 and got_st is st
    torch.testing.assert_close(
        got, epilogue.weighted_reduce_reference(stacked, w))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mix_global_matches_jax(dtype):
    g = _tree(1, dtype, 70, lead=False, with_int=True)
    agg = _tree(1, jnp.float32, 71, lead=False, with_int=True)
    want = jax_agg.mix_global(g, agg, 0.3)
    got = mix_global({k: _t(v) for k, v in g.items()},
                     {k: _t(v) for k, v in agg.items()}, 0.3)
    for k in want:
        assert got[k].dtype == _t(want[k]).dtype, k
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("lr", [1.0, 0.5])
def test_fold_buffer_matches_jax(lr):
    """The buffered-async fold: staleness-decayed weights, one reduction,
    mixed into the global — the ``none`` channel of the fused epilogue."""
    c = 6
    stacked = _tree(c, jnp.float32, 23, with_int=True)
    g = _tree(c, jnp.float32, 24, lead=False, with_int=True)
    w = (np.asarray([1.0, 0.5, 0.25, 1.0, 0.125, 0.5], np.float32)
         * np.asarray([30, 12, 44, 8, 20, 16], np.float32))
    want = jax_agg.fold_buffer(g, stacked, jnp.asarray(w), lr)
    before = dict(epilogue.LAUNCHES)
    got = fold_buffer({k: _t(v) for k, v in g.items()},
                      {k: _t(v) for k, v in stacked.items()},
                      torch.from_numpy(w), lr)
    assert epilogue.LAUNCHES == before
    for k in want:
        assert got[k].dtype == _t(want[k]).dtype, k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(want[k], np.float32),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("cfg", [
    dict(server_optimizer="adam"),
    dict(server_optimizer="yogi"),
    dict(server_optimizer="adagrad"),
    dict(server_optimizer="sgd", server_momentum=0.0),
    dict(server_optimizer="sgd", server_momentum=0.9),
], ids=lambda c: f"{c['server_optimizer']}-{c.get('server_momentum', '')}")
def test_server_optimizer_matches_optax(cfg):
    """Three steps of the unfused arm's optimizer on one flat leaf."""
    cfg = dict(cfg, server_lr=0.05)
    rng = np.random.default_rng(80)
    params = rng.normal(size=1000).astype(np.float32)
    grads = [rng.normal(size=1000).astype(np.float32) * 10.0 ** -k
             for k in range(3)]
    tx = jax_server_optimizer(fedml_tpu.Config(**cfg))
    jp = jnp.asarray(params)
    jst = tx.init(jp)
    opt = build_server_optimizer(Config(**cfg))
    pp = torch.from_numpy(params.copy())
    pst = opt.init(pp)
    for gr in grads:
        upd, jst = tx.update(jnp.asarray(gr), jst, jp)
        jp = optax.apply_updates(jp, upd)
        pupd, pst = opt.update(torch.from_numpy(gr), pst)
        pp = apply_updates(pp, pupd)
        np.testing.assert_allclose(pupd.numpy(), np.asarray(upd), **OPT_TOL)
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), **OPT_TOL)
    fields = {}
    for part in jst:
        fields.update(part._asdict())
    assert set(pst) == set(fields)
    for k, v in fields.items():
        if k == "count":
            assert pst[k] == int(v) == 3
        else:
            np.testing.assert_allclose(pst[k].numpy(), np.asarray(v),
                                       err_msg=k, **OPT_TOL)


@pytest.mark.parametrize("which", ["global", "stacked", "weights"])
def test_wrapper_refuses_other_devices(which):
    """Only CPU tensors take the plain version; a tensor elsewhere goes to
    the kernel's checks and is refused, never computed."""
    args = {"global": torch.zeros(4), "stacked": torch.zeros(3, 4),
            "weights": torch.ones(3)}
    args[which] = args[which].to("meta")
    with pytest.raises(ValueError, match="on the CPU or on one card"):
        epilogue.fused_epilogue(args["global"], args["stacked"],
                                args["weights"])
