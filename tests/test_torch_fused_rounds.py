"""The port's fused rounds (``run_rounds_fused``, ``fused_rounds: true``)
against the JAX package's scan over rounds.

Both sides start from the JAX package's initial variables and run with
``FUSED_CHUNK_ROUNDS`` = 4 on both API instances, so that the scan compiles
at 4 rounds and the run of 5 rounds crosses a chunk edge.  Sizes are
``tests/test_torch_parrot.py``'s: synthetic CIFAR-10, ResNet depth 8,
float32 compute, 4 clients.  The two frameworks draw their clients from
other bits (the port's generator against ``jax.random``), so every client
trains in every round — the uniform round samples all 4, the bucketed one
all members of its 2 strata — and the sets are the same while the orders
differ.

(a) Uniform FedAvg, (b) bucketed FedAvg (2 strata, no cap): the global
variables within 1e-3 and the per-round ``train_loss`` at ``rtol=1e-4``,
as ``tests/test_torch_parrot.py``'s test (a) holds the per-round path (the
JAX package's float32 gradients on the CPU are off their float64 values by
up to 3e-3).  (c) FedOpt with server adam on the fused channel over two
rounds, one chunk each, by that file's three criteria for adam (every
parameter within ``2·server_lr`` a round, 99.5 % of the moves in the same
sign, the moves within 10 % in L2), calibrated there at two rounds, the
BatchNorm statistics at 1e-3, and the carried ``t`` (on the device), ``m``
and ``v``.
The unfused adam and yogi arms (``fused_epilogue: false``, their step
count on the device) are held the same way.
(d) The chunking contract; (e) the gated local update against the host-skip
one, bit for bit; (f) the five-step entry; (g) the options that the
per-round path runs, each run fused; (h) the device step rows of the fused
epilogue, bit for bit; (i) ``run_rounds_fused``'s ``rng``; (j) the language
model (``TinyTransformerLM`` narrowed to dim 32, one layer) at dropout 0
against the JAX package, and at dropout 0.1 reproducible from its seed.

Every test runs torch on one CPU thread (``_one_torch_thread``).
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
from fedml_tpu_torch.ml.engine import local_update as lu
from fedml_tpu_torch.ml.engine.model_bundle import FlatVariables, ModelBundle
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.ops import epilogue
from fedml_tpu_torch.simulation.parrot.parrot_api import ParrotAPI
from fedml_tpu_torch.utils.weights import opt_state_to_jax

CPU = torch.device("cpu")
CHUNK = 4
ROUNDS = CHUNK + 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread.  Beside other test processes on the
    host (JAX's among them), a pool of intra-op threads per process
    oversubscribes the cores, and every parallel op then waits on threads
    that are not running: a test that takes a second alone took minutes
    beside one other worker.  One thread keeps the cost of an op its
    own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _args(cls, tmp_path, **kw):
    base = dict(dataset="cifar10", backend="parrot", partition_method="hetero",
                client_num_in_total=4, client_num_per_round=4, comm_round=2,
                epochs=1, batch_size=16, learning_rate=0.05,
                frequency_of_the_test=1, data_scale=0.02,
                compute_dtype="float32", enable_tracking=False,
                device_type="cpu", data_cache_dir=str(tmp_path))
    base.update(kw)
    return cls(**base)


def _port_bundle():
    return ModelBundle(CIFARResNet(depth=8, num_classes=10), (32, 32, 3), 10)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _moves(got, want, init, coll):
    keys = [k for k in want if k.startswith(f"['{coll}']")]

    def cat(t):
        return np.concatenate([t[k].ravel() for k in keys])

    return cat(got) - cat(init), cat(want) - cat(init)


def _fused(api, calls):
    """``run_rounds_fused`` once per entry of ``calls`` (its round count),
    the metrics concatenated."""
    outs = [api.run_rounds_fused(n) for n in calls]
    return {k: np.concatenate([np.asarray(o[k]) for o in outs])
            for k in outs[0]}


def _run_both(tmp_path, calls=(ROUNDS,), **kw):
    """Fused rounds on each side from the JAX initial variables, one call
    of ``run_rounds_fused`` per entry of ``calls``: (JAX API, port API,
    initial variables, JAX metrics, port metrics)."""
    jargs = _args(JaxConfig, tmp_path, parrot_aot_cache=False, **kw)
    japi = JaxParrot(jargs, None, jax_loader.load(jargs),
                     JaxBundle(JaxResNet(depth=8, num_classes=10,
                                         dtype=jnp.float32), (32, 32, 3), 10))
    japi.FUSED_CHUNK_ROUNDS = CHUNK
    init = jax.tree_util.tree_map(np.array, dict(japi.global_vars))
    jrm = _fused(japi, calls)

    args = _args(Config, tmp_path, **kw)
    api = ParrotAPI(args, CPU, data_loader.load(args), _port_bundle(),
                    initial_variables=init)
    api.FUSED_CHUNK_ROUNDS = CHUNK
    return japi, api, init, jrm, _fused(api, calls)


def _check_fedavg(japi, api, jrm, rm):
    for k in ("train_loss", "train_acc", "samples"):
        assert rm[k].shape == (ROUNDS,) and rm[k].dtype == np.float32
    np.testing.assert_allclose(rm["train_loss"], jrm["train_loss"],
                               rtol=1e-4)
    np.testing.assert_array_equal(rm["samples"], jrm["samples"])
    got = _leaves(api.global_flax_variables())
    want = _leaves(dict(japi.global_vars))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, rtol=0,
                                   err_msg=k)
    assert rm["train_loss"][-1] < rm["train_loss"][0]
    assert [c["rounds"] for c in api.fused_stats["chunks"]] == [CHUNK, 1]


def test_uniform_fedavg_rounds_match_jax(tmp_path):
    japi, api, _, jrm, rm = _run_both(tmp_path)
    assert api.buckets is None
    _check_fedavg(japi, api, jrm, rm)


def test_bucketed_fedavg_rounds_match_jax(tmp_path):
    japi, api, _, jrm, rm = _run_both(tmp_path, hetero_buckets=2)
    assert api.n_buckets == japi.n_buckets == 2
    # every member of every stratum trains in every round, uncapped
    for b in api.buckets:
        assert b["k"] == b["gids"].shape[0] and b["nb"] == b["nb_full"]
    _check_fedavg(japi, api, jrm, rm)


def _check_adam_moves(japi, api, init, jrm, rm, rounds):
    """Adam held as ``tests/test_torch_parrot.py`` holds it: the losses at
    ``rtol=1e-4``, the BatchNorm statistics at 1e-3, every parameter within
    ``2·server_lr`` a round, 99.5 % of the moves in the same sign, the
    moves within 10 % in L2."""
    np.testing.assert_allclose(rm["train_loss"], jrm["train_loss"],
                               rtol=1e-4)
    got = _leaves(api.global_flax_variables())
    want = _leaves(dict(japi.global_vars))
    p_got, p_want = _moves(got, want, _leaves(init), "params")
    s_got, s_want = _moves(got, want, _leaves(init), "batch_stats")
    np.testing.assert_allclose(s_got, s_want, atol=1e-3, rtol=0)
    lr = float(api.args.server_lr)
    np.testing.assert_allclose(p_got, p_want, atol=2 * lr * rounds, rtol=0)
    assert np.mean(np.sign(p_got) == np.sign(p_want)) >= 0.995
    assert np.linalg.norm(p_got - p_want) <= 0.1 * np.linalg.norm(p_want)
    assert np.abs(p_want).max() > 0


def _check_moments(mine, ref, keys):
    for k in keys:
        a, b = (np.concatenate([v.ravel() for v in _leaves(t).values()])
                for t in (mine[k], ref[k]))
        assert np.linalg.norm(a - b) <= 0.1 * np.linalg.norm(b), k


def test_fedopt_adam_rounds_match_jax(tmp_path):
    """Two rounds, one call each, so that adam's state crosses a chunk
    edge: the length at which ``tests/test_torch_parrot.py`` calibrates
    adam's criteria (its sign flips, 0.2 % after two rounds, compound from
    round to round: about 1 % after five)."""
    kw = dict(federated_optimizer="FedOpt", server_optimizer="adam")
    japi, api, init, jrm, rm = _run_both(tmp_path, calls=(1, 1), **kw)
    assert [c["rounds"] for c in api.fused_stats["chunks"]] == [1, 1]
    rounds = 2
    _check_adam_moves(japi, api, init, jrm, rm, rounds)

    # the step count lives on the device and was carried through the chunks
    st = api.server_state["opt_state"][torch.float32]
    assert isinstance(st["t"], torch.Tensor) and int(st["t"]) == rounds
    mine = opt_state_to_jax(api.server_state["opt_state"], api.vars)
    ref = japi.server_state["opt_state"]
    assert int(mine["t"]) == int(ref["t"]) == rounds
    _check_moments(mine, ref, ("m", "v"))


@pytest.mark.parametrize("opt", ["adam", "yogi"])
def test_unfused_server_steps_match_jax(opt, tmp_path):
    """The unfused arm (optax's adam or yogi on the pseudo-gradient, kernel
    1's reduce ahead of it) over two one-round chunks, against the JAX
    package's scan over the same arm, by adam's criteria; optax's count
    is a device tensor equal to the rounds run, its bias corrections read
    from the device table."""
    kw = dict(federated_optimizer="FedOpt", server_optimizer=opt,
              fused_epilogue=False)
    japi, api, init, jrm, rm = _run_both(tmp_path, calls=(1, 1), **kw)
    rounds = 2
    _check_adam_moves(japi, api, init, jrm, rm, rounds)
    st = api.server_state["opt_state"][torch.float32]
    assert isinstance(st["count"], torch.Tensor) and st["count"].dim() == 0
    assert int(st["count"]) == rounds
    mine = opt_state_to_jax(api.server_state["opt_state"], api.vars)
    ref = {}
    for part in japi.server_state["opt_state"]:
        ref.update(part._asdict())
    assert int(mine["count"]) == int(ref["count"]) == rounds
    _check_moments(mine, ref, ("mu", "nu"))


def test_chunking_and_noop(tmp_path):
    args = _args(Config, tmp_path, federated_optimizer="FedOpt",
                 server_optimizer="adam", client_num_per_round=2)
    api = ParrotAPI(args, CPU, data_loader.load(args), _port_bundle())
    api.FUSED_CHUNK_ROUNDS = CHUNK
    start = {dt: f.clone() for dt, f in api.global_vars.items()}
    rm0 = api.run_rounds_fused(0)
    for k in ("train_loss", "train_acc", "samples"):
        assert rm0[k].shape == (0,) and rm0[k].dtype == np.float32
    assert all(torch.equal(api.global_vars[dt], start[dt]) for dt in start)
    assert api.server_state["opt_state"][torch.float32]["t"] == 0
    assert not api.round_history and api._fgen is None

    n = 2 * CHUNK + 3
    rm = api.run_rounds_fused(n)
    assert all(rm[k].shape == (n,) for k in rm)
    assert np.isfinite(rm["train_loss"]).all()
    assert [c["rounds"] for c in api.fused_stats["chunks"]] == [4, 4, 3]
    assert int(api.server_state["opt_state"][torch.float32]["t"]) == n
    assert len(api.round_history) == n
    assert not torch.equal(api.global_vars[torch.float32],
                           start[torch.float32])
    # the state stays usable across calls
    assert np.isfinite(api.run_rounds_fused(2)["train_loss"]).all()


def test_gated_update_equals_host_skip_bit_for_bit():
    """Every batch of a grid with fully padded batches in the middle and
    at the end, and a partly padded one: the gated body's variables and
    metrics equal the host-skip body's, bit for bit."""
    bs, nb = 8, 5
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(nb, bs, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, size=(nb, bs)).astype(np.int64))
    mask = torch.ones(nb, bs)
    mask[1] = 0.0
    mask[2, 5:] = 0.0
    mask[4] = 0.0
    batches = {"x": x, "y": y, "mask": mask}
    valid = (mask > 0).any(dim=1)
    cfg = Config(federated_optimizer="FedAvg", epochs=2, learning_rate=0.05)

    bundle = _port_bundle()
    flat = FlatVariables(bundle.module)
    init = flat.snapshot()
    skip = lu.build_local_update(bundle, cfg)(flat, batches, valid.tolist())
    want = flat.snapshot()
    flat.load(init)
    gated = lu.build_local_update(bundle, cfg, gated=True)(flat, batches,
                                                           valid)
    for dt in want:
        assert torch.equal(flat.flat[dt], want[dt])
    assert not torch.equal(want[torch.float32], init[torch.float32])
    for k in ("train_loss", "train_acc", "n_samples"):
        assert torch.equal(gated[k], skip[k]), k
    assert skip["local_steps"] == int(gated["local_steps"]) == 6


def test_five_step_entry_runs_fused_rounds(tmp_path):
    import fedml_tpu_torch

    args = fedml_tpu_torch.init(_args(
        Config, tmp_path, model="resnet20", comm_round=3,
        frequency_of_the_test=2, client_num_per_round=2, fused_rounds=True,
        hetero_buckets=2, hetero_bucket_cap=0.8))
    device = fedml_tpu_torch.device.get_device(args)
    dataset = fedml_tpu_torch.data.load(args)
    bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, bundle)
    out = runner.run()
    api = runner.runner
    assert out["round"] == args.comm_round - 1
    assert [m["round"] for m in api.metrics_history] == [1, 2]
    assert [c["rounds"] for c in api.fused_stats["chunks"]] == [2, 1]
    assert len(api.round_history) == 3
    assert 0.0 <= out["test_acc"] <= 1.0 and np.isfinite(out["test_loss"])


def _lm_bundle(dropout, dim=32, layers=1):
    """``TinyTransformerLM`` narrowed through its constructor (one layer of
    dim 32, 2 heads of 16), float32 compute."""
    from fedml_tpu_torch.ml.engine.model_bundle import TASK_LM
    from fedml_tpu_torch.models.nlp import TinyTransformerLM

    torch.manual_seed(0)
    return ModelBundle(TinyTransformerLM(dim=dim, layers=layers,
                                         dropout=dropout), (80,), 90,
                       task=TASK_LM, input_dtype=torch.int32)


#: BASELINE config 3's FedOpt (server adam 0.1, lr 0.05) on Fed-Shakespeare
#: at 4 clients, batch 8, data_scale 0.05, split evenly (25 sequences a
#: client).  Even weights make the weighted mean of a parameter that no
#: client moved (the embeddings of absent tokens and positions, the key
#: bias) the same bits in any client order; with uneven weights it is off
#: by an ulp that depends on the order, and adam, which moves every
#: component by about server_lr, turns that into moves of either sign — in
#: fused rounds the two frameworks draw their orders from other bits
LM_KW = dict(dataset="fed_shakespeare", model="bert_tiny",
             federated_optimizer="FedOpt", server_optimizer="adam",
             server_lr=0.1, batch_size=8, data_scale=0.05,
             partition_method="homo")


@pytest.mark.parametrize("opt", [
    dict(server_optimizer="adam", fused_epilogue=False),
    dict(server_optimizer="yogi"),
    dict(checkpoint_dir="ckpt"),
    dict(dropout=True),
], ids=["unfused_adam", "yogi", "checkpoint_dir", "dropout"])
def test_per_round_options_run_fused(opt, tmp_path):
    """What the fused rounds refused until they ported it runs through
    ``train()`` with ``fused_rounds: true``: two chunks of one round, an
    eval after each — the unfused adam and yogi with their step count on
    the device, a checkpoint after each eval, dropout drawn from the card
    generator of the round."""
    opt = dict(opt, federated_optimizer="FedOpt")
    bundle = _port_bundle()
    dropout = opt.pop("dropout", False)
    if dropout:
        opt.update(LM_KW)
        bundle = _lm_bundle(0.1)
    if "checkpoint_dir" in opt:
        opt["checkpoint_dir"] = str(tmp_path / opt["checkpoint_dir"])
    args = _args(Config, tmp_path, fused_rounds=True, **opt)
    api = ParrotAPI(args, CPU, data_loader.load(args), bundle)
    out = api.train()
    assert [c["rounds"] for c in api.fused_stats["chunks"]] == [1, 1]
    assert out["round"] == 1 and np.isfinite(out["test_loss"])
    assert np.isfinite([r["train_loss"] for r in api.round_history]).all()
    st = api.server_state["opt_state"][torch.float32]
    count = st.get("count", st.get("t"))
    assert isinstance(count, torch.Tensor) and int(count) == 2
    if "checkpoint_dir" in opt:
        from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer

        ckpt = RoundCheckpointer(opt["checkpoint_dir"])
        assert ckpt.latest_round() == 1
        assert int(ckpt.restore()["server_state"]["opt_state"]["float32"][
            "t"]) == 2
    assert (api._dgen is not None) == dropout


def test_unfused_sgd_runs_fused_rounds_as_the_fused_channel(tmp_path):
    """The unfused arms whose state is tensors alone (sgd with momentum
    here) run in the fused rounds, their state written back in place: three
    rounds give the fused momentum channel's globals and the same
    momentum."""
    runs = []
    for fused in (True, False):
        args = _args(Config, tmp_path, federated_optimizer="FedOpt",
                     server_optimizer="sgd", server_momentum=0.9,
                     server_lr=0.5, fused_epilogue=fused)
        torch.manual_seed(0)
        api = ParrotAPI(args, CPU, data_loader.load(args), _port_bundle())
        trace = None if fused else \
            api.server_state["opt_state"][torch.float32]["trace"]
        api.run_rounds_fused(3)
        runs.append(api)
    fused, plain = runs
    np.testing.assert_allclose(plain.global_vars[torch.float32],
                               fused.global_vars[torch.float32], atol=1e-6)
    st = plain.server_state["opt_state"][torch.float32]
    assert st["trace"] is trace and trace.abs().max() > 0
    np.testing.assert_allclose(
        st["trace"], fused.server_state["opt_state"][torch.float32]["m"],
        atol=1e-6)


def test_device_step_rows_equal_host_steps_bit_for_bit():
    spec = epilogue.EpilogueSpec(opt="adam", lr=1e-3)
    steps = epilogue.step_rows(1.0, spec, 300, CPU)
    assert steps.rows.shape == (300, epilogue.STEP_COLS)
    assert not steps.final and steps.covers(300) and not steps.covers(301)
    for t in range(1, 301):
        want = np.array(epilogue._step(1.0, spec, {"t": t - 1})[:-1],
                        np.float32)
        np.testing.assert_array_equal(
            steps.rows[t - 1].numpy().view(np.uint32), want.view(np.uint32),
            err_msg=f"t {t}")
    # past the bias corrections' saturation one row holds every later step
    fast = epilogue.EpilogueSpec(opt="adam", b1=0.5, b2=0.5)
    sat = epilogue.step_rows(1.0, fast, 10 ** 6, CPU)
    assert sat.final and sat.covers(10 ** 6) and sat.rows.shape[0] < 64
    assert sat.rows[-1, -2:].tolist() == [1.0, 1.0]
    assert epilogue.step_rows(0.5, epilogue.EpilogueSpec(opt="sgd"), 300,
                              CPU).rows.shape == (1, epilogue.STEP_COLS)

    # the plain version with the count in a tensor reads the same row as
    # with the count on the host, and advances it in place
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 910, generator=gen)
    g = torch.randn(910, generator=gen)
    w = torch.rand(5, generator=gen) + 0.1
    for t in (1, 2, 3, 300):
        m, v = torch.randn(910, generator=gen), torch.rand(910, generator=gen)
        host = {"m": m.clone(), "v": v.clone(), "t": t - 1}
        dev = {"m": m.clone(), "v": v.clone(),
               "t": torch.tensor(t - 1, dtype=torch.int64)}
        want, want_st = epilogue.fused_epilogue(g, x, w, 1.0, spec, host)
        got, got_st = epilogue.fused_epilogue(g, x, w, 1.0, spec, dev,
                                              steps=steps)
        assert torch.equal(got, want)
        assert got_st["t"] is dev["t"] and int(dev["t"]) == want_st["t"] == t
        for k in ("m", "v"):
            assert torch.equal(got_st[k], want_st[k])
    with pytest.raises(ValueError, match="step table"):
        epilogue.fused_epilogue(g, x, w, 1.0, spec, dev)
    with pytest.raises(ValueError, match="step table is for"):
        epilogue.fused_epilogue(g, x, w, 0.5, spec, dev, steps=steps)


# ------------------------------------------------------------------ (i) rng
def _lr_api(tmp_path, **kw):
    """Logistic regression on the synthetic dataset, 6 clients, 2 a round:
    cheap rounds whose draws decide which clients train."""
    args = _args(Config, tmp_path, dataset="synthetic", model="lr",
                 client_num_in_total=6, client_num_per_round=2,
                 data_scale=0.1, **kw)
    import fedml_tpu_torch

    dataset = data_loader.load(args)
    torch.manual_seed(0)
    return ParrotAPI(args, CPU, dataset,
                     fedml_tpu_torch.model.create(args, dataset[-1]))


def test_rng_reseeds_the_fused_draws(tmp_path):
    """The same ``rng`` from the same start runs the same rounds bit for
    bit, an int seed or a generator to draw it from; another seed draws
    other clients; ``rng=None`` reseeds ``seed + 23`` on every call, so two
    calls draw the same clients, as the JAX package replays its key."""
    def run(rng, calls=1, n=3):
        api = _lr_api(tmp_path)
        outs = [api.run_rounds_fused(n, rng=rng() if callable(rng) else rng)
                for _ in range(calls)]
        return api, outs

    a, (ra,) = run(11)
    b, (rb,) = run(11)
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k])
    assert torch.equal(a.global_vars[torch.float32],
                       b.global_vars[torch.float32])
    _, (rc,) = run(12)
    assert not np.array_equal(ra["samples"], rc["samples"])
    g1, (rg1,) = run(lambda: torch.Generator().manual_seed(5))
    _, (rg2,) = run(lambda: torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(rg1["train_loss"], rg2["train_loss"])
    # None: the same clients on every call (their sample counts), the
    # state carried on
    _, (r1, r2) = run(None, calls=2)
    np.testing.assert_array_equal(r1["samples"], r2["samples"])
    assert not np.array_equal(r1["train_loss"], r2["train_loss"])
    with pytest.raises(TypeError, match="rng"):
        g1.run_rounds_fused(1, rng=1.5)


# --------------------------------------------------- (j) the language model
def test_fused_lm_rounds_at_dropout_0_match_jax(tmp_path):
    """The narrowed LM at dropout 0 in fused rounds, two one-round chunks
    of FedOpt (server adam 0.1) from the JAX package's initial variables:
    the losses at ``rtol=1e-4`` and adam held as in
    ``test_fedopt_adam_rounds_match_jax`` (no BatchNorm here)."""
    from fedml_tpu.models.nlp import TinyTransformerLM as JaxLM

    jargs = _args(JaxConfig, tmp_path, parrot_aot_cache=False, **LM_KW)
    japi = JaxParrot(jargs, None, jax_loader.load(jargs),
                     JaxBundle(JaxLM(dim=32, layers=1, dropout=0.0), (80,),
                               90, task="lm", input_dtype=jnp.int32))
    japi.FUSED_CHUNK_ROUNDS = CHUNK
    init = jax.tree_util.tree_map(np.array, dict(japi.global_vars))
    jrm = _fused(japi, (1, 1))

    args = _args(Config, tmp_path, **LM_KW)
    api = ParrotAPI(args, CPU, data_loader.load(args), _lm_bundle(0.0),
                    initial_variables=init)
    api.FUSED_CHUNK_ROUNDS = CHUNK
    rm = _fused(api, (1, 1))
    rounds = 2
    np.testing.assert_allclose(rm["train_loss"], jrm["train_loss"],
                               rtol=1e-4)
    np.testing.assert_array_equal(rm["samples"], jrm["samples"])
    got = _leaves(api.global_flax_variables())
    want = _leaves(dict(japi.global_vars))
    assert got.keys() == want.keys()
    p_got, p_want = _moves(got, want, _leaves(init), "params")
    lr = float(api.args.server_lr)
    np.testing.assert_allclose(p_got, p_want, atol=2 * lr * rounds, rtol=0)
    assert np.mean(np.sign(p_got) == np.sign(p_want)) >= 0.995
    assert np.linalg.norm(p_got - p_want) <= 0.1 * np.linalg.norm(p_want)
    assert np.abs(p_want).max() > 0
    assert int(api.server_state["opt_state"][torch.float32]["t"]) == rounds


def test_fused_lm_rounds_at_dropout_01_are_seeded(tmp_path):
    """At dropout 0.1 the fused LM rounds are finite, the same bits from
    the same seed, and other than at dropout 0 from the same start."""
    def run(dropout, seed=0):
        args = _args(Config, tmp_path, random_seed=seed, **LM_KW)
        api = ParrotAPI(args, CPU, data_loader.load(args),
                        _lm_bundle(dropout))
        return api, api.run_rounds_fused(2)

    a, ra = run(0.1)
    b, rb = run(0.1)
    _, r0 = run(0.0)
    assert np.isfinite(ra["train_loss"]).all()
    np.testing.assert_array_equal(ra["train_loss"], rb["train_loss"])
    assert torch.equal(a.global_vars[torch.float32],
                       b.global_vars[torch.float32])
    assert a._dgen is not None
    assert not np.array_equal(ra["train_loss"], r0["train_loss"])


@pytest.mark.parametrize("opt", ["adam", "yogi"])
def test_device_count_bias_rows_equal_host_counts_bit_for_bit(opt):
    """The unfused adam's and yogi's update with optax's count in a tensor
    takes its bias corrections from the last two columns of the step table
    for its (b1, b2): the bits of the host-count update at every step, the
    count advanced in place."""
    from fedml_tpu_torch.ml.engine.optimizers import build_server_optimizer

    tx = build_server_optimizer(Config(server_optimizer=opt, server_lr=0.1))
    b1, b2 = tx.betas
    steps = epilogue.step_rows(1.0, epilogue.EpilogueSpec("adam", b1=b1,
                                                          b2=b2), 300, CPU)
    gen = torch.Generator().manual_seed(1)
    for t in (1, 2, 3, 300):
        g = torch.randn(910, generator=gen)
        st = tx.init(torch.zeros(910))
        st["mu"], st["nu"] = (torch.randn(910, generator=gen) * 1e-2,
                              torch.rand(910, generator=gen) * 1e-3)
        host = dict(st, count=t - 1)
        dev = dict(st, count=torch.tensor(t - 1, dtype=torch.int64))
        want, want_st = tx.update(g, host)
        got, got_st = tx.update(g, dev, steps.rows[:, -2:])
        assert torch.equal(got, want), t
        assert got_st["count"] is dev["count"] and int(dev["count"]) == \
            want_st["count"] == t
        for k in ("mu", "nu"):
            assert torch.equal(got_st[k], want_st[k]), (t, k)
    with pytest.raises(ValueError, match="bias_rows"):
        tx.update(g, dev)
