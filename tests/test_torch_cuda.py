"""The CUDA kernels against their plain PyTorch versions, on the card: the
weighted reduce, the fused epilogue, the flash-attention forward, the
int8 wire codec's quantize and dequantize and top-k selection on ties, and
the fed-LLM adapter fold (bit for bit), one fed-LLM round on the card
against the same round on the CPU, the multi-client conv's forward and
weight-gradient kernels (forward, dx and dw; within the float32 error of
sums in another order, √terms · 2^-23 · Σ|terms|, and one bfloat16 step),
and ``ops/pallas_ops``' weighted average and int8 product (within the
float32 bound of a sum of C or K terms; the weighted average also at every
row offset, and its tree form in each launch form bit for bit the flat
form over the leaves concatenated) and SecAgg's quantize-mask (bit for
bit), with SecAgg's round and the int8 weight quantization card against CPU.  Every test here needs an NVIDIA card
and ``nvcc``: the kernel has no CPU mode, so they skip elsewhere.  The file imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in ``tests/test_torch_epilogue.py``: float32 at
``atol=rtol=2e-6`` (sums in another order), bfloat16 at one bfloat16 step.
"""

import math
import os

import pytest
import torch

from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.ops import epilogue
from fedml_tpu_torch.ops import pallas_attention as attn
from fedml_tpu_torch.ops import wire_compression as wc
from fedml_tpu_torch.utils.compression import WireCodec
from fedml_tpu_torch.utils.tree import tree_leaves, tree_map
from fedml_tpu_torch.utils.weights import tree_from_module

# cuBLAS's deterministic workspace, for the fused rounds' bit-for-bit check
# under torch.use_deterministic_algorithms (read when cuBLAS is first used)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

F32_TOL = dict(atol=2e-6, rtol=2e-6)
BF16_TOL = dict(atol=1e-6, rtol=2.0 ** -8)

# (C, D, dtype, weights): the CPU cases of test_torch_epilogue.py, ragged
# widths on both the 16-byte and the one-column path, 1024 clients, and the
# ResNet-56 flat buffer of the Parrot round
CASES = {
    "f32": (5, 910, torch.float32, "pos"),
    "bf16": (5, 910, torch.bfloat16, "pos"),
    "masked": (6, 910, torch.float32, "masked"),
    "all_zero": (4, 910, torch.float32, "zero"),
    "int32": (5, 9, torch.int32, "pos"),
    "one_client": (1, 9, torch.float32, "pos"),
    "ragged": (3, 1027, torch.float32, "pos"),
    "ragged_bf16": (3, 1031, torch.bfloat16, "pos"),
    "c1024": (1024, 4099, torch.float32, "pos"),
    "resnet56": (10, 860032, torch.float32, "pos"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(name, card):
    c, d, dtype, kind = CASES[name]
    gen = torch.Generator().manual_seed(len(name))
    if dtype == torch.int32:
        x = torch.randint(0, 50, (c, d), generator=gen, dtype=dtype)
    else:
        x = torch.randn(c, d, generator=gen).to(dtype)
    w = torch.rand(c, generator=gen) * 2.5 + 0.5
    if kind == "masked":
        w[[1, 4]] = 0.0
    elif kind == "zero":
        w.zero_()
    x, w = x.to(card), w.to(card)
    before = epilogue.LAUNCHES["weighted_reduce"]
    got = epilogue.weighted_reduce(x, w)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["weighted_reduce"] == before + 1
    ref = epilogue.weighted_reduce_reference(x, w)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    w = torch.ones(3, device=card)
    with pytest.raises(TypeError):
        epilogue.weighted_reduce(torch.zeros(3, 4, device=card,
                                             dtype=torch.float16), w)
    with pytest.raises(ValueError):
        epilogue.weighted_reduce(torch.zeros(4, 3, device=card).t(), w)
    with pytest.raises(ValueError):
        epilogue.weighted_reduce(torch.zeros(2, 4, device=card), w)
    with pytest.raises(TypeError):
        epilogue.weighted_reduce(torch.zeros(3, 4, device=card), w.double())


@pytest.mark.gpu
def test_weighted_reduce_takes_a_column_range(card):
    """The BatchNorm columns [P, D) of the round's [10, 860,032] buffer:
    row stride 860,032, 4,256 columns, written into a slice of the new
    global."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(10, 860032, generator=gen).to(card)
    w = (torch.rand(10, generator=gen) + 0.5).to(card)
    cols = x[:, 855776:]
    out = torch.zeros(860032, device=card)
    got = epilogue.weighted_reduce(cols, w, out=out[855776:])
    torch.cuda.synchronize()
    assert got.data_ptr() == out[855776:].data_ptr()
    torch.testing.assert_close(got, epilogue.weighted_reduce_reference(
        cols.contiguous(), w), **F32_TOL)
    assert bool((out[:855776] == 0).all())


def _card_payloads(card, n=3):
    gen = torch.Generator().manual_seed(11)
    return [(float(10 + c), {"params": {"Dense_0": {
        "kernel": torch.randn(60, 10, generator=gen).to(card),
        "bias": torch.randn(10, generator=gen).to(card)}}})
        for c in range(n)]


@pytest.mark.gpu
def test_cross_silo_funnel_launches_the_kernel_once(card):
    """Payloads on the card: one weighted-reduce launch for the round,
    the plain sample-weighted mean's values."""
    pairs = _card_payloads(card)
    before = epilogue.LAUNCHES["weighted_reduce"]
    got = FedMLAggOperator.agg(Config(), pairs)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["weighted_reduce"] == before + 1
    total = sum(n for n, _ in pairs)
    for i, leaf in enumerate(tree_leaves(got)):
        want = sum(n / total * tree_leaves(t)[i] for n, t in pairs)
        torch.testing.assert_close(leaf, want, **F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "tree"])
def test_cross_silo_funnel_raises_on_payloads_that_do_not_stack(fault,
                                                                  card):
    """On a card no kernel takes payloads that do not stack into one
    ``[C, D]`` buffer per dtype, so the funnel raises instead of averaging
    them leaf by leaf in plain PyTorch."""
    pairs = _card_payloads(card)
    dense = pairs[1][1]["params"]["Dense_0"]
    if fault == "dtype":
        dense["kernel"] = dense["kernel"].bfloat16()
    elif fault == "shape":
        dense["kernel"] = dense["kernel"][:59]
    elif fault == "device":
        dense["kernel"] = dense["kernel"].cpu()
    else:
        dense["extra"] = dense["bias"].clone()
    before = epilogue.LAUNCHES["weighted_reduce"]
    with pytest.raises(ValueError, match="do not stack"):
        FedMLAggOperator.agg(Config(), pairs)
    assert epilogue.LAUNCHES["weighted_reduce"] == before


# (opt, C, P, stacked dtype, global dtype, weights, s, t): every channel
# on float32 and bfloat16 stacked buffers; masked and all-zero weights; one
# client and 1,024; a ragged P on the one-column path; adam at t = 1 (zero
# state) and t = 5 (random state); s != 1 for mix and sgd; and the FedOpt
# round's parameter columns of a [10, 860,032] buffer (row stride 860,032)
FUSED_CASES = {
    **{f"{o}_f32": (o, 5, 910, torch.float32, torch.float32, "pos", 0.7, 5)
       for o in ("none", "sgd", "momentum", "adam")},
    **{f"{o}_bf16": (o, 5, 910, torch.bfloat16, torch.float32, "pos", 0.7, 5)
       for o in ("none", "sgd", "momentum", "adam")},
    "adam_bf16_global": ("adam", 5, 910, torch.bfloat16, torch.bfloat16,
                         "pos", 1.0, 5),
    "sgd_masked": ("sgd", 6, 910, torch.float32, torch.float32, "masked",
                   1.0, 0),
    "momentum_all_zero": ("momentum", 4, 910, torch.float32, torch.float32,
                          "zero", 1.0, 0),
    "adam_one_client": ("adam", 1, 9, torch.float32, torch.float32, "pos",
                        1.0, 5),
    "mix_c1024": ("none", 1024, 4099, torch.float32, torch.float32, "pos",
                  0.5, 0),
    "adam_ragged": ("adam", 3, 1027, torch.float32, torch.float32, "pos",
                    1.0, 5),
    "adam_t1": ("adam", 5, 910, torch.float32, torch.float32, "pos", 1.0, 0),
    "adam_round": ("adam", 10, 855776, torch.float32, torch.float32, "pos",
                   1.0, 0),
}


def _fused_inputs(name, card):
    opt, c, p, xdt, gdt, kind, s, t = FUSED_CASES[name]
    gen = torch.Generator().manual_seed(len(name))
    ld = 860032 if name == "adam_round" else p
    x = torch.randn(c, ld, generator=gen).to(xdt)[:, :p]
    g = torch.randn(p, generator=gen).to(gdt)
    w = torch.rand(c, generator=gen) * 2.5 + 0.5
    if kind == "masked":
        w[[1, 4]] = 0.0
    elif kind == "zero":
        w.zero_()
    st = None
    if opt == "momentum":
        st = {"m": torch.randn(p, generator=gen)}
    elif opt == "adam":
        st = {"m": torch.randn(p, generator=gen) * (t > 0),
              "v": torch.rand(p, generator=gen) * (t > 0), "t": t}
    move = {k: v.to(card) if isinstance(v, torch.Tensor) else v
            for k, v in (st or {}).items()} or None
    spec = epilogue.EpilogueSpec(opt=opt, lr=0.1)
    return x.to(card), g.to(card), w.to(card), s, spec, move


def _clone(st):
    return None if st is None else {
        k: v.clone() if isinstance(v, torch.Tensor) else v
        for k, v in st.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_epilogue_matches_plain_version(name, card):
    """Tolerance ``atol = rtol = 2e-6``: the kernel and the plain version
    sum the clients in another order (a float32 ulp of the reduce), and
    round every other operation alike (the source is built without fma
    contraction).  A bfloat16 global at one bfloat16 step."""
    x, g, w, s, spec, st = _fused_inputs(name, card)
    key = f"fused_epilogue.{spec.opt}"
    before = epilogue.LAUNCHES[key]
    got, got_st = epilogue.fused_epilogue(g, x, w, s, spec, _clone(st))
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES[key] == before + 1
    ref, ref_st = epilogue.fused_epilogue_reference(g, x, w, s, spec,
                                                    _clone(st))
    assert got.dtype == ref.dtype == g.dtype and got.shape == ref.shape
    tol = BF16_TOL if g.dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    if ref_st is not None:
        for k in ("m", "v"):
            if k in ref_st:
                torch.testing.assert_close(got_st[k], ref_st[k], **F32_TOL)
        assert got_st.get("t") == ref_st.get("t")


@pytest.mark.gpu
def test_fused_epilogue_updates_in_place(card):
    """out may be the global itself, and m, v are updated in place."""
    x, g, w, s, spec, st = _fused_inputs("adam_f32", card)
    ref, ref_st = epilogue.fused_epilogue_reference(g, x, w, s, spec,
                                                    _clone(st))
    m_ptr = st["m"].data_ptr()
    got, got_st = epilogue.fused_epilogue(g, x, w, s, spec, st, out=g)
    torch.cuda.synchronize()
    assert got.data_ptr() == g.data_ptr()
    assert got_st["m"].data_ptr() == m_ptr and got_st["t"] == 6
    torch.testing.assert_close(got, ref, **F32_TOL)
    torch.testing.assert_close(st["v"], ref_st["v"], **F32_TOL)


@pytest.mark.gpu
def test_fused_epilogue_refuses_what_it_does_not_take(card):
    g = torch.zeros(8, device=card)
    x = torch.zeros(3, 8, device=card)
    w = torch.ones(3, device=card)
    adam = epilogue.EpilogueSpec(opt="adam")
    st = {"m": torch.zeros(8, device=card), "v": torch.zeros(8, device=card),
          "t": 0}
    with pytest.raises(TypeError):       # float16 stacked
        epilogue.fused_epilogue(g, x.half(), w)
    with pytest.raises(TypeError):       # float64 weights
        epilogue.fused_epilogue(g, x, w.double())
    with pytest.raises(TypeError):       # bfloat16 state
        epilogue.fused_epilogue(g, x, w, 1.0, adam,
                                dict(st, m=st["m"].bfloat16()))
    with pytest.raises(ValueError):      # weights on the CPU
        epilogue.fused_epilogue(g, x, w.cpu())
    with pytest.raises(ValueError):      # a transposed stacked buffer
        epilogue.fused_epilogue(g, torch.zeros(8, 3, device=card).t(), w)
    with pytest.raises(ValueError):      # a strided global
        epilogue.fused_epilogue(torch.zeros(16, device=card)[::2], x, w)
    with pytest.raises(ValueError):      # state of another length
        epilogue.fused_epilogue(g, x, w, 1.0, adam,
                                dict(st, v=torch.zeros(7, device=card)))
    with pytest.raises(ValueError):      # clients and weights disagree
        epilogue.fused_epilogue(g, x, torch.ones(2, device=card))


@pytest.mark.gpu
@pytest.mark.parametrize("opt, t, count", [
    ("adam", t, count) for t in (1, 2, 3, 300) for count in ("device", "host")]
    + [(o, 1, None) for o in ("none", "sgd", "momentum")])
def test_fused_epilogue_reads_its_step_row_from_the_device(opt, t, count,
                                                           card):
    """The kernel with the step's row read from a device table — adam's t
    in a device tensor, advanced in place, or a host int passed by value —
    against the plain version with the step rounded on the host, at t = 1,
    2, 3 and 300 and in every channel."""
    x, g, w, s, spec, st = _fused_inputs(f"{opt}_f32", card)
    steps = epilogue.step_rows(s, spec, 300, card)
    ref_st = _clone(st)
    if opt == "adam":
        ref_st["t"] = st["t"] = t - 1
        if count == "device":
            st["t"] = torch.tensor(t - 1, dtype=torch.int64, device=card)
    ref, ref_st = epilogue.fused_epilogue_reference(g, x, w, s, spec, ref_st)
    got, got_st = epilogue.fused_epilogue(g, x, w, s, spec, st, steps=steps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **F32_TOL)
    for k in ("m", "v"):
        if ref_st is not None and k in ref_st:
            torch.testing.assert_close(got_st[k], ref_st[k], **F32_TOL)
    if count == "device":
        assert got_st["t"] is st["t"] and int(st["t"]) == t
    elif opt == "adam":
        assert got_st["t"] == t and st["t"] == t - 1


@pytest.mark.gpu
def test_a_captured_fused_epilogue_takes_each_replays_step(card):
    """Adam's launch captured once into a CUDA graph: each replay takes
    its own step's row (t advances on the device), held step by step
    against the plain version from the kernel's own state."""
    x, g, w, s, spec, st = _fused_inputs("adam_f32", card)
    steps = epilogue.step_rows(s, spec, 10, card)
    st["t"] = torch.zeros((), dtype=torch.int64, device=card)
    out = torch.empty_like(g)
    epilogue._kernel_lib("fused_epilogue")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        epilogue.fused_epilogue(g, x, w, s, spec, st, out=out, steps=steps)
    for step in range(1, 4):
        before = {"m": st["m"].clone(), "v": st["v"].clone(), "t": step - 1}
        graph.replay()
        ref, ref_st = epilogue.fused_epilogue_reference(g, x, w, s, spec,
                                                        before)
        torch.cuda.synchronize()
        assert int(st["t"]) == step
        torch.testing.assert_close(out, ref, **F32_TOL)
        for k in ("m", "v"):
            torch.testing.assert_close(st[k], ref_st[k], **F32_TOL)


# ------------------------------------------------------------ fused rounds
def _fused_api(card, tmp_path, lm=False, **kw):
    """A ParrotAPI on the card at the CPU tests' size (ResNet-8, float32):
    8 clients, 4 a round in 2 size strata capped at 0.5, so the round draws
    clients and window starts on the device.  ``lm``: the full-width
    ``TinyTransformerLM`` at dropout 0.1, float32, on Fed-Shakespeare (8
    clients, 4 a round, batch 8), so every batch draws its dropout masks
    from the round's second card generator."""
    from fedml_tpu_torch.data import data_loader
    from fedml_tpu_torch.ml.engine.model_bundle import TASK_LM, ModelBundle
    from fedml_tpu_torch.models.nlp import TinyTransformerLM
    from fedml_tpu_torch.simulation.parrot.parrot_api import ParrotAPI

    base = dict(dataset="cifar10", backend="parrot",
                partition_method="hetero", client_num_in_total=8,
                client_num_per_round=4, comm_round=8, epochs=1,
                batch_size=16, learning_rate=0.05, data_scale=0.05,
                compute_dtype="float32", enable_tracking=False,
                hetero_buckets=2, hetero_bucket_cap=0.5,
                data_cache_dir=str(tmp_path))
    if lm:
        base.update(dataset="fed_shakespeare", model="bert_tiny",
                    batch_size=8, hetero_buckets=1, hetero_bucket_cap=0.0)
    args = Config(**dict(base, **kw))
    torch.manual_seed(0)
    if lm:
        bundle = ModelBundle(TinyTransformerLM(dropout=0.1), (80,), 90,
                             task=TASK_LM, input_dtype=torch.int32)
    else:
        bundle = ModelBundle(CIFARResNet(depth=8, num_classes=10),
                             (32, 32, 3), 10)
    return ParrotAPI(args, card, data_loader.load(args), bundle)


FUSED_ALGOS = {"FedAvg": {},
               "FedOpt": dict(federated_optimizer="FedOpt",
                              server_optimizer="adam")}
#: the replay check's cases: FUSED_ALGOS, config 3's model at dropout 0.1
#: (server adam 0.1), and the unfused adam and yogi, their step count on
#: the device
REPLAY_CASES = {
    **FUSED_ALGOS,
    "LM-dropout": dict(lm=True, federated_optimizer="FedOpt",
                       server_optimizer="adam", server_lr=0.1),
    "unfused-adam": dict(federated_optimizer="FedOpt",
                         server_optimizer="adam", fused_epilogue=False),
    "yogi": dict(federated_optimizer="FedOpt", server_optimizer="yogi")}


def _round_state(api):
    """Copies of what a round changes: the globals, the server state's
    tensors (the device step counts among them) and the generators'
    states."""
    opt = api.server_state.get("opt_state", {})
    return {"global": {dt: f.clone() for dt, f in api.global_vars.items()},
            "opt": {dt: {k: v.clone() for k, v in (st or {}).items()
                         if isinstance(v, torch.Tensor)}
                    for dt, st in opt.items()},
            "gen": api._fgen.get_state(),
            "dgen": None if api._dgen is None else api._dgen.get_state()}


def _set_round_state(api, state):
    for dt, f in api.global_vars.items():
        f.copy_(state["global"][dt])
    for dt, st in api.server_state.get("opt_state", {}).items():
        for k, v in state["opt"][dt].items():
            st[k].copy_(v)
    api._fgen.set_state(state["gen"])
    if state["dgen"] is not None:
        api._dgen.set_state(state["dgen"])


def _step_count(state):
    st = state["opt"].get(torch.float32, {})
    count = st.get("t", st.get("count"))
    return None if count is None else int(count)


def _assert_same_rounds(rows_a, a, rows_b, b):
    assert torch.equal(rows_a, rows_b)
    assert torch.equal(a["gen"], b["gen"])
    if a["dgen"] is not None:
        assert torch.equal(a["dgen"], b["dgen"])
    for dt in a["global"]:
        assert torch.equal(a["global"][dt], b["global"][dt])
    for dt, st in a["opt"].items():
        for k in st:
            assert torch.equal(st[k], b["opt"][dt][k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("algo", sorted(REPLAY_CASES))
def test_replayed_rounds_equal_uncaptured_rounds(algo, card, tmp_path):
    """From the same globals, server state and generator states, two
    replays of the captured round and two uncaptured runs of its body give
    the same bits, under deterministic algorithms: metrics, globals, the
    server state (device step counts included) and the generators' states
    after."""
    torch.use_deterministic_algorithms(True)
    try:
        api = _fused_api(card, tmp_path, **REPLAY_CASES[algo])
        api.run_rounds_fused(1)      # a real round uncaptured, then capture
        start = _round_state(api)
        replayed = api._fused_chunk(2).clone()
        assert api._last_replays == 2
        after = _round_state(api)
        _set_round_state(api, start)
        rows = []
        for _ in range(2):
            api._fused_round()
            rows.append(api._rm.clone())
        eager = _round_state(api)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    _assert_same_rounds(replayed, after, torch.stack(rows), eager)
    for dt in after["global"]:
        assert not torch.equal(after["global"][dt], start["global"][dt])
    if algo != "FedAvg":
        assert _step_count(after) == 3
    assert (api._dgen is not None) == (algo == "LM-dropout")


@pytest.mark.gpu
def test_a_reseed_between_replays_runs_a_fresh_apis_rounds(card, tmp_path):
    """``run_rounds_fused(2, rng=9)`` on an API whose round is captured
    (both rounds replays, the generators reseeded between replays) gives
    the bits of a fresh API, from the same globals and server state, run
    with ``rng=9`` (its first round uncaptured, its second a replay of its
    own capture), under deterministic algorithms: config 3's model at
    dropout 0.1, so both generators are reseeded."""
    torch.use_deterministic_algorithms(True)
    try:
        kw = REPLAY_CASES["LM-dropout"]
        api = _fused_api(card, tmp_path, **kw)
        api.run_rounds_fused(1)
        start = _round_state(api)
        t = _step_count(start)
        got = api.run_rounds_fused(2, rng=9)
        assert api._last_replays == 2
        after = _round_state(api)

        fresh = _fused_api(card, tmp_path, **kw)
        for dt, f in fresh.global_vars.items():
            f.copy_(start["global"][dt])
        for dt, st in fresh.server_state["opt_state"].items():
            for k, v in start["opt"][dt].items():
                if k == "t":
                    st[k] = t
                else:
                    st[k].copy_(v)
        want = fresh.run_rounds_fused(2, rng=9)
        assert fresh._last_replays == 1
        again = _round_state(fresh)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    for k in want:
        assert (got[k] == want[k]).all(), k
    for dt in after["global"]:
        assert torch.equal(after["global"][dt], again["global"][dt])
    for k in ("m", "v", "t"):
        assert torch.equal(after["opt"][torch.float32][k],
                           again["opt"][torch.float32][k]), k
    assert torch.equal(after["gen"], again["gen"])
    assert torch.equal(after["dgen"], again["dgen"])


@pytest.mark.gpu
def test_a_restored_round_replays_as_it_runs_uncaptured(card, tmp_path):
    """A checkpoint written to a file and restored into an API whose round
    is captured: one replay from the restored state equals one uncaptured
    run of the round body from the same restored state (and the same
    generator states), bit for bit, under deterministic algorithms — the
    restore wrote into the addresses the graph reads."""
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer

    torch.use_deterministic_algorithms(True)
    try:
        api = _fused_api(card, tmp_path, **FUSED_ALGOS["FedOpt"])
        api.run_rounds_fused(2)          # uncaptured, capture, one replay
        ckpt = RoundCheckpointer(str(tmp_path / "ckpt"))
        ckpt.save(1, api._checkpoint_state(1))
        api.run_rounds_fused(2)          # move on past the checkpoint
        api._restore_state(ckpt.restore())
        restored = _round_state(api)
        assert _step_count(restored) == 2
        replayed = api._fused_chunk(1).clone()
        assert api._last_replays == 1
        after = _round_state(api)
        api._restore_state(ckpt.restore())
        api._fgen.set_state(restored["gen"])
        api._fused_round()
        eager = _round_state(api)
        row = api._rm.clone()[None]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    _assert_same_rounds(replayed, after, row, eager)
    assert _step_count(after) == 3
    assert not torch.equal(after["global"][torch.float32],
                           restored["global"][torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("algo", sorted(FUSED_ALGOS))
def test_captured_round_holds_the_epilogue_nodes(algo, card, tmp_path):
    """One weighted-reduce node per dtype group on FedAvg; one
    fused-epilogue node and one weighted-reduce node (the BatchNorm
    columns) on FedOpt."""
    api = _fused_api(card, tmp_path, **FUSED_ALGOS[algo])
    api.run_rounds_fused(1)
    names = [n for kind, n in api.fused_graph_nodes() if kind == "kernel"]
    reduce = sum("weighted_reduce_kernel" in n for n in names)
    fused = sum("fused_epilogue_kernel" in n for n in names)
    if algo == "FedAvg":
        assert (reduce, fused) == (len(api.global_vars), 0)
    else:
        assert (reduce, fused) == (1, 1)
    assert len(names) > 100


@pytest.mark.gpu
def test_a_replayed_chunk_reads_nothing_on_the_host(card, tmp_path):
    """Under sync-debug mode "error" a chunk of replays raises nothing:
    no host read, no synchronising call."""
    api = _fused_api(card, tmp_path, **FUSED_ALGOS["FedOpt"])
    api.run_rounds_fused(1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        api._fused_chunk(3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert api._last_replays == 3
    loss = api.run_rounds_fused(2)["train_loss"]
    assert loss.shape == (2,) and bool(torch.isfinite(torch.from_numpy(
        loss)).all())


# ------------------------------------------------------------ flash attention
#: (atol, rtol) of the flash kernel against _reference_residuals: float32
#: sums in another order (the kernel's FMAs or tensor-core sums over key
#: tiles, the plain version's cuBLAS products) — the JAX package's own
#: tolerance for its kernel; a bfloat16 o at one to two bfloat16 steps
#: (2^-8 relative) after rounding float32 results that differ in their
#: last bits
FLASH_F32 = dict(atol=2e-5, rtol=2e-5)
FLASH_BF16 = dict(atol=1e-2, rtol=1e-2)
#: the most of a bfloat16 o's values that may round to another bfloat16
#: value than the plain version's (chip_smoke.FLASH_BF16_FLIPS): float32
#: results a few last bits apart flip a rounding rarely; p rounded to
#: bfloat16 without its low part (up to 2^-8 of p) flips over a third of
#: them, yet passes FLASH_BF16
FLASH_BF16_FLIPS = 0.01


def _flash_inputs(b, h, t, d, dtype, card, tk=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, n, d, generator=gen).to(dtype).to(card)
            for n in (t, tk or t, tk or t)]


def _check_partial(got, ref, dtype):
    for g, r, name in zip(got, ref, "olm"):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        tol = FLASH_BF16 if (name == "o" and dtype == torch.bfloat16) \
            else FLASH_F32
        torch.testing.assert_close(g.float(), r.float(), msg=name, **tol)
    if dtype == torch.bfloat16:
        flips = float((got[0] != ref[0]).float().mean())
        assert flips <= FLASH_BF16_FLIPS, f"o: {flips:.2%} of values differ"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", attn.HEAD_DIMS)
@pytest.mark.parametrize("t", [80, 200, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_version(causal, t, d, dtype, card):
    q, k, v = _flash_inputs(2, 2, t, d, dtype, card, seed=t + d)
    for t_valid in (t, t - 13):
        before = attn.LAUNCHES["flash_attention"]
        got = attn.flash_attention_residuals(q, k, v, causal, t_valid)
        torch.cuda.synchronize()
        assert attn.LAUNCHES["flash_attention"] == before + 1
        _check_partial(got, attn._reference_residuals(q, k, v, causal,
                                                      t_valid), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 16, 31, 32, 33, 65])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_at_short_lengths(causal, t, dtype, card):
    """Sequences around the float32 kernel's 16-row query blocks, 8-key
    groups and 64-key tiles, and the bfloat16 kernel's 32-row ones (the
    fed-LLM eval's T is 32), every head dim, with t_valid at T and ragged
    inside it (two thirds of T; 0 at T = 1); one launch a call."""
    for d in attn.HEAD_DIMS:
        q, k, v = _flash_inputs(4, 2, t, d, dtype, card, seed=31 * t + d)
        for t_valid in (t, t * 2 // 3):
            before = attn.LAUNCHES["flash_attention"]
            got = attn.flash_attention_residuals(q, k, v, causal, t_valid)
            torch.cuda.synchronize()
            assert attn.LAUNCHES["flash_attention"] == before + 1
            _check_partial(got, attn._reference_residuals(q, k, v, causal,
                                                          t_valid), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 2, 80, 64), (8, 2, 512, 64)])
def test_flash_bf16_o_rounds_as_the_plain_version(shape, card):
    """The language model's eval passes (BERT-tiny at 80 tokens and at
    max_len): o in bfloat16 is the plain version's float32 o rounded,
    but for a share under FLASH_BF16_FLIPS of its values."""
    q, k, v = _flash_inputs(*shape, torch.bfloat16, card, seed=24)
    got = attn.flash_attention_residuals(q, k, v, True)
    torch.cuda.synchronize()
    _check_partial(got, attn._reference_residuals(q, k, v, True),
                   torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tk", [160, 37])
def test_flash_kernel_with_another_key_length(tk, dtype, card):
    """Non-causal residuals over Tk != T keys, aligned and ragged."""
    q, k, v = _flash_inputs(3, 2, 80, 64, dtype, card, tk=tk)
    got = attn.flash_attention_residuals(q, k, v, causal=False)
    torch.cuda.synchronize()
    _check_partial(got, attn._reference_residuals(q, k, v, False), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_with_scores_of_large_magnitude(causal, dtype, card):
    """q and k times 8 (exact in both dtypes): scores 64 times larger, so
    the running row max moves by tens from tile to tile and the running l
    and o are rescaled often."""
    q, k, v = _flash_inputs(2, 2, 200, 64, dtype, card, seed=21)
    q, k = q * 8, k * 8
    got = attn.flash_attention_residuals(q, k, v, causal)
    torch.cuda.synchronize()
    _check_partial(got, attn._reference_residuals(q, k, v, causal), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_valid", [0, 1])
def test_flash_kernel_with_no_key_or_one(t_valid, dtype, card):
    """t_valid 0 masks every key (l 0, m -1e30, o 0, as the plain version
    gives) and 1 leaves key 0 alone; one launch each."""
    q, k, v = _flash_inputs(2, 2, 80, 64, dtype, card, seed=22)
    for causal in (True, False):
        before = attn.LAUNCHES["flash_attention"]
        got = attn.flash_attention_residuals(q, k, v, causal, t_valid)
        torch.cuda.synchronize()
        assert attn.LAUNCHES["flash_attention"] == before + 1
        _check_partial(got, attn._reference_residuals(q, k, v, causal,
                                                      t_valid), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_with_a_ragged_causal_length(dtype, card):
    """Causal T = 97: a multiple of neither query tile (32 or 64 rows) nor
    key tile (64 keys), with t_valid at T and inside the last tile."""
    q, k, v = _flash_inputs(2, 2, 97, 64, dtype, card, seed=23)
    for t_valid in (97, 70):
        got = attn.flash_attention_residuals(q, k, v, True, t_valid)
        torch.cuda.synchronize()
        _check_partial(got, attn._reference_residuals(q, k, v, True,
                                                      t_valid), dtype)


@pytest.mark.gpu
def test_flash_kernel_reads_and_writes_through_strides(card):
    """flash_mha hands the kernel [B, T, H, D] tensors as [B, H, T, D]
    views: no copy, and o comes back in the same layout."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(4, 80, 2, 64, generator=gen).bfloat16().to(card)
               for _ in range(3))
    got = attn.flash_mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.is_contiguous()
    ref = attn._reference(*(x.transpose(1, 2) for x in (q, k, v)), True)
    torch.testing.assert_close(got.float(), ref.transpose(1, 2).float(),
                               **FLASH_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_misaligned_rows(dtype, card):
    """Rows that do not start 16-byte aligned (a slice one element into a
    wider tensor): the wrapper copies them, and the kernel gives the plain
    version's values."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 2, 80, 65, generator=gen).to(dtype).to(card)
               [..., 1:] for _ in range(3))
    got = attn.flash_attention_residuals(q, k, v, True)
    torch.cuda.synchronize()
    _check_partial(got, attn._reference_residuals(q, k, v, True), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [80, 200])
def test_flash_attention_gradients_on_the_card(t, card):
    """The autograd path on the card (kernel forward, blockwise backward)
    against the same path on the CPU (plain forward, blockwise backward)."""
    cpu = _flash_inputs(2, 2, t, 64, torch.float32, "cpu", seed=t)
    do = torch.randn(2, 2, t, 64, generator=torch.Generator().manual_seed(1))
    grads = {}
    for dev in ("cpu", card):
        xs = [x.to(dev).requires_grad_(True) for x in cpu]
        out = attn.flash_attention(*xs, causal=True)
        grads[str(dev)] = [out] + list(torch.autograd.grad(
            out, xs, do.to(dev)))
    for g, c in zip(grads[str(card)], grads["cpu"]):
        torch.testing.assert_close(g.detach().cpu(), c.detach(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(1, 2, 8, 48, device=card)
    with pytest.raises(ValueError):      # head dim 48
        attn.flash_attention_residuals(q, q, q)
    h = torch.zeros(1, 2, 8, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):       # float16
        attn.flash_attention_residuals(h, h, h)
    f = torch.zeros(1, 2, 8, 64, device=card)
    with pytest.raises(TypeError):       # mixed dtypes
        attn.flash_attention_residuals(f, f.bfloat16(), f.bfloat16())
    with pytest.raises(ValueError):      # k on the CPU
        attn.flash_attention_residuals(f, f.cpu(), f)
    with pytest.raises(ValueError):      # k, v of other shapes
        attn.flash_attention_residuals(f, f, torch.zeros(1, 2, 9, 64,
                                                         device=card))


# ------------------------------------------------------------ wire codec
def _wire_vector(d, seed=0):
    """float32 [d] whose 512-value rows cycle through random, all zero,
    values on .5 after scaling, max below 1e-30, above 1e30, all negative
    (``tests/test_torch_wire_compression.py``'s cases), a NaN among random
    values, and +inf and -inf among random values."""
    gen = torch.Generator().manual_seed(d + seed)
    x = torch.randn(d, generator=gen)
    for r in range(-(-d // wc.BLOCK)):
        lo, hi = r * wc.BLOCK, min(d, (r + 1) * wc.BLOCK)
        kind = (r + d) % 8
        if kind == 1:
            x[lo:hi] = 0.0
        elif kind == 2:
            v = torch.randint(-126, 127, (hi - lo,), generator=gen) + 0.5
            v[0] = 127.0
            x[lo:hi] = v
        elif kind == 3:
            x[lo:hi] *= 1e-33
        elif kind == 4:
            x[lo:hi] *= 1e35
        elif kind == 5:
            x[lo:hi] = -x[lo:hi].abs()
        elif kind == 6:
            x[lo + (hi - lo) // 2] = float("nan")
        elif kind == 7:
            x[lo] = float("inf")
            x[hi - 1] = -float("inf")
    return x


def _bits_equal(got, want):
    """Equal bits, where a NaN matches a NaN of any payload (the card and
    the CPU make NaNs of different signs)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.cpu(), want.cpu()
    if want.is_floating_point():
        nan = want.isnan()
        assert torch.equal(got.isnan(), nan)
        got, want = got[~nan], want[~nan]
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _resnet56_lengths():
    """One segment per leaf of ResNet-56's wire tree (287), in wire
    order: the broadcast's segment table."""
    tree = tree_from_module(CIFARResNet(depth=56, num_classes=10))
    return [leaf.numel() for leaf in tree_leaves(tree)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 511, 512, 513, 32 * 512 + 7, 100_000,
                               860_026])
def test_wire_kernels_match_plain_versions_bit_for_bit(d, card):
    x = _wire_vector(d)
    before = dict(wc.LAUNCHES)
    flat = wc.DEQUANT_FORMS["flat"]
    qflat = wc.QUANT_FORMS["flat"]
    q, s = wc.quantize_int8_blocked(x.to(card))
    out = wc.dequantize_int8_blocked(q, s, d)
    torch.cuda.synchronize()
    assert wc.LAUNCHES["quantize"] == before["quantize"] + 1
    assert wc.LAUNCHES["dequantize"] == before["dequantize"] + 1
    assert wc.DEQUANT_FORMS["flat"] == flat + 1
    assert wc.QUANT_FORMS["flat"] == qflat + 1
    want_q, want_s = wc.quantize_int8_reference(x)
    _bits_equal(q, want_q)
    _bits_equal(s, want_s)
    _bits_equal(out, wc.dequantize_int8_reference(want_q, want_s, d))
    # the plain version gives the same bits on the card (it divides by a
    # tensor: PyTorch's CUDA division by a scalar multiplies instead)
    card_q, card_s = wc.quantize_int8_reference(x.to(card))
    _bits_equal(card_q, want_q)
    _bits_equal(card_s, want_s)


@pytest.mark.gpu
def test_wire_kernels_keep_nan_and_inf_rows_visible(card):
    """Rows with a NaN, an infinity, or both: q all 0, the scale NaN (a
    NaN in the row) or inf, every value decoded NaN — the plain versions'
    results, so a diverged update is not sent as a finite one."""
    x = torch.randn(4 * wc.BLOCK, generator=torch.Generator().manual_seed(3))
    x[3] = float("nan")
    x[wc.BLOCK + 7] = float("inf")
    x[2 * wc.BLOCK + 9] = -float("inf")
    x[3 * wc.BLOCK + 1], x[3 * wc.BLOCK + 2] = float("nan"), float("inf")
    q, s = wc.quantize_int8_blocked(x.to(card))
    out = wc.dequantize_int8_blocked(q, s, x.numel())
    torch.cuda.synchronize()
    assert not q.any()
    assert s[0].isnan() and s[3].isnan()
    assert s[1].isinf() and s[2].isinf()
    assert out.isnan().all()
    want_q, want_s = wc.quantize_int8_reference(x)
    _bits_equal(q, want_q)
    _bits_equal(s, want_s)
    _bits_equal(out, wc.dequantize_int8_reference(want_q, want_s, x.numel()))


#: segment layouts, and the dequantize's launch form for each: ResNet-56's
#: 287 leaves (the broadcast) and a ragged table with an empty segment by
#: value, 2,100 segments of 1 to 3 values (past the by-value capacity of
#: 2,048 scale rows) through the device table
SEGMENT_LAYOUTS = {"resnet56_leaves": "by_value", "ragged": "by_value",
                   "past_capacity": "table"}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(SEGMENT_LAYOUTS))
def test_wire_kernels_take_a_segment_table_in_one_launch(layout, card):
    lengths = {"resnet56_leaves": _resnet56_lengths,
               "ragged": lambda: [700, 3, 0, 512, 1029, 1, 5000],
               "past_capacity": lambda: [1 + i % 3 for i in range(2100)],
               }[layout]()
    x = _wire_vector(sum(lengths), seed=1)
    before = dict(wc.LAUNCHES)
    forms = dict(wc.DEQUANT_FORMS)
    qforms = dict(wc.QUANT_FORMS)
    q, s = wc.quantize_int8_blocked(x.to(card), lengths)
    out = wc.dequantize_int8_blocked(q, s, q.numel(), lengths)
    torch.cuda.synchronize()
    assert wc.LAUNCHES["quantize"] == before["quantize"] + 1
    assert wc.LAUNCHES["dequantize"] == before["dequantize"] + 1
    form = SEGMENT_LAYOUTS[layout]
    assert wc.DEQUANT_FORMS[form] == forms[form] + 1
    assert wc.QUANT_FORMS[form] == qforms[form] + 1
    want_q, want_s = wc.quantize_int8_blocked(x, lengths)
    _bits_equal(q, want_q)
    _bits_equal(s, want_s)
    _bits_equal(out, wc.dequantize_int8_blocked(want_q, want_s, q.numel(),
                                                lengths))


@pytest.mark.gpu
def test_wire_kernels_take_rows_that_are_not_aligned(card):
    """A vector starting 4 bytes into its buffer: no row is 16-byte
    aligned, so every row takes the masked scalar path."""
    x = _wire_vector(5 * 512 + 1, seed=2)
    base = torch.zeros(x.numel() + 1, device=card)
    base[1:] = x.to(card)
    q, s = wc.quantize_int8_blocked(base[1:])
    qbase = torch.zeros(q.numel() + 1, dtype=torch.int8, device=card)
    qbase[1:] = q
    out = wc.dequantize_int8_blocked(qbase[1:], s, q.numel())
    torch.cuda.synchronize()
    want_q, want_s = wc.quantize_int8_reference(x)
    _bits_equal(q, want_q)
    _bits_equal(s, want_s)
    _bits_equal(out, wc.dequantize_int8_reference(want_q, want_s,
                                                  x.numel()))


#: the quantize's three launch forms over segments whose rows hold a NaN,
#: +inf, -inf, or a NaN and +inf: one segment (flat), segments by value,
#: and past the by-value capacity (the device table)
NON_FINITE_LAYOUTS = {"flat": None, "by_value": [700, 3, 0, 512, 1029, 4],
                      "table": [1 + i % 3 for i in range(2100)] + [2048]}


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(NON_FINITE_LAYOUTS))
def test_quantize_forms_keep_nan_and_inf_rows_visible(form, card):
    """Every launch form of the quantize: a row with a NaN has a NaN scale,
    one with an infinity an inf scale, q 0 in both, as the plain version
    gives them; the integer max of |x|'s bits orders NaN above inf."""
    lengths = NON_FINITE_LAYOUTS[form]
    d = sum(lengths) if lengths else 4 * wc.BLOCK
    x = torch.randn(d, generator=torch.Generator().manual_seed(13))
    last = d - 2048 if form == "table" else 0    # the last segment's rows
    for r, kinds in enumerate(("nan", "inf", "-inf", "nan inf")):
        at = last + r * wc.BLOCK + 5 if form != "by_value" else [
            1, 704, 1216, 1800][r]
        for i, kind in enumerate(kinds.split()):
            x[at + i] = float(kind)
    forms = dict(wc.QUANT_FORMS)
    q, s = wc.quantize_int8_blocked(x.to(card), lengths)
    torch.cuda.synchronize()
    assert wc.QUANT_FORMS[form] == forms[form] + 1
    want_q, want_s = wc.quantize_int8_blocked(x, lengths)
    assert bool(want_s.isnan().any()) and bool(want_s.isinf().any())
    _bits_equal(q, want_q)
    _bits_equal(s, want_s)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["by_value", "table"])
def test_quantize_forms_take_rows_that_are_not_aligned(form, card):
    """Segments over a vector that starts 4 bytes into its buffer, in the
    by-value and the table forms: no row is 16-byte aligned, every row
    takes the masked scalar loads."""
    lengths = {"by_value": [700, 3, 0, 512, 1029, 1, 5000],
               "table": [1 + i % 3 for i in range(2100)] + [1537]}[form]
    x = _wire_vector(sum(lengths), seed=4)
    base = torch.zeros(x.numel() + 1, device=card)
    base[1:] = x.to(card)
    forms = dict(wc.QUANT_FORMS)
    q, s = wc.quantize_int8_blocked(base[1:], lengths)
    torch.cuda.synchronize()
    assert wc.QUANT_FORMS[form] == forms[form] + 1
    want_q, want_s = wc.quantize_int8_blocked(x, lengths)
    _bits_equal(q, want_q)
    _bits_equal(s, want_s)


@pytest.mark.gpu
def test_encode_and_decode_model_on_the_card_match_the_cpu(card):
    """A whole model's broadcast: one quantize and one dequantize launch,
    the same bits as the CPU's encode and decode."""
    tree = tree_from_module(CIFARResNet(depth=8, num_classes=10))
    on_card = tree_map(lambda t: t.to(card), tree)
    before = dict(wc.LAUNCHES)
    enc = WireCodec.encode_model(on_card)
    dec = WireCodec.decode_model(enc)
    torch.cuda.synchronize()
    assert wc.LAUNCHES["quantize"] == before["quantize"] + 1
    assert wc.LAUNCHES["dequantize"] == before["dequantize"] + 1
    want = WireCodec.decode_model(WireCodec.encode_model(tree))
    for g, w in zip(tree_leaves(dec), tree_leaves(want)):
        _bits_equal(g, w)


@pytest.mark.gpu
def test_wire_kernels_refuse_what_they_do_not_take(card):
    with pytest.raises(TypeError):
        wc.quantize_int8_blocked(torch.zeros(600, dtype=torch.float64,
                                             device=card))
    with pytest.raises(TypeError):
        wc.quantize_int8_blocked(torch.zeros(600, dtype=torch.bfloat16,
                                             device=card))
    q, s = wc.quantize_int8_blocked(torch.ones(600, device=card))
    with pytest.raises(ValueError):
        wc.dequantize_int8_blocked(q, s, 599)
    with pytest.raises(ValueError):
        wc.dequantize_int8_blocked(q, s[:1], 600)
    with pytest.raises(ValueError):
        wc.dequantize_int8_blocked(q, s.cpu(), 600)
    with pytest.raises(ValueError):
        wc.quantize_int8_blocked(torch.ones(600, device=card), [300, 200])


# ------------------------------------------------ top-k ties (the wire codec)
def _tied_delta(seed=7):
    """4,096 float32 values of four magnitudes with random signs: the k-th
    largest |x| of ``topk:0.1`` falls inside a run of ties."""
    gen = torch.Generator().manual_seed(seed)
    mags = torch.tensor([0.5, 0.25, 2.0 ** -6, 2.0 ** -10])
    sign = torch.where(torch.rand(4096, generator=gen) < 0.5, -1.0, 1.0)
    return mags[torch.randint(0, 4, (4096,), generator=gen)] * sign


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["topk:0.1", "topk8:0.1"])
def test_topk_ties_select_on_the_card_what_the_cpu_selects(spec, card):
    """On ties the card selects the CPU's coordinates in the CPU's order
    (the CPU is held to ``jax.lax.top_k`` by the CPU tests): indices,
    values and the error-feedback residual bit for bit over three
    encodes."""
    x = _tied_delta()
    got_v, got_i = wc.topk_select(x.to(card), 409)
    want_v, want_i = wc.topk_select(x, 409)
    _bits_equal(got_i, want_i)
    _bits_equal(got_v, want_v)
    ref = {"w": torch.zeros(4096)}
    on_card, on_cpu = WireCodec(spec), WireCodec(spec)
    for step in range(3):
        update = {"w": _tied_delta(8 + step)}
        got = on_card.encode_delta(tree_map(lambda t: t.to(card), update),
                                   tree_map(lambda t: t.to(card), ref))
        want = on_cpu.encode_delta(update, ref)
        for k in ("idx", "values", "values_q", "scales"):
            if k in want:
                _bits_equal(got[k], want[k])
        _bits_equal(on_card._residual, on_cpu._residual)


# ------------------------------------------------------ the adapter fold (B6)
#: (d_in, d_out) of TinyTransformerLM's five LoRA targets
LORA_TARGETS = [(128, 90), (128, 512), (512, 128), (128, 512), (512, 128)]


def _adapter_tree(rank, dtype, card, seed, misalign=0):
    """The BERT-tiny adapter table at ``rank`` (10 leaves) and a float32
    delta of the same shapes, each a tree of views into one buffer;
    ``misalign`` starts the adapters' buffer that many values in, so no
    leaf is 16-byte aligned."""
    gen = torch.Generator().manual_seed(seed)
    shapes = []
    for i, (d_in, d_out) in enumerate(LORA_TARGETS):
        shapes += [(f"t{i}", "a", (d_in, rank)), (f"t{i}", "b", (rank, d_out))]
    total = sum(math.prod(s) for _, _, s in shapes)
    a_buf = (torch.randn(total + misalign, generator=gen) * 0.01).to(dtype)
    d_buf = torch.randn(total, generator=gen) * 1e-3
    a_buf, d_buf = a_buf.to(card), d_buf.to(card)
    a, d, off = {}, {}, 0
    for path, k, shape in shapes:
        n = math.prod(shape)
        a.setdefault(path, {})[k] = a_buf[misalign + off:
                                          misalign + off + n].view(shape)
        d.setdefault(path, {})[k] = d_buf[off:off + n].view(shape)
        off += n
    return a, d


FOLD_CASES = {
    f"{name}_{dt_name}_lr{lr}": (rank, dt, lr, mis)
    for name, rank, mis in (("rank4", 4, 0), ("rank3", 3, 0),
                            ("misaligned", 4, 1))
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))
    for lr in (0.0, 1.0, 0.37)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_fold_delta_matches_plain_version_bit_for_bit(name, card):
    """Kernel B6 against ``fold_delta_reference`` on the same card tensors:
    rank 4 (BERT-tiny's 10 leaves, 11,112 values), rank 3 (leaves that are
    no multiples of 4) and a buffer whose leaves start misaligned, float32
    and bfloat16 adapters, ``server_lr`` 0, 1 and 0.37 — one launch, equal
    bits."""
    rank, dtype, lr, mis = FOLD_CASES[name]
    a, d = _adapter_tree(rank, dtype, card, seed=len(name), misalign=mis)
    before = epilogue.LAUNCHES["fold_delta"]
    got = epilogue.fold_delta(a, d, lr)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["fold_delta"] == before + 1
    want = epilogue.fold_delta_reference(a, d, lr)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        _bits_equal(g, w)


def _views(buf, sizes, gap):
    """Views of ``sizes`` values into ``buf``, ``gap`` values apart."""
    out, off = [], 0
    for n in sizes:
        out.append(buf[off:off + n])
        off += n + gap
    return out


#: layout -> (leaf sizes, gap between the delta's leaves, launch form):
#: BERT-tiny's rank-4 leaves laid out alike (one flat range), the same
#: with 3 values between the delta's leaves, 120 leaves of 1 to 700
#: values with gaps (both a device table)
FOLD_FORM_CASES = {
    "alike": ([n for d_in, d_out in LORA_TARGETS for n in (4 * d_in,
                                                           4 * d_out)],
              0, "flat"),
    "gaps": ([n for d_in, d_out in LORA_TARGETS for n in (4 * d_in,
                                                          4 * d_out)],
             3, "table"),
    "many_leaves": ([1 + (97 * i) % 700 for i in range(120)], 5, "table"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", sorted(FOLD_FORM_CASES))
def test_fold_delta_launch_forms_match_bit_for_bit(layout, dtype, card):
    """Each launch form of ``fold_plan`` on the card, bit for bit against
    ``fold_delta_reference``, one launch counted under its form, into a
    new buffer and in place."""
    sizes, gap, form = FOLD_FORM_CASES[layout]
    gen = torch.Generator().manual_seed(len(sizes) + gap)
    total = sum(sizes) + gap * len(sizes)
    a_buf = (torch.randn(sum(sizes), generator=gen) * 0.01).to(dtype).to(card)
    d_buf = (torch.randn(total, generator=gen) * 1e-3).to(card)
    a = _views(a_buf, sizes, 0)
    d = _views(d_buf, sizes, gap)
    lib = epilogue._kernel_lib("fold_delta")
    assert lib.fedml_fold_delta_chunk() == 512
    for out in (None, a):
        want = epilogue.fold_delta_reference(a, d, 0.37)
        before = dict(epilogue.FOLD_FORMS), epilogue.LAUNCHES["fold_delta"]
        got = epilogue.fold_delta(a, d, 0.37, out=out)
        torch.cuda.synchronize()
        assert epilogue.LAUNCHES["fold_delta"] == before[1] + 1
        assert epilogue.FOLD_FORMS == {
            k: v + (k == form) for k, v in before[0].items()}
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            _bits_equal(g, w)


@pytest.mark.gpu
def test_fold_delta_in_place_and_mixed_dtypes(card):
    """``out`` = the adapters folds in place; a tree of float32 and
    bfloat16 leaves takes one launch per dtype; leaves that are not views
    of one buffer are packed first and still folded in one launch."""
    a, d = _adapter_tree(4, torch.float32, card, seed=1)
    want = epilogue.fold_delta_reference(a, d, 0.37)
    before = epilogue.LAUNCHES["fold_delta"]
    same = epilogue.fold_delta(a, d, 0.37, out=a)
    torch.cuda.synchronize()
    assert same is a and epilogue.LAUNCHES["fold_delta"] == before + 1
    for g, w in zip(tree_leaves(a), tree_leaves(want)):
        _bits_equal(g, w)
    mixed = {"x": {"a": a["t0"]["a"].clone(),
                   "b": a["t0"]["b"].to(torch.bfloat16)},
             "y": {"a": a["t1"]["a"].clone(), "b": a["t1"]["b"].clone()}}
    dm = {"x": d["t0"], "y": d["t1"]}
    before = epilogue.LAUNCHES["fold_delta"]
    got = epilogue.fold_delta(mixed, dm, 1.0)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["fold_delta"] == before + 2
    for g, w in zip(tree_leaves(got),
                    tree_leaves(epilogue.fold_delta_reference(mixed, dm,
                                                              1.0))):
        _bits_equal(g, w)


@pytest.mark.gpu
def test_fold_delta_refuses_what_it_does_not_take(card):
    """What the kernel does not take raises — it is never folded in plain
    PyTorch on the card, and nothing is launched."""
    a, d = _adapter_tree(4, torch.float32, card, seed=2)
    before = epilogue.LAUNCHES["fold_delta"]
    with pytest.raises(TypeError):
        epilogue.fold_delta(tree_map(lambda t: t.half(), a), d, 1.0)
    with pytest.raises(TypeError):
        epilogue.fold_delta(a, tree_map(lambda t: t.bfloat16(), d), 1.0)
    with pytest.raises(ValueError):
        epilogue.fold_delta(a, tree_map(lambda t: t.cpu(), d), 1.0)
    with pytest.raises(ValueError):
        epilogue.fold_delta(a, {"t0": d["t0"]}, 1.0)
    with pytest.raises(ValueError):
        epilogue.fold_delta(a, d, 1.0,
                            out=tree_map(lambda t: t.clone(), a))
    assert epilogue.LAUNCHES["fold_delta"] == before


def _fed_llm_round(device):
    """One fed-LLM round over INPROC — 2 silos, the full-width
    TinyTransformerLM at dropout 0 in float32, rank 4, seq 32, batch 4 —
    through the five-step entry on ``device``, from the same seeded
    variables: the final adapters, the metrics and the launch counts."""
    import fedml_tpu_torch
    from fedml_tpu_torch.ml.engine.model_bundle import TASK_LM, ModelBundle
    from fedml_tpu_torch.models.nlp import TinyTransformerLM

    args = fedml_tpu_torch.init(Config(
        dataset="shakespeare", model="transformer",
        training_type="cross_silo", backend="INPROC", role="simulated",
        client_num_in_total=2, client_num_per_round=2, comm_round=1,
        epochs=1, batch_size=4, learning_rate=3e-3, data_scale=0.05,
        frequency_of_the_test=1, random_seed=0, fed_llm=True, lora_rank=4,
        fed_llm_seq_len=32, compute_dtype="float32",
        run_id=f"cuda_fed_llm_{device.type}", device_type=device.type))
    dataset = fedml_tpu_torch.data.load(args)
    bundle = ModelBundle(TinyTransformerLM(
        dropout=0.0, generator=torch.Generator().manual_seed(0)), (80,), 90,
        task=TASK_LM, input_dtype=torch.int32)
    counts = (epilogue.LAUNCHES["fold_delta"],
              epilogue.LAUNCHES["weighted_reduce"],
              attn.LAUNCHES["flash_attention"])
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, bundle)
    metrics = runner.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launched = (epilogue.LAUNCHES["fold_delta"] - counts[0],
                epilogue.LAUNCHES["weighted_reduce"] - counts[1],
                attn.LAUNCHES["flash_attention"] - counts[2])
    final = runner.runner.server.aggregator.get_global_model_params()
    return final, metrics, launched


@pytest.mark.gpu
def test_fed_llm_round_on_the_card_matches_the_cpu(card):
    """One round card vs CPU from the same seeded model and adapters.  The
    silos' adam moves every factor element by about lr per step whatever
    its gradient's size, so an element whose gradient is at the level of
    the two devices' summation-order noise can move another way: every
    element within 2·lr·steps (0.006 × 31 steps), at least 99 % within
    1e-4, the eval loss at ``rtol=1e-4``.  The card round launches the fold
    once, the weighted reduce once and the flash kernel once per layer of
    every forward pass at dropout 0: each training step's and each eval
    batch's."""
    from fedml_tpu_torch.train.fed_llm.trainer import FED_LLM_TOKENS

    got, g_m, launched = _fed_llm_round(card)
    want, c_m, _ = _fed_llm_round(torch.device("cpu"))
    diffs = torch.cat([(g.cpu() - w).abs().reshape(-1) for g, w in
                       zip(tree_leaves(got), tree_leaves(want))])
    assert float(diffs.max()) <= 2 * 3e-3 * 31, float(diffs.max())
    assert float((diffs <= 1e-4).float().mean()) >= 0.99
    torch.testing.assert_close(g_m["test_loss"], c_m["test_loss"],
                               rtol=1e-4, atol=0)
    n_eval = -(-int(c_m["test_total"]) // (80 * 4))
    steps = sum(FED_LLM_TOKENS.for_run("cuda_fed_llm_cuda").values()) \
        // (32 * 4)
    assert launched == (1, 1, 2 * (steps + n_eval)), launched


# ------------------------------------------------ the multi-client conv
#: (K, B, H, W, Ci, Co, kh, kw, stride): tests/test_mc_conv.py's cases, a
#: stem-like Ci of 3 and a Co of 12 (the kernels' scalar paths), and two of
#: ResNet-56's shapes at 10 clients of batch 32
MC_CASES = {
    "s1": (3, 4, 8, 8, 16, 16, 3, 3, (1, 1)),
    "s2": (2, 4, 8, 8, 16, 32, 3, 3, (2, 2)),
    "shortcut_1x1_s2": (2, 4, 8, 8, 16, 32, 1, 1, (2, 2)),
    "odd_spatial": (2, 2, 5, 7, 8, 8, 3, 3, (1, 1)),
    "even_kernel": (2, 2, 6, 6, 8, 8, 2, 2, (1, 1)),
    "stem_ci3": (2, 4, 8, 8, 3, 16, 3, 3, (1, 1)),
    "co12": (2, 2, 6, 6, 8, 12, 3, 3, (1, 1)),
    "resnet56_16_16_s1": (10, 32, 32, 32, 16, 16, 3, 3, (1, 1)),
    "resnet56_16_32_s2": (10, 32, 32, 32, 16, 32, 3, 3, (2, 2)),
}
#: ResNet-56's deeper shapes and its stem at 10 clients of batch 32; one
#: client of batch 64 on 32x32, whose weight gradient splits its pixels
#: over more blocks than one thread-block cluster holds (the float32
#: scratch of partials and their ordered sum); and 3 channels on rows of 7
#: pixels, whose image rows are no 16-byte copy either (the kernels' scalar
#: staging)
MC_DEEP_CASES = {
    "resnet56_stem_3_16": (10, 32, 32, 32, 3, 16, 3, 3, (1, 1)),
    "resnet56_32_32_s1": (10, 32, 16, 16, 32, 32, 3, 3, (1, 1)),
    "resnet56_32_64_s2": (10, 32, 16, 16, 32, 64, 3, 3, (2, 2)),
    "resnet56_32_64_1x1_s2": (10, 32, 16, 16, 32, 64, 1, 1, (2, 2)),
    "resnet56_64_64_s1": (10, 32, 8, 8, 64, 64, 3, 3, (1, 1)),
    "one_client_past_a_cluster": (1, 64, 32, 32, 16, 16, 3, 3, (1, 1)),
    "ci3_rows_of_7": (2, 2, 7, 7, 3, 16, 3, 3, (1, 1)),
}


def _mc_case(name):
    """(shape, seed): MC_CASES are seeded by their sorted index and
    MC_DEEP_CASES from 100 on, so a case added to one leaves the other's
    inputs as they are."""
    if name in MC_CASES:
        return MC_CASES[name], sorted(MC_CASES).index(name)
    return MC_DEEP_CASES[name], 100 + sorted(MC_DEEP_CASES).index(name)


def _mc_inputs(name, dtype, card):
    (k, b, h, w_, ci, co, kh, kw, stride), seed = _mc_case(name)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(k, b, h, w_, ci, generator=gen)
    w = torch.randn(k, kh, kw, ci, co, generator=gen) * (ci * kh * kw) ** -0.5
    oh, ow = -(-h // stride[0]), -(-w_ // stride[1])
    g = torch.randn(k, b, oh, ow, co, generator=gen)
    return tuple(t.to(dtype).to(card) for t in (x, w, g)) + (stride,)


def _assert_sums_close(got, ref, abs_terms, n, label):
    """Sums of ``n`` float32 products in another order: within
    √n · 2^-23 · Σ|terms| (``abs_terms``), plus one bfloat16 step of the
    reference where the output is bfloat16."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, label
    g, r = got.float(), ref.float()
    assert bool(torch.isfinite(g).all()), label
    tol = math.sqrt(n) * 2.0 ** -23 * abs_terms.float() + 1e-30
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * r.abs()
    excess = float(((g - r).abs() - tol).max())
    assert excess <= 0, f"{label}: {excess:.3g} past the tolerance"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(MC_CASES) + sorted(MC_DEEP_CASES))
def test_mc_conv_kernels_match_plain_versions(name, dtype, card):
    """Forward, dx and dw on the card against the plain versions on the
    same inputs.  dx of a stride-1 odd conv is the forward kernel on
    flipped weights; the others take the library input gradient, held here
    against autograd through the library arm (one grouped conv) in float32, with
    cuDNN's TF32 off as the port's ``get_device`` sets it."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        _check_mc_conv_case(name, dtype, card)


def _check_mc_conv_case(name, dtype, card):
    from fedml_tpu_torch.ops import pallas_mc_conv as mc

    x, w, g, stride = _mc_inputs(name, dtype, card)
    _, kh, kw, ci, co = w.shape
    before = dict(mc.LAUNCHES)
    y = mc.mc_conv_fwd(x, w, stride)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["mc_conv.fwd"] == before["mc_conv.fwd"] + 1
    _assert_sums_close(y, mc.mc_conv_fwd_reference(x, w, stride),
                       mc.mc_conv_fwd_reference(x.abs(), w.abs(), stride)
                       .float(), kh * kw * ci, f"{name} forward")

    dw = mc.mc_conv_wgrad(x, g, kh, kw, stride)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["mc_conv.wgrad"] == before["mc_conv.wgrad"] + 1
    n = g.numel() // (g.shape[0] * co)
    _assert_sums_close(dw, mc.mc_conv_wgrad_reference(x, g, kh, kw, stride),
                       mc.mc_conv_wgrad_reference(x.abs(), g.abs(), kh, kw,
                                                  stride), n, f"{name} dw")
    assert torch.equal(dw, mc.mc_conv_wgrad(x, g, kh, kw, stride)), \
        f"{name}: dw differs from run to run"

    xr = x.detach().clone().requires_grad_(True)
    wr = w.detach().clone().requires_grad_(True)
    dx, dw_auto = torch.autograd.grad(mc.mc_conv(xr, wr, stride), (xr, wr), g)
    assert torch.equal(dw_auto, dw.to(dtype))
    if stride == (1, 1) and kh % 2 == 1:
        w_flip = w.flip(1, 2).transpose(3, 4)
        _assert_sums_close(dx, mc.mc_conv_fwd_reference(g, w_flip),
                           mc.mc_conv_fwd_reference(g.abs(), w_flip.abs())
                           .float(), kh * kw * co, f"{name} dx")
    else:
        xf = x.float().requires_grad_(True)
        (dx_f32,) = torch.autograd.grad(
            mc.conv_for_clients(xf, w.float(), stride, impl="library"), xf,
            g.float())
        abs_terms = mc._library_dx(x.shape, w.abs().float(),
                                   g.abs().float(), stride)
        _assert_sums_close(dx, dx_f32.to(dtype), abs_terms, kh * kw * co,
                           f"{name} library dx")


@pytest.mark.gpu
def test_mc_conv_refuses_what_it_does_not_take(card):
    from fedml_tpu_torch.ops import pallas_mc_conv as mc

    before = dict(mc.LAUNCHES)
    x = torch.zeros(2, 1, 4, 4, 8, device=card)
    w = torch.zeros(2, 3, 3, 8, 8, device=card)
    with pytest.raises(TypeError, match="one dtype"):
        mc.mc_conv_fwd(x.half(), w.half())
    with pytest.raises(TypeError, match="one dtype"):
        mc.mc_conv_wgrad(x.double(), x.double(), 3, 3)
    with pytest.raises(ValueError, match=r"\[K, B, H, W, Ci\]"):
        mc.mc_conv_fwd(x[0], w)
    with pytest.raises(ValueError, match="on the CPU or on one card"):
        mc.mc_conv_fwd(x, w.cpu())
    assert mc.LAUNCHES == before


# ------------------------------------- ops/pallas_ops: kernels 7, 8 and 9
@pytest.fixture
def card_fp32(card):
    """The card, with TF32 off for the plain versions' cuBLAS products, as
    the port's ``get_device`` sets it."""
    from fedml_tpu_torch.ml.engine.device import get_device

    return get_device(Config(device_type="cuda"))


def _misaligned(t, offset):
    """``t``'s values in a tensor whose data starts ``offset`` elements into
    its storage (not 16-byte aligned for offset 1)."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


#: (C, D, x dtype, weights, storage offset of x): the CPU tests' cases,
#: weights of every kernel type, ragged D (one column a thread), a
#: misaligned x, 1,024 clients and the ResNet-56 tree's flat [10, 860,026]
WAVG_CARD_CASES = {
    "jax_test": (10, 3000, torch.float32, "float", 0),
    "zero_weights": (10, 3000, torch.float32, "some_zero", 0),
    "all_zero_weights": (4, 777, torch.float32, "zero", 0),
    "one_client": (1, 777, torch.float32, "float", 0),
    "int32_weights": (10, 3000, torch.float32, "int32", 0),
    "int64_weights_ragged": (10, 3001, torch.float32, "int64", 0),
    "f64_weights": (5, 1024, torch.float32, "float64", 0),
    "bf16_ragged": (6, 777, torch.bfloat16, "float", 0),
    "bf16": (6, 1024, torch.bfloat16, "int32", 0),
    "misaligned": (10, 3000, torch.float32, "float", 1),
    "c1024": (1024, 4099, torch.float32, "float", 0),
    "resnet56": (10, 860026, torch.float32, "int32", 0),
}


def _wavg_card_inputs(name, card):
    c, d, dtype, kind, off = WAVG_CARD_CASES[name]
    gen = torch.Generator().manual_seed(sorted(WAVG_CARD_CASES).index(name))
    x = torch.randn(c, d, generator=gen).to(dtype)
    if kind in ("int32", "int64"):
        w = torch.randint(1, 600, (c,), generator=gen,
                          dtype=getattr(torch, kind))
    else:
        w = torch.rand(c, generator=gen, dtype=torch.float64)
        w = w.float() if kind != "float64" else w
        if kind == "some_zero":
            w[::3] = 0
        elif kind == "zero":
            w.zero_()
    return _misaligned(x.to(card), off), w.to(card)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WAVG_CARD_CASES))
def test_weighted_average_kernel_matches_plain_version(name, card_fp32):
    """Within C · 2^-24 · Σ_c |wn_c x_c|: a float32 sum of C terms in the
    kernel's order (clients in turn) against cuBLAS's."""
    from fedml_tpu_torch.ops import pallas_ops as po

    x, w = _wavg_card_inputs(name, card_fp32)
    before = po.LAUNCHES["pallas_ops.weighted_average"]
    got = po.weighted_average_flat(x, w)
    torch.cuda.synchronize()
    assert po.LAUNCHES["pallas_ops.weighted_average"] == before + 1
    ref = po.weighted_average_flat_reference(x, w)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    wn = po.normalized_weights(w)
    torch.testing.assert_close(wn, po.normalized_weights(w.cpu()).to(
        wn.device), rtol=0, atol=0)
    bound = x.shape[0] * 2.0 ** -24 * (wn.abs() @ x.float().abs()) + 1e-30
    excess = float(((got - ref).abs() - bound).max())
    assert excess <= 0, f"{name}: {excess:.3g} past the bound"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("d_mod4", [0, 1, 2, 3])
def test_weighted_average_kernel_at_every_row_offset(d_mod4, offset, dtype,
                                                     card_fp32):
    """Rows that start 0-3 elements past a 16-byte (bfloat16: 8-byte)
    chunk, from every D mod 4 and every base offset: within the bound of
    the plain version, and bit for bit the same sums as the same rows read
    from an aligned start."""
    from fedml_tpu_torch.ops import pallas_ops as po

    c, d = 7, 1000 + d_mod4
    gen = torch.Generator().manual_seed(10 * d_mod4 + offset)
    x = torch.randn(c, d, generator=gen).to(dtype).to(card_fp32)
    w = torch.randint(1, 600, (c,), generator=gen,
                      dtype=torch.int32).to(card_fp32)
    xo = _misaligned(x, offset)
    before = dict(po.WAVG_FORMS)
    got = po.weighted_average_flat(xo, w)
    torch.cuda.synchronize()
    assert po.WAVG_FORMS == dict(before, flat=before["flat"] + 1)
    ref = po.weighted_average_flat_reference(xo, w)
    wn = po.normalized_weights(w)
    bound = c * 2.0 ** -24 * (wn.abs() @ x.float().abs()) + 1e-30
    assert bool(((got - ref).abs() <= bound).all())
    assert torch.equal(got, po.weighted_average_flat(x, w))


def _form_tree(form, card):
    """(leaves, weights) laid out for one launch form: one leaf (with an
    empty one beside it); 23 float32 and bfloat16 leaves of every size mod
    4, each starting 0-3 elements into its storage, with leaves of 1-3
    values that share a warp's tile; 400 leaves, past the by-value
    capacity; and two leaves of 6.1 million columns in all, past its
    units."""
    gen = torch.Generator().manual_seed(len(form))
    c = 5
    if form == "flat":
        sizes, dtypes = [0, 1234, 0], [torch.float32] * 3
    elif form == "by_value":
        sizes = [1, 2, 3, 4, 5, 6, 7, 130, 33, 1027, 2, 3, 1, 500, 129,
                 4093, 64, 16, 1, 1, 77, 3000, 9]
        dtypes = [torch.bfloat16 if i % 3 == 1 else torch.float32
                  for i in range(len(sizes))]
    elif form == "table":
        sizes = [1 + (7 * i) % 13 for i in range(400)]
        dtypes = [torch.bfloat16 if i % 5 == 2 else torch.float32
                  for i in range(len(sizes))]
    else:   # "table_long"
        sizes, dtypes = [4000003, 2100001], [torch.float32, torch.bfloat16]
    leaves = []
    for i, (n, dt) in enumerate(zip(sizes, dtypes)):
        shape = (c, n) if i % 2 else (c, 1, n)
        x = torch.randn(shape, generator=gen).to(dt).to(card)
        leaves.append(_misaligned(x, i % 4))
    w = torch.randint(1, 600, (c,), generator=gen).to(card)
    return leaves, w


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["flat", "by_value", "table",
                                  "table_long"])
def test_agg_stacked_pallas_forms_match_the_flat_form_bit_for_bit(form,
                                                                   card_fp32):
    """Every launch form reads the leaves where they lie in one launch and
    gives, column for column, the flat form's bits over the leaves
    concatenated; float32 leaves of the result are views of one buffer."""
    from fedml_tpu_torch.ops import pallas_ops as po

    leaves, w = _form_tree(form, card_fp32)
    tree = {f"l{i:03d}": leaf for i, leaf in enumerate(leaves)}
    sizes = [leaf[0].numel() for leaf in leaves]
    want_form = form.split("_")[0] if form != "by_value" else form
    assert po.weighted_average_form(sizes) == want_form
    before, forms = dict(po.LAUNCHES), dict(po.WAVG_FORMS)
    got = po.agg_stacked_pallas(tree, w)
    torch.cuda.synchronize()
    assert po.LAUNCHES == dict(before, **{
        "pallas_ops.weighted_average":
            before["pallas_ops.weighted_average"] + 1})
    assert po.WAVG_FORMS == dict(forms, **{want_form: forms[want_form] + 1})
    flat = po.weighted_average_flat(torch.cat(
        [leaf.reshape(leaf.shape[0], -1).float() for leaf in leaves], 1), w)
    off = 0
    storages = set()
    for i, leaf in enumerate(leaves):
        out = got[f"l{i:03d}"]
        n = sizes[i]
        assert out.dtype == leaf.dtype and out.shape == leaf.shape[1:]
        assert torch.equal(out, flat[off:off + n].view(out.shape)
                           .to(leaf.dtype))
        if leaf.dtype == torch.float32 and n:
            storages.add(out.untyped_storage().data_ptr())
        off += n
    assert len(storages) <= 1


@pytest.mark.gpu
def test_agg_stacked_pallas_is_one_launch_and_casts_back(card_fp32):
    from fedml_tpu_torch.ops import pallas_ops as po

    gen = torch.Generator().manual_seed(3)
    tree = {"w": torch.randn(6, 17, 5, generator=gen).to(card_fp32),
            "b": torch.randn(6, 9, generator=gen).to(card_fp32)
            .to(torch.bfloat16),
            "n": [torch.randn(6, 4, generator=gen).to(card_fp32)]}
    w = torch.tensor([3, 1, 4, 1, 5, 9], device=card_fp32)
    before = po.LAUNCHES["pallas_ops.weighted_average"]
    by_value = po.WAVG_FORMS["by_value"]
    got = po.agg_stacked_pallas(tree, w)
    torch.cuda.synchronize()
    assert po.LAUNCHES["pallas_ops.weighted_average"] == before + 1
    assert po.WAVG_FORMS["by_value"] == by_value + 1
    flat = torch.cat([tree["b"].float(), tree["n"][0],
                      tree["w"].reshape(6, -1)], dim=1)
    ref = po.weighted_average_flat_reference(flat, w)
    assert got["b"].dtype == torch.bfloat16 and got["w"].dtype == torch.float32
    torch.testing.assert_close(got["b"], ref[:9].to(torch.bfloat16),
                               atol=1e-6, rtol=2.0 ** -7)
    torch.testing.assert_close(got["n"][0], ref[9:13], **F32_TOL)
    torch.testing.assert_close(got["w"], ref[13:].reshape(17, 5), **F32_TOL)


def _qmask_card_inputs(d, seed):
    """x with the CPU tests' edge values (±40000, ±inf, NaN, exact halves
    2^-17·(2k+1)) and masks near 2^32 − 1 that wrap; uint32 bits as int32."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(d, generator=gen)
    special = torch.tensor([40000.0, -40000.0, float("inf"), -float("inf"),
                            float("nan"), 32767.99, -32768.0, 32768.0])
    halves = 2.0 ** -17 * (2 * torch.arange(-20, 20) + 1).float()
    edge = torch.cat([special, halves])[:d]
    x[:edge.numel()] = edge
    mask = torch.randint(-2 ** 31, 2 ** 31, (d,), generator=gen,
                         dtype=torch.int32)
    mask[:min(d, 64)] = -1 - torch.arange(min(d, 64), dtype=torch.int32)
    return x, mask


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype,offset", [
    (1, torch.float32, 0), (3, torch.float32, 0), (777, torch.float32, 0),
    (1024, torch.float32, 0), (777, torch.float32, 1),
    (1025, torch.bfloat16, 0), (860026, torch.float32, 0)])
def test_quantize_mask_kernel_matches_bit_for_bit(d, dtype, offset, card):
    """The kernel, the plain version on the card and the plain version on
    the CPU give the same words."""
    from fedml_tpu_torch.ops import pallas_ops as po

    x, mask = _qmask_card_inputs(d, d + offset)
    x = x.to(dtype)
    xc, mc = _misaligned(x.to(card), offset), _misaligned(mask.to(card),
                                                          offset)
    before = po.LAUNCHES["pallas_ops.quantize_mask"]
    got = po.quantize_mask(xc, mc)
    torch.cuda.synchronize()
    assert po.LAUNCHES["pallas_ops.quantize_mask"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, po.quantize_mask_reference(xc, mc))
    assert torch.equal(got.cpu(), po.quantize_mask(x, mask))
    as_u32 = po.quantize_mask(xc, mc.view(torch.uint32))
    assert as_u32.dtype == torch.uint32
    assert torch.equal(as_u32.view(torch.int32), got)


@pytest.mark.gpu
def test_secagg_round_on_the_card_matches_the_cpu(card):
    """quantize, mask_model, unmask_sum and dequantize on the card give the
    CPU's bits; prg_mask_like gives the same masks on both."""
    from fedml_tpu_torch.core.mpc import secagg as sa

    x, _ = _qmask_card_inputs(1000, 11)
    tree = {"w": x.reshape(40, 25)}
    out = {}
    for dev in ("cpu", card):
        t = {"w": tree["w"].to(dev)}
        q = sa.quantize(t, 3000.0)
        m = sa.prg_mask_like(q, seed=5)
        un = sa.unmask_sum(sa.mask_model(q, m), m)
        out[str(dev)] = (m["w"].cpu(), un["w"].cpu(),
                         sa.dequantize(un, scale=3000.0)["w"].cpu())
    for a, b in zip(*out.values()):
        assert torch.equal(a, b)


#: (M, K, N, x dtype, storage offset of q, extra row stride of x): the
#: CPU test's [4, 48] @ [48, 700], the GPT-2-small decode widths at M = 1
#: and 64 (wq, w1 and w2), ragged M, K and N, a misaligned q, a strided x,
#: M past one tile row, M on both sides of the CUDA-core path's limit
#: (2, 16, 17, 32), K of 48 and 100 on both paths, bf16 x at M 64, and the
#: x kinds of MM_X_KIND
MM_CARD_CASES = {
    "jax_test": (4, 48, 700, torch.float32, 0, 0),
    "jax_test_m1_bf16": (1, 48, 700, torch.bfloat16, 0, 0),
    "wq_m1": (1, 768, 768, torch.float32, 0, 0),
    "wq_m64": (64, 768, 768, torch.float32, 0, 0),
    "w1_m64": (64, 768, 3072, torch.float32, 0, 0),
    "w2_m1": (1, 3072, 768, torch.float32, 0, 0),
    "w2_m64_bf16": (64, 3072, 768, torch.bfloat16, 0, 0),
    "ragged": (17, 100, 203, torch.float32, 0, 0),
    "misaligned_q": (8, 64, 256, torch.float32, 1, 0),
    "strided_x": (5, 96, 128, torch.float32, 0, 7),
    "m130": (130, 256, 192, torch.float32, 0, 0),
    "m2": (2, 768, 768, torch.float32, 0, 0),
    "m16": (16, 768, 768, torch.float32, 0, 0),
    "m17": (17, 768, 768, torch.float32, 0, 0),
    "m32": (32, 768, 3072, torch.float32, 0, 0),
    "k48_m1": (1, 48, 768, torch.float32, 0, 0),
    "k100_m3": (3, 100, 203, torch.float32, 0, 0),
    "k100_m64": (64, 100, 768, torch.float32, 0, 0),
    "bf16_m64": (64, 768, 768, torch.bfloat16, 0, 0),
    "span_m1": (1, 100, 256, torch.float32, 0, 0),
    "span_m64": (64, 100, 256, torch.float32, 0, 0),
    "tiny_m1": (1, 768, 256, torch.float32, 0, 0),
    "tiny_m64": (64, 768, 256, torch.float32, 0, 0),
    "nonfinite_m5": (5, 96, 128, torch.float32, 0, 0),
    "nonfinite_m64": (64, 96, 130, torch.float32, 0, 0),
}
#: x other than randn: "span", float32 magnitudes from 1e-40 (subnormal) to
#: 1e28 with one entry a row at 1e38 to 3.4028235e38 (past bfloat16's
#: largest value, where bf16(x) rounds to inf), against ternary weights and
#: scales under 1, so that every sum and output stays finite; "tiny", rows
#: of float32 magnitudes from 1e-40 to 1e-37 only (where bfloat16 parts of
#: x would lose bits under bfloat16's least subnormal unless scaled up:
#: unscaled parts miss the bound there about 9-fold), against int8 weights
#: with scales near 2^113, so that the outputs lie near 1 and the bound,
#: not its 1e-30 floor, decides; "nonfinite", randn
#: with +inf, -inf and NaN entries (a row with both infinities), compared
#: by the pattern of NaNs and infinities
MM_X_KIND = {"span_m1": "span", "span_m64": "span",
             "tiny_m1": "tiny", "tiny_m64": "tiny",
             "nonfinite_m5": "nonfinite", "nonfinite_m64": "nonfinite"}


def _mm_card_inputs(name, card):
    from fedml_tpu_torch.serving.quantization import quantize_matrix_int8

    m, k, n, dtype, q_off, pad = MM_CARD_CASES[name]
    kind = MM_X_KIND.get(name, "randn")
    gen = torch.Generator().manual_seed(sorted(MM_CARD_CASES).index(name))
    if kind == "span":
        q = torch.randint(-1, 2, (k, n), generator=gen, dtype=torch.int8)
        s = torch.rand(n, generator=gen) * 0.5 + 0.25
        mag = 10.0 ** (torch.rand(m, k + pad, generator=gen,
                                  dtype=torch.float64) * 68 - 40)
        sign = torch.randint(0, 2, (m, k + pad), generator=gen) * 2 - 1
        x = (sign * mag).float()
        big = torch.tensor([3.4e38, -3.4028235e38, 1e38, -2e38])
        x[torch.arange(m), torch.arange(m) % k] = big[torch.arange(m) % 4]
        q, s = q.to(card), s.to(card)
    elif kind == "tiny":
        q = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
        s = (torch.rand(n, generator=gen) * 0.5 + 0.5) * 2.0 ** 113
        mag = 10.0 ** (torch.rand(m, k + pad, generator=gen,
                                  dtype=torch.float64) * 3 - 40)
        sign = torch.randint(0, 2, (m, k + pad), generator=gen) * 2 - 1
        x = (sign * mag).float()
        q, s = q.to(card), s.to(card)
    else:
        qs = quantize_matrix_int8(torch.randn(k, n, generator=gen).to(card)
                                  * k ** -0.5)
        q, s = qs["q"], qs["s"]
        x = torch.randn(m, k + pad, generator=gen)
        if kind == "nonfinite":
            inf = float("inf")
            for r, c, v in ((0, 3, inf), (m - 1, 5, -inf), (m // 2, 7,
                                                             float("nan")),
                            (m // 3, 1, inf), (m // 3, 9, -inf)):
                x[r, c] = v
    x = x.to(dtype).to(card)[:, :k]
    return x, _misaligned(q, q_off), s


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MM_CARD_CASES))
def test_int8_matmul_kernel_matches_plain_version(name, card_fp32):
    """Within K · 2^-24 · (|x| @ |q|) · s: sums of K float32 products in the
    kernel's order (K split across a cluster, each split in order, float32
    x as three exact bf16 parts on the tensor cores) against cuBLAS's; NaN
    and infinities where the plain version has them; the same bits from
    call to call."""
    from fedml_tpu_torch.ops import pallas_ops as po

    m, k, n = MM_CARD_CASES[name][:3]
    x, q, s = _mm_card_inputs(name, card_fp32)
    before = po.LAUNCHES["pallas_ops.int8_matmul"]
    got = po.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert po.LAUNCHES["pallas_ops.int8_matmul"] == before + 1
    ref = po.int8_matmul_reference(x, q, s)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    if MM_X_KIND.get(name) == "nonfinite":
        assert torch.equal(got.isnan(), ref.isnan()), f"{name}: NaNs differ"
        assert torch.equal(got.isinf(), ref.isinf()), f"{name}: infs differ"
        assert torch.equal(got[got.isinf()], ref[ref.isinf()])
        assert bool(ref.isnan().any()) and bool(ref.isinf().any())
    fin = ref.isfinite()
    assert torch.equal(got.isfinite(), fin), f"{name}: non-finite outputs"
    if MM_X_KIND.get(name) != "nonfinite":
        assert bool(fin.all()), f"{name}: the plain version overflowed"
    bound = k * 2.0 ** -24 * po.int8_matmul_reference(x.abs(), q.abs(), s)
    excess = float(((got - ref).abs() - bound - 1e-30)[fin].max())
    assert excess <= 0, f"{name}: {excess:.3g} past the bound"
    again = po.int8_matmul(x, q, s)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
        f"{name}: differs from run to run"


@pytest.mark.gpu
def test_quantize_matrix_int8_on_the_card_matches_the_cpu(card):
    from fedml_tpu_torch.serving.quantization import quantize_matrix_int8

    w = torch.randn(768, 3072, generator=torch.Generator().manual_seed(9))
    w[:, 0] = 0.0
    got, want = quantize_matrix_int8(w.to(card)), quantize_matrix_int8(w)
    assert torch.equal(got["q"].cpu(), want["q"])
    assert torch.equal(got["s"].cpu(), want["s"])


@pytest.mark.gpu
def test_pallas_ops_kernels_refuse_what_they_do_not_take(card):
    from fedml_tpu_torch.ops import pallas_ops as po

    before = dict(po.LAUNCHES)
    x, w = torch.zeros(3, 8, device=card), torch.ones(3, device=card)
    with pytest.raises(TypeError, match="weighted_average"):
        po.weighted_average_flat(x.half(), w)
    with pytest.raises(TypeError, match="weighted_average"):
        po.weighted_average_flat(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="on the CPU or on one card"):
        po.weighted_average_flat(x, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        po.weighted_average_flat(torch.zeros(8, 3, device=card).t(), w)
    with pytest.raises(ValueError, match=r"\[C, D\]"):
        po.weighted_average_flat(x, torch.ones(4, device=card))
    with pytest.raises(TypeError, match="agg_stacked_pallas"):
        po.agg_stacked_pallas({"a": x, "b": x.long()}, w)
    with pytest.raises(ValueError, match="contiguous"):
        po.agg_stacked_pallas({"a": x, "b": torch.zeros(8, 3,
                                                        device=card).t()}, w)
    with pytest.raises(ValueError, match="one C"):
        po.agg_stacked_pallas({"a": x, "b": torch.zeros(4, 8,
                                                        device=card)}, w)
    with pytest.raises(ValueError, match="at least one value"):
        po.agg_stacked_pallas({"a": x[:, :0], "b": x[:, :0]}, w)
    with pytest.raises(ValueError, match=r"leaves \[C, \.\.\.\]"):
        po.agg_stacked_pallas({"a": x}, torch.ones(4, device=card))
    v, m = torch.zeros(8, device=card), torch.zeros(8, device=card,
                                                   dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        po.quantize_mask(v, m.long())
    with pytest.raises(TypeError, match="quantize_mask"):
        po.quantize_mask(v.half(), m)
    with pytest.raises(ValueError, match="one non-empty shape"):
        po.quantize_mask(v, m[:4])
    with pytest.raises(ValueError, match="contiguous"):
        po.quantize_mask(v[::2], m[::2])
    a = torch.zeros(2, 16, device=card)
    q = torch.zeros(16, 4, device=card, dtype=torch.int8)
    s = torch.ones(4, device=card)
    with pytest.raises(TypeError, match="int8 q"):
        po.int8_matmul(a, q.float(), s)
    with pytest.raises(TypeError, match="float32 s"):
        po.int8_matmul(a, q, s.to(torch.bfloat16))
    with pytest.raises(ValueError, match=r"x \[M, K\]"):
        po.int8_matmul(a[:, :8], q, s)
    with pytest.raises(ValueError, match="unit"):
        po.int8_matmul(torch.zeros(16, 2, device=card).t(), q, s)
    with pytest.raises(ValueError, match="contiguous"):
        po.int8_matmul(a, torch.zeros(4, 16, device=card,
                                      dtype=torch.int8).t(), s)
    assert po.LAUNCHES == before
