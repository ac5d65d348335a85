"""The port's client optimizer chain against optax's.

``ml/engine/optimizers.build_client_optimizer`` against the JAX package's
(``fedml_tpu/ml/engine/optimizers.py``): sgd with momentum, adam, adamw,
``weight_decay`` chained ahead of sgd and adam, and the cosine and linear
schedules with warmup, over 5 steps on seeded numpy tensors, the step count
on the host and on the device.  Tolerance: 1e-6 relative to each leaf's
largest magnitude.  Both sides compute in float32 with the same operations
in the same order, but XLA's CPU code may contract a product and a sum
into one fused multiply-add: adam's update then differs in its last bit
now and then, and a parameter that a step carries across a power of two
keeps that one ulp of its former magnitude (up to 1.2e-7 at magnitudes
near 1, elementwise 1e-5 relative on an element near 0.001).

Then the gated local update's optimizer state on padded steps: a step
followed by ``keep`` with the flag off leaves every state tensor and the
count as they were, and a gated local update with adam and a schedule over
padded batches gives the host-skip body's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.arguments import Config as JaxConfig
from fedml_tpu.ml.engine import optimizers as jopt
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.ml.engine import local_update as lu
from fedml_tpu_torch.ml.engine import optimizers as opt
from fedml_tpu_torch.ml.engine.model_bundle import FlatVariables, ModelBundle
from fedml_tpu_torch.models.cv import CIFARResNet

SHAPES = [(4, 3), (5,), (2, 2, 3)]
STEPS = 5
RTOL = 1e-6


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=RTOL * np.abs(ref).max())


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread (see ``tests/test_torch_fused_rounds.py``:
    beside other test processes, a thread pool per process oversubscribes
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


CASES = {
    "sgd momentum": dict(client_optimizer="sgd", momentum=0.9),
    "sgd momentum wd": dict(client_optimizer="sgd", momentum=0.9,
                            weight_decay=1e-2),
    "sgd wd": dict(client_optimizer="sgd", weight_decay=5e-3),
    "adam": dict(client_optimizer="adam"),
    "adam wd": dict(client_optimizer="adam", weight_decay=1e-2),
    "adamw": dict(client_optimizer="adamw", weight_decay=1e-2),
    "sgd cosine warmup": dict(client_optimizer="sgd", lr_schedule="cosine",
                              warmup_steps=2, lr_decay_steps=6),
    "sgd momentum linear warmup": dict(client_optimizer="sgd", momentum=0.5,
                                       lr_schedule="linear", warmup_steps=2,
                                       lr_decay_steps=6),
    "adam linear": dict(client_optimizer="adam", lr_schedule="linear",
                        lr_decay_steps=4),
    "adamw cosine warmup": dict(client_optimizer="adamw", weight_decay=1e-3,
                                lr_schedule="cosine", warmup_steps=1,
                                lr_decay_steps=5),
}


def _tensors(seed):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _optax_run(kw, params, grads):
    tx = jopt.build_client_optimizer(JaxConfig(learning_rate=0.1, **kw))
    p = [jnp.asarray(a) for a in params]
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, p)
        p = optax.apply_updates(p, updates)
    return [np.asarray(a) for a in p], state


@pytest.mark.parametrize("device_count", [False, True],
                         ids=["host count", "device count"])
@pytest.mark.parametrize("case", list(CASES))
def test_client_optimizer_matches_optax(case, device_count):
    kw = CASES[case]
    params, grads = _tensors(list(CASES).index(case))
    want, jstate = _optax_run(kw, params, grads)

    o = opt.build_client_optimizer(Config(learning_rate=0.1, **kw))
    assert not o.plain
    p = [torch.from_numpy(a.copy()) for a in params]
    state = o.init(p, device_count=device_count)
    rows = o.step_rows(STEPS, torch.device("cpu"))
    for g in grads:
        state = o.step(p, [torch.from_numpy(a) for a in g], state, rows)
    for got, ref in zip(p, want):
        _close(got.numpy(), ref)
    assert int(state["count"]) == STEPS
    assert isinstance(state["count"], torch.Tensor) == device_count
    # the moments carried match optax's state too
    fields = {}
    for part in jax.tree_util.tree_leaves(
            jstate, is_leaf=lambda x: hasattr(x, "_asdict")):
        if hasattr(part, "_asdict"):
            fields.update(part._asdict())
    for k in ("trace", "mu", "nu"):
        if k in state:
            for got, ref in zip(state[k], fields[k]):
                _close(got.numpy(), ref)


def test_plain_sgd_keeps_no_state():
    o = opt.build_client_optimizer(Config(learning_rate=0.1))
    assert o.plain and o.init([torch.zeros(3)]) == {}
    p = [torch.ones(3)]
    o.step(p, [torch.full((3,), 2.0)], {})
    assert torch.equal(p[0], torch.full((3,), np.float32(1.0)
                                        + np.float32(-0.1) * 2))


def test_unknown_client_optimizer_raises():
    with pytest.raises(ValueError, match="unknown client_optimizer"):
        opt.ClientOptimizer("lamb", 0.1)


def test_padded_step_keeps_the_whole_state():
    """A step, then ``keep`` with the device flag off: every state tensor
    and the count as before the step; with it on, the step's."""
    o = opt.build_client_optimizer(Config(learning_rate=0.1,
                                          client_optimizer="adam",
                                          lr_schedule="cosine",
                                          warmup_steps=1, lr_decay_steps=4))
    params, grads = _tensors(7)
    p = [torch.from_numpy(a.copy()) for a in params]
    rows = o.step_rows(STEPS, torch.device("cpu"))
    state = o.init(p, device_count=True)
    state = o.step(p, [torch.from_numpy(a) for a in grads[0]], state, rows)
    before = {k: ([t.clone() for t in v] if isinstance(v, (list, tuple))
                  else v.clone()) for k, v in state.items()}
    new = o.step(p, [torch.from_numpy(a) for a in grads[1]], state, rows)
    kept = o.keep(torch.tensor(False), new, state)
    taken = o.keep(torch.tensor(True), new, state)
    assert int(kept["count"]) == 1 and int(taken["count"]) == 2
    for k in ("mu", "nu"):
        for a, b in zip(kept[k], before[k]):
            assert torch.equal(a, b)
        for a, b in zip(taken[k], new[k]):
            assert torch.equal(a, b)
        assert not all(torch.equal(a, b) for a, b in zip(new[k], before[k]))


@pytest.mark.parametrize("kw", [
    dict(client_optimizer="adam", lr_schedule="linear", warmup_steps=2,
         lr_decay_steps=8),
    dict(client_optimizer="sgd", momentum=0.9, weight_decay=1e-3)],
    ids=["adam linear warmup", "sgd momentum wd"])
def test_gated_update_with_optimizer_state_equals_host_skip(kw):
    """Padded batches in the middle and at the end, two epochs: the gated
    body (every batch run, the optimizer state and its device count kept
    where the batch is padding) gives the host-skip body's variables and
    metrics, bit for bit."""
    bs, nb = 4, 4
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(nb, bs, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, size=(nb, bs)).astype(np.int64))
    mask = torch.ones(nb, bs)
    mask[1] = 0.0
    mask[2, 3:] = 0.0
    mask[3] = 0.0
    batches = {"x": x, "y": y, "mask": mask}
    valid = (mask > 0).any(dim=1)
    cfg = Config(federated_optimizer="FedAvg", epochs=2, learning_rate=0.05,
                 **kw)
    bundle = ModelBundle(CIFARResNet(
        depth=8, num_classes=10, generator=torch.Generator().manual_seed(0)),
        (32, 32, 3), 10)
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
    assert skip["local_steps"] == int(gated["local_steps"]) == 4
