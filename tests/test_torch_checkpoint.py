"""The port's round checkpoints (``utils/checkpoint.RoundCheckpointer``,
``utils/serialization``'s pytree format) and resume on both Parrot paths.

(a) The checkpointer's contract: the newest ``keep`` files stay, a round
already saved is refused unless forced, a forced re-save replaces it, and
``restore`` returns the newest or the one asked for.
(b) The format against the JAX package's: a file the port writes reads
with ``fedml_tpu.utils.serialization.loads_pytree``, and bytes that the JAX
package's ``dumps_pytree`` writes — a bfloat16 leaf among them — read in
the port.
(c) The per-round path against the JAX run: two uniform FedAvg rounds of
logistic regression with ``checkpoint_dir``; the port's newest checkpoint,
read by the JAX package, holds the JAX run's globals within the parity
tolerance of ``tests/test_torch_parrot.py`` (1e-3).
(d) Resume on the per-round path (uniform FedAvg on ResNet depth 8, 6
clients, 2 a round, the reference's ``np.random.seed(round)`` draws): four
rounds straight equal two rounds and a resume of two, bit for bit — the
reference's ``test_parrot_resumes_from_checkpoint``.
(e) Resume in the fused rounds (FedOpt adam): the checkpoint is written
into the live buffers in place, their ``data_ptr`` unchanged, and the
step count carries on.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Config as JaxConfig
from fedml_tpu.data import data_loader as jax_loader
from fedml_tpu.models import model_hub as jax_hub
from fedml_tpu.simulation.parrot.parrot_api import ParrotAPI as JaxParrot
from fedml_tpu.utils import serialization as jax_ser
import fedml_tpu_torch
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.data import data_loader
from fedml_tpu_torch.ml.engine.model_bundle import ModelBundle
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.simulation.parrot.parrot_api import ParrotAPI
from fedml_tpu_torch.utils import serialization as ser
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer

CPU = torch.device("cpu")


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


def _args(cls, tmp_path, **kw):
    base = dict(dataset="synthetic", model="lr", backend="parrot",
                partition_method="hetero", client_num_in_total=4,
                client_num_per_round=4, comm_round=2, epochs=1,
                batch_size=16, learning_rate=0.1, frequency_of_the_test=1,
                data_scale=0.1, compute_dtype="float32",
                enable_tracking=False, device_type="cpu",
                data_cache_dir=str(tmp_path / "data"))
    base.update(kw)
    return cls(**base)


def _lr_api(args, **kw):
    dataset = data_loader.load(args)
    return ParrotAPI(args, CPU, dataset,
                     fedml_tpu_torch.model.create(args, dataset[-1]), **kw)


# ------------------------------------------------------------ (a) contract
def test_checkpointer_keeps_forces_and_refuses(tmp_path):
    ckpt = RoundCheckpointer(str(tmp_path / "ck"), keep=2)
    assert ckpt.latest_round() is None and ckpt.restore() is None
    for r in range(4):
        ckpt.save(r, {"round_idx": r, "w": np.full(3, r, np.float32)})
    files = sorted(f for f in os.listdir(ckpt.dir))
    assert files == ["round_00000002.ckpt", "round_00000003.ckpt"]
    assert ckpt.latest_round() == 3
    with pytest.raises(ValueError, match="already checkpointed"):
        ckpt.save(3, {"round_idx": 3})
    np.testing.assert_array_equal(ckpt.restore()["w"], np.full(3, 3.0))
    ckpt.save(3, {"round_idx": 3, "w": np.full(3, 7, np.float32)},
              force=True)
    assert not any(f.endswith(".tmp") for f in os.listdir(ckpt.dir))
    np.testing.assert_array_equal(ckpt.restore()["w"], np.full(3, 7.0))
    assert ckpt.restore(2)["round_idx"] == 2 and ckpt.restore(0) is None
    with pytest.raises(ValueError, match="keep"):
        RoundCheckpointer(str(tmp_path / "ck"), keep=0)


# -------------------------------------------------------------- (b) format
def test_pytree_bytes_cross_between_the_packages():
    rng = np.random.RandomState(0)
    tree = {"params": {"w": rng.randn(3, 4).astype(np.float32),
                       "i": np.arange(5, dtype=np.int32)},
            "round_idx": 7, "t": np.asarray(9, np.int64), "none": None,
            "seq": [1.5, "x", (True, np.zeros((0, 2), np.float64))]}
    mine = ser.dumps_pytree(tree)
    assert mine == jax_ser.dumps_pytree(tree)
    back = jax_ser.loads_pytree(mine)
    np.testing.assert_array_equal(back["params"]["w"], tree["params"]["w"])
    assert back["round_idx"] == 7 and back["none"] is None

    # the JAX package's bytes, with a bfloat16 leaf, read through torch
    bf = rng.randn(2, 5).astype(ml_dtypes.bfloat16)
    theirs = jax_ser.dumps_pytree({"b": bf, "f": jnp.arange(4.0)})
    got = ser.loads_pytree(theirs)
    assert got["b"].dtype == torch.bfloat16 and got["b"].shape == (2, 5)
    np.testing.assert_array_equal(got["b"].float().numpy(),
                                  bf.astype(np.float32))
    np.testing.assert_array_equal(got["f"], np.arange(4.0, dtype=np.float32))
    # and the port's bfloat16 tensor as the JAX package reads it
    t = torch.from_numpy(bf.astype(np.float32)).to(torch.bfloat16)
    assert ser.dumps_pytree({"b": t}) == jax_ser.dumps_pytree({"b": bf})
    for bad in (b"nope", mine[:len(mine) - 3], mine[:10]):
        with pytest.raises(ValueError):
            ser.loads_pytree(bad)


# ---------------------------------------------- (c) the JAX package reads it
def test_the_jax_package_reads_the_ports_checkpoint(tmp_path):
    jargs = _args(JaxConfig, tmp_path)
    jds = jax_loader.load(jargs)
    japi = JaxParrot(jargs, None, jds, jax_hub.create(jargs, jds[-1]))
    init = jax.tree_util.tree_map(np.array, dict(japi.global_vars))
    japi.train()

    ck = tmp_path / "ckpt"
    args = _args(Config, tmp_path, checkpoint_dir=str(ck))
    api = _lr_api(args, initial_variables=init)
    api.train()
    files = sorted(os.listdir(ck))
    assert files == ["round_00000000.ckpt", "round_00000001.ckpt"]
    with open(ck / files[-1], "rb") as f:
        state = jax_ser.loads_pytree(f.read())
    assert int(state["round_idx"]) == 1 and state["server_state"] == {}
    got = dict(jax.tree_util.tree_flatten_with_path(state["global_vars"])[0])
    want = dict(jax.tree_util.tree_flatten_with_path(
        dict(japi.global_vars))[0])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-3,
                                   rtol=0, err_msg=str(k))


# ------------------------------------------------ (d) per-round resume
def _resnet_args(tmp_path, ck, rounds):
    return _args(Config, tmp_path, dataset="cifar10",
                 client_num_in_total=6, client_num_per_round=2,
                 learning_rate=0.05, data_scale=0.02, comm_round=rounds,
                 frequency_of_the_test=2, checkpoint_frequency=1,
                 checkpoint_dir=None if ck is None else str(ck))


def _resnet_api(args):
    torch.manual_seed(0)
    return ParrotAPI(args, CPU, data_loader.load(args),
                     ModelBundle(CIFARResNet(depth=8, num_classes=10),
                                 (32, 32, 3), 10))


def test_per_round_resume_equals_a_straight_run(tmp_path):
    straight = _resnet_api(_resnet_args(tmp_path, None, 4))
    straight.train()

    ck = tmp_path / "ckpt"
    first = _resnet_api(_resnet_args(tmp_path, ck, 2))
    first.train()
    assert RoundCheckpointer(str(ck)).latest_round() == 1
    resumed = _resnet_api(_resnet_args(tmp_path, ck, 4))
    resumed.train()
    assert [r["round"] for r in resumed.round_history] == [2, 3]
    assert [r["train_loss"] for r in resumed.round_history] == \
        [r["train_loss"] for r in straight.round_history[2:]]
    for dt, f in straight.global_vars.items():
        assert torch.equal(resumed.global_vars[dt], f)
    assert [m["round"] for m in resumed.metrics_history] == [2, 3]
    assert resumed.metrics_history[-1] == {
        **straight.metrics_history[-1],
        "round_time": resumed.metrics_history[-1]["round_time"]}
    assert RoundCheckpointer(str(ck)).latest_round() == 3


# ------------------------------------------------------ (e) fused resume
def test_fused_resume_restores_in_place(tmp_path):
    ck = tmp_path / "ckpt"
    kw = dict(fused_rounds=True, federated_optimizer="FedOpt",
              server_optimizer="adam", server_lr=0.01,
              checkpoint_dir=str(ck))
    first = _lr_api(_args(Config, tmp_path, **kw))
    first.train()
    saved = RoundCheckpointer(str(ck)).restore()
    assert int(saved["round_idx"]) == 1

    api = _lr_api(_args(Config, tmp_path, **dict(kw, comm_round=3)))
    api.run_rounds_fused(1)        # the device state exists, t on the device
    st = api.server_state["opt_state"][torch.float32]
    ptrs = {"global": api.global_vars[torch.float32].data_ptr(),
            **{k: st[k].data_ptr() for k in ("m", "v", "t")}}
    api._restore_state(saved)
    assert torch.equal(api.global_vars[torch.float32],
                       first.global_vars[torch.float32])
    for k in ("m", "v", "t"):
        assert torch.equal(st[k], first.server_state["opt_state"][
            torch.float32][k]), k
    assert api._t_host == 2
    out = api.train()              # restores round 1 again, runs round 2
    assert out["round"] == 2 and len(api.metrics_history) == 1
    assert int(st["t"]) == 3
    assert {"global": api.global_vars[torch.float32].data_ptr(),
            **{k: st[k].data_ptr() for k in ("m", "v", "t")}} == ptrs
    assert RoundCheckpointer(str(ck)).latest_round() == 2

    # a checkpoint of another server step, or of other widths, is refused
    other = _lr_api(_args(Config, tmp_path, comm_round=3))
    with pytest.raises(ValueError, match="server state"):
        other._restore_state(saved)
    saved["server_state"]["opt_state"]["float32"]["m"] = np.zeros(
        3, np.float32)
    with pytest.raises(ValueError, match="of shape"):
        api._restore_state(saved)
