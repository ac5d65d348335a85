"""The port's data layer against the JAX package's: byte-identical.

Partitions, synthetic stand-ins, the loaded 8-tuple with its client row map,
and the size-bucket plan are numpy on both sides, so the port must return
exactly the JAX package's arrays.
"""

import numpy as np
import pytest

from fedml_tpu.arguments import Config as JaxConfig
from fedml_tpu.data import data_loader as jax_loader
from fedml_tpu.data import datasets as jax_datasets
from fedml_tpu.data import partition as jax_partition
from fedml_tpu.simulation.parrot.parrot_api import bucket_plan as jax_plan
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.data import data_loader, datasets, partition
from fedml_tpu_torch.simulation.parrot.parrot_api import bucket_plan


def _same_map(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("method,alpha,seed", [
    ("hetero", 0.5, 0), ("hetero", 0.1, 3), ("homo", 0.5, 1)])
def test_partition_identical(method, alpha, seed):
    labels = np.random.RandomState(seed).randint(0, 10, size=3000)
    got = partition.partition(labels, 17, method, alpha, seed)
    want = jax_partition.partition(labels, 17, method, alpha, seed)
    _same_map(got, want)
    assert (partition.record_data_stats(labels, got)
            == jax_partition.record_data_stats(labels, want))


@pytest.mark.parametrize("dataset,hard", [
    ("cifar10", False), ("cifar10", True), ("mnist", True),
    ("cifar100", False), ("synthetic", False)])
def test_load_arrays_identical(dataset, hard, tmp_path):
    (got, n_got) = datasets.load_arrays(dataset, str(tmp_path), seed=5,
                                        scale=0.02, hard=hard)
    (want, n_want) = jax_datasets.load_arrays(dataset, str(tmp_path),
                                              seed=5, scale=0.02, hard=hard)
    assert n_got == n_want
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_load_arrays_reads_an_npz(tmp_path):
    rng = np.random.RandomState(0)
    np.savez(tmp_path / "cifar10.npz",
             x_train=rng.randint(0, 256, (70, 32, 32, 3)).astype(np.uint8),
             y_train=rng.randint(0, 10, 70),
             x_test=rng.randint(0, 256, (20, 32, 32, 3)).astype(np.uint8),
             y_test=rng.randint(0, 10, 20))
    got, _ = datasets.load_arrays("cifar10", str(tmp_path))
    want, _ = jax_datasets.load_arrays("cifar10", str(tmp_path))
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


def test_load_arrays_names_what_is_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="cifar10"):
        datasets.load_arrays("stackoverflow_nwp", str(tmp_path))


@pytest.mark.parametrize("dataset,scale,seed", [
    ("shakespeare", 0.05, 0), ("fed_shakespeare", 0.3, 4)])
def test_shakespeare_arrays_identical(dataset, scale, seed, tmp_path):
    (got, n_got) = datasets.load_arrays(dataset, str(tmp_path), seed=seed,
                                        scale=scale)
    (want, n_want) = jax_datasets.load_arrays(dataset, str(tmp_path),
                                              seed=seed, scale=scale)
    assert n_got == n_want == 90
    assert got[0].shape == (max(int(2000 * scale), 64), 80)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_shakespeare_vocab_is_90():
    from fedml_tpu.data import tff_text as jax_tff
    from fedml_tpu_torch.data import tff_text

    assert tff_text.shakespeare_vocab_size() == 90
    assert tff_text.shakespeare_word_dict() == jax_tff.shakespeare_word_dict()
    assert datasets.dataset_class_num("fed_shakespeare") == 90


def test_shakespeare_reads_a_corpus_from_the_cache(tmp_path):
    (tmp_path / "shakespeare.txt").write_text(
        "Now is the winter of our discontent made glorious summer " * 9)
    got, _ = datasets.load_arrays("shakespeare", str(tmp_path), scale=0.05)
    want, _ = jax_datasets.load_arrays("shakespeare", str(tmp_path),
                                       scale=0.05)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dataset,method", [
    ("cifar10", "hetero"), ("mnist", "homo"), ("fed_shakespeare", "hetero"),
    ("shakespeare", "homo")])
def test_load_identical(dataset, method, tmp_path):
    kw = dict(dataset=dataset, partition_method=method,
              client_num_in_total=7, data_scale=0.03, random_seed=2,
              data_cache_dir=str(tmp_path), synthetic_hard=True)
    args, jargs = Config(**kw), JaxConfig(**kw)
    got, want = data_loader.load(args), jax_loader.load(jargs)
    assert got[0] == want[0] and got[1] == want[1] and got[7] == want[7]
    for g, w in zip(got[2] + got[3], want[2] + want[3]):
        assert g.tobytes() == w.tobytes()
    assert got[4] == want[4]
    for cid in range(7):
        for g, w in zip(got[5][cid] + got[6][cid], want[5][cid] + want[6][cid]):
            assert g.tobytes() == w.tobytes()
    _same_map(args.client_row_map, jargs.client_row_map)
    assert args.data_stats == jargs.data_stats


@pytest.mark.parametrize("k,n_buckets,cap", [
    (10, 10, 0.8), (10, 3, 0.0), (4, 4, 0.5), (6, 100, 0.8)])
def test_bucket_plan_identical(k, n_buckets, cap):
    sizes = np.random.RandomState(k).randint(1, 900, size=100)
    got = bucket_plan(sizes, k, 32, n_buckets, cap)
    want = jax_plan(sizes, k, 32, n_buckets, cap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["members"], w["members"])
        assert {k: v for k, v in g.items() if k != "members"} == \
            {k: v for k, v in w.items() if k != "members"}


def test_fed_shakespeare_partitions_by_first_token(tmp_path):
    """Hetero Dirichlet splits of token data go by each sequence's first
    label token, with the JAX package's index maps."""
    kw = dict(dataset="fed_shakespeare", partition_method="hetero",
              partition_alpha=0.5, client_num_in_total=10, data_scale=0.2,
              random_seed=3, data_cache_dir=str(tmp_path))
    args, jargs = Config(**kw), JaxConfig(**kw)
    got, want = data_loader.load(args), jax_loader.load(jargs)
    y = got[2][1]
    assert y.ndim == 2
    want_map = jax_partition.partition(y[:, 0], 10, "hetero", 0.5, 3)
    _same_map(args.client_row_map, want_map)
    _same_map(args.client_row_map, jargs.client_row_map)
    assert args.data_stats == jargs.data_stats
    assert got[4] == want[4]


def _write_user_npz(path):
    rng = np.random.RandomState(0)
    np.savez(path, x_alice=rng.randint(0, 90, (5, 80)),
             y_alice=rng.randint(0, 90, (5, 80)))


@pytest.mark.parametrize("where", ["npz", "leaf", "h5"])
def test_natural_files_are_not_silently_skipped(where, tmp_path):
    """With client-keyed files in data_cache_dir the JAX package builds its
    clients from them: the port raises, naming port item A2, instead of
    taking the synthetic split."""
    if where == "npz":
        _write_user_npz(tmp_path / "fed_shakespeare_train.npz")
    elif where == "leaf":
        (tmp_path / "FED_SHAKESPEARE" / "train").mkdir(parents=True)
        (tmp_path / "FED_SHAKESPEARE" / "train" / "all_data.json"
         ).write_text('{"users": [], "user_data": {}}')
    else:
        (tmp_path / "shakespeare_train.h5").write_bytes(b"")
    args = Config(dataset="fed_shakespeare", client_num_in_total=4,
                  data_scale=0.05, data_cache_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="A2"):
        data_loader.load(args)


def test_no_natural_files_take_the_synthetic_split(tmp_path):
    """An npz of the dataset's name without user arrays is not client-keyed
    (the JAX package reads no users from it); neither is an empty or
    absent cache dir."""
    np.savez(tmp_path / "fed_shakespeare_train.npz", x=np.zeros(3))
    for cache in (str(tmp_path), ""):
        kw = dict(dataset="fed_shakespeare", client_num_in_total=4,
                  data_scale=0.05, data_cache_dir=cache)
        got = data_loader.load(Config(**kw))
        want = jax_loader.load(JaxConfig(**kw))
        assert got[0] == want[0] and got[7] == want[7] == 90
        for g, w in zip(got[2], want[2]):
            assert g.tobytes() == w.tobytes()
    with pytest.raises(FileNotFoundError):
        data_loader.load(Config(dataset="fed_shakespeare",
                                partition_method="natural",
                                data_cache_dir=str(tmp_path)))
