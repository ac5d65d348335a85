"""Dataset sources the ported slice reads.

Port of ``fedml_tpu/data/datasets.py``, limited to ``load_arrays``' npz,
mnist/cifar and default-synthetic branches.  Numpy only and kept verbatim,
so both packages generate byte-identical synthetic stand-ins from one seed.
A dataset found neither as ``<data_cache_dir>/<name>.npz`` nor among those
branches raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

DATASET_CLASSES = {
    "mnist": 10, "femnist": 62,
    "cifar10": 10, "cifar100": 100, "cinic10": 10, "fed_cifar100": 100,
}


def dataset_class_num(dataset: str, default: int = 10) -> int:
    return DATASET_CLASSES.get(dataset.lower(), default)


def _try_npz(cache_dir: str, name: str) -> Optional[Arrays]:
    path = os.path.join(cache_dir, f"{name}.npz")
    if os.path.exists(path):
        z = np.load(path)

        def _x(a: np.ndarray) -> np.ndarray:
            # uint8 image archives (the standard ingest format) → [0,1] floats
            if np.issubdtype(a.dtype, np.integer):
                return a.astype(np.float32) / 255.0
            return a

        return (_x(z["x_train"]), z["y_train"].astype(np.int64),
                _x(z["x_test"]), z["y_test"].astype(np.int64))
    return None


def _synthetic_images(shape: Tuple[int, ...], n_classes: int, n_train: int,
                      n_test: int, seed: int, hard: bool = False) -> Arrays:
    """Class-structured images: per-class template + noise, so linear/conv
    models can actually learn (deterministic).  Large images (≥96px) build
    templates at low resolution and upsample, and add noise in float32
    batches, keeping peak memory ~n·H·W·C·4 bytes instead of several GB.

    ``hard=True`` (the north-star bench data): the plain construction
    saturates at test acc 1.0 at 50k scale, which makes an accuracy guard
    weak evidence.  Hard mode adds per-sample class MIXING (convex combo
    of two class templates, label = dominant — irreducible ambiguity near
    the 0.5 boundary), per-sample affine jitter (random ±3px roll — a
    template-memorizing degenerate model can't be shift-robust) and
    intensity scaling, plus train-label noise, so a ResNet-class model
    plateaus below 1.0 like real CIFAR."""
    rng = np.random.RandomState(seed)
    h, w = shape[0], shape[1]
    lowres = h >= 96
    if lowres:  # store 16px templates; upsample per gathered batch
        templates = rng.rand(n_classes, 16, 16,
                             *shape[2:]).astype(np.float32)
    else:
        templates = rng.rand(n_classes, *shape).astype(np.float32)

    def make(n, train):
        y = rng.randint(0, n_classes, size=n)
        x = templates[y]
        if hard:
            # convex mix with a second class (BEFORE the lowres upsample —
            # nearest-neighbor repeat commutes with the convex combination)
            y2 = rng.randint(0, n_classes, size=n)
            lam = rng.uniform(0.60, 1.0, size=n).astype(np.float32)
            lam_b = lam.reshape((n,) + (1,) * (x.ndim - 1))
            x = lam_b * x + (1.0 - lam_b) * templates[y2]
        if lowres:
            x = np.repeat(np.repeat(x, -(-h // 16), axis=1),
                          -(-w // 16), axis=2)[:, :h, :w]
        noise = rng.standard_normal(size=x.shape).astype(np.float32)
        x = np.clip(x + 0.35 * noise, 0.0, 1.0).astype(np.float32)
        if hard:
            # per-sample affine jitter: random roll + intensity scale.
            # Group by the 49 distinct (dy,dx) shifts — one vectorized
            # roll per group instead of a Python loop over every sample.
            sh = rng.randint(-3, 4, size=(n, 2))
            for dy in range(-3, 4):
                for dx in range(-3, 4):
                    if dy == 0 and dx == 0:
                        continue
                    sel = (sh[:, 0] == dy) & (sh[:, 1] == dx)
                    if sel.any():
                        x[sel] = np.roll(x[sel], (dy, dx), axis=(1, 2))
            x *= rng.uniform(0.8, 1.2, size=n).astype(
                np.float32).reshape((n,) + (1,) * (x.ndim - 1))
            # clip back to [0,1]: the uint8 npz export quantizes by 255,
            # so values past 1.0 would WRAP and corrupt bright pixels
            x = np.clip(x, 0.0, 1.0)
            if train:
                flip = rng.rand(n) < 0.02          # 2% train label noise
                y = np.where(flip, rng.randint(0, n_classes, size=n), y)
        return x.astype(np.float32), y.astype(np.int64)

    xt, yt = make(n_train, True)
    xe, ye = make(n_test, False)
    return xt, yt, xe, ye


def synthetic_classification(n_features: int = 60, n_classes: int = 10,
                             n_train: int = 2000, n_test: int = 500,
                             seed: int = 0) -> Arrays:
    """LEAF/Li-et-al-style synthetic logistic data (reference
    `data/synthetic_*`): y = argmax(Wx + b) with gaussian x."""
    rng = np.random.RandomState(seed)
    W = rng.randn(n_features, n_classes).astype(np.float32)
    b = rng.randn(n_classes).astype(np.float32)

    def make(n):
        x = rng.randn(n, n_features).astype(np.float32)
        logits = x @ W + b + 0.1 * rng.randn(n, n_classes)
        return x, np.argmax(logits, axis=1).astype(np.int64)

    xt, yt = make(n_train)
    xe, ye = make(n_test)
    return xt, yt, xe, ye


def load_arrays(dataset: str, cache_dir: str, seed: int = 0,
                scale: float = 1.0, hard: bool = False) -> Tuple[Arrays, int]:
    """→ ((x_train, y_train, x_test, y_test), num_classes).  ``scale``
    shrinks the synthetic fallbacks for fast tests; ``hard`` applies the
    non-saturating construction (mixing/jitter/label noise) to synthetic
    IMAGE fallbacks — the north-star bench data regime."""
    dataset = dataset.lower()
    os.makedirs(cache_dir, exist_ok=True) if cache_dir else None
    sz = lambda n: max(int(n * scale), 64)

    if dataset in ("mnist", "femnist"):
        classes = dataset_class_num(dataset)
        real = _try_npz(cache_dir, dataset)
        return (real or _synthetic_images((28, 28, 1), classes, sz(6000),
                                          sz(1000), seed,
                                          hard=hard)), classes
    if dataset in ("cifar10", "cifar100", "cinic10", "fed_cifar100"):
        classes = dataset_class_num(dataset)
        key = "cifar100" if "100" in dataset else "cifar10"
        real = _try_npz(cache_dir, key)
        return (real or _synthetic_images((32, 32, 3), classes, sz(5000),
                                          sz(1000), seed,
                                          hard=hard)), classes
    if dataset == "synthetic":
        return synthetic_classification(60, 10, sz(2000), sz(500), seed), 10
    raise NotImplementedError(
        f"dataset {dataset!r} is not ported yet; the PyTorch port loads "
        f"mnist, femnist, cifar10, cifar100, cinic10, fed_cifar100 and "
        f"synthetic")
