"""Dataset partitioners — IID ("homo") and Dirichlet non-IID ("hetero").

Capability parity: reference `core/data/noniid_partition.py` (124 LoC,
`partition_class_samples_with_dirichlet_distribution`) and the cifar loaders'
`partition_method`/`partition_alpha` contract (`data/data_loader.py:448-525`).

Port of ``fedml_tpu/data/partition.py``: numpy only, kept verbatim so both
packages split the same data into the same clients.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def homo_partition(n_samples: int, n_clients: int, seed: int = 0
                   ) -> Dict[int, np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n_samples)
    return {i: np.sort(part) for i, part in
            enumerate(np.array_split(idx, n_clients))}


def hetero_partition(labels: np.ndarray, n_clients: int, alpha: float = 0.5,
                     seed: int = 0, min_size_floor: int = 1
                     ) -> Dict[int, np.ndarray]:
    """Dirichlet(alpha) label-skew partition (reference
    `partition_class_samples_with_dirichlet_distribution`): for each class,
    split its sample indices across clients by p ~ Dir(alpha), balancing so no
    client exceeds n/n_clients early; retry until every client has at least
    ``min_size_floor`` samples."""
    labels = np.asarray(labels).reshape(-1)
    n = len(labels)
    classes = np.unique(labels)
    rng = np.random.RandomState(seed)
    min_size = 0
    tries = 0
    while min_size < min_size_floor:
        idx_batch: List[List[int]] = [[] for _ in range(n_clients)]
        for k in classes:
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            p = rng.dirichlet(np.repeat(alpha, n_clients))
            # balance clause from the reference implementation
            p = np.array([pv * (len(b) < n / n_clients)
                          for pv, b in zip(p, idx_batch)])
            p = p / p.sum() if p.sum() > 0 else np.repeat(1.0 / n_clients,
                                                          n_clients)
            cuts = (np.cumsum(p) * len(idx_k)).astype(int)[:-1]
            for b, part in zip(idx_batch, np.split(idx_k, cuts)):
                b.extend(part.tolist())
        min_size = min(len(b) for b in idx_batch)
        tries += 1
        if tries > 100:
            break
    return {i: np.sort(np.array(b, dtype=np.int64))
            for i, b in enumerate(idx_batch)}


def partition(labels: np.ndarray, n_clients: int, method: str = "hetero",
              alpha: float = 0.5, seed: int = 0) -> Dict[int, np.ndarray]:
    if method in ("homo", "iid"):
        return homo_partition(len(labels), n_clients, seed)
    return hetero_partition(labels, n_clients, alpha, seed)


def record_data_stats(labels: np.ndarray,
                      net_dataidx_map: Dict[int, np.ndarray]) -> Dict:
    """Per-client class histogram (reference `record_net_data_stats`)."""
    stats = {}
    for cid, idx in net_dataidx_map.items():
        unq, cnt = np.unique(np.asarray(labels)[idx], return_counts=True)
        stats[cid] = {int(u): int(c) for u, c in zip(unq, cnt)}
    return stats
