"""fedml_tpu_torch.data.load(args) — the standard dataset tuple.

Port of ``fedml_tpu/data/data_loader.py::load``: returns ``[train_num,
test_num, train_global, test_global, local_num_dict, train_local_dict,
test_local_dict, class_num]`` as host numpy ``(x, y)`` tuples and stashes
``args.client_row_map`` (each client's global row indices) for the Parrot
device-resident gather.  Batching and the move to the device happen in the
engine (``ml/engine/local_update.py``, ``simulation/parrot``).  The natural
per-user partitions (LEAF family) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from .datasets import load_arrays
from .partition import partition, record_data_stats

DatasetTuple = Tuple[int, int, Tuple, Tuple, Dict, Dict, Dict, int]


def load(args: Any) -> DatasetTuple:
    dataset = str(getattr(args, "dataset", "synthetic"))
    cache_dir = str(getattr(args, "data_cache_dir", "") or "")
    seed = int(getattr(args, "random_seed", 0) or 0)
    n_clients = int(getattr(args, "client_num_in_total", 10))
    method = str(getattr(args, "partition_method", "hetero"))
    alpha = float(getattr(args, "partition_alpha", 0.5) or 0.5)
    scale = float(getattr(args, "data_scale", 1.0) or 1.0)
    if method == "natural":
        raise NotImplementedError(
            "partition_method 'natural' is not ported yet")

    (x_train, y_train, x_test, y_test), class_num = load_arrays(
        dataset, cache_dir, seed=seed, scale=scale,
        hard=bool(getattr(args, "synthetic_hard", False)))

    net_dataidx_map = partition(y_train, n_clients, method, alpha, seed)
    test_map = partition(y_test, n_clients, "homo", alpha, seed + 1)

    train_local: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    test_local: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    local_num: Dict[int, int] = {}
    for cid in range(n_clients):
        idx = net_dataidx_map[cid]
        train_local[cid] = (x_train[idx], y_train[idx])
        local_num[cid] = int(len(idx))
        tidx = test_map[cid]
        test_local[cid] = (x_test[tidx], y_test[tidx])

    setattr(args, "data_stats", record_data_stats(y_train, net_dataidx_map))
    # global-row index map per client, for the Parrot device-resident gather
    setattr(args, "client_row_map",
            {c: np.asarray(v, np.int64) for c, v in net_dataidx_map.items()})

    return (len(y_train), len(y_test), (x_train, y_train), (x_test, y_test),
            local_num, train_local, test_local, class_num)
