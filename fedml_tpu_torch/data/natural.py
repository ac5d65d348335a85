"""Natural (per-user) federated partitions: the "no files → None" contract.

Port of the dispatch half of ``fedml_tpu/data/natural.py::load_natural``.
The JAX package reads client-keyed files from ``data_cache_dir`` — an npz
cache (``<stem>_train.npz`` with ``x_<user>`` arrays), LEAF JSON
directories (``<DATASET>/train/*.json``) or client-keyed h5
(``<stem>_train.h5``) — and builds one client per natural user from them;
with none there it returns None and the caller takes the synthetic
Dirichlet split.  The port keeps that contract and no more: with no such
file it returns None, and where the JAX package would read one it raises
``NotImplementedError`` (port item A2), so it never trains on the
synthetic split in place of the user's own data.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import numpy as np

#: reference TFF archive stems whose h5 file names do not carry the
#: dataset name (``fedml_tpu/data/natural.py:_REFERENCE_H5_STEMS``)
_REFERENCE_H5_STEMS = {
    "fed_shakespeare": "shakespeare",
    "shakespeare": "shakespeare",
    "stackoverflow_nwp": "stackoverflow",
}


def _h5_stems(dataset: str) -> List[str]:
    stems = [dataset, dataset.replace("fed_", "")]
    ref = _REFERENCE_H5_STEMS.get(dataset)
    if ref:
        stems.append(ref)
    return list(dict.fromkeys(stems))


def _npz_has_users(path: str) -> bool:
    if not os.path.exists(path):
        return False
    with np.load(path, allow_pickle=False) as z:
        return any(k.startswith("x_") for k in z.files)


def client_keyed_files(cache_dir: str, dataset: str) -> List[str]:
    """The client-keyed files under ``cache_dir`` that the JAX package's
    ``load_user_splits`` would read for ``dataset``, in its order of
    preference (npz cache, LEAF JSON, h5); empty when there are none."""
    base = dataset.replace("fed_", "")
    found = [p for stem in (dataset, base, f"leaf_{base}")
             for p in [os.path.join(cache_dir, f"{stem}_train.npz")]
             if _npz_has_users(p)]
    leaf_root = os.path.join(cache_dir, dataset.upper())
    if not os.path.isdir(leaf_root):
        leaf_root = os.path.join(cache_dir, dataset)
    train_dir = os.path.join(leaf_root, "train")
    if os.path.isdir(train_dir):
        found += [os.path.join(train_dir, f) for f in
                  sorted(os.listdir(train_dir)) if f.endswith(".json")]
    found += [p for stem in _h5_stems(dataset)
              for p in [os.path.join(cache_dir, f"{stem}_train.h5")]
              if os.path.exists(p)]
    return found


def load_natural(args: Any) -> Optional[Tuple]:
    """None when ``data_cache_dir`` holds no client-keyed files for
    ``args.dataset``; raises ``NotImplementedError`` when it does."""
    cache_dir = str(getattr(args, "data_cache_dir", "") or "")
    dataset = str(getattr(args, "dataset", ""))
    if not cache_dir:
        return None
    files = client_keyed_files(cache_dir, dataset)
    if not files:
        return None
    raise NotImplementedError(
        f"natural per-user partitions are not ported yet (port item A2): "
        f"the JAX package would build {dataset!r}'s clients from "
        f"{files[0]}; move the client-keyed files out of {cache_dir!r} to "
        f"train on the synthetic split")
