"""Pytree serialization and message payload sizes.

Port of ``fedml_tpu/utils/serialization.py``:

* ``dumps_pytree`` and ``loads_pytree``, the JAX package's self-describing
  binary format — the magic ``FTPT``, a little-endian uint32 header length,
  a JSON header (the tree's structure, and each leaf's dtype name and
  shape), then each leaf's raw little-endian bytes in order.  Nothing is
  executed on decode.  Files written by either package read in the other.
  The port does without ``ml_dtypes``: a bfloat16 leaf (a torch tensor, or
  a numpy array of that dtype) is written as its 16-bit pattern under the
  dtype name ``bfloat16`` and read back as a torch bfloat16 tensor.  The
  JAX package's FHE ciphertext trees are not ported (port item A13).
* ``estimate_nbytes``, the wire-byte accounting of the INPROC transport,
  which passes payloads by reference and never serializes them.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, List

import numpy as np
import torch

_MAGIC = b"FTPT"  # fedml-tpu pytree
_BF16 = "bfloat16"


def _leaf_bytes(obj: Any) -> Any:
    """``(dtype name, shape, bytes)`` of an array leaf: a torch tensor or
    anything numpy takes."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16, list(t.shape), t.view(torch.int16).numpy().tobytes()
        obj = t.numpy()
    arr = np.asarray(obj)
    name = arr.dtype.name
    if name == _BF16:
        arr = arr.view(np.uint16)
    elif arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return name, list(arr.shape), arr.tobytes()


def _flatten_struct(obj: Any, leaves: List[Any]) -> Any:
    """Replace arrays and tensors with leaf placeholders, recursing into
    containers."""
    if isinstance(obj, dict):
        keys = sorted(obj.keys())
        return {"t": "d", "k": keys,
                "v": [_flatten_struct(obj[k], leaves) for k in keys]}
    if isinstance(obj, (list, tuple)):
        return {"t": "l" if isinstance(obj, list) else "u",
                "v": [_flatten_struct(x, leaves) for x in obj]}
    if obj is None:
        return {"t": "n"}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "s", "v": obj}
    leaves.append(_leaf_bytes(obj))
    return {"t": "a", "i": len(leaves) - 1}


def _unflatten_struct(spec: Any, leaves: List[Any]) -> Any:
    t = spec["t"]
    if t == "d":
        return {k: _unflatten_struct(v, leaves)
                for k, v in zip(spec["k"], spec["v"])}
    if t == "l":
        return [_unflatten_struct(x, leaves) for x in spec["v"]]
    if t == "u":
        return tuple(_unflatten_struct(x, leaves) for x in spec["v"])
    if t == "n":
        return None
    if t == "s":
        return spec["v"]
    if t == "a":
        return leaves[spec["i"]]
    raise ValueError(f"unknown node {t!r} in a pytree payload")


def dumps_pytree(tree: Any) -> bytes:
    """``tree`` — dicts (keys sorted), lists, tuples, None, Python scalars,
    numpy arrays and torch tensors — as the JAX package's bytes."""
    leaves: List[Any] = []
    spec = _flatten_struct(tree, leaves)
    header = {"spec": spec,
              "leaves": [{"dtype": name, "shape": shape}
                         for name, shape, _ in leaves]}
    hbytes = json.dumps(header).encode()
    out = io.BytesIO()
    out.write(_MAGIC)
    out.write(struct.pack("<I", len(hbytes)))
    out.write(hbytes)
    for _, _, data in leaves:
        out.write(data)
    return out.getvalue()


def loads_pytree(data: bytes) -> Any:
    """The inverse: numpy arrays for the leaves, torch bfloat16 tensors
    for bfloat16 leaves.  Raises ValueError on a payload that is not one
    or is cut short."""
    if data[:4] != _MAGIC or len(data) < 8:
        raise ValueError("not a fedml_tpu pytree payload")
    hlen = struct.unpack("<I", data[4:8])[0]
    if len(data) < 8 + hlen:
        raise ValueError("pytree payload cut short in its header")
    header = json.loads(data[8:8 + hlen].decode())
    off = 8 + hlen
    leaves: List[Any] = []
    for meta in header["leaves"]:
        shape = [int(s) for s in meta["shape"]]
        n = int(np.prod(shape)) if shape else 1
        bf16 = meta["dtype"] == _BF16
        dt = np.dtype("<u2" if bf16 else meta["dtype"]).newbyteorder("<")
        nbytes = n * dt.itemsize
        if len(data) < off + nbytes:
            raise ValueError("pytree payload cut short in its leaves")
        arr = np.frombuffer(data, dtype=dt, count=n, offset=off).reshape(
            tuple(shape))
        if bf16:
            arr = torch.from_numpy(arr.astype(np.int16)).view(torch.bfloat16)
        leaves.append(arr)
        off += nbytes
    return _unflatten_struct(header["spec"], leaves)


def estimate_nbytes(obj: Any) -> int:
    """Wire-size estimate of a message payload without serializing it:
    tensors count ``numel · element_size``, numpy arrays their buffer,
    scalars and strings their natural width, containers a framing constant
    of 16 — the JAX package's counts, so a payload weighs the same in
    either package."""
    if obj is None or isinstance(obj, bool):
        return 1
    if isinstance(obj, (int, float)):
        return 8
    if isinstance(obj, (str, bytes)):
        return len(obj)
    if isinstance(obj, dict):
        return 16 + sum(estimate_nbytes(k) + estimate_nbytes(v)
                        for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return 16 + sum(estimate_nbytes(x) for x in obj)
    if isinstance(obj, torch.Tensor):
        return int(obj.numel() * obj.element_size())
    nbytes = getattr(obj, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    try:
        return int(np.asarray(obj).nbytes)
    except (TypeError, ValueError):  # opaque object: a flat guess
        return 64
