"""The cross-silo wire codec.

Port of ``fedml_tpu/utils/compression.py:117-353``: ``WireSpec``,
``parse_wire_compression``, ``required_caps``, ``WIRE_CAPS``, ``WireCodec``
(delta encoding with a client-side error-feedback residual, the four
codecs bf16 | int8 | topk | topk8, and the self-describing full-model
downlink encoding) and the decode paths.  ``TopKCompressor`` and
``EFTopKCompressor`` (the ``enable_compression`` upload leg) are not
ported: that leg raises (``cross_silo/client``).

Trees are nested dicts of tensors in the JAX package's layout and names
(``utils/weights.tree_from_module``), flattened in its order
(``utils/tree.py``).  A payload is a dict of tensors and scalars, the same
keys and values as the JAX package's: ``dtype`` fields carry JAX's dtype
names (``"float32"``).

The int8 legs run on ``ops/wire_compression.py``: the uplink's flat delta
is one quantize launch, and a whole model's broadcast one quantize launch
over a segment per float leaf (the blocks restart at every leaf, as the
JAX package's one ``pallas_call`` per leaf restarts them) and one
dequantize launch to decode it.

``WIRE_BYTES`` counts the payload bytes each run puts on the wire, by
direction and codec — the port's own counter, not the JAX package's
metrics registry.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..ops.wire_compression import (
    dequantize_int8_blocked,
    n_blocks,
    quantize_int8_blocked,
    scatter_flat,
    topk_select,
)
from .tree import tree_leaves, tree_map, tree_structure, tree_unflatten


class WireBytes:
    """Model payload bytes placed on the wire, by run id, direction (``up``:
    client uploads, ``down``: server broadcasts) and codec (``raw`` when
    uncompressed).  Thread-safe: every silo thread of a run counts into
    it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str, str], int] = {}

    def inc(self, run_id: Any, direction: str, codec: str,
            nbytes: int) -> None:
        key = (str(run_id), direction, codec)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + int(nbytes)

    def value(self, run_id: Any, direction: str, codec: str) -> int:
        with self._lock:
            return self._counts.get((str(run_id), direction, codec), 0)

    def for_run(self, run_id: Any) -> Dict[Tuple[str, str], int]:
        """``{(direction, codec): bytes}`` of one run."""
        with self._lock:
            return {(d, c): n for (r, d, c), n in self._counts.items()
                    if r == str(run_id)}


#: shared by the client and server managers: both ends of the wire count
#: into one table
WIRE_BYTES = WireBytes()

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64",
                torch.int32: "int32", torch.int64: "int64",
                torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_NAMED_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """JAX's name of ``dtype`` (``"float32"``), as payloads carry it."""
    return _DTYPE_NAMES[dtype]


def dtype_from_name(name: str) -> torch.dtype:
    return _NAMED_DTYPES[str(name)]


def _is_float(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype.is_floating_point


def tree_spec(tree: Any) -> Tuple[Any, List[torch.Size], List[torch.dtype]]:
    """(structure, shapes, dtypes) of ``tree``'s leaves, for
    ``_unflatten``."""
    leaves = tree_leaves(tree)
    return (tree_structure(tree), [l.shape for l in leaves],
            [l.dtype for l in leaves])


def _flatten(tree: Any) -> Tuple[torch.Tensor, Any]:
    """Every leaf, raveled and cast to float32, concatenated in flatten
    order — no padding between leaves."""
    return _cat_f32(tree_leaves(tree)), tree_spec(tree)


def _cat_f32(leaves: List[torch.Tensor]) -> torch.Tensor:
    """The leaves raveled into one float32 vector (one cast per leaf only
    where a leaf is not float32: the host work per leaf is what a model of
    hundreds of leaves pays for)."""
    return torch.cat([(l if l.dtype == torch.float32 else l.float())
                      .reshape(-1) for l in leaves])


def _unflatten(flat: torch.Tensor, spec: Any) -> Any:
    structure, shapes, dtypes = spec
    parts = torch.split(flat, [shape.numel() for shape in shapes])
    return tree_unflatten(structure, [
        p.view(shape) if dt == flat.dtype else p.view(shape).to(dt)
        for p, shape, dt in zip(parts, shapes, dtypes)])


# ---------------------------------------------------------------------------
# wire codec: delta + quantize/sparsify, negotiated per cross-silo link
# ---------------------------------------------------------------------------

class WireSpec(NamedTuple):
    """Parsed ``wire_compression`` selector (static per link)."""

    kind: str          # bf16 | int8 | topk | topk8
    ratio: float = 0.01


_WIRE_KINDS = ("bf16", "int8", "topk", "topk8")

#: capability tokens a client advertises in its status message; the server
#: only assigns a codec whose tokens the link's peer supports
WIRE_CAPS = ("delta", "bf16", "int8", "topk")

#: reserved marker key for per-leaf quantized downlink payloads
_WQ_KEY = "__wq__"


def parse_wire_compression(spec: Any) -> Optional[WireSpec]:
    """``None``/empty/``none`` → None; else validate and parse.  Raises
    ``ValueError`` on an unknown codec or a malformed ratio, so a typo
    fails at start-up, not on the first upload."""
    if spec is None or spec is False or str(spec).strip() == "":
        return None
    parts = [p for p in str(spec).strip().split(":") if p != ""]
    kind = parts[0].lower()
    if kind == "none":
        return None
    if kind not in _WIRE_KINDS:
        raise ValueError(
            f"unknown wire_compression codec {kind!r}; expected one of "
            f"none|{'|'.join(_WIRE_KINDS)}")
    ratio = 0.01
    if len(parts) > 1:
        if kind in ("bf16", "int8"):
            raise ValueError(f"wire_compression {kind} takes no parameter")
        try:
            ratio = float(parts[1])
        except ValueError as e:
            raise ValueError(
                f"malformed wire_compression ratio {parts[1]!r}") from e
        if not 0.0 < ratio <= 1.0:
            raise ValueError("wire_compression top-k ratio must be in (0, 1]")
    return WireSpec(kind, ratio)


def required_caps(spec: WireSpec) -> Tuple[str, ...]:
    """Capability tokens a peer must advertise for this codec to apply."""
    caps = ["delta"]
    if spec.kind == "bf16":
        caps.append("bf16")
    if spec.kind in ("int8", "topk8"):
        caps.append("int8")
    if spec.kind in ("topk", "topk8"):
        caps.append("topk")
    return tuple(caps)


def _add_delta_tree(ref: Any, delta_flat: torch.Tensor) -> Any:
    """ref tree + flat f32 delta → reconstructed tree, per leaf
    ``(leaf.float() + delta_slice).to(leaf.dtype)``.

    The add runs in float32: the delta is an exact float32 difference of
    the client's values, so adding in float32 and then casting reproduces
    the client's update bit for bit; narrowing the delta first would round
    twice.  The leaves are added as one flat vector, which gives each
    element the same float32 sum as a per-leaf add."""
    structure, shapes, dtypes = tree_spec(ref)
    total = _flatten(ref)[0] + delta_flat
    return _unflatten(total, (structure, shapes, dtypes))


class WireCodec:
    """Per-link update codec: DELTA against a shared reference + one of
    bf16 cast / blocked-int8 quantize / top-k sparsify / top-k+int8, with
    an error-feedback residual on the encode side.

    One instance per link per direction: the encoder's residual
    accumulates everything the codec dropped, so the information is sent
    eventually rather than lost."""

    def __init__(self, spec: Any) -> None:
        parsed = spec if isinstance(spec, WireSpec) else (
            parse_wire_compression(spec))
        if parsed is None:
            raise ValueError("WireCodec needs a non-empty codec spec")
        self.spec = parsed
        self._residual: Optional[torch.Tensor] = None

    # -- uplink: delta encoding ---------------------------------------------
    def encode_delta(self, update: Any, ref: Any) -> Dict[str, Any]:
        """update tree + shared reference tree → wire payload dict (tensors
        and scalars only)."""
        flat_u, _ = _flatten(update)
        flat_r, _ = _flatten(ref)
        delta = flat_u - flat_r
        if self._residual is not None and self._residual.shape == delta.shape:
            delta = delta + self._residual
        payload = self._encode_flat(delta)
        decoded = decode_delta_flat(payload)
        self._residual = delta - decoded
        return payload

    def _encode_flat(self, delta: torch.Tensor) -> Dict[str, Any]:
        kind = self.spec.kind
        d = int(delta.shape[0])
        if kind == "bf16":
            return {"codec": "bf16", "flat": delta.to(torch.bfloat16),
                    "size": d}
        if kind == "int8":
            q, s = quantize_int8_blocked(delta)
            return {"codec": "int8", "q": q, "scales": s, "size": d}
        k = max(1, int(d * self.spec.ratio))
        values, idx = topk_select(delta, k)
        if kind == "topk":
            return {"codec": "topk", "values": values, "idx": idx, "size": d}
        q, s = quantize_int8_blocked(values)
        return {"codec": "topk8", "values_q": q, "scales": s, "idx": idx,
                "size": d}

    # -- downlink: self-describing full-model encoding -----------------------
    @staticmethod
    def encode_model(tree: Any, kind: str = "int8") -> Any:
        """Full-model broadcast payload: every floating-point tensor leaf is
        replaced by a marker dict holding its blocked-int8 (or bf16) form
        plus what it takes to invert it without a reference tree.  The
        containers are kept.  The int8 form quantizes every float leaf in
        one launch, each leaf a segment of its own."""
        if kind not in ("int8", "bf16"):
            kind = "int8"   # topk on a full model is meaningless
        if kind == "bf16":
            return tree_map(
                lambda x: ({_WQ_KEY: "bf16", "flat": x.to(torch.bfloat16),
                            "dtype": dtype_name(x.dtype)}
                           if _is_float(x) else x), tree)
        floats = [l for l in tree_leaves(tree) if _is_float(l)]
        if not floats:
            return tree
        lengths = [l.numel() for l in floats]
        q, s = quantize_int8_blocked(_cat_f32(floats), lengths)
        marks = iter([
            {_WQ_KEY: "int8", "q": qi, "scales": si, "shape": list(l.shape),
             "dtype": dtype_name(l.dtype)}
            for l, qi, si in zip(floats, torch.split(q, lengths),
                                 torch.split(s, [n_blocks(n)
                                                 for n in lengths]))])
        return tree_map(lambda x: next(marks) if _is_float(x) else x, tree)

    @staticmethod
    def is_encoded_model(tree: Any) -> bool:
        return any(_is_marker(l) for l in tree_leaves(tree,
                                                      is_leaf=_is_marker))

    @staticmethod
    def decode_model(tree: Any) -> Any:
        """Invert ``encode_model``.  Deterministic: every decoder of the
        same payload reconstructs bit-identical values, which is what makes
        the decoded broadcast usable as the shared delta reference.  The
        int8 leaves decode in one launch."""
        int8 = [m for m in tree_leaves(tree, is_leaf=_is_marker)
                if _is_marker(m) and m[_WQ_KEY] != "bf16"]
        values = iter(())
        if int8:
            # the q and scales of a marker are flat vectors (ravel any
            # other shape), one cat each for the whole model
            lengths = [m["q"].numel() for m in int8]
            flat = dequantize_int8_blocked(
                torch.cat([m["q"].reshape(-1) for m in int8]),
                torch.cat([m["scales"].reshape(-1) for m in int8]),
                sum(lengths), lengths)
            values = iter(torch.split(flat, lengths))

        def _leaf(x: Any) -> Any:
            if not _is_marker(x):
                return x
            if x[_WQ_KEY] == "bf16":
                return x["flat"].to(dtype_from_name(x["dtype"]))
            v = next(values).view(x["shape"])
            return v if x["dtype"] == "float32" else v.to(
                dtype_from_name(x["dtype"]))

        return tree_map(_leaf, tree, is_leaf=_is_marker)


def _is_marker(x: Any) -> bool:
    return isinstance(x, dict) and _WQ_KEY in x


def decode_delta_flat(payload: Dict[str, Any]) -> torch.Tensor:
    """Wire payload → flat f32 delta."""
    codec = str(payload["codec"])
    size = int(payload["size"])
    if codec == "bf16":
        return payload["flat"].float()
    if codec == "int8":
        return dequantize_int8_blocked(payload["q"], payload["scales"], size)
    if codec == "topk":
        return scatter_flat(payload["values"], payload["idx"], size)
    if codec == "topk8":
        q = payload["values_q"]
        return scatter_flat(
            dequantize_int8_blocked(q, payload["scales"], q.numel()),
            payload["idx"], size)
    raise ValueError(f"unknown wire payload codec {codec!r}")


def decode_delta(payload: Dict[str, Any], ref: Any) -> Any:
    """payload + shared reference tree → reconstructed update tree (ref +
    delta in each leaf's own dtype)."""
    return _add_delta_tree(ref, decode_delta_flat(payload))
