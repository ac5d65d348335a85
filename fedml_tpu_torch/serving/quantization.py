"""Int8 weight quantization for serving.

Port of ``fedml_tpu/serving/quantization.py`` (``_MATMUL_KEYS``,
``quantize_matrix_int8``, ``dequantize_matrix`` and
``quantize_lm_params``).  Single-token decode streams every weight from
memory for one row of activations, so storing the matmul weights as
per-output-channel int8 quarters their bytes against float32; the error
of a weight is at most half its column's scale.
``ops/pallas_ops.int8_matmul`` multiplies by such a matrix with the
dequantization inside the kernel.

``quantize_lm_params`` takes the functional LM's parameter dict (the JAX
package's ``parallel/seq_parallel.init_lm_params`` layout: ``blocks`` of
``wq``, ``wk``, ``wv``, ``wo`` ``[dim, dim]``, ``w1`` ``[dim, 4·dim]`` and
``w2`` ``[4·dim, dim]``); embeddings, positions and LayerNorm parameters
stay in full precision.  ``QuantizedKVCacheLM`` and its jitted
``_q_prefill``, ``_q_decode`` and ``_q_decode_multi`` steps wrap the
KV-cache LM, which is not ported yet (ROADMAP A17): they come with it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


def quantize_matrix_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``[in, out]`` → ``{"q": int8 [in, out], "s": float32 [out]}``,
    symmetric per output channel: ``s = max(amax|w| / 127, 1e-12)``,
    ``q = clip(round(w / s), ±127)``.  The divisions divide by tensors,
    as jnp's do (PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal), so the bits are the JAX package's on either device."""
    amax = w.abs().amax(dim=0)
    s = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    q = torch.clamp(torch.round(w / s[None, :]), -127, 127).to(torch.int8)
    return {"q": q, "s": s.float()}


def dequantize_matrix(qs: Dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return qs["q"].to(dtype) * qs["s"].to(dtype)[None, :]


def quantize_lm_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every transformer matmul weight; leave embeddings, position
    table, and layernorm params full-precision."""
    out = dict(params)
    out["blocks"] = []
    for blk in params["blocks"]:
        qblk = dict(blk)
        for k in _MATMUL_KEYS:
            qblk[k] = quantize_matrix_int8(blk[k])
        out["blocks"].append(qblk)
    return out
