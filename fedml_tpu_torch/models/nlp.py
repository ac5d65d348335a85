"""The BERT-tiny-scale transformer language model in PyTorch.

Port of ``fedml_tpu/models/nlp.py::TransformerBlock`` and
``TinyTransformerLM`` (the Fed-Shakespeare BASELINE config's model).
Submodules and parameters carry flax's names — ``Embed_0``, ``pos_embed``,
``TransformerBlock_<i>`` with ``LayerNorm_0``,
``MultiHeadDotProductAttention_0`` (``query``, ``key``, ``value``,
``out``), ``LayerNorm_1``, ``Dense_0`` and ``Dense_1``, then ``LayerNorm_0``
and ``Dense_0`` — so ``utils/weights.py`` maps the JAX tree by path.

What flax does, and this module repeats explicitly:

* ``dtype`` is the compute dtype: parameters stay float32 and every
  ``Dense``/``DenseGeneral`` casts its input, kernel and bias to ``dtype``;
  the head returns float32 logits.  Tokens and positions are embedded in
  float32 and cast to ``dtype`` after their sum.
* ``LayerNorm``: epsilon 1e-6, statistics in float32 with the fast
  variance ``E[x²] − E[x]²`` (clipped at 0), the normalisation in float32,
  the result cast to ``dtype``.
* ``gelu`` is the tanh approximation.
* Attention heads keep flax's ``DenseGeneral`` kernels: ``[dim, heads,
  head_dim]`` for query, key and value (biases ``[heads, head_dim]``) and
  ``[heads, head_dim, dim]`` for out; the weights here are stored in those
  layouts, so the carry-over is a copy.
* Two attention paths, switched as ``nlp.py:98-101`` switches them: a pass
  with no attention dropout (eval, or training at ``dropout`` 0) goes
  through ``ops/pallas_attention.flash_mha`` — the flash kernel on a card;
  a training pass with dropout goes through ``dot_product_attention``, the
  plain product of ``nn.dot_product_attention``: scores in ``dtype``, a
  masked score at ``dtype``'s minimum, softmax, then dropout on the weights
  with one keep mask ``[1, 1, T, T]`` shared by the batch and the heads.
  On the rows the causal mask allows the two give the same softmax.
* Dropout (``nn.Dropout`` on the embeddings, elementwise, and on the
  attention weights) keeps with probability ``1 − rate`` and scales by
  ``1 / (1 − rate)``.  It draws from the ``torch.Generator`` passed as
  ``rng``; JAX's bits are not torch's, so the masks match in structure and
  rate, not in value.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pallas_attention import flash_mha
from .cv import Dense, _lecun_normal_

_LN_EPS = 1e-6


def _keep_mask(shape, rate: float, rng: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """Bernoulli(1 − rate) keep mask of ``shape``, drawn from ``rng``."""
    if rng is None:
        raise ValueError("a training pass with dropout needs a dropout "
                         "generator (rng)")
    return torch.rand(shape, generator=rng, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, train: bool,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """``nn.Dropout``: elementwise keep mask, kept values divided by the
    keep rate in ``x``'s dtype."""
    if not train or rate == 0.0:
        return x
    keep = _keep_mask(x.shape, rate, rng, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dot_product_attention_weights(query: torch.Tensor, key: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None,
                                  dropout_rate: float = 0.0,
                                  deterministic: bool = True,
                                  rng: Optional[torch.Generator] = None
                                  ) -> torch.Tensor:
    """flax's ``dot_product_attention_weights`` on [B, T, H, D] query and
    key: [B, H, T, Tk] weights in the inputs' dtype; dropout shares one
    keep mask [1, 1, T, Tk] over batch and heads (``broadcast_dropout``)."""
    dtype = query.dtype
    depth = query.shape[-1]
    query = query / torch.tensor(math.sqrt(depth), dtype=torch.float32
                                 ).to(dtype)
    w = torch.einsum("bqhd,bkhd->bhqk", query, key)
    if mask is not None:
        w = w.masked_fill(~mask, torch.finfo(dtype).min)
    w = torch.softmax(w, dim=-1).to(dtype)
    if not deterministic and dropout_rate > 0.0:
        keep_prob = 1.0 - dropout_rate
        keep = _keep_mask((1, 1) + tuple(w.shape[-2:]), dropout_rate, rng,
                          w.device)
        w = w * (keep.to(dtype) / torch.tensor(keep_prob, dtype=dtype))
    return w


def dot_product_attention(query, key, value, mask=None,
                          dropout_rate: float = 0.0,
                          deterministic: bool = True,
                          rng: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """flax's ``nn.dot_product_attention`` on [B, T, H, D]: the weights,
    then their product with ``value``, [B, T, H, D]."""
    w = dot_product_attention_weights(query, key, mask, dropout_rate,
                                      deterministic, rng)
    return torch.einsum("bhqk,bkhd->bqhd", w, value)


class Embed(nn.Module):
    """``nn.Embed``: ``weight`` is flax's ``embedding`` [vocab, dim],
    float32, looked up in float32."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        # variance_scaling(1, fan_in, normal, out_axis=0): std 1/sqrt(dim)
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight)


class LayerNorm(nn.Module):
    """``nn.LayerNorm(dtype=dtype)``: ``weight``/``bias`` are flax's
    ``scale``/``bias``; see the module note for the arithmetic."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + _LN_EPS) * self.weight)
        return (y + self.bias).to(self.dtype)


class DenseGeneral(nn.Module):
    """``nn.DenseGeneral`` of the attention heads, its weights in flax's
    layout: ``"in"`` projects [..., dim] to [..., heads, head_dim] (kernel
    [dim, heads, head_dim], bias [heads, head_dim]); ``"out"`` contracts
    [..., heads, head_dim] to [..., dim] (kernel [heads, head_dim, dim],
    bias [dim]).  Computes in ``dtype`` and returns ``dtype``."""

    def __init__(self, dim: int, heads: int, head_dim: int, kind: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kind, self.dtype = kind, dtype
        self.heads, self.head_dim = heads, head_dim
        if kind == "in":
            self.weight = nn.Parameter(torch.empty(dim, heads, head_dim))
            self.bias = nn.Parameter(torch.zeros(heads, head_dim))
        else:
            self.weight = nn.Parameter(torch.empty(heads, head_dim, dim))
            self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        fan_in = (self.weight.shape[0] if self.kind == "in"
                  else self.heads * self.head_dim)
        _lecun_normal_(self.weight, fan_in, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = self.bias.to(self.dtype)
        x = x.to(self.dtype)
        if self.kind == "in":
            y = x @ w.reshape(w.shape[0], -1)
            return (y + b.reshape(-1)).unflatten(-1, (self.heads,
                                                      self.head_dim))
        return x.flatten(-2) @ w.reshape(-1, w.shape[-1]) + b


class MultiHeadDotProductAttention(nn.Module):
    """``nn.MultiHeadDotProductAttention`` (qkv features = dim) with its
    ``attention_fn`` chosen per call (see ``TransformerBlock``)."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        hd = dim // heads
        self.query = DenseGeneral(dim, heads, hd, "in", dtype)
        self.key = DenseGeneral(dim, heads, hd, "in", dtype)
        self.value = DenseGeneral(dim, heads, hd, "in", dtype)
        self.out = DenseGeneral(dim, heads, hd, "out", dtype)

    def forward(self, x: torch.Tensor, causal: bool, flash: bool,
                dropout_rate: float, train: bool,
                rng: Optional[torch.Generator]) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, T, H, D]
        if flash:
            y = flash_mha(q, k, v, causal=causal)
        else:
            mask = None
            if causal:
                t = x.shape[1]
                mask = torch.tril(torch.ones((1, 1, t, t), dtype=torch.bool,
                                             device=x.device))
            y = dot_product_attention(q, k, v, mask, dropout_rate,
                                      deterministic=not train, rng=rng)
        return self.out(y)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + MHA(LN(x)), then x + MLP(LN(x)) (gelu, ratio 4)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, causal: bool = False,
                 dtype: torch.dtype = torch.float32, use_flash: bool = True):
        super().__init__()
        self.dropout, self.causal, self.use_flash = dropout, causal, use_flash
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, dim * mlp_ratio, dtype, float_out=False)
        self.Dense_1 = Dense(dim * mlp_ratio, dim, dtype, float_out=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        # the flash kernel on every pass without attention-weight dropout
        flashable = self.use_flash and (not train or self.dropout == 0.0)
        y = self.MultiHeadDotProductAttention_0(
            y, self.causal, flashable, self.dropout, train, rng)
        x = x + y
        y = self.LayerNorm_1(x)
        y = F.gelu(self.Dense_0(y), approximate="tanh")
        return x + self.Dense_1(y)


class TinyTransformerLM(nn.Module):
    """BERT-tiny-scale causal LM (dim 128, 2 layers, 2 heads) for the
    Fed-Shakespeare BASELINE config.  ``forward(x, train, rng)``: x [B, T]
    integer tokens → float32 logits [B, T, vocab]."""

    def __init__(self, vocab_size: int = 90, dim: int = 128, layers: int = 2,
                 heads: int = 2, max_len: int = 512, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.Embed_0 = Embed(vocab_size, dim)
        self.pos_embed = nn.Parameter(torch.empty(max_len, dim))
        self.blocks = []
        for i in range(layers):
            blk = TransformerBlock(dim, heads, causal=True, dropout=dropout,
                                   dtype=dtype)
            self.add_module(f"TransformerBlock_{i}", blk)
            self.blocks.append(blk)
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, vocab_size, dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Fresh variables from ``generator``: flax's initializers (normal
        embeddings, pos_embed normal(0.02), lecun normal kernels, zero
        biases, unit LayerNorm scales), drawn by torch, so not JAX's
        numbers."""
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        t = x.shape[1]
        h = self.Embed_0(x) + self.pos_embed[:t][None]
        h = dropout(h.to(self.dtype), self.dropout, train, rng)
        for blk in self.blocks:
            h = blk(h, train=train, rng=rng)
        return self.Dense_0(self.LayerNorm_0(h))
