"""Secure-aggregation primitives: finite field, Shamir shares, LCC, and the
bulk mask arithmetic on tensors.

Port of ``fedml_tpu/core/mpc/secagg.py``.  Two halves, as there:

* the key and share math is tiny and runs on the host in numpy int64 over
  the prime field p = 2^31 − 1 (products of two residues below 2^31 fit
  int64): ``modular_inv``, ``pow_mod``, Shamir sharing and reconstruction,
  the Lagrange basis and LCC encoding and decoding — the JAX package's own
  numpy code, carried over as it is;
* the bulk masking of model updates runs on tensors as natural modulo
  2^32 arithmetic: ``quantize`` (float → fixed-point words), ``mask_model``
  (add a mask with wraparound), ``unmask_sum`` (subtract the aggregate
  mask) and ``dequantize``, with the masks from ``prg_mask_like``.

uint32 words travel as ``torch.int32`` tensors with the same bits
(``ops/pallas_ops.words``): PyTorch cannot add ``torch.uint32`` tensors,
and int32 addition and subtraction wrap as uint32 arithmetic does.  The
fixed-point conversion saturates at the int32 range and maps NaN to 0, as
XLA's does (``ops/pallas_ops.fixed_point``).  ``quantize`` and
``mask_model`` stay plain tensor ops, as in the JAX package;
``ops/pallas_ops.quantize_mask`` fuses the two into one kernel pass.

``prg_mask_like`` draws each leaf's mask from a ``torch.Generator`` seeded
with ``(seed & 0x7FFFFFFF, leaf index)`` on the CPU and moves it to the
leaf's device, so a seed gives the same masks on the CPU and on a card.
The draws are not ``jax.random.bits``': the distribution (uniform 32-bit
words) is the same, the bits are not.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ...ops.pallas_ops import SCALE, fixed_point, words
from ...utils.tree import (
    leaf_generator,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

# Mersenne prime 2^31 − 1: residues fit in int32; int64 products are exact.
FIELD_PRIME = np.int64(2**31 - 1)


# ---------------------------------------------------------------------------
# field arithmetic (host, numpy int64)
# ---------------------------------------------------------------------------

def modular_inv(a: np.ndarray, p: np.int64 = FIELD_PRIME) -> np.ndarray:
    """Inverse via Fermat: a^(p-2) mod p."""
    return pow_mod(a, int(p - 2), p)


def pow_mod(a: np.ndarray, e: int, p: np.int64 = FIELD_PRIME) -> np.ndarray:
    a = np.asarray(a, np.int64) % p
    result = np.ones_like(a)
    while e > 0:
        if e & 1:
            result = (result * a) % p
        a = (a * a) % p
        e >>= 1
    return result


def _eval_poly(coeffs: np.ndarray, x: np.int64,
               p: np.int64 = FIELD_PRIME) -> np.ndarray:
    """Horner evaluation of polynomial(s) with vector coefficients.
    coeffs: [deg+1, dim] int64."""
    acc = np.zeros(coeffs.shape[1], np.int64)
    for c in coeffs[::-1]:
        acc = (acc * np.int64(x) + c) % p
    return acc


# ---------------------------------------------------------------------------
# Shamir secret sharing (vector secrets)
# ---------------------------------------------------------------------------

def shamir_share(secret: np.ndarray, n: int, t: int, rng: np.random.RandomState,
                 p: np.int64 = FIELD_PRIME) -> Dict[int, np.ndarray]:
    """Split a vector secret into n shares, any t+1 reconstruct.
    Share for party i evaluates the degree-t polynomial at x=i+1."""
    secret = np.asarray(secret, np.int64) % p
    coeffs = np.concatenate([
        secret[None, :],
        rng.randint(0, int(p), size=(t, len(secret))).astype(np.int64),
    ])
    return {i: _eval_poly(coeffs, np.int64(i + 1), p) for i in range(n)}


def shamir_reconstruct(shares: Dict[int, np.ndarray],
                       p: np.int64 = FIELD_PRIME) -> np.ndarray:
    """Lagrange interpolation at x=0 from party-indexed shares."""
    xs = np.array(sorted(shares.keys()), np.int64)
    out = np.zeros_like(next(iter(shares.values())))
    for i in xs:
        num, den = np.int64(1), np.int64(1)
        for j in xs:
            if j == i:
                continue
            num = (num * ((-(j + 1)) % p)) % p
            den = (den * ((i - j) % p)) % p
        lam = (num * modular_inv(den, p)) % p
        out = (out + lam * (shares[int(i)] % p)) % p
    return out


# ---------------------------------------------------------------------------
# Lagrange coded computing
# ---------------------------------------------------------------------------

def _lagrange_basis(eval_points: np.ndarray, interp_points: np.ndarray,
                    p: np.int64 = FIELD_PRIME) -> np.ndarray:
    """U[i, j] = l_j(alpha_i): evaluate basis polys (nodes = interp_points)
    at eval_points. Shapes: [len(eval), len(interp)]."""
    e = np.asarray(eval_points, np.int64) % p
    b = np.asarray(interp_points, np.int64) % p
    U = np.zeros((len(e), len(b)), np.int64)
    for j in range(len(b)):
        num = np.ones(len(e), np.int64)
        den = np.int64(1)
        for k in range(len(b)):
            if k == j:
                continue
            num = (num * ((e - b[k]) % p)) % p
            den = (den * ((b[j] - b[k]) % p)) % p
        U[:, j] = (num * modular_inv(den, p)) % p
    return U


def LCC_encoding_with_points(X: np.ndarray, interp_points: Sequence[int],
                             eval_points: Sequence[int],
                             p: np.int64 = FIELD_PRIME) -> np.ndarray:
    """Encode data blocks X [m, ...] (poly through (beta_j, X_j)) evaluated
    at alpha_i → [n_eval, ...]."""
    X = np.asarray(X, np.int64) % p
    U = _lagrange_basis(np.asarray(eval_points), np.asarray(interp_points), p)
    flat = X.reshape(X.shape[0], -1)
    out = np.zeros((U.shape[0], flat.shape[1]), np.int64)
    for i in range(U.shape[0]):
        out[i] = np.sum((U[i][:, None] * flat) % p, axis=0) % p
    return out.reshape((U.shape[0],) + X.shape[1:])


def LCC_decoding_with_points(F: np.ndarray, eval_points_in: Sequence[int],
                             target_points: Sequence[int],
                             p: np.int64 = FIELD_PRIME) -> np.ndarray:
    """Decode: interpolate through (alpha_i, F_i) and evaluate at targets."""
    F = np.asarray(F, np.int64) % p
    U = _lagrange_basis(np.asarray(target_points), np.asarray(eval_points_in),
                        p)
    flat = F.reshape(F.shape[0], -1)
    out = np.zeros((U.shape[0], flat.shape[1]), np.int64)
    for i in range(U.shape[0]):
        out[i] = np.sum((U[i][:, None] * flat) % p, axis=0) % p
    return out.reshape((U.shape[0],) + F.shape[1:])


# ---------------------------------------------------------------------------
# bulk masking on tensors (mod 2^32, uint32 bits in int32)
# ---------------------------------------------------------------------------

def quantize(tree: Any, scale: float = SCALE) -> Any:
    """float tree → fixed-point words (two's-complement int32 bits)."""
    return tree_map(lambda x: fixed_point(x, scale), tree)


def dequantize(tree: Any, n_summed: int = 1, scale: float = SCALE) -> Any:
    """Words → float32 ``int32(x) / scale``.  ``n_summed`` is unused, as in
    the JAX package: a sum of n quantized values dequantizes to their sum.
    The divisor is a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds differently for scales that
    are no power of two."""
    def one(x: torch.Tensor) -> torch.Tensor:
        xf = words(x).float()
        return xf / torch.full((), scale, dtype=torch.float32,
                               device=xf.device)

    return tree_map(one, tree)


def prg_mask_like(tree: Any, seed: int) -> Any:
    """Deterministic uint32 mask tree (int32 bits) from a seed, one leaf of
    uniform words per leaf of ``tree``: the PRG both the client and the
    reconstructor expand."""
    seed = int(seed) & 0x7FFFFFFF
    masks = [torch.randint(-2 ** 31, 2 ** 31, tuple(leaf.shape),
                           dtype=torch.int32,
                           generator=leaf_generator(seed, i)
                           ).to(leaf.device)
             for i, leaf in enumerate(tree_leaves(tree))]
    return tree_unflatten(tree, masks)


def mask_model(qtree: Any, mask: Any) -> Any:
    """Add the mask modulo 2^32 (int32 wraparound)."""
    return tree_map(lambda x, m: words(x) + words(m), qtree, mask)


def unmask_sum(qsum: Any, aggregate_mask: Any) -> Any:
    """Subtract the aggregate mask modulo 2^32."""
    return tree_map(lambda x, m: words(x) - words(m), qsum, aggregate_mask)
