"""LightSecAgg — mask-encoding secure aggregation.

Port of ``fedml_tpu/core/mpc/lightsecagg.py``, numpy only, as there: each
client generates a local mask z_i, LCC-encodes it into n shares (tolerating
d dropouts), sends share j to client j; the server sums the surviving
clients' masked models and asks each survivor for the sum of the shares it
holds; the aggregate mask is LCC-decoded from any U survivors and
subtracted.  The mask itself is applied to tensors by
``secagg.mask_model``; the encoded-share plumbing below is host field math.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .secagg import (
    FIELD_PRIME,
    LCC_decoding_with_points,
    LCC_encoding_with_points,
)


def mask_encoding(d: int, n: int, u: int, t: int,
                  local_mask: np.ndarray,
                  rng: np.random.RandomState,
                  p: np.int64 = FIELD_PRIME) -> Dict[int, np.ndarray]:
    """Encode a flat int mask [d] into n shares; any u of them reconstruct.

    Pads the mask into (u − t) blocks, appends t random blocks (privacy),
    and LCC-encodes over points beta=1..u, alpha=u+1..u+n."""
    k = u - t
    block = -(-d // k)
    padded = np.zeros(k * block, np.int64)
    padded[:d] = np.asarray(local_mask, np.int64) % p
    blocks = padded.reshape(k, block)
    noise = rng.randint(0, int(p), size=(t, block)).astype(np.int64)
    X = np.concatenate([blocks, noise], axis=0)          # [u, block]
    beta = list(range(1, u + 1))
    alpha = list(range(u + 1, u + n + 1))
    encoded = LCC_encoding_with_points(X, beta, alpha, p)  # [n, block]
    return {j: encoded[j] for j in range(n)}


def aggregate_encoded_masks(shares: Sequence[np.ndarray],
                            p: np.int64 = FIELD_PRIME) -> np.ndarray:
    """Each surviving client sums the shares it holds for the surviving set."""
    out = np.zeros_like(np.asarray(shares[0], np.int64))
    for s in shares:
        out = (out + np.asarray(s, np.int64)) % p
    return out


def decode_aggregate_mask(agg_shares: Dict[int, np.ndarray], d: int, n: int,
                          u: int, t: int,
                          p: np.int64 = FIELD_PRIME) -> np.ndarray:
    """From any u surviving clients' aggregated shares, interpolate the sum
    of masks: decode at beta=1..(u−t) and unpad to [d]."""
    if len(agg_shares) < u:
        raise ValueError(f"need ≥{u} surviving shares, got {len(agg_shares)}")
    ids = sorted(agg_shares.keys())[:u]
    F = np.stack([agg_shares[j] for j in ids])            # [u, block]
    alpha_surv = [u + 1 + j for j in ids]
    beta_targets = list(range(1, (u - t) + 1))
    blocks = LCC_decoding_with_points(F, alpha_surv, beta_targets, p)
    return blocks.reshape(-1)[:d]
