"""The port's MPC primitives (``fedml_tpu_torch/core/mpc``) against the JAX
package's ``fedml_tpu.core.mpc``, on the cases of ``tests/test_mpc.py``.

* The host field math (``modular_inv``, ``pow_mod``, Shamir sharing and
  reconstruction, LCC encoding and decoding) and LightSecAgg's mask
  encoding, share aggregation and decoding are numpy on both sides: equal
  bits from the same numpy generator state.
* SecAgg's bulk masking — ``quantize``, ``mask_model``, ``unmask_sum`` and
  ``dequantize`` — bit for bit on the same masks, made with numpy and
  passed to both (uint32 words in the port travel as int32 tensors with
  the same bits; they are compared as ``numpy.view(np.uint32)``).
* The round trip with the port's own ``prg_mask_like`` masks.  Those come
  from a ``torch.Generator`` seeded with (seed, leaf index), not from
  ``jax.random.bits``: the same distribution, other bits (ROADMAP Queue C),
  so they are held by what the protocol needs — determinism per seed,
  independence across seeds and leaves, and a sum that unmasks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.mpc import lightsecagg as jlsa
from fedml_tpu.core.mpc import secagg as jsa
from fedml_tpu_torch.core.mpc import lightsecagg as lsa
from fedml_tpu_torch.core.mpc import secagg as sa
from fedml_tpu_torch.ops.pallas_ops import words

P = sa.FIELD_PRIME


def _u32(t):
    return words(t).numpy().view(np.uint32)


def test_field_constants_and_inverse_match():
    assert sa.FIELD_PRIME == jsa.FIELD_PRIME
    a = np.random.RandomState(0).randint(1, int(P), size=10).astype(np.int64)
    inv = sa.modular_inv(a)
    assert np.all((a * inv) % P == 1)
    np.testing.assert_array_equal(inv, jsa.modular_inv(a))
    np.testing.assert_array_equal(sa.pow_mod(a, 12345), jsa.pow_mod(a, 12345))


def test_shamir_matches_and_round_trips():
    secret = np.random.RandomState(1).randint(0, int(P), size=20).astype(
        np.int64)
    shares = sa.shamir_share(secret, n=5, t=2, rng=np.random.RandomState(7))
    want = jsa.shamir_share(secret, n=5, t=2, rng=np.random.RandomState(7))
    assert sorted(shares) == sorted(want)
    for i in shares:
        np.testing.assert_array_equal(shares[i], want[i])
    for ids in ([0, 2, 4], [1, 2, 3]):
        sub = {k: shares[k] for k in ids}
        np.testing.assert_array_equal(sa.shamir_reconstruct(sub), secret)
        np.testing.assert_array_equal(sa.shamir_reconstruct(sub),
                                      jsa.shamir_reconstruct(sub))


def test_lcc_matches_and_round_trips():
    X = np.random.RandomState(2).randint(0, int(P), size=(3, 7)).astype(
        np.int64)
    beta, alpha = [1, 2, 3], [4, 5, 6, 7, 8]
    enc = sa.LCC_encoding_with_points(X, beta, alpha)
    np.testing.assert_array_equal(enc, jsa.LCC_encoding_with_points(
        X, beta, alpha))
    dec = sa.LCC_decoding_with_points(enc[:4], alpha[:4], beta)
    np.testing.assert_array_equal(dec, jsa.LCC_decoding_with_points(
        enc[:4], alpha[:4], beta))
    np.testing.assert_array_equal(dec % P, X % P)
    np.testing.assert_array_equal(sa._lagrange_basis(np.array(alpha),
                                                     np.array(beta)),
                                  jsa._lagrange_basis(np.array(alpha),
                                                      np.array(beta)))


@pytest.mark.parametrize("survivors", [[0, 2], [1, 2], [0, 1, 2]])
def test_lightsecagg_dropout_tolerant_sum_matches(survivors):
    """3 clients, up to 1 drops after sharing; the aggregate mask of the
    surviving set is decoded from u survivors' aggregated shares, equal to
    the JAX package's from the same generator state."""
    d, n, u, t = 11, 3, 2, 1

    def run(mod):
        rng = np.random.RandomState(3)
        masks = [rng.randint(0, 2 ** 16, size=d).astype(np.int64)
                 for _ in range(n)]
        shares = [mod.mask_encoding(d, n, u, t, masks[i], rng)
                  for i in range(n)]
        agg = {j: mod.aggregate_encoded_masks([shares[i][j]
                                               for i in survivors])
               for j in survivors}
        return masks, shares, mod.decode_aggregate_mask(agg, d, n, u, t)

    masks, shares, got = run(lsa)
    _, jshares, want = run(jlsa)
    for s, js in zip(shares, jshares):
        for j in s:
            np.testing.assert_array_equal(s[j], js[j])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got % P,
                                  sum(masks[i] for i in survivors) % P)
    with pytest.raises(ValueError, match="surviving shares"):
        lsa.decode_aggregate_mask({0: shares[0][0]}, d, n, u, t)


def _update(shape=(8, 3), seed=4):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x.flat[:6] = [40000.0, -40000.0, np.inf, -np.inf, np.nan,
                  2.0 ** -17 * 3]
    return x


def test_quantize_dequantize_match_bit_for_bit():
    x = _update()
    got = sa.quantize({"w": torch.from_numpy(x)})["w"]
    want = np.asarray(jsa.quantize({"w": jnp.asarray(x)})["w"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    back = sa.dequantize({"w": got})["w"]
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jsa.dequantize({"w": jnp.asarray(want)})["w"]))
    # a scale that is no power of two divides, as jnp does
    got3 = sa.dequantize(sa.quantize({"w": torch.from_numpy(x)}, 3000.0),
                         scale=3000.0)["w"]
    want3 = jsa.dequantize(jsa.quantize({"w": jnp.asarray(x)}, 3000.0),
                           scale=3000.0)["w"]
    np.testing.assert_array_equal(got3.numpy(), np.asarray(want3))


def test_mask_and_unmask_match_bit_for_bit():
    """Two silos' updates masked with the same numpy uint32 masks (words near
    2^32 − 1 included, so the adds wrap), summed, unmasked, dequantized."""
    rng = np.random.RandomState(5)
    xs = [_update(seed=s) for s in (6, 7)]
    ms = [rng.randint(0, 2 ** 32, size=(8, 3), dtype=np.uint32)
          for _ in range(2)]
    ms[0].flat[:4] = np.uint32(2 ** 32 - 1)
    ms[1].flat[:4] = np.uint32(2 ** 32 - 2)

    def port():
        masked = [sa.mask_model(sa.quantize({"w": torch.from_numpy(x)}),
                                {"w": torch.from_numpy(m.view(np.int32))})
                  for x, m in zip(xs, ms)]
        qsum = {"w": masked[0]["w"] + masked[1]["w"]}
        agg = {"w": torch.from_numpy((ms[0] + ms[1]).view(np.int32))}
        un = sa.unmask_sum(qsum, agg)
        return masked, un, sa.dequantize(un)

    def jax_side():
        masked = [jsa.mask_model(jsa.quantize({"w": jnp.asarray(x)}),
                                 {"w": jnp.asarray(m)})
                  for x, m in zip(xs, ms)]
        qsum = {"w": masked[0]["w"] + masked[1]["w"]}
        agg = {"w": jnp.asarray(ms[0] + ms[1])}
        un = jsa.unmask_sum(qsum, agg)
        return masked, un, jsa.dequantize(un)

    (pm, pu, pd), (jm, ju, jd) = port(), jax_side()
    for a, b in zip(pm, jm):
        np.testing.assert_array_equal(_u32(a["w"]), np.asarray(b["w"]))
    np.testing.assert_array_equal(_u32(pu["w"]), np.asarray(ju["w"]))
    np.testing.assert_array_equal(pd["w"].numpy(), np.asarray(jd["w"]))


def test_uint32_mask_roundtrip_with_the_ports_prg():
    """tests/test_mpc.py's round trip, on the port's masks."""
    x = np.random.RandomState(4).randn(8, 3).astype(np.float32)
    tree = {"w": torch.from_numpy(x), "b": torch.zeros(5)}
    q = sa.quantize(tree)
    m1 = sa.prg_mask_like(q, seed=101)
    m2 = sa.prg_mask_like(q, seed=202)
    masked1, masked2 = sa.mask_model(q, m1), sa.mask_model(q, m2)
    assert not torch.equal(masked1["w"], q["w"])
    qsum = {k: masked1[k] + masked2[k] for k in q}
    agg = {k: m1[k] + m2[k] for k in q}
    recovered = sa.dequantize(sa.unmask_sum(qsum, agg))
    np.testing.assert_allclose(recovered["w"].numpy(), 2 * x, atol=1e-3)
    assert not recovered["b"].any()


def test_prg_masks_are_deterministic_per_seed_and_leaf():
    tree = {"a": torch.zeros(4096), "b": [torch.zeros(3, 5)]}
    m = sa.prg_mask_like(tree, seed=7)
    again = sa.prg_mask_like(tree, seed=7 + 2 ** 31)     # seed & 0x7FFFFFFF
    other = sa.prg_mask_like(tree, seed=8)
    assert m["a"].dtype == torch.int32 and tuple(m["b"][0].shape) == (3, 5)
    assert torch.equal(m["a"], again["a"])
    assert torch.equal(m["b"][0], again["b"][0])
    assert not torch.equal(m["a"], other["a"])
    assert not torch.equal(m["a"][:15], m["b"][0].reshape(-1))
    # uniform words: both halves of the uint32 range, all bits in play
    u = _u32(m["a"]).astype(np.int64)
    assert 0.4 < float((u >= 2 ** 31).mean()) < 0.6
    assert np.bitwise_or.reduce(u) == 2 ** 32 - 1
