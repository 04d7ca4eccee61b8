"""The port's gemmlowp fixed-point requantization
(deepdish_tpu_torch/ops/intmath.py) against the JAX package's
(deepdish_tpu/ops/intmath.py, 16-bit limbs) and the int64 numpy oracles,
on the CPU: the edge cases of tests/test_qgraph.py (INT32_MIN, +-2^30,
every shift branch), the C++ truncation of the nudged product (torch's
`//` floors), the INT32_MIN * INT32_MIN saturation, the inverse square
root of L2_NORMALIZATION, and a hypothesis property over int32 pairs.
Every comparison is exact."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deepdish_tpu.ops import intmath as jim
from deepdish_tpu_torch.ops import intmath as pim

EDGE = np.array([0, 1, -1, 2, -2, (1 << 30), -(1 << 30), (1 << 31) - 1,
                 -(1 << 31), 0x40000000, 0x7FFFFFFE], np.int64).astype(
    np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pairs(rng, n=4096):
    a = np.concatenate([EDGE, rng.randint(-2 ** 31, 2 ** 31, n,
                                          np.int64).astype(np.int32)])
    m = np.concatenate([EDGE[::-1], rng.randint(-2 ** 31, 2 ** 31, n,
                                                np.int64).astype(np.int32)])
    return a, m


def test_srdhm_matches_jax_and_oracle(rng):
    a, m = _pairs(rng)
    got = pim.saturating_rounding_doubling_high_mul(_t(a), _t(m)).numpy()
    np.testing.assert_array_equal(got, pim.np_srdhm(a, m))
    np.testing.assert_array_equal(got, np.asarray(
        jim.saturating_rounding_doubling_high_mul(jnp.asarray(a),
                                                  jnp.asarray(m))))
    # the oracles are the JAX package's, copied
    np.testing.assert_array_equal(pim.np_srdhm(a, m), jim.np_srdhm(a, m))


def test_srdhm_truncates_and_saturates():
    """gemmlowp divides the nudged 64-bit product by 2^31 truncating
    toward zero: for a negative inexact quotient that is one above torch's
    floor division; INT32_MIN * INT32_MIN saturates to INT32_MAX."""
    a = _t(np.array([-3, -(1 << 31), -(1 << 31), 12345], np.int32))
    m = _t(np.array([(1 << 30) + 7, -(1 << 31), (1 << 31) - 1, -98765],
                    np.int32))
    got = pim.saturating_rounding_doubling_high_mul(a, m)
    ab = a.long() * m.long()
    nudge = torch.where(ab >= 0, 1 << 30, 1 - (1 << 30))
    floor = torch.div(ab + nudge, 1 << 31, rounding_mode="floor")
    assert int(got[0]) == int(floor[0]) + 1       # truncation, not floor
    assert int(got[1]) == pim.INT32_MAX
    np.testing.assert_array_equal(got.numpy(), pim.np_srdhm(a.numpy(),
                                                            m.numpy()))


@pytest.mark.parametrize("exponent", [0, 1, 5, 17, 31])
def test_rdbp_matches_jax_and_oracle(rng, exponent):
    x = np.concatenate([EDGE, rng.randint(-2 ** 31, 2 ** 31, 4096,
                                          np.int64).astype(np.int32)])
    got = pim.rounding_divide_by_pot(_t(x), exponent).numpy()
    np.testing.assert_array_equal(got, pim.np_rdbp(x, exponent))
    np.testing.assert_array_equal(got, np.asarray(
        jim.rounding_divide_by_pot(jnp.asarray(x), exponent)))


def test_mbqm_per_channel_both_variants(rng):
    """The conv epilogue's shape: acc (N, C) with per-channel multipliers
    whose shifts cover every branch (left shifts, zero, deep right)."""
    acc = rng.randint(-2 ** 24, 2 ** 24, (64, 32), np.int64).astype(np.int32)
    scales = np.concatenate([rng.uniform(1e-9, 1e-4, 8),
                             rng.uniform(1e-4, 0.9, 8),
                             rng.uniform(0.9, 1.1, 8),
                             rng.uniform(2.0, 900.0, 8)])
    qm = [pim.quantize_multiplier(s) for s in scales]
    assert qm == [jim.quantize_multiplier(s) for s in scales]
    m0 = np.asarray([q[0] for q in qm], np.int32)
    sh = np.asarray([q[1] for q in qm], np.int32)
    assert sh.min() < 0 < sh.max() and 0 in sh
    got = pim.multiply_by_quantized_multiplier(_t(acc), _t(m0), _t(sh))
    np.testing.assert_array_equal(got.numpy(), pim.np_mbqm(acc, m0, sh))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jim.multiply_by_quantized_multiplier(
            jnp.asarray(acc), jnp.asarray(m0), jnp.asarray(sh))))
    single = pim.multiply_by_quantized_multiplier_single(_t(acc), _t(m0),
                                                         _t(sh))
    np.testing.assert_array_equal(single.numpy(),
                                  pim.np_mbqm_single(acc, m0, sh))
    np.testing.assert_array_equal(single.numpy(), np.asarray(
        jim.multiply_by_quantized_multiplier_single(
            jnp.asarray(acc), jnp.asarray(m0), jnp.asarray(sh))))


def test_mbqm_left_shift_wraps_like_int32():
    """A left shift past int32 wraps as the JAX package's int32 shift does
    (the saturating high-mul then sees the wrapped value)."""
    x = _t(np.array([3 << 29, -(3 << 29), 12345, -1], np.int32))
    got = pim.multiply_by_quantized_multiplier(x, 1 << 30, 3).numpy()
    want = np.asarray(jim.multiply_by_quantized_multiplier(
        jnp.asarray(x.numpy()), 1 << 30, 3))
    np.testing.assert_array_equal(got, want)


def test_quantize_multiplier_contract():
    for v in (0.25, 0.5, 0.9999, 1e-8, 0.0078125, 123.456, 1e-12, 2.0 ** 40,
              0.0):
        assert pim.quantize_multiplier(v) == jim.quantize_multiplier(v)
        m0, sh = pim.quantize_multiplier(v)
        if m0 and sh < 30:
            assert 2 ** 30 <= m0 < 2 ** 31
            assert abs(m0 * 2.0 ** (sh - 31) - v) < v * 1e-9


def test_inv_sqrt_and_clz_match_jax(rng):
    """L2_NORMALIZATION's fixed-point 1/sqrt (GetInvSqrtQuantized-
    MultiplierExp) and its count of leading zeros, over the trivial inputs
    and every magnitude up to INT32_MAX."""
    acc = np.concatenate([
        np.array([0, 1, 2, 3, 5, 100, 127, 128, (1 << 29) - 1, 1 << 29,
                  (1 << 31) - 1]),
        rng.randint(2, 1 << 14, 50), rng.randint(1 << 14, 1 << 24, 50),
        rng.randint(1 << 24, (1 << 31) - 1, 50)]).astype(np.int32)
    m, s = pim.get_inv_sqrt_quantized_multiplier_exp(_t(acc))
    jm, js = jim.get_inv_sqrt_quantized_multiplier_exp(jnp.asarray(acc))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pim._clz32(_t(acc)).numpy(),
                                  np.asarray(jim._clz32(jnp.asarray(acc))))
    # what it exists to compute: 128 * x / sqrt(acc) within 1 LSB
    x = np.int32(100)
    out = pim.multiply_by_quantized_multiplier(
        torch.full(acc.shape, int(x), dtype=torch.int64), m, s + 7).numpy()
    ok = acc > 1
    want = np.round(128.0 * x / np.sqrt(acc[ok].astype(np.float64)))
    assert np.abs(out[ok] - want).max() <= 1


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.integers(-2 ** 31, 2 ** 31 - 1),
                          st.integers(-2 ** 31, 2 ** 31 - 1),
                          st.integers(-31, 30)),
                min_size=1, max_size=16))
def test_random_int32_pairs_match_oracle(rows):
    """Property: for any int32 pairs and shifts, the int64 SRDHM and the
    double-rounding MBQM equal the numpy oracles (the JAX package's)."""
    a = np.array([r[0] for r in rows], np.int64).astype(np.int32)
    m = np.array([r[1] for r in rows], np.int64).astype(np.int32)
    sh = np.array([r[2] for r in rows], np.int32)
    np.testing.assert_array_equal(
        pim.saturating_rounding_doubling_high_mul(_t(a), _t(m)).numpy(),
        pim.np_srdhm(a, m))
    np.testing.assert_array_equal(
        pim.multiply_by_quantized_multiplier(_t(a), _t(m), _t(sh)).numpy(),
        pim.np_mbqm(a, m, sh))
