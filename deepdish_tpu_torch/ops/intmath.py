"""TFLite/gemmlowp fixed-point requantization, exact, in int64.

Port of deepdish_tpu/ops/intmath.py. Full-integer TFLite artifacts (the
reference's EdgeTPU models, tools/ssd_mobilenet.py:100-103,
tools/yolov5.py:102-118) scale int32 accumulators back to int8 with
gemmlowp fixed-point arithmetic:

    out = RoundingDivideByPOT(
              SaturatingRoundingDoublingHighMul(acc << left_shift, M0),
              right_shift) + zero_point

where (M0, shift) = QuantizeMultiplier(in_scale * w_scale / out_scale).
Replaying that bit-exactly makes a quantized graph's outputs byte-equal to
the TFLite interpreter's (models/qgraph.py).

The JAX package builds the 64-bit product from 16-bit limbs in uint32
(JAX runs without int64 by default); torch has int64 on the CPU and on the
card, so the product here is one int64 multiply. Values are int32 numbers
carried in int64 tensors; where the JAX version's int32 arithmetic wraps
(a left shift), `wrap32` wraps the same way. Two traps the int64 form
keeps explicit:
  * gemmlowp divides the nudged product by 2^31 with C++ truncation toward
    zero; torch's `//` and `>>` floor negative numbers, so the division
    is `torch.div(..., rounding_mode="trunc")`;
  * INT32_MIN * INT32_MIN saturates to INT32_MAX.
The numpy int64 oracles at the end are the JAX package's, copied.
"""
from __future__ import annotations

import numpy as np
import torch

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1


def quantize_multiplier(real_multiplier: float):
    """TFLite QuantizeMultiplier (quantization_util.cc): a positive double
    -> (M0 int32 in [2^30, 2^31) or 0, shift) with M0 * 2^shift ~= value.
    Host-side (numpy float64), exact replica incl. the rounding-overflow
    renormalization and the shift < -31 flush-to-zero."""
    if real_multiplier == 0.0:
        return 0, 0
    q, shift = np.frexp(np.float64(real_multiplier))
    q_fixed = int(np.floor(q * (1 << 31) + 0.5))   # round half away (q>0)
    if q_fixed == (1 << 31):
        q_fixed //= 2
        shift += 1
    if shift < -31:
        shift = 0
        q_fixed = 0
    if shift > 30:            # TFLite clamps via the left-shift cap
        shift = 30
        q_fixed = INT32_MAX
    return int(q_fixed), int(shift)


def _i64(v, like: torch.Tensor) -> torch.Tensor:
    """An int, numpy array or tensor as an int64 tensor on `like`'s
    device."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(v, np.int64), device=like.device)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement (what int32
    arithmetic does on overflow), still int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def saturating_rounding_doubling_high_mul(a, m) -> torch.Tensor:
    """gemmlowp SaturatingRoundingDoublingHighMul on int32 values:
    (2*a*m + nudge) / 2^31 truncated, saturated at INT32_MIN*INT32_MIN."""
    a = _i64(a, a)
    m = _i64(m, a)
    ab = a * m
    nudge = torch.where(ab >= 0, 1 << 30, 1 - (1 << 30))
    res = torch.div(ab + nudge, 1 << 31, rounding_mode="trunc")
    overflow = (a == INT32_MIN) & (m == INT32_MIN)
    return torch.where(overflow, INT32_MAX, res)


def rounding_divide_by_pot(x, exponent) -> torch.Tensor:
    """gemmlowp RoundingDivideByPOT on int32 values: arithmetic >> exponent
    rounding to nearest, ties away from zero. exponent: int tensor or
    scalar, 0..31."""
    x = _i64(x, x)
    e = _i64(exponent, x)
    mask = (torch.ones_like(e) << e) - 1
    remainder = x & mask
    threshold = (mask >> 1) + (x < 0).long()
    return (x >> e) + (remainder > threshold).long()


def multiply_by_quantized_multiplier(x, quantized_multiplier, shift
                                     ) -> torch.Tensor:
    """TFLite MultiplyByQuantizedMultiplier, DOUBLE-rounding variant
    (gemmlowp SRDHM + RoundingDivideByPOT): the semantics of standard
    TFLite builds (TFLITE_SINGLE_ROUNDING=0) and of the EdgeTPU-era
    runtimes. x int32 values, M0 (tensor or scalar), shift (positive =
    multiply by 2^shift)."""
    x = _i64(x, x)
    shift = _i64(shift, x)
    left = torch.clamp(shift, min=0)
    right = torch.clamp(-shift, min=0)
    return rounding_divide_by_pot(
        saturating_rounding_doubling_high_mul(wrap32(x << left),
                                              quantized_multiplier),
        right)


def multiply_by_quantized_multiplier_single(x, quantized_multiplier, shift
                                            ) -> torch.Tensor:
    """TFLite MultiplyByQuantizedMultiplier, SINGLE-rounding variant (builds
    with TFLITE_SINGLE_ROUNDING=1):

        total = 31 - shift            # in [1, 62]
        result = (x * M0 + (1 << (total-1))) >> total    # int64, floor

    Result fits int32 by the kernel contract (DCHECKed, not clamped,
    upstream)."""
    x = _i64(x, x)
    total = 31 - _i64(shift, x)
    prod = x * _i64(quantized_multiplier, x)
    return wrap32((prod + (torch.ones_like(total) << (total - 1))) >> total)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of non-negative int32 values (exact: 32 minus
    the bit length, counted by comparisons, no float log2)."""
    x = _i64(x, x)
    bits = torch.zeros_like(x)
    for k in range(32):
        bits = bits + (x >= (1 << k)).long()
    return 32 - bits


def _srmbpot(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """gemmlowp SaturatingRoundingMultiplyByPOT with a STATIC exponent:
    positive = saturating left shift, negative = RoundingDivideByPOT."""
    if exponent == 0:
        return x
    if exponent < 0:
        return rounding_divide_by_pot(x, -exponent)
    threshold = (1 << (31 - exponent)) - 1
    shifted = wrap32(x << exponent)
    shifted = torch.where(x > threshold, INT32_MAX, shifted)
    return torch.where(x < -threshold, INT32_MIN, shifted)


def get_inv_sqrt_quantized_multiplier_exp(input_):
    """TFLite GetInvSqrtQuantizedMultiplierExp (quantization_util.cc) with
    reverse_shift = -1 (the only value the kernels use), vectorized over
    non-negative int32 sums-of-squares. Returns (multiplier, shift) int64
    tensors such that MultiplyByQuantizedMultiplier(v, multiplier,
    shift + k) reproduces the kernel's 1/sqrt rescale bit-exactly.

    As in the JAX package: the `input /= 4` normalization loop runs at most
    twice for int32 inputs, so it is unrolled; the Newton-Raphson
    iteration is gemmlowp F3 fixed-point (SRDHM products, saturating POT
    rescales)."""
    x = _i64(input_, input_)
    shift = torch.full_like(x, 11)
    for _ in range(2):                     # while (input >= 1 << 29)
        big = x >= (1 << 29)
        x = torch.where(big, x >> 2, x)
        shift = shift + big.long()
    # guard the input<=1 branch through the pipeline with a safe value
    trivial = _i64(input_, input_) <= 1
    x = torch.where(trivial, 1 << 28, x)
    max_left_shift_bits = _clz32(x) - 1
    left_shift_bit_pairs = torch.div(max_left_shift_bits, 2,
                                     rounding_mode="floor") - 1
    shift = shift - left_shift_bit_pairs
    x = wrap32(x << (2 * left_shift_bit_pairs))

    # F3 Newton-Raphson for 1/sqrt (gemmlowp fixed-point, 5 iterations)
    half_input = rounding_divide_by_pot(x >> 1, 1)     # SRMBPOT<-1>(F3 raw)
    half_three = torch.full_like(x, (1 << 28) + (1 << 27))
    nr = torch.full_like(x, 1 << 28)                   # F3::One()
    srdhm = saturating_rounding_doubling_high_mul
    for _ in range(5):
        x2 = srdhm(nr, nr)                                   # F6
        x3 = _srmbpot(srdhm(x2, nr), 6)                      # F9 -> F3
        t1 = srdhm(half_three, nr)                           # F6
        t2 = srdhm(half_input, x3)                           # F6
        nr = _srmbpot(wrap32(t1 - t2), 3)                    # -> F3
    nr = srdhm(nr, 1518500250)                         # F0 sqrt(2)/2

    neg = shift < 0
    mult = torch.where(neg, wrap32(nr << torch.clamp(-shift, min=0)), nr)
    shift = -torch.where(neg, 0, shift)                # reverse_shift = -1
    mult = torch.where(trivial, INT32_MAX, mult)
    shift = torch.where(trivial, 0, shift)
    return mult, shift


# ---------------------------------------------------------------------------
# numpy int64 oracles (tests + host-side precomputation), as in the JAX
# package
# ---------------------------------------------------------------------------

def np_srdhm(a, m):
    a = np.asarray(a, np.int64)
    m = np.asarray(m, np.int64)
    ab = a * m
    nudge = np.where(ab >= 0, 1 << 30, 1 - (1 << 30))
    q = ab + nudge
    # C++ int64 division truncates toward zero (gemmlowp uses /, not >>)
    res = np.sign(q) * (np.abs(q) >> 31)
    res = np.where((a == INT32_MIN) & (m == INT32_MIN), INT32_MAX, res)
    return res.astype(np.int32)


def np_rdbp(x, exponent):
    x = np.asarray(x, np.int64).astype(np.int32)
    exponent = np.asarray(exponent, np.int32)
    mask = ((np.int64(1) << exponent) - 1).astype(np.int32)
    remainder = (x & mask).astype(np.int32)
    threshold = (mask >> 1) + (x < 0).astype(np.int32)
    return (x >> exponent) + (remainder > threshold).astype(np.int32)


def np_mbqm(x, m0, shift):
    shift = np.asarray(shift, np.int32)
    left = np.maximum(shift, 0)
    right = np.maximum(-shift, 0)
    return np_rdbp(np_srdhm(np.asarray(x, np.int32) << left, m0), right)


def np_mbqm_single(x, m0, shift):
    """int64 oracle for the single-rounding MultiplyByQuantizedMultiplier."""
    total = (31 - np.asarray(shift, np.int64)).astype(np.int64)
    prod = np.asarray(x, np.int64) * np.asarray(m0, np.int64)
    return ((prod + (np.int64(1) << (total - 1))) >> total).astype(np.int32)
