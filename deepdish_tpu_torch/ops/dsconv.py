"""Fused depthwise-separable block: MobileNetV1's ds layer as one kernel.

Port of deepdish_tpu/ops/dsconv_pallas.py (`fused_dsconv` :137 with its
Pallas kernels `_dsconv_s1_kernel` :83 and `_dsconv_s2_kernel` :110,
`fold_bn` :226, `dsconv_reference` :232). Every function takes and returns
NHWC, the JAX layout:

  x (B, H, W, Cin) float32 or bfloat16; dw_k (3, 3, Cin); pw_k (Cin, Cout);
  dw_scale, dw_bias (Cin,) and pw_scale, pw_bias (Cout,) folded BN, float32;
  stride 1 or 2 with TF SAME padding -> (B, ceil(H/s), ceil(W/s), Cout) in
  x.dtype.

`fused_dsconv` is the entry: a CPU tensor takes `dsconv_plain`, a CUDA
tensor the hand-written kernel (kernels/dsconv.py, csrc/dsconv.cu), which
raises on anything it cannot take. `dsconv_reference` is the two-convolution
composition (the model's lowering, cuDNN on the card): the probe's library
leg, which nothing on a main path calls.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layers import same_pad
from ..utils import flops


def _check_stride(stride: int) -> None:
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")


def fold_bn(gamma, beta, mean, var, eps: float = 1e-3):
    """Inference BN -> (scale, bias): y = x*scale + bias."""
    scale = gamma / np.sqrt(np.asarray(var) + eps)
    return scale, beta - mean * scale


def dsconv_plain(x, dw_k, dw_scale, dw_bias, pw_k, pw_scale, pw_bias,
                 stride: int = 1):
    """The kernel's plain version: the Pallas kernel's arithmetic, step by
    step. Kernels cast to x.dtype; the nine taps summed in f32 in row-major
    (i, j) order from zero, each product and each add a separate rounded
    op; acc * dw_scale + dw_bias as two rounded f32 ops, clip to [0, 6]; one
    cast of the intermediate to x.dtype; its product with pw_k accumulated
    in f32; y * pw_scale + pw_bias, clip, cast to x.dtype. The taps'
    work is reported to `utils.flops` (the matmul is counted as it runs)."""
    _check_stride(stride)
    b, h, w, cin = x.shape
    cout = pw_k.shape[1]
    ho, wo = -(-h // stride), -(-w // stride)
    flops.report(flops.conv(b * ho * wo * cin, 9, 1))
    dw = dw_k.to(x.dtype).float()
    pw = pw_k.to(x.dtype).float()
    pt, pb = same_pad(h, stride, 3)
    pl, pr = same_pad(w, stride, 3)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    acc = torch.zeros((b, ho, wo, cin), dtype=torch.float32, device=x.device)
    for i in range(3):
        for j in range(3):
            tap = xp[:, i:i + stride * (ho - 1) + 1:stride,
                     j:j + stride * (wo - 1) + 1:stride]
            acc = acc + tap * dw[i, j]
    mid = (acc * dw_scale.float() + dw_bias.float()).clamp(0.0, 6.0)
    mid = mid.to(x.dtype).float()
    y = (mid.reshape(-1, cin) @ pw).reshape(b, ho, wo, cout)
    return (y * pw_scale.float() + pw_bias.float()).clamp(0.0, 6.0).to(
        x.dtype)


def reorder_tolerance(a, b, x, dw_k, dw_scale, dw_bias, pw_k, pw_scale,
                      pw_bias, stride: int = 1):
    """Per output element, how far apart two results `a` and `b` of this
    block on these inputs may be when they differ only in the order of the
    f32 pointwise sum (the CUDA kernel against `dsconv_plain`, or the JAX
    kernel's dot against torch's matmul).

    Each order is within g * S of the exact sum, S = sum_k |mid_k pw_kn|,
    g = n u / (1 - n u), n = Cin, u = 2^-24 (Higham's bound for recursive
    summation, which covers any order); BN scales the gap by |pw_scale|, and
    its two rounded operations add at most 4u (|pw_scale| S + |pw_bias|).
    The clip cannot widen the gap; the final rounding to x.dtype adds at most
    one ulp at the larger of |a|, |b|. Near zero that ulp is far below
    g * S, so a plain one-ulp rule would be wrong there."""
    cin = x.shape[-1]
    ones = torch.ones(cin, device=x.device)
    # the rounded intermediate: an identity pointwise block outputs it as is
    mid = dsconv_plain(x, dw_k, dw_scale, dw_bias,
                       torch.eye(cin, device=x.device), ones,
                       torch.zeros_like(ones), stride).float()
    mag = mid.abs() @ pw_k.to(x.dtype).float().abs()
    u = 2.0 ** -24
    g = cin * u / (1 - cin * u)
    scale = pw_scale.float().abs()
    larger = torch.maximum(a.float().abs(), b.float().abs())
    ulp = torch.ldexp(torch.full_like(larger, torch.finfo(a.dtype).eps),
                      torch.frexp(larger)[1] - 1)
    return (2 * g * mag * scale + 4 * u * (mag * scale + pw_bias.float().abs())
            + ulp)


def dsconv_reference(x, dw_k, dw_scale, dw_bias, pw_k, pw_scale, pw_bias,
                     stride: int = 1):
    """The composition of the same block (the model's lowering): grouped
    conv -> BN -> relu6 -> 1x1 conv -> BN -> relu6, each convolution's
    output in x.dtype, as the JAX composition rounds."""
    _check_stride(stride)
    h, w, cin = x.shape[1:]
    # flax-module semantics: kernels are cast to the compute dtype
    dw = dw_k.to(x.dtype).permute(2, 0, 1)[:, None]      # (Cin, 1, 3, 3)
    pw = pw_k.to(x.dtype).t()[:, :, None, None]          # (Cout, Cin, 1, 1)
    ph, pv = same_pad(h, stride, 3), same_pad(w, stride, 3)
    xn = x.permute(0, 3, 1, 2)                           # NCHW view
    if ph[0] == ph[1] and pv[0] == pv[1]:
        y = F.conv2d(xn, dw, stride=stride, padding=(ph[0], pv[0]),
                     groups=cin)
    else:                    # TF SAME at stride 2 pads (0, 1): explicit pad
        y = F.conv2d(F.pad(xn, (pv[0], pv[1], ph[0], ph[1])), dw,
                     stride=stride, groups=cin)
    y = y.permute(0, 2, 3, 1)
    y = (y * dw_scale + dw_bias).clamp(0.0, 6.0).to(x.dtype)
    y = F.conv2d(y.permute(0, 3, 1, 2), pw).permute(0, 2, 3, 1)
    return (y * pw_scale + pw_bias).clamp(0.0, 6.0).to(x.dtype)


def fused_dsconv(x, dw_k, dw_scale, dw_bias, pw_k, pw_scale, pw_bias,
                 stride: int = 1):
    """The fused block. CPU tensors take the plain version; CUDA tensors
    the CUDA kernel, which raises rather than fall back."""
    _check_stride(stride)
    if x.device.type == "cpu":
        return dsconv_plain(x, dw_k, dw_scale, dw_bias, pw_k, pw_scale,
                            pw_bias, stride)
    from ..kernels import dsconv
    return dsconv.fused(x, dw_k, dw_scale, dw_bias, pw_k, pw_scale, pw_bias,
                        stride)
