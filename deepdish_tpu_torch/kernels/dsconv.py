"""Wrapper of the CUDA fused depthwise-separable kernel (csrc/dsconv.cu).

Replaces the Pallas TPU kernels deepdish_tpu/ops/dsconv_pallas.py
`_dsconv_s1_kernel` (:83) and `_dsconv_s2_kernel` (:110), reached through
`fused_dsconv` (:137), which run MobileNetV1's depthwise 3x3 + BN + ReLU6 +
pointwise 1x1 + BN + ReLU6 with the intermediate in VMEM.

Bound: bytes at the large-spatial stages (150^2, 75^2), tensor-core
operations at 19^2 and 10^2. One kernel covers both strides and both
element types; it keeps the intermediate in shared memory (never in device
memory) and runs the pointwise product on CUDA cores, the simple design
(csrc/dsconv.cu's head note has the numbers).

The plain version is `ops.dsconv.dsconv_plain`; `ops.dsconv.fused_dsconv`
uses it only for CPU tensors. Here a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches since the count was last reset (the main-path check)
launches = 0
#: the same launches by stride (the report lists the two strides apart)
stride_launches = {1: 0, 2: 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("dsconv")
        lib.dsconv_launch.argtypes = ([ctypes.c_void_p] * 8 +
                                      [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.dsconv_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def fused(x: torch.Tensor, dw_k: torch.Tensor, dw_scale: torch.Tensor,
          dw_bias: torch.Tensor, pw_k: torch.Tensor, pw_scale: torch.Tensor,
          pw_bias: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin) float32 or bfloat16, dw_k (3, 3, Cin), pw_k (Cin,
    Cout) of any float dtype (cast to x.dtype here), dw_scale/dw_bias (Cin,)
    and pw_scale/pw_bias (Cout,) float32, all contiguous on one CUDA device
    -> (B, ceil(H/stride), ceil(W/stride), Cout) in x.dtype."""
    global launches
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    vecs = (dw_scale, dw_bias, pw_scale, pw_bias)
    tensors = (x, dw_k, pw_k) + vecs
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("dsconv.fused needs every tensor on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (dw_k.is_floating_point() and pw_k.is_floating_point()):
        raise TypeError("dw_k and pw_k must be floating point")
    if any(v.dtype != torch.float32 for v in vecs):
        raise TypeError("BN scales and biases must be float32, got "
                        f"{[v.dtype for v in vecs]}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    if tuple(dw_k.shape) != (3, 3, cin) or pw_k.dim() != 2 or \
            pw_k.shape[0] != cin:
        raise ValueError(f"dw_k must be (3, 3, {cin}) and pw_k ({cin}, "
                         f"Cout), got {tuple(dw_k.shape)} and "
                         f"{tuple(pw_k.shape)}")
    cout = pw_k.shape[1]
    if tuple(dw_scale.shape) != (cin,) or tuple(dw_bias.shape) != (cin,) or \
            tuple(pw_scale.shape) != (cout,) or \
            tuple(pw_bias.shape) != (cout,):
        raise ValueError(f"BN vectors must be ({cin},) and ({cout},)")
    if cin == 0 or cout == 0:
        raise ValueError("Cin and Cout must be positive")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every tensor must be contiguous")
    ho, wo = -(-h // stride), -(-w // stride)
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    dw = dw_k.to(x.dtype)
    pw = pw_k.to(x.dtype)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.dsconv_launch(
            x.data_ptr(), dw.data_ptr(), dw_scale.data_ptr(),
            dw_bias.data_ptr(), pw.data_ptr(), pw_scale.data_ptr(),
            pw_bias.data_ptr(), out.data_ptr(), b, h, w, cin, cout, stride,
            _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dsconv kernel launch failed: CUDA error {err}")
    launches += 1
    stride_launches[stride] += 1
    return out
