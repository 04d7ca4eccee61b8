"""Wrapper of the CUDA fused depthwise-separable kernels (csrc/dsconv.cu).

Replaces the Pallas TPU kernels deepdish_tpu/ops/dsconv_pallas.py
`_dsconv_s1_kernel` (:83) and `_dsconv_s2_kernel` (:110), reached through
`fused_dsconv` (:137), which run MobileNetV1's depthwise 3x3 + BN + ReLU6 +
pointwise 1x1 + BN + ReLU6 with the intermediate in VMEM.

Bound: bytes at the large-spatial stages (150^2, 75^2), tensor-core
operations at 19^2 and 10^2, and at batch 1 the number of SMs a call keeps
busy. bfloat16 runs the pointwise product on the tensor cores (wgmma) with
the depthwise intermediate in shared memory as its A operand, under a launch
plan (`plan`) that splits K across blocks when a call would leave the card
short of a wave; float32, the parity configuration, keeps the CUDA-core
product (csrc/dsconv.cu's head note has the numbers).

The plain version is `ops.dsconv.dsconv_plain`; `ops.dsconv.fused_dsconv`
uses it only for CPU tensors. Here a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build

#: wrapper calls that launched the kernel since the count was last reset
#: (one per call, however many CUDA launches a split-K call makes)
launches = 0
#: the same launches by stride (the report lists the two strides apart)
stride_launches = {1: 0, 2: 0}

BLOCK_M = 64        # output pixels per block: one wgmma m64 (csrc kBM)
MIN_BLOCKS = 128    # a wave: the H100 has 132 SMs

_lib = None


@dataclass(frozen=True)
class Plan:
    """How csrc/dsconv.cu's bf16 kernel covers one call: blocks of BLOCK_M
    flattened output pixels x `block_n` output channels, K (Cin) cut into
    `k_splits` chunks of `k_chunk` channels (the last may be shorter); the
    grid is m_tiles x n_tiles x k_splits blocks."""
    m: int
    cout: int
    cin: int
    block_n: int
    k_chunk: int

    @property
    def m_tiles(self) -> int:
        return -(-self.m // BLOCK_M)

    @property
    def n_tiles(self) -> int:
        return -(-self.cout // self.block_n)

    @property
    def k_splits(self) -> int:
        return -(-self.cin // self.k_chunk)

    @property
    def grid(self) -> int:
        return self.m_tiles * self.n_tiles * self.k_splits

    def block(self, i: int):
        """Block i's (m0, n0, k_begin, k_end), as the kernel derives them
        from blockIdx.x: split slowest, then pixel tile, output tile fastest."""
        tiles = self.m_tiles * self.n_tiles
        split, tile = divmod(i, tiles)
        k_begin = split * self.k_chunk
        return ((tile // self.n_tiles) * BLOCK_M,
                (tile % self.n_tiles) * self.block_n,
                k_begin, min(self.cin, k_begin + self.k_chunk))


def plan(b: int, h: int, w: int, cin: int, cout: int, stride: int) -> Plan:
    """The launch plan of a bf16 call on x (b, h, w, cin) -> cout channels.

    block_n: 64 for Cout <= 64, 256 for Cout > 512 where 256-wide tiles
    still fill a wave, else 128. Each n tile recomputes the depthwise sum,
    so wide tiles do less of it, but a 256-wide block holds 128 f32
    accumulators a thread and an SM only 2 such blocks (3 at 128): on the
    H100 256 wins at Cout = 1024 and loses at 512 (PERF.md). K stays
    whole when the (m, n) tiles fill a wave; otherwise it is split into the
    fewest chunks of whole wgmma steps (16 channels) that bring the grid to
    MIN_BLOCKS, as far as Cin / 16 allows."""
    ho, wo = -(-h // stride), -(-w // stride)
    m = b * ho * wo
    m_tiles = -(-m // BLOCK_M)
    if cout <= 64:
        block_n = 64
    elif cout > 512 and m_tiles * -(-cout // 256) >= MIN_BLOCKS:
        block_n = 256
    else:
        block_n = 128
    tiles = m_tiles * -(-cout // block_n)
    steps = -(-cin // 16)
    want = -(-MIN_BLOCKS // tiles)
    per_split = -(-steps // want)
    while per_split > 1 and -(-steps // per_split) < want:
        per_split -= 1
    return Plan(m, cout, cin, block_n, 16 * per_split)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("dsconv")
        lib.dsconv_f32_launch.argtypes = ([ctypes.c_void_p] * 8 +
                                          [ctypes.c_int] * 6 +
                                          [ctypes.c_void_p])
        lib.dsconv_f32_launch.restype = ctypes.c_int
        lib.dsconv_bf16_launch.argtypes = ([ctypes.c_void_p] * 9 +
                                           [ctypes.c_int] * 8 +
                                           [ctypes.c_void_p])
        lib.dsconv_bf16_launch.restype = ctypes.c_int
        lib.dsconv_bf16_smem_bytes.argtypes = [ctypes.c_int]
        lib.dsconv_bf16_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(block_n: int) -> int:
    """Dynamic shared memory of one bf16 block `block_n` channels wide
    (builds the library on first use)."""
    return _library().dsconv_bf16_smem_bytes(block_n)


def fused(x: torch.Tensor, dw_k: torch.Tensor, dw_scale: torch.Tensor,
          dw_bias: torch.Tensor, pw_k: torch.Tensor, pw_scale: torch.Tensor,
          pw_bias: torch.Tensor, stride: int = 1,
          launch_plan: Optional[Plan] = None) -> torch.Tensor:
    """x (B, H, W, Cin) float32 or bfloat16, dw_k (3, 3, Cin), pw_k (Cin,
    Cout) of any float dtype (cast to x.dtype here), dw_scale/dw_bias (Cin,)
    and pw_scale/pw_bias (Cout,) float32, all contiguous on one CUDA device
    -> (B, ceil(H/stride), ceil(W/stride), Cout) in x.dtype. bfloat16 runs
    under `plan(...)` of these shapes; `launch_plan` replaces it, so that
    the card tests and chip_smoke.py can hold every block width and K
    split against the plain version and time them."""
    global launches
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    vecs = (dw_scale, dw_bias, pw_scale, pw_bias)
    tensors = (x, dw_k, pw_k) + vecs
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("dsconv.fused needs every tensor on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if x.dtype not in (torch.float32, torch.bfloat16):
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
    ptrs = (x.data_ptr(), dw.data_ptr(), dw_scale.data_ptr(),
            dw_bias.data_ptr(), pw.data_ptr(), pw_scale.data_ptr(),
            pw_bias.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        if x.dtype == torch.float32:
            err = lib.dsconv_f32_launch(*ptrs, b, h, w, cin, cout, stride,
                                        stream)
        else:
            p = launch_plan or plan(b, h, w, cin, cout, stride)
            if (p.m, p.cin, p.cout) != (b * ho * wo, cin, cout) or \
                    p.block_n not in (64, 128, 256) or p.k_chunk <= 0 or \
                    p.k_chunk % 16:
                raise ValueError(f"launch plan {p} does not fit this call")
            partial = None
            if p.k_splits > 1:
                partial = torch.empty((p.k_splits, p.m, cout),
                                      dtype=torch.float32, device=x.device)
            err = lib.dsconv_bf16_launch(
                *ptrs, None if partial is None else partial.data_ptr(), b,
                h, w, cin, cout, stride, p.block_n, p.k_chunk, stream)
    if err != 0:
        raise RuntimeError(f"dsconv kernel launch failed: CUDA error {err}")
    launches += 1
    stride_launches[stride] += 1
    return out
