"""Wrapper of the CUDA LSAP kernel (csrc/lsap.cu).

Replaces the Pallas TPU kernel deepdish_tpu/ops/assignment_pallas.py
`_kernel` (:49, reached through `_solve_batched_pallas` and
`solve_lsap_pallas`), which runs the whole scipy-exact assignment solve of
one capacity-padded matrix in VMEM.

Bound: not memory. At the tracker's K = 64 a 32 x 32 problem's live block is
4 KB, about 1.3 ns of HBM traffic at 3.35 TB/s. The solve is a serial chain
of Dijkstra steps (a relaxation of the scan and an argmin over it), so its
time is that chain's latency. The kernel gives each matrix a block of one
warp, with its columns' and rows' state in registers, the argmin as two
`redux.sync` and no block barrier; the live block of the cost and a copy of
the row duals sit in the block's shared memory, sized by `plan`.

The plain version is `ops.assignment.solve_lsap_plain`; the pipeline uses
it only for CPU tensors. Here a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

#: kernel launches since the count was last reset (the main-path check)
launches = 0

MAX_Q = 8                  # columns per lane (csrc kMaxQ): K <= 256

_lib = None
_capacity = {}             # device index -> largest K


class Plan(NamedTuple):
    """How csrc/lsap.cu covers a (B, K, K) call: `grid` blocks of one warp,
    one matrix each; lane l owns columns l + 32 q for q < `q`; `smem_bytes`
    of dynamic shared memory a block."""
    q: int
    grid: int
    smem_bytes: int


def plan(b: int, k: int) -> Plan:
    """The launch of a (b, k, k) call. A block's shared memory is the cost
    at an odd row stride (k | 1, so a transposed store hits 32 banks) and
    a copy of u, as csrc/lsap.cu lays it out."""
    if not 1 <= k <= 32 * MAX_Q:
        raise ValueError(f"K must be in 1..{32 * MAX_Q}, got {k}")
    return Plan(-(-k // 32), b, 4 * (k * (k | 1) + k))


def capacity(smem_optin: int) -> int:
    """Largest K whose block fits `smem_optin` bytes of shared memory."""
    return max((k for k in range(1, 32 * MAX_Q + 1)
                if plan(1, k).smem_bytes <= smem_optin), default=0)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("lsap")
        lib.lsap_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                    + [ctypes.c_void_p])
        lib.lsap_launch.restype = ctypes.c_int
        lib.lsap_smem_optin.argtypes = [ctypes.c_int]
        lib.lsap_smem_optin.restype = ctypes.c_int
        _lib = lib
    return _lib


def max_capacity(device=None) -> int:
    """Largest K the kernel takes on `device` (default: the current CUDA
    device): its block within the device's opt-in shared memory."""
    index = torch.device("cuda" if device is None else device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _capacity:
        optin = _library().lsap_smem_optin(index)
        if optin < 0:
            raise RuntimeError(f"lsap capacity query failed: CUDA error "
                               f"{-optin}")
        _capacity[index] = capacity(optin)
    return _capacity[index]


def solve(costs: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """costs (B, K, K) float32 and sizes (B, 2) int32 (n_rows, n_cols), both
    contiguous on one CUDA device -> (B, K) int32 row -> col, -1 where a row
    has no column."""
    global launches
    if costs.device.type != "cuda" or sizes.device != costs.device:
        raise ValueError("lsap.solve needs costs and sizes on one CUDA "
                         f"device, got {costs.device} and {sizes.device}")
    if costs.dtype != torch.float32 or sizes.dtype != torch.int32:
        raise TypeError("lsap.solve needs float32 costs and int32 sizes, got "
                        f"{costs.dtype} and {sizes.dtype}")
    if costs.dim() != 3 or costs.shape[1] != costs.shape[2]:
        raise ValueError(f"costs must be (B, K, K), got {tuple(costs.shape)}")
    B, K = costs.shape[0], costs.shape[1]
    if tuple(sizes.shape) != (B, 2):
        raise ValueError(f"sizes must be ({B}, 2), got {tuple(sizes.shape)}")
    if not (costs.is_contiguous() and sizes.is_contiguous()):
        raise ValueError("costs and sizes must be contiguous")
    index = costs.device.index
    cap = _capacity.get(index) or max_capacity(index)
    if K > cap:
        raise ValueError(f"K = {K} does not fit one block's shared memory "
                         f"(largest K is {cap})")
    out = torch.empty((B, K), dtype=torch.int32, device=costs.device)
    if B == 0 or K == 0:
        return out
    p = plan(B, K)
    err = _library().lsap_launch(
        costs.data_ptr(), sizes.data_ptr(), out.data_ptr(), B, K, p.q, p.grid,
        p.smem_bytes, index, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lsap kernel launch failed: CUDA error {err}")
    launches += 1
    return out
