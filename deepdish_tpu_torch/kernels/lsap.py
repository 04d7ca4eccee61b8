"""Wrapper of the CUDA LSAP kernel (csrc/lsap.cu).

Replaces the Pallas TPU kernel deepdish_tpu/ops/assignment_pallas.py
`_kernel` (:49, reached through `_solve_batched_pallas` and
`solve_lsap_pallas`), which runs the whole scipy-exact assignment solve of
one capacity-padded matrix in VMEM.

Bound: not memory. At the tracker's K = 64 the cost matrix is 16 KB, about
5 ns of HBM traffic at 3.35 TB/s. The solve is a serial chain of up to K
augmentations x K Dijkstra steps, each step a relaxation of the frontier
and a block-wide argmin, so its time is that chain's latency. The kernel
answers with one CTA per matrix that keeps the cost and all solver state in
shared memory for the whole solve, one thread per column, warp-shuffle
argmins, and device-side sizes (a launch needs no host sync). It is the
simple design; a persistent or warp-specialised one is later work.

The plain version is `ops.assignment.solve_lsap_plain`; the pipeline uses
it only for CPU tensors. Here a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches since the count was last reset (the main-path check)
launches = 0

_lib = None
_capacity = {}                  # device index -> largest K


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("lsap")
        lib.lsap_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
        lib.lsap_launch.restype = ctypes.c_int
        lib.lsap_max_capacity.argtypes = [ctypes.c_int]
        lib.lsap_max_capacity.restype = ctypes.c_int
        _lib = lib
    return _lib


def max_capacity(device=None) -> int:
    """Largest K whose (K, K) cost and solver state fit in one block's
    shared memory on `device` (default: the current CUDA device), as the
    kernel's library computes it."""
    index = torch.device("cuda" if device is None else device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _capacity:
        k = _library().lsap_max_capacity(index)
        if k < 0:
            raise RuntimeError(f"lsap capacity query failed: CUDA error {-k}")
        _capacity[index] = k
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
    if K > max_capacity(costs.device):
        raise ValueError(f"K = {K} does not fit one block's shared memory "
                         f"(largest K is {max_capacity(costs.device)})")
    out = torch.empty((B, K), dtype=torch.int32, device=costs.device)
    if B == 0 or K == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(costs.device).cuda_stream
    with torch.cuda.device(costs.device):
        err = lib.lsap_launch(costs.data_ptr(), sizes.data_ptr(),
                              out.data_ptr(), B, K, stream)
    if err != 0:
        raise RuntimeError(f"lsap kernel launch failed: CUDA error {err}")
    launches += 1
    return out
