"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
into a shared library (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The library lands in `deepdish_tpu_torch/_build/`, named by a hash of the
source, every header in `csrc/` (`*.cuh`, which the sources include) and the
flags, so an edited source or header is rebuilt at its next use and an
unchanged one is loaded as built. The kernels use inline PTX only (wgmma,
cp.async): no TMA descriptor, so no -lcuda, and no CUTLASS headers. Nothing
is built at import time: the first call of a kernel's wrapper builds it. Fast math stays off: the kernels'
results must match their plain versions bit for bit.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> (loaded library, nvcc's -Xptxas -v report)
_LOADED: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "deepdish_tpu_torch's kernels")


def _headers() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if its hashed
    library is missing."""
    if name not in _LOADED:
        src = os.path.join(CSRC, f"{name}.cu")
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [src] + _headers():
            with open(path, "rb") as f:
                digest.update(f.read())
        digest = digest.hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"   # another process may build too
            done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit "
                                   f"{done.returncode}):\n{done.stdout}"
                                   f"{done.stderr}")
            with open(f"{so}.log", "w") as f:
                f.write(done.stdout + done.stderr)
            os.replace(tmp, so)
        with open(f"{so}.log") as f:
            report = f.read()
        _LOADED[name] = (ctypes.CDLL(so), report)
    return _LOADED[name][0]


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v lines (registers, shared memory, spills) of the
    loaded library."""
    load(name)
    return _LOADED[name][1]
