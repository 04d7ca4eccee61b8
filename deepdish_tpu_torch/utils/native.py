"""ctypes bindings + lazy build for the native C++ frame loader.

A copy of deepdish_tpu/utils/native.py (host C++, not a kernel; the port
keeps its own binding to the repo's native/frameloader.cpp).

See native/frameloader.cpp. The library is built on first use with the
system g++/OpenCV (cached next to the source); if the toolchain or OpenCV
dev headers are unavailable the caller can fall back to the Python
cv2.VideoCapture path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libframeloader.so"))

_lib = None


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                       check=True, capture_output=True, timeout=300)
        return os.path.exists(_LIB_PATH)
    except (subprocess.SubprocessError, OSError):
        return False


def load_library() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fl_open_yuv.restype = ctypes.c_void_p
    lib.fl_open_yuv.argtypes = lib.fl_open.argtypes
    lib.fl_next_chunk.restype = ctypes.c_int
    lib.fl_next_chunk.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_ubyte),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.fl_close.argtypes = [ctypes.c_void_p]
    lib.fls_open.restype = ctypes.c_void_p
    lib.fls_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int]
    lib.fls_total_frames.restype = ctypes.c_int
    lib.fls_total_frames.argtypes = [ctypes.c_void_p]
    lib.fls_next.restype = ctypes.c_int
    lib.fls_next.argtypes = [ctypes.c_void_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_ubyte)]
    lib.fls_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeFrameLoader:
    """Parallel multi-stream decoder feeding (S, F, H, W, 3) uint8 chunks."""

    def __init__(self, paths: List[str], out_w: int, out_h: int,
                 queue_depth: int = 8, yuv420: bool = False):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native frame loader unavailable "
                               "(g++/OpenCV dev missing?)")
        self._lib = lib
        self.n_streams = len(paths)
        self.out_w, self.out_h = out_w, out_h
        self.yuv420 = yuv420
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        opener = lib.fl_open_yuv if yuv420 else lib.fl_open
        self._handle = opener(arr, len(paths), out_w, out_h, queue_depth)
        if not self._handle:
            raise RuntimeError("fl_open failed")

    def next_chunk(self, chunk: int):
        """Returns (frames, counts (S,) int32, total). RGB mode:
        (S, chunk, H, W, 3) uint8; YUV420 mode: (S, chunk, H*3/2, W)."""
        if self.yuv420:
            out = np.empty((self.n_streams, chunk,
                            self.out_h * 3 // 2, self.out_w), np.uint8)
        else:
            out = np.empty((self.n_streams, chunk, self.out_h, self.out_w,
                            3), np.uint8)
        counts = np.zeros((self.n_streams,), np.int32)
        total = self._lib.fl_next_chunk(
            self._handle, chunk,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out, counts, total

    def close(self):
        if self._handle:
            self._lib.fl_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class StripedFrameLoader:
    """Keyframe-striped parallel decode of ONE file (native/frameloader.cpp
    StripedLoader): K C++ decoder threads each own interleaved stripes of
    `stripe_len` frames, seeking stripe starts with FFmpeg's accurate
    (keyframe + roll-forward) seek; frames come back in global order,
    byte-equal to sequential decode (tests/test_striped_decode.py).

    This is the decode-side answer to the ≥1000 FPS offline north star:
    a single mp4's sequential decode tops out at ~1 core (~85-300 FPS),
    so single-stream decode->count needs intra-file decode parallelism.
    On this 1-core bench host the scaling curve is flat by construction;
    the tool exists for production hosts (like the cold-start probe)."""

    def __init__(self, path: str, n_workers: int = 4, stripe_len: int = 64,
                 out_w: int = 1280, out_h: int = 720,
                 queue_depth: int = 128, yuv420: bool = False):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native frame loader unavailable "
                               "(g++/OpenCV dev missing?)")
        self._lib = lib
        self.n_workers = n_workers
        self.out_w, self.out_h = out_w, out_h
        self.yuv420 = yuv420
        self._handle = lib.fls_open(path.encode(), n_workers, stripe_len,
                                    out_w, out_h, queue_depth,
                                    1 if yuv420 else 0)
        if not self._handle:
            raise RuntimeError(
                f"fls_open failed for {path!r} (unopenable, or the "
                "container reports no frame count — use the sequential "
                "loader)")
        self.total_frames = lib.fls_total_frames(self._handle)

    def next(self, n: int):
        """Next n frames in global order: (got, frames) where frames is
        (n, H, W, 3) uint8 RGB or (n, H*3/2, W) planar I420; got < n only
        at end of file (slots past got are uninitialized)."""
        if self.yuv420:
            out = np.empty((n, self.out_h * 3 // 2, self.out_w), np.uint8)
        else:
            out = np.empty((n, self.out_h, self.out_w, 3), np.uint8)
        got = self._lib.fls_next(
            self._handle, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        return got, out

    # NativeFrameLoader-compatible single-stream chunk interface, so the
    # striped loader drops into any consumer of the sequential loader
    # (pipeline/runtime.capture_native, bench.py) unchanged.
    n_streams = 1

    def next_chunk(self, chunk: int):
        """(frames (1, chunk, ...), counts (1,) int32, total) — the
        NativeFrameLoader.next_chunk contract for one stream."""
        got, frames = self.next(chunk)
        return frames[None], np.array([got], np.int32), got

    def close(self):
        if self._handle:
            self._lib.fls_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
