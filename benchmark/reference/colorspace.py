"""I420 (planar YUV 4:2:0) -> RGB on the frames' device.

Port of deepdish_tpu/ops/colorspace.py (`yuv420_to_rgb` :35,
`yuv420_to_rgb_u8` :47). Sending I420 instead of RGB halves the
host-to-device bytes (1.5 against 3 bytes a pixel), and the conversion runs
on the card as plain elementwise torch ops. The coefficients are ITU-R
BT.601 video range, cv2.COLOR_YUV2RGB_I420's up to its fixed-point rounding
and chroma replication.

Layout (OpenCV I420): a (H*3/2, W) uint8 buffer holds the Y plane (H, W),
then the U plane packed into H/4 rows, then V likewise; chroma is
(H/2, W/2). Any leading dims are frames.
"""
from __future__ import annotations

import numpy as np
import torch

# BT.601 video range (cv2 YUV2RGB_I420)
_YC, _VR, _UG, _VG, _UB = 1.1644, 1.5960, 0.3918, 0.8130, 2.0172


def _planes(yuv: torch.Tensor, h: int, w: int):
    lead = yuv.shape[:-2]
    y = yuv[..., :h, :].float()
    u = yuv[..., h:h + h // 4, :].reshape(lead + (h // 2, w // 2)).float()
    v = yuv[..., h + h // 4:, :].reshape(lead + (h // 2, w // 2)).float()
    return y, u, v


def _upsample(c: torch.Tensor) -> torch.Tensor:
    return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _fma(a, b: float, c):
    """float32 a * b + c with one rounding (a fused multiply-add): the
    product of two float32 values is exact in float64."""
    return (a.double() * float(np.float32(b)) + c.double()).float()


def yuv420_to_rgb(yuv: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., H*3/2, W) uint8 I420 -> (..., H, W, 3) float32 RGB in
    [0, 255].

    The rounding points are those of the JAX version as XLA compiles it
    (its elementwise fusion contracts each channel's last multiply-add
    into an FMA), so both give the same bytes."""
    y, u, v = _planes(yuv, h, w)
    u = _upsample(u) - 128.0
    v = _upsample(v) - 128.0
    ym = y - 16.0
    c = _YC * ym
    r = _fma(v, _VR, c)
    g = _fma(v, -_VG, _fma(ym, _YC, -(_UG * u)))
    b = _fma(u, _UB, c)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def yuv420_to_rgb_u8(yuv: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., H*3/2, W) uint8 I420 -> (..., H, W, 3) uint8 RGB, rounded to
    nearest: the frame dtype the host RGB transport delivers, so both
    transports feed the frame step the same thing."""
    return torch.floor(yuv420_to_rgb(yuv, h, w) + 0.5).to(torch.uint8)
