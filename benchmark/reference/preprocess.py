"""Frame resize and aspect-corrected box crops as sampling-matrix products.

Port of deepdish_tpu/models/preprocess.py (`resize_bilinear_mxu` :60,
`crop_resize_patches_mxu` :134). Bilinear resampling along an axis is a
linear map with 2-tap rows w = max(0, 1 - |src - coord|) (half-pixel
centres, edge clamping included), so a resize is Wy @ image @ Wx: two
plain matrix products (cuBLAS on the card), no gathers.

Layouts stay the JAX package's: NHWC images with any leading batch dims.
"""
from __future__ import annotations

from typing import Optional

import torch


def default_compute_dtype(device) -> torch.dtype:
    """bf16 on the card, float32 on the CPU (as the JAX package picks bf16
    on the TPU and float32 elsewhere)."""
    return (torch.bfloat16 if torch.device(device).type == "cuda"
            else torch.float32)


def _taps(coords: torch.Tensor, n: int) -> torch.Tensor:
    """(..., A) float sample coordinates -> (..., A, n) 2-tap weights."""
    grid = torch.arange(n, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(grid - coords[..., None]), min=0.0)


def resize_bilinear_mxu(image: torch.Tensor, out_h: int, out_w: int,
                        compute_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C) float32, half-pixel bilinear
    (cv2 INTER_LINEAR semantics up to its fixed-point rounding)."""
    if compute_dtype is None:
        compute_dtype = default_compute_dtype(image.device)
    H, W = image.shape[-3], image.shape[-2]
    dev = image.device
    ys = torch.clamp((torch.arange(out_h, dtype=torch.float32, device=dev)
                      + 0.5) * (H / out_h) - 0.5, 0, H - 1)
    xs = torch.clamp((torch.arange(out_w, dtype=torch.float32, device=dev)
                      + 0.5) * (W / out_w) - 0.5, 0, W - 1)
    wy = _taps(ys, H)                         # (out_h, H)
    wx = _taps(xs, W).transpose(0, 1)         # (W, out_w)
    mid = torch.einsum("...hwc,wo->...hoc", image.to(compute_dtype),
                       wx.to(compute_dtype)).float()
    return torch.einsum("yh,...hoc->...yoc", wy, mid)


def crop_resize_patches_mxu(image: torch.Tensor, boxes_tlwh: torch.Tensor,
                            valid: torch.Tensor, patch_h: int, patch_w: int,
                            compute_dtype: Optional[torch.dtype] = None):
    """Aspect-corrected crop + resize of every box (generate_detections.py
    extract_image_patch semantics): widen the box to the patch aspect about
    its centre, truncate to ints, clip at the frame, resample bilinearly.
    Empty or out-of-frame boxes give a zero patch and ok = False.

    image (..., H, W, C); boxes_tlwh (..., D, 4); valid (..., D).
    Returns (patches (..., D, patch_h, patch_w, C) float32, ok (..., D))."""
    if compute_dtype is None:
        compute_dtype = default_compute_dtype(image.device)
    H, W = image.shape[-3], image.shape[-2]
    dev = image.device
    target_aspect = float(patch_w) / float(patch_h)
    x, y, w, h = boxes_tlwh.unbind(-1)
    new_w = target_aspect * h
    x = x - (new_w - w) / 2.0
    w = new_w
    sx = torch.clamp(torch.trunc(x).to(torch.int32), min=0)
    sy = torch.clamp(torch.trunc(y).to(torch.int32), min=0)
    ex = torch.clamp(torch.trunc(x + w).to(torch.int32), max=W - 1)
    ey = torch.clamp(torch.trunc(y + h).to(torch.int32), max=H - 1)
    ok = valid & (sx < ex) & (sy < ey)
    ch = torch.clamp(ey - sy, min=1).float()
    cw = torch.clamp(ex - sx, min=1).float()
    ar_h = torch.arange(patch_h, dtype=torch.float32, device=dev)
    ar_w = torch.arange(patch_w, dtype=torch.float32, device=dev)
    sy_f, sx_f = sy.float()[..., None], sx.float()[..., None]
    ys = sy_f + (ar_h + 0.5) * ch[..., None] / patch_h - 0.5
    xs = sx_f + (ar_w + 0.5) * cw[..., None] / patch_w - 0.5
    ys = torch.minimum(torch.maximum(ys, sy_f),
                       torch.maximum(ey - 1, sy).float()[..., None])
    xs = torch.minimum(torch.maximum(xs, sx_f),
                       torch.maximum(ex - 1, sx).float()[..., None])
    wy = _taps(ys, H).to(compute_dtype)                      # (..., D, ph, H)
    wx = _taps(xs, W).transpose(-1, -2).to(compute_dtype)    # (..., D, W, pw)
    # columns first: W -> patch_w is the larger reduction (as in the JAX
    # version), and the (H, patch_w, C) intermediate per box is small
    mid = torch.einsum("...hwc,...dwo->...dhoc", image.to(compute_dtype), wx)
    patch = torch.einsum("...dyh,...dhoc->...dyoc", wy, mid).float()
    patch = torch.where(ok[..., None, None, None], patch,
                        torch.zeros_like(patch))
    return patch, ok
