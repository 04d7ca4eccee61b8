"""The frame step's glue in plain PyTorch: the foreground integral image,
the box filters and the pipeline NMS, the crop + embed, and the
fixed-capacity detections the tracker takes.

A frozen copy of `FrameStep._apply_bgsub`, `_motion_ok`,
`_filter_and_nms`, `_pad_features` and `_detect_encode_frames`'s crop +
embed, as functions of their inputs instead of methods of a FrameStep.
Every function carries a leading frame axis.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as nnf

from . import boxes as boxops
from . import nms as nmsops
from .preprocess import crop_resize_patches_mxu


class StepConfig(NamedTuple):
    nms_max_overlap: float = 0.6
    spurious_area_frac: float = 0.9
    score_threshold: float = 0.5
    background_ratio: float = 0.25
    max_detections: int = 32
    encode_capacity: int = 8


class Snapshot(NamedTuple):
    tlwh: torch.Tensor
    label: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor


def label_lut(detector_labels: dict, wanted: Sequence[str],
              device) -> torch.Tensor:
    """Detector class -> index into `wanted`, or -1."""
    lut = np.full((max(detector_labels) + 1,), -1, np.int32)
    for idx, name in detector_labels.items():
        if name in wanted:
            lut[idx] = list(wanted).index(name)
    return torch.from_numpy(lut).to(device)


def foreground_integral(mask: torch.Tensor) -> torch.Tensor:
    """(..., H, W) MOG2 mask -> (..., H + 1, W + 1) integral image of the
    foreground count (shadow counts as foreground, as in the frame step)."""
    fg = (mask != 0).to(torch.int32)
    return nnf.pad(fg.cumsum(-2).cumsum(-1), (1, 0, 1, 0))


def _motion_ok(cfg: StepConfig, integral, x, y, w, h):
    cols = integral.shape[-1]
    flat = integral.flatten(-2)
    xi = x.to(torch.int32)
    yi = y.to(torch.int32)
    x2 = xi + w.to(torch.int32)
    y2 = yi + h.to(torch.int32)

    def at(r, c):
        return flat.gather(-1, (r.long() * cols + c.long()))
    s = at(y2, x2) - at(yi, x2) - at(y2, xi) + at(yi, xi)
    return s >= cfg.background_ratio * w * h


def filter_and_nms(cfg: StepConfig, lut, frame_h, frame_w, integral, xyxy,
                   classes, scores, valid) -> Snapshot:
    """Label, score, NaN, clip, spurious-area and motion filters, then the
    pipeline's class-agnostic NMS, compacted to max_detections slots."""
    H, W = frame_h, frame_w
    vocab = lut[classes.long().clamp(0, lut.shape[0] - 1)]
    valid = valid & (vocab >= 0) & (scores >= cfg.score_threshold)
    raw_tlwh = boxops.xyxy_to_tlwh(xyxy)
    any_nan = (valid[..., None] & ~torch.isfinite(raw_tlwh)).flatten(
        -2).any(-1)
    valid = valid & ~any_nan[..., None]
    x = torch.floor(torch.clamp(raw_tlwh[..., 0], 0, W))
    y = torch.floor(torch.clamp(raw_tlwh[..., 1], 0, H))
    w = torch.floor(torch.minimum(torch.clamp(raw_tlwh[..., 2], min=0),
                                  W - x))
    h = torch.floor(torch.minimum(torch.clamp(raw_tlwh[..., 3], min=0),
                                  H - y))
    tlwh = torch.stack([x, y, w, h], dim=-1)
    valid = valid & (w * h <= cfg.spurious_area_frac * (W * H))
    valid = valid & (w * h > 0)
    if integral is not None:
        valid = valid & _motion_ok(cfg, integral, x, y, w, h)
    order, _keep = nmsops.nms_tlwh(tlwh, scores, valid, cfg.nms_max_overlap)
    sel = order[..., :cfg.max_detections].long()
    ok = sel >= 0
    sel = sel.clamp(0, tlwh.shape[-2] - 1)
    return Snapshot(
        tlwh=torch.where(
            ok[..., None],
            tlwh.gather(-2, sel[..., None].expand(sel.shape + (4,))), 0.0),
        label=torch.where(ok, vocab.gather(-1, sel), 0),
        score=torch.where(ok, scores.gather(-1, sel), 0.0), valid=ok)


def embed_boxes(mars, frames, tlwh, valid, patch_hw=(128, 64)):
    """(F, H, W, 3) uint8 frames and (F, E, 4) boxes -> (F, E, 128) float32
    features (zero where the crop is empty) and the crops' ok mask."""
    F, E = tlwh.shape[:2]
    patches, ok = crop_resize_patches_mxu(frames, tlwh, valid, patch_hw[0],
                                          patch_hw[1], torch.float32)
    feats = mars(patches.reshape((F * E,) + patches.shape[2:]))
    feats = torch.where(ok.reshape(F * E)[:, None], feats,
                        torch.zeros_like(feats))
    return feats.reshape(F, E, -1), ok
