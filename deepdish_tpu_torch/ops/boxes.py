"""Box format conversions and pairwise IoU on (..., 4) tensors.

Port of deepdish_tpu/ops/boxes.py:19-81 (the reference's per-box
conversions in deep_sort/detection.py and track.py, vectorized).

Formats:
  tlwh: (top-left x, top-left y, width, height)
  tlbr: (min x, min y, max x, max y)
  xyah: (center x, center y, aspect = w/h, height)
"""
from __future__ import annotations

import torch


def tlwh_to_tlbr(tlwh: torch.Tensor) -> torch.Tensor:
    tl = tlwh[..., :2]
    return torch.cat([tl, tl + tlwh[..., 2:4]], dim=-1)


def tlbr_to_tlwh(tlbr: torch.Tensor) -> torch.Tensor:
    tl = tlbr[..., :2]
    return torch.cat([tl, tlbr[..., 2:4] - tl], dim=-1)


def tlwh_to_xyah(tlwh: torch.Tensor) -> torch.Tensor:
    center = tlwh[..., :2] + tlwh[..., 2:4] / 2.0
    a = tlwh[..., 2:3] / tlwh[..., 3:4]
    return torch.cat([center, a, tlwh[..., 3:4]], dim=-1)


def xyah_to_tlwh(xyah: torch.Tensor) -> torch.Tensor:
    h = xyah[..., 3:4]
    w = xyah[..., 2:3] * h
    tl = xyah[..., :2] - torch.cat([w, h], dim=-1) / 2.0
    return torch.cat([tl, w, h], dim=-1)


def xyxy_to_tlwh(xyxy: torch.Tensor) -> torch.Tensor:
    return tlbr_to_tlwh(xyxy)


def iou_matrix_tlwh(a_tlwh: torch.Tensor, b_tlwh: torch.Tensor
                    ) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M), deep_sort/iou_matching.py
    arithmetic (no +1 pixel convention)."""
    a_tl = a_tlwh[..., :, None, :2]
    a_br = a_tl + a_tlwh[..., :, None, 2:4]
    b_tl = b_tlwh[..., None, :, :2]
    b_br = b_tl + b_tlwh[..., None, :, 2:4]
    tl = torch.maximum(a_tl, b_tl)
    br = torch.minimum(a_br, b_br)
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = a_tlwh[..., :, None, 2] * a_tlwh[..., :, None, 3]
    area_b = b_tlwh[..., None, :, 2] * b_tlwh[..., None, :, 3]
    return inter / (area_a + area_b - inter)


def iou_matrix_tlbr_plus1(a_tlbr: torch.Tensor, b_tlbr: torch.Tensor
                          ) -> torch.Tensor:
    """Pairwise IoU with +1 on the intersection's w/h and area = w*h (the
    tools/ssd_mobilenet.py NMS convention)."""
    tl = torch.maximum(a_tlbr[:, None, :2], b_tlbr[None, :, :2])
    br = torch.minimum(a_tlbr[:, None, 2:4], b_tlbr[None, :, 2:4])
    wh = torch.clamp(br - tl + 1.0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a_tlbr[:, 2] - a_tlbr[:, 0]) *
              (a_tlbr[:, 3] - a_tlbr[:, 1]))[:, None]
    area_b = ((b_tlbr[:, 2] - b_tlbr[:, 0]) *
              (b_tlbr[:, 3] - b_tlbr[:, 1]))[None, :]
    return inter / (area_a + area_b - inter)
