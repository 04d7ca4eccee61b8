"""Greedy non-max suppression with the reference's pick order, batched.

Port of deepdish_tpu/ops/nms.py (`_greedy` :29-30, `nms_tlwh` :91,
`nms_xyxy_per_class` :109). Greedy NMS keeps box j iff no kept box earlier
in pick order suppresses it. In pick-rank space the suppression matrix is
strictly upper triangular, so the keep mask is the unique fixpoint of

    keep <- valid & ~any(S & keep[:, None], axis=0)

which Jacobi sweeps reach in as many sweeps as the longest suppression
chain. Each sweep here ends in one host sync (the convergence test), shared
by every problem of the batch. All functions take leading batch dims.
"""
from __future__ import annotations

import torch

from .. import device as devmod
from . import boxes as boxops
from .onehot import (argsort_desc_tie_high, argsort_desc_tie_low,
                     stable_argsort)


def _greedy(overlap: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
            max_overlap: float, tie_high: bool = True):
    """overlap[..., i, j]: suppression metric of candidate j against picked
    box i. Pick order is score descending with ties to the higher index
    (the reference NMS's pick-from-the-end of an ascending argsort), or
    with `tie_high=False` to the lower index (tf.image.non_max_suppression,
    the Faster R-CNN stages' order).

    Returns (order, keep): order (..., K) int32 original indices of the kept
    boxes in pick order, -1 past the last; keep (..., K) bool."""
    k = scores.shape[-1]
    dev = scores.device
    rank = (argsort_desc_tie_high(scores) if tie_high
            else argsort_desc_tie_low(scores))
    valid_r = valid.gather(-1, rank)
    rows = overlap.gather(-2, rank[..., :, None].expand(overlap.shape))
    s = rows.gather(-1, rank[..., None, :].expand(overlap.shape)) > max_overlap
    upper = torch.ones((k, k), dtype=torch.bool, device=dev).triu(1)
    s = s & upper & valid_r[..., :, None]

    keep_r = valid_r
    while True:
        new = valid_r & ~(s & keep_r[..., :, None]).any(-2)
        if not devmod.sync_bool((new != keep_r).any(), "nms"):
            break
        keep_r = new

    pos = torch.arange(k, device=dev)
    slot_key = torch.where(keep_r, pos, k)
    picked = stable_argsort(slot_key)       # kept rank positions, in order
    order = torch.where(slot_key.gather(-1, picked) < k,
                        rank.gather(-1, picked), -1).to(torch.int32)
    keep = torch.zeros_like(keep_r).scatter(-1, rank, keep_r)
    return order, keep


def nms_tlwh(boxes_tlwh: torch.Tensor, scores: torch.Tensor,
             valid: torch.Tensor, max_overlap: float):
    """Class-agnostic NMS of deep_sort/preprocessing.py: intersection (+1 px
    on w/h) over the candidate's (w+1)*(h+1) area."""
    tlbr = boxops.tlwh_to_tlbr(boxes_tlwh)
    tl = torch.maximum(tlbr[..., :, None, :2], tlbr[..., None, :, :2])
    br = torch.minimum(tlbr[..., :, None, 2:4], tlbr[..., None, :, 2:4])
    wh = torch.clamp(br - tl + 1.0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (boxes_tlwh[..., 2] + 1.0) * (boxes_tlwh[..., 3] + 1.0)
    overlap = inter / area[..., None, :]
    return _greedy(overlap, scores, valid, max_overlap)


def nms_xyxy_per_class(boxes_xyxy: torch.Tensor, scores: torch.Tensor,
                       classes: torch.Tensor, valid: torch.Tensor,
                       iou_threshold: float, coord_span: float = 1e4):
    """Per-class NMS of tools/ssd_mobilenet.py: IoU with +1 px intersection
    and area w*h. Classes are moved coord_span apart (and the same-class
    guard makes cross-class IoU exactly 0), as the JAX version does."""
    offset = classes.to(boxes_xyxy.dtype)[..., None] * coord_span
    zero = torch.zeros_like(offset)
    shifted = boxes_xyxy + torch.cat([offset, zero, offset, zero], dim=-1)
    tl = torch.maximum(shifted[..., :, None, :2], shifted[..., None, :, :2])
    br = torch.minimum(shifted[..., :, None, 2:4], shifted[..., None, :, 2:4])
    wh = torch.clamp(br - tl + 1.0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    w = boxes_xyxy[..., 2] - boxes_xyxy[..., 0]
    h = boxes_xyxy[..., 3] - boxes_xyxy[..., 1]
    area = w * h
    denom = area[..., :, None] + area[..., None, :] - inter
    iou = inter / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    same = classes[..., :, None] == classes[..., None, :]
    iou = torch.where(same, iou, torch.zeros_like(iou))
    return _greedy(iou, scores, valid, iou_threshold)
