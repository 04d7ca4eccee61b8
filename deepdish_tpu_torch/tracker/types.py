"""Fixed-capacity tracker state as NamedTuples of tensors.

Port of deepdish_tpu/tracker/types.py. The whole tracker is a table of
tensors with a per-slot state code (EMPTY -> TENTATIVE -> CONFIRMED, freed
back to EMPTY on deletion), a per-slot appearance gallery ring standing in
for the reference's unbounded feature lists, and a per-slot label-vote
histogram. Capacities are plain ints in `TrackerConfig`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..device import resolve_device, sync_int

EMPTY = 0
TENTATIVE = 1
CONFIRMED = 2

INFTY_COST = 1e5  # deep_sort/linear_assignment.py:8


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Static tracker parameters (defaults match the reference CLI:
    deepdish.py:1412-1423 and deep_sort/tracker.py:40). The assignment
    solver follows the tensors' device: the CUDA kernel on the card, the
    plain PyTorch version on the CPU (ops/assignment.py)."""
    max_tracks: int = 64
    max_detections: int = 32
    feature_dim: int = 128
    gallery_size: int = 128
    pending_size: int = 8
    num_labels: int = 8
    max_cosine_distance: float = 0.2
    max_iou_distance: float = 0.7
    max_age: int = 60
    n_init: int = 3
    gating_threshold: float = 9.4877  # chi2inv95[4]


class TrackTable(NamedTuple):
    mean: torch.Tensor          # (T, 8) Kalman mean (x, y, a, h, v*)
    cov: torch.Tensor           # (T, 8, 8) Kalman covariance
    state: torch.Tensor         # (T,) int32 EMPTY/TENTATIVE/CONFIRMED
    track_id: torch.Tensor      # (T,) int32, creation-ordered unique ids
    hits: torch.Tensor          # (T,) int32
    age: torch.Tensor           # (T,) int32
    time_since_update: torch.Tensor  # (T,) int32
    gallery: torch.Tensor       # (T, G, F) confirmed-track feature ring
    gallery_count: torch.Tensor  # (T,) int32 total appended (ring index)
    pending: torch.Tensor       # (T, P, F) features awaiting partial_fit
    pending_count: torch.Tensor  # (T,) int32
    label_count: torch.Tensor   # (T, L) int32 votes per label
    label_conf: torch.Tensor    # (T, L) f32 summed confidence per label
    next_id: torch.Tensor       # () int32, next track id (starts at 1)


class Detections(NamedTuple):
    """Fixed-capacity per-frame detections, in pipeline-NMS pick order."""
    tlwh: torch.Tensor        # (D, 4)
    confidence: torch.Tensor  # (D,)
    label: torch.Tensor       # (D,) int32 index into the wanted-label vocab
    feature: torch.Tensor     # (D, F)
    valid: torch.Tensor       # (D,) bool


class TrackStepOutput(NamedTuple):
    """Per-frame snapshot the host reads for analytics and rendering."""
    track_id: torch.Tensor     # (T,) int32
    state: torch.Tensor        # (T,) int32
    tlwh: torch.Tensor         # (T, 4)
    time_since_update: torch.Tensor  # (T,) int32
    hits: torch.Tensor         # (T,) int32
    age: torch.Tensor          # (T,) int32
    label_count: torch.Tensor  # (T, L) int32
    label_conf: torch.Tensor   # (T, L) f32
    matched_det: torch.Tensor  # (T,) int32 det index matched or -1
    deleted_id: torch.Tensor   # (T,) int32 ids deleted this frame, -1 none
    deleted_tlwh: torch.Tensor  # (T, 4)
    deleted_label_count: torch.Tensor  # (T, L)
    deleted_label_conf: torch.Tensor   # (T, L)


def create_table(cfg: TrackerConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32) -> TrackTable:
    """An empty table on `device` (default CUDA; raises without a card
    unless device="cpu")."""
    dev = resolve_device(device)
    T, G, P, F, L = (cfg.max_tracks, cfg.gallery_size, cfg.pending_size,
                     cfg.feature_dim, cfg.num_labels)
    i32 = dict(dtype=torch.int32, device=dev)
    mean = torch.zeros((T, 8), dtype=dtype, device=dev)
    mean[:, 3] = 1.0  # h = 1 keeps the filter finite in empty slots
    return TrackTable(
        mean=mean,
        cov=torch.eye(8, dtype=dtype, device=dev).repeat(T, 1, 1),
        state=torch.zeros((T,), **i32),
        track_id=torch.full((T,), -1, **i32),
        hits=torch.zeros((T,), **i32),
        age=torch.zeros((T,), **i32),
        time_since_update=torch.zeros((T,), **i32),
        gallery=torch.zeros((T, G, F), dtype=dtype, device=dev),
        gallery_count=torch.zeros((T,), **i32),
        pending=torch.zeros((T, P, F), dtype=dtype, device=dev),
        pending_count=torch.zeros((T,), **i32),
        label_count=torch.zeros((T, L), **i32),
        label_conf=torch.zeros((T, L), dtype=dtype, device=dev),
        next_id=torch.tensor(1, **i32),
    )


def gallery_pressure(cfg: TrackerConfig, table: TrackTable) -> int:
    """Largest per-slot appended-feature count (host int, one counted
    sync). When it reaches gallery_size the ring starts overwriting and
    appearance costs diverge from the reference's unbounded gallery
    (deepdish.py:515 budget=None); the runtime grows the gallery first."""
    return sync_int(table.gallery_count.max())


def gallery_overflow(cfg: TrackerConfig, table: TrackTable) -> int:
    """Total features overwritten by the ring across slots (0: the bounded
    gallery is still exactly the reference's unbounded one)."""
    over = torch.clamp(table.gallery_count - cfg.gallery_size, min=0)
    return sync_int(over.sum())


def grow_gallery(cfg: TrackerConfig, table: TrackTable, new_size: int):
    """(cfg', table') with the gallery ring enlarged to `new_size`. Must be
    called while every slot's gallery_count is still <= gallery_size
    (before any overwrite): the ring is then linear, so zero-padding the
    gallery axis keeps every stored feature at its index and the min-cosine
    distances are unchanged."""
    if new_size < cfg.gallery_size:
        raise ValueError("gallery can only grow")
    if gallery_pressure(cfg, table) > cfg.gallery_size:
        raise ValueError("gallery already wrapped; growth would scramble "
                         "ring order — grow earlier (pressure threshold)")
    new_cfg = dataclasses.replace(cfg, gallery_size=new_size)
    T, G, F = table.gallery.shape
    pad = table.gallery.new_zeros((T, new_size - G, F))
    return new_cfg, table._replace(
        gallery=torch.cat([table.gallery, pad], dim=1))


def pack_detections(cfg: TrackerConfig, tlwh, confidence, label, feature,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Detections:
    """Host helper: pad variable-length detections to capacity."""
    dev = resolve_device(device)
    D, F = cfg.max_detections, cfg.feature_dim
    n = min(len(tlwh), D)
    out_tlwh = np.zeros((D, 4), np.float32)
    out_conf = np.zeros((D,), np.float32)
    out_label = np.zeros((D,), np.int32)
    out_feat = np.zeros((D, F), np.float32)
    valid = np.zeros((D,), bool)
    if n:
        out_tlwh[:n] = np.asarray(tlwh, np.float32)[:n]
        out_conf[:n] = np.asarray(confidence, np.float32)[:n]
        out_label[:n] = np.asarray(label, np.int32)[:n]
        out_feat[:n] = np.asarray(feature, np.float32)[:n]
        valid[:n] = True
    return Detections(*(torch.from_numpy(a).to(dev) for a in
                        (out_tlwh, out_conf, out_label, out_feat, valid)))
