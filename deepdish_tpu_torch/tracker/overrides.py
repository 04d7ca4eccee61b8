"""Host-initiated track-table overrides for annotation-driven (CVAT) mode.

Port of deepdish_tpu/tracker/overrides.py (`force_update_slots` :22,
`delete_slots` :67). The reference's FrameRecords mutates tracker objects
directly (deepdish/framerecords.py:130-184: force-updating lost annotated
tracks via `t.update(...); t.state = Confirmed; t.time_since_update = 0`,
and silently dropping duplicate tracks). With the table-based tracker these
are two masked tensor functions that the runtime calls only in CVAT mode,
an offline evaluation path: plain torch ops, no kernel.
"""
from __future__ import annotations

import torch

from ..ops import boxes as boxops
from ..ops import kalman
from ..ops.distance import _normalize as _normalize_rows
from .tracker import _one_hot
from .types import CONFIRMED, EMPTY, Detections, TrackTable, TrackerConfig


def force_update_slots(cfg: TrackerConfig, table: TrackTable,
                       slot_det: torch.Tensor, dets: Detections
                       ) -> TrackTable:
    """For each slot with slot_det[slot] >= 0, run a full measurement update
    against detection slot_det[slot] and force Confirmed / tsu = 0
    (framerecords.py:157-160)."""
    D, L, P = cfg.max_detections, cfg.num_labels, cfg.pending_size
    do = slot_det >= 0
    do_i = do.to(torch.int32)
    mdet = slot_det.long().clamp(0, D - 1)
    det_xyah = boxops.tlwh_to_xyah(dets.tlwh)

    um, uc = kalman.update_v(table.mean, table.cov, det_xyah[mdet])
    mean = torch.where(do[:, None], um, table.mean)
    cov = torch.where(do[:, None, None], uc, table.cov)

    onehot = _one_hot(dets.label[mdet], L, torch.int32) * do_i[:, None]
    label_count = table.label_count + onehot
    label_conf = (table.label_conf + onehot.to(table.label_conf.dtype)
                  * dets.confidence[mdet][:, None])

    pslot = table.pending_count.clamp(0, P - 1)
    p_ids = torch.arange(P, device=slot_det.device)
    put = do[:, None] & (p_ids[None, :] == pslot[:, None])
    pending = torch.where(put[:, :, None],
                          _normalize_rows(dets.feature[mdet])[:, None, :],
                          table.pending)
    return table._replace(
        mean=mean, cov=cov, hits=table.hits + do_i,
        state=torch.where(do, CONFIRMED, table.state),
        time_since_update=torch.where(do, 0, table.time_since_update),
        label_count=label_count, label_conf=label_conf, pending=pending,
        pending_count=torch.clamp(table.pending_count + do_i, max=P))


def delete_slots(cfg: TrackerConfig, table: TrackTable,
                 delete_mask: torch.Tensor) -> TrackTable:
    """Silently free the masked slots (duplicate-track removal,
    framerecords.py:169-183: these produce no deletion events)."""
    d = delete_mask

    def z(x):
        m = d.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(m, torch.zeros_like(x), x)
    empty_mean = torch.zeros_like(table.mean)
    empty_mean[:, 3] = 1.0
    eye = torch.eye(8, dtype=table.cov.dtype, device=table.cov.device)
    return table._replace(
        state=torch.where(d, EMPTY, table.state),
        track_id=torch.where(d, -1, table.track_id),
        hits=z(table.hits), age=z(table.age),
        time_since_update=z(table.time_since_update),
        label_count=z(table.label_count), label_conf=z(table.label_conf),
        pending_count=z(table.pending_count),
        gallery_count=z(table.gallery_count),
        mean=torch.where(d[:, None], empty_mean, table.mean),
        cov=torch.where(d[:, None, None], eye, table.cov))
