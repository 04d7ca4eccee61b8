"""The multi-target tracker step over the fixed track table.

Port of deepdish_tpu/tracker/tracker.py `step` (:47-231): predict, the
appearance cascade and IoU association, Kalman updates, label votes,
lifecycle, new tracks, and the gallery partial_fit, as masked tensor ops
over the (T,)-slot table. Semantics, for crossing-count parity with the
reference (deep_sort/tracker.py, track.py):
  * predict ages every live track;
  * the cascade gates appearance costs at chi2inv95[4] and clamps at
    max_distance; the IoU stage takes unconfirmed and just-missed confirmed
    tracks, with INFTY rows for time_since_update > 1;
  * tentative tracks die on their first miss, confirm after n_init hits,
    and confirmed tracks age out past max_age;
  * unmatched detections start tracks in detection order with sequential
    ids; features wait in `pending` and reach the gallery once the track is
    confirmed.

The step works on S streams' tables at once, stacked on a leading axis
((S, T, ...) fields, (S, D, ...) detections), as the JAX engine's `vmap`
over streams does: each op and each cascade level runs once for all S
(`matching.py`), and each stream's result is the one it gets alone. One
stream's (T, ...) table is the S = 1 case.

`step` consumes its table: the gallery ring is written in place (it is the
largest tensor, (S, T, G, F)); every other field of the returned table is
new.
Its four stages run in the profiler ranges "framestep.trk_predict",
"framestep.trk_cascade", "framestep.trk_iou" and "framestep.trk_update"
(`device.span`), which together cover the step.
"""
from __future__ import annotations

import torch

from ..device import span
from ..ops import boxes as boxops
from ..ops import kalman
from ..ops.distance import _normalize as _normalize_rows
from ..ops.distance import gallery_min_cosine
from ..ops.onehot import (flat_rows, gather_rows, scatter_rows_unique,
                          stable_argsort)
from .matching import iou_stage, matching_cascade
from .types import (CONFIRMED, EMPTY, INFTY_COST, TENTATIVE, Detections,
                    TrackStepOutput, TrackTable, TrackerConfig)


def _gallery_valid(cfg: TrackerConfig, gallery_count: torch.Tensor):
    g = torch.arange(cfg.gallery_size, device=gallery_count.device)
    return g < torch.clamp(gallery_count, max=cfg.gallery_size)[..., None]


def _one_hot(label: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., N) -> (..., N, n); out-of-range labels give a zero row, as
    jax.nn.one_hot does."""
    ids = torch.arange(n, device=label.device)
    return (label.long()[..., None] == ids).to(dtype)


def step(cfg: TrackerConfig, table: TrackTable, dets: Detections):
    """One frame: returns (new_table, TrackStepOutput).

    A table of one stream ((T, ...) fields, `next_id` ()) with (D, ...)
    detections is the S = 1 case of S streams' tables stacked on a leading
    axis ((S, T, ...), `next_id` (S,)) with (S, D, ...) detections; the
    outputs have the table's leading axes."""
    if table.state.dim() == 1:
        new, out = step(cfg, TrackTable(*(x.unsqueeze(0) for x in table)),
                        Detections(*(x.unsqueeze(0) for x in dets)))
        return (TrackTable(*(x[0] for x in new)),
                TrackStepOutput(*(x[0] for x in out)))
    with span("framestep.trk_predict"):
        T, D, L, P = (cfg.max_tracks, cfg.max_detections, cfg.num_labels,
                      cfg.pending_size)
        G = cfg.gallery_size
        if P > G:
            raise ValueError("pending_size must not exceed gallery_size")
        S = table.state.shape[0]
        dev = table.mean.device
        i32 = torch.int32
        live = table.state != EMPTY
        live_i = live.to(i32)

        # ---- predict (tracker.py:51-57) ----
        pm, pc = kalman.predict_v(table.mean, table.cov)
        mean = torch.where(live[..., None], pm, table.mean)
        cov = torch.where(live[..., None, None], pc, table.cov)
        age = table.age + live_i
        tsu = table.time_since_update + live_i

        # ---- cost matrices, once per frame ----
        # features are unit-normalized once here and stored normalized, so the
        # gallery never needs re-normalizing (cosine distance is invariant)
        feat_n = _normalize_rows(dets.feature)
        det_xyah = boxops.tlwh_to_xyah(dets.tlwh)
        app = gallery_min_cosine(
            table.gallery,
            _gallery_valid(cfg, table.gallery_count) & live[..., None],
            feat_n, data_is_normalized=True)
        app = torch.where(torch.isfinite(app), app,
                          torch.full_like(app, INFTY_COST))
        gate = kalman.gating_distance_v(mean, cov, det_xyah)
        app = torch.where(gate > cfg.gating_threshold,
                          torch.full_like(app, INFTY_COST), app)

        track_tlwh = boxops.xyah_to_tlwh(mean[..., :4])
        iou = 1.0 - boxops.iou_matrix_tlwh(track_tlwh, dets.tlwh)
        iou = torch.where((tsu > 1)[..., None],
                          torch.full_like(iou, INFTY_COST), iou)

    # ---- two-stage association (tracker.py:95-133) ----
    with span("framestep.trk_cascade"):
        matched, taken = matching_cascade(
            cfg, app, table.state, table.track_id, tsu, dets.valid)
    with span("framestep.trk_iou"):
        matched, taken = iou_stage(
            cfg, iou, table.state, table.track_id, tsu, matched, dets.valid,
            taken)
    with span("framestep.trk_update"):
        was_matched = matched >= 0
        wm_i = was_matched.to(i32)
        mdet = matched.clamp(0, D - 1).long()

        # ---- Kalman measurement update of matched tracks ----
        um, uc = kalman.update_v(mean, cov, gather_rows(det_xyah, mdet))
        mean = torch.where(was_matched[..., None], um, mean)
        cov = torch.where(was_matched[..., None, None], uc, cov)
        hits = table.hits + wm_i
        tsu = torch.where(was_matched, 0, tsu)

        # label vote (track.py:147-152)
        onehot = _one_hot(dets.label.gather(1, mdet), L, i32) * wm_i[..., None]
        label_count = table.label_count + onehot
        label_conf = (table.label_conf +
                      onehot.to(table.label_conf.dtype) *
                      dets.confidence.gather(1, mdet)[..., None])

        # pending feature append (track.py:141)
        pslot = table.pending_count.clamp(0, P - 1)
        p_ids = torch.arange(P, device=dev)
        put = was_matched[..., None] & (p_ids == pslot[..., None])
        pending = torch.where(put[..., None],
                              gather_rows(feat_n, mdet)[:, :, None, :],
                              table.pending)
        pending_count = torch.clamp(table.pending_count + wm_i, max=P)

        # confirmation (track.py:145-146)
        state = torch.where(
            (table.state == TENTATIVE) & was_matched & (hits >= cfg.n_init),
            CONFIRMED, table.state)

        # ---- mark_missed (track.py:190-196) ----
        unmatched_live = live & ~was_matched
        aged_out = (state == CONFIRMED) & (tsu > cfg.max_age)
        delete = unmatched_live & ((state == TENTATIVE) | aged_out)
        deleted_id = torch.where(delete, table.track_id, -1)
        deleted_tlwh = torch.where(delete[..., None],
                                   boxops.xyah_to_tlwh(mean[..., :4]), 0.0)
        deleted_lc = torch.where(delete[..., None], label_count, 0)
        deleted_lf = torch.where(delete[..., None], label_conf, 0.0)

        # free deleted slots
        state = torch.where(delete, EMPTY, state)
        live = state != EMPTY
        track_id = torch.where(delete, -1, table.track_id)

        def zero_on_delete(x):
            mask = delete.reshape((S, T) + (1,) * (x.dim() - 2))
            return torch.where(mask, torch.zeros_like(x), x)

        hits = zero_on_delete(hits)
        age = zero_on_delete(age)
        tsu = zero_on_delete(tsu)
        label_count = zero_on_delete(label_count)
        label_conf = zero_on_delete(label_conf)
        pending_count = zero_on_delete(pending_count)
        gallery_count = zero_on_delete(table.gallery_count)
        blank_mean = torch.zeros_like(mean)
        blank_mean[..., 3] = 1.0
        mean = torch.where(delete[..., None], blank_mean, mean)
        cov = torch.where(delete[..., None, None],
                          torch.eye(8, dtype=cov.dtype, device=dev), cov)

        # ---- initiate new tracks (tracker.py:78-79,135-138) ----
        new_det = dets.valid & ~taken
        det_rank = torch.cumsum(new_det.to(i32), -1) - 1
        free = ~live
        slot_ids = torch.arange(T, dtype=i32, device=dev)
        free_order = stable_argsort(torch.where(free, slot_ids, T + slot_ids))
        n_free = free.to(i32).sum(-1)
        can_place = new_det & (det_rank < n_free[:, None])
        det_slot = torch.where(
            can_place, free_order.gather(1, det_rank.clamp(0, T - 1)), T)

        im, ic = kalman.initiate_v(det_xyah)
        # each stream's slots offset onto its rows of the (S * T) tables
        flat_slot = flat_rows(det_slot, T)

        def scat(arr, upd):
            return scatter_rows_unique(arr.flatten(0, 1), flat_slot,
                                       upd.flatten(0, 1)).view(arr.shape)

        mean = scat(mean, im)
        cov = scat(cov, ic)
        state = scat(state,
                     torch.full((S, D), TENTATIVE, dtype=i32, device=dev))
        track_id = scat(track_id, (table.next_id[:, None] + det_rank).to(i32))
        ones = torch.ones((S, D), dtype=i32, device=dev)
        hits = scat(hits, ones)
        age = scat(age, ones)
        tsu = scat(tsu, torch.zeros_like(ones))
        label_count = scat(label_count, _one_hot(dets.label, L, i32))
        label_conf = scat(label_conf,
                          _one_hot(dets.label, L, label_conf.dtype) *
                          dets.confidence[..., None])
        pend0 = torch.zeros((S, D, P, cfg.feature_dim), dtype=pending.dtype,
                            device=dev)
        pend0[:, :, 0, :] = feat_n
        pending = scat(pending, pend0)
        pending_count = scat(pending_count, ones)
        gallery_count = scat(gallery_count, torch.zeros_like(ones))
        next_id = table.next_id + can_place.to(i32).sum(-1)

        # ---- gallery partial_fit of confirmed tracks (tracker.py:83-93) --
        # feature k of slot t goes to ring position (gallery_count[t] + k) %
        # G when k < flush_n. Positions of one slot's flush are distinct
        # (P <= G), so one index_put writes them all; masked entries write
        # back their own current value, which drops them with no host sync.
        confirmed_now = state == CONFIRMED
        flush_n = torch.where(confirmed_now, pending_count, 0)
        pos = (gallery_count[..., None] + p_ids) % G               # (S, T, P)
        do = p_ids < flush_n[..., None]
        s_idx = torch.arange(S, device=dev)[:, None, None].expand(S, T, P)
        t_idx = torch.arange(T, device=dev)[:, None].expand(S, T, P)
        gallery = table.gallery
        pos_l = pos.long()
        vals = torch.where(do[..., None], pending,
                           gallery[s_idx, t_idx, pos_l])
        gallery.index_put_((s_idx, t_idx, pos_l), vals)
        gallery_count = gallery_count + flush_n
        pending_count = torch.where(confirmed_now, 0, pending_count)

        new_table = TrackTable(
            mean=mean, cov=cov, state=state, track_id=track_id, hits=hits,
            age=age, time_since_update=tsu, gallery=gallery,
            gallery_count=gallery_count, pending=pending,
            pending_count=pending_count, label_count=label_count,
            label_conf=label_conf, next_id=next_id)
        out = TrackStepOutput(
            track_id=track_id, state=state,
            tlwh=boxops.xyah_to_tlwh(mean[..., :4]), time_since_update=tsu,
            hits=hits, age=age, label_count=label_count, label_conf=label_conf,
            matched_det=matched, deleted_id=deleted_id,
            deleted_tlwh=deleted_tlwh, deleted_label_count=deleted_lc,
            deleted_label_conf=deleted_lf)
    return new_table, out
