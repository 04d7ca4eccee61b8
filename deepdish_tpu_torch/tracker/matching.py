"""Masked matching stages: the appearance cascade and the IoU association.

Port of deepdish_tpu/tracker/matching.py (`masked_min_cost_matching` :46,
`matching_cascade` :105, `iou_stage` :163). Each stage gathers a submatrix
of the frame's (T, D) cost matrix into a square capacity-K problem, ordered
the way the reference orders its index lists (so the assignment's tie rules
see the same problem), solves it with `ops.assignment.solve_lsap` (the CUDA
kernel on the card), and scatters accepted matches back to slot space.

Every stage works on S streams' tables at once, (S, T, D) costs and (S, T)
/ (S, D) masks, as the JAX package's `vmap` over streams does: one LSAP
launch solves the S problems of a stage (B = S), and a stream with nothing
to match at a level poses an empty problem (no rows or no columns), which
matches nothing. So each stream's result is the one it gets alone.

The JAX package's `while_loop` over cascade levels and its `lax.cond`
around the IoU stage become Python control flow here; each of their
decisions is one counted host sync (device.sync_*, site "trk") over all
S streams. Each cascade level solved runs in the profiler range
"framestep.trk_level", which holds its one LSAP launch.
"""
from __future__ import annotations

import torch

from .. import device as devmod
from ..ops.assignment import solve_lsap
from ..ops.onehot import (flat_rows, gather_rows, scatter_rows_unique,
                          sort_values, stable_argsort)
from .types import CONFIRMED, TENTATIVE, TrackerConfig

_BIGKEY = 2 ** 30
_PAD_COST = 7e7


def masked_min_cost_matching(cost_full: torch.Tensor,
                             row_mask: torch.Tensor,
                             row_key: torch.Tensor,
                             col_mask: torch.Tensor,
                             max_distance: float,
                             K: int):
    """One min_cost_matching (linear_assignment.py:11-75) a stream over the
    masked rows/cols of S streams' (S, T, D) cost matrices, solved in one
    LSAP launch. Rows are ordered by row_key, columns by ascending
    detection index. Returns (matched col per row slot (S, T) int32,
    matched per col (S, D) bool)."""
    S, T, D = cost_full.shape
    dev = cost_full.device
    n_rows = row_mask.sum(-1).to(torch.int32)
    n_cols = col_mask.sum(-1).to(torch.int32)

    d_ids = torch.arange(D, dtype=torch.int32, device=dev)
    row_perm = stable_argsort(torch.where(row_mask, row_key, _BIGKEY))
    col_perm = stable_argsort(torch.where(col_mask, d_ids, _BIGKEY))
    rp = (torch.cat([row_perm, row_perm.new_zeros(S, K - T)], -1) if K > T
          else row_perm[:, :K])
    cp = (torch.cat([col_perm, col_perm.new_zeros(S, K - D)], -1) if K > D
          else col_perm[:, :K])
    sub = gather_rows(cost_full, rp).gather(2, cp[:, None, :].expand(S, K, K))
    # the reference's clamp before solving (linear_assignment.py:57)
    sub = torch.where(sub > max_distance,
                      torch.full_like(sub, max_distance + 1e-5), sub)
    ri = torch.arange(K, dtype=torch.int32, device=dev)
    real = ((ri[:, None] < n_rows[:, None, None]) &
            (ri[None, :] < n_cols[:, None, None]))
    sub = torch.where(real, sub, torch.full_like(sub, _PAD_COST))

    # sizes stay on the device: the kernel reads them there, no host sync
    sizes = torch.stack([n_rows, n_cols], -1)
    col4row = solve_lsap(sub.contiguous(), sizes).long()         # (S, K)

    # accept matches with cost <= max_distance (linear_assignment.py:70-74)
    got_col = col4row >= 0
    c4r = col4row.clamp(0, K - 1)
    sub_cost = sub.gather(2, c4r[..., None])[..., 0]
    accept = got_col & (ri < n_rows[:, None]) & (sub_cost <= max_distance)
    det_idx = cp.gather(1, c4r).to(torch.int32)

    scatter_slot = torch.where(accept, rp, T)
    matched_col = scatter_rows_unique(
        torch.full((S * T,), -1, dtype=torch.int32, device=dev),
        flat_rows(scatter_slot, T), det_idx.reshape(-1)).view(S, T)
    col_scatter = torch.where(accept, det_idx.long(), D)
    col_matched = (col_scatter[:, :, None] == d_ids).any(1)
    return matched_col, col_matched


def matching_cascade(cfg: TrackerConfig, app_cost: torch.Tensor,
                     state: torch.Tensor, track_id: torch.Tensor,
                     time_since_update: torch.Tensor,
                     det_valid: torch.Tensor):
    """Age-levelled appearance cascade (linear_assignment.py:78-141) over
    each stream's distinct time_since_update values of confirmed tracks,
    ascending and capped at max_age. Level i solves every stream's i-th
    level at once, for as many levels as the stream with the most has (a
    stream with fewer poses no rows there); stops early once no stream has
    both a level left and a detection unmatched. Takes (S, T, D) costs,
    (S, T) track fields and (S, D) validity; returns (matched_det (S, T)
    int32, det_taken (S, D) bool).

    A level none of whose tracks has a valid detection within
    max_cosine_distance is left out: every cost of its problem is clamped
    above the distance, so it would accept no match (the reference solves
    it for nothing). Levels kept are solved with all of their tracks."""
    S, T, D = app_cost.shape
    K = max(T, D)
    dev = app_cost.device
    confirmed = state == CONFIRMED
    big = 1 << 30
    reach = ((app_cost <= cfg.max_cosine_distance) &
             det_valid[:, None, :]).any(-1)
    eligible = torch.where(
        confirmed & reach & (time_since_update <= cfg.max_age),
        time_since_update, big)
    sorted_tsu = sort_values(eligible)
    prev = torch.cat([sorted_tsu.new_full((S, 1), -1), sorted_tsu[:, :-1]],
                     -1)
    distinct = torch.where((sorted_tsu != prev) & (sorted_tsu < big),
                           sorted_tsu, big)
    levels = sort_values(distinct)                    # (S, T), big-padded
    n_levels = devmod.sync_int((levels < big).sum(-1).max(), "trk")

    matched = torch.full((S, T), -1, dtype=torch.int32, device=dev)
    taken = torch.zeros((S, D), dtype=torch.bool, device=dev)
    for lv_i in range(n_levels):
        if not devmod.sync_bool(((det_valid & ~taken).any(-1) &
                                 (levels[:, lv_i] < big)).any(), "trk"):
            break
        with devmod.span("framestep.trk_level"):
            row_mask = confirmed & (time_since_update ==
                                    levels[:, lv_i, None])
            mc, cm = masked_min_cost_matching(
                app_cost, row_mask, track_id, det_valid & ~taken,
                cfg.max_cosine_distance, K)
            matched = torch.where(mc >= 0, mc, matched)
            taken = taken | cm
    return matched, taken


def iou_stage(cfg: TrackerConfig, iou_cost: torch.Tensor,
              state: torch.Tensor, track_id: torch.Tensor,
              time_since_update: torch.Tensor,
              cascade_matched: torch.Tensor, det_valid: torch.Tensor,
              det_taken: torch.Tensor):
    """IoU association of unconfirmed and just-missed confirmed tracks
    (tracker.py:119-129), over S streams as `matching_cascade`; solved
    when any stream has both rows and columns. Returns (matched_det
    (S, T), det_taken (S, D))."""
    S, T, D = iou_cost.shape
    K = max(T, D)
    confirmed = state == CONFIRMED
    tentative = state == TENTATIVE
    unmatched_conf = confirmed & (cascade_matched < 0)
    row_mask = tentative | (unmatched_conf & (time_since_update == 1))
    # reference order: unconfirmed first (creation order), then the
    # unmatched confirmed tsu == 1 ones (ascending)
    row_key = torch.where(tentative, track_id, track_id + _BIGKEY // 2)
    col_mask = det_valid & ~det_taken
    if not devmod.sync_bool((row_mask.any(-1) & col_mask.any(-1)).any(),
                            "trk"):
        return cascade_matched, det_taken
    mc, cm = masked_min_cost_matching(iou_cost, row_mask, row_key, col_mask,
                                      cfg.max_iou_distance, K)
    return torch.where(mc >= 0, mc, cascade_matched), det_taken | cm
