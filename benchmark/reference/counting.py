"""Countline-crossing analytics over device track snapshots.

A copy of deepdish_tpu/pipeline/counting.py (host numpy code; the port
keeps its own copy), reading the port's TrackStepOutput tensors, which may
lie on the card. Host-side port of the counting logic in deepdish.py:1035-1139 and
check_deleted_track (:1303-1312), operating on the fixed-capacity
TrackStepOutput arrays the device step returns instead of Python Track
objects. Semantics preserved:

  * deleted tracks whose whole path intersects the countline bump
    `delcount[label]` and clear their path (:1040-1044, 1303-1312) —
    including the reference quirk that only the LAST deleted track of a
    frame actually contributes (its loop overwrites `delcounts`);
  * confirmed tracks with time_since_update <= 1 append their bottom-centre
    to the path db (:1053-1064);
  * a crossing between the last two path points bumps pos/neg via the sign
    of cross(q1-p1, q2-p2) (>= 0 is 'pos', :1071-1107) and intcount;
  * per-track labels come from the Dirichlet vote (track.get_label).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import tracker as tt

CONFIRMED = tt.CONFIRMED


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cross2(a, b) -> float:
    """2-D scalar cross product (np.cross on 2-vectors is deprecated)."""
    return float(a[0] * b[1] - a[1] * b[0])


def _intersect(p, pr, q, qs) -> bool:
    """Segment intersection (tools/intersection.py:4-24) in numpy."""
    r = pr - p
    s = qs - q
    rxs = cross2(r, s)
    qmp = q - p
    qpxr = cross2(qmp, r)
    eps = np.finfo(float).eps
    if abs(rxs) < eps:
        if abs(qpxr) < eps:
            rdrr = r / np.dot(r, r)
            t0 = np.dot(qmp, rdrr)
            t1 = t0 + np.dot(s, rdrr)
            if t0 > t1:
                t0, t1 = t1, t0
            return not (t1 < 0 or t0 > 1)
        return False
    t = cross2(qmp, s) / rxs
    u = qpxr / rxs
    return 0.0 <= t <= 1.0 and 0.0 <= u <= 1.0


def _any_intersection(p1, q1, pts) -> bool:
    for a, b in zip(pts, pts[1:]):
        if _intersect(p1, q1, np.asarray(a), np.asarray(b)):
            return True
    return False


@dataclass
class CrossingEvent:
    kind: str           # 'pos' | 'neg'
    label: str
    track_id: int
    path_tail: np.ndarray  # last two path points, flattened (4,)
    cp: float


@dataclass
class TrackView:
    """Per-frame view of one live track for rendering."""
    track_id: int
    tlbr: np.ndarray
    label: Optional[str]
    confidence: float
    path: Optional[np.ndarray]   # (K, 2) or None
    crossed: bool


class CountingState:
    """Counters + per-track path database (the reference's self.db)."""

    def __init__(self, wanted_labels: Sequence[str], countline: np.ndarray):
        self.wanted_labels = list(wanted_labels)
        self.countline = np.asarray(countline, float)
        self.db: Dict[int, List[np.ndarray]] = {}
        self.poscount = {l: 0 for l in self.wanted_labels}
        self.negcount = {l: 0 for l in self.wanted_labels}
        self.intcount = {l: 0 for l in self.wanted_labels}
        self.delcount = {l: 0 for l in self.wanted_labels}

    def counters_payload(self) -> Dict[str, int]:
        """poscount_/negcount_/diff_/intcount_/delcount_<label>
        (deepdish.py:1141-1145)."""
        payload = {}
        for lbl in self.wanted_labels:
            payload.update({
                'poscount_' + lbl: self.poscount[lbl],
                'negcount_' + lbl: self.negcount[lbl],
                'diff_' + lbl: self.poscount[lbl] - self.negcount[lbl],
                'intcount_' + lbl: self.intcount[lbl],
                'delcount_' + lbl: self.delcount[lbl],
            })
        return payload

    def restore(self, data: Dict):
        """--restore-from-log semantics (deepdish.py:546-558)."""
        for lbl in self.wanted_labels:
            self.poscount[lbl] = data.get('poscount_' + lbl, 0)
            self.negcount[lbl] = data.get('negcount_' + lbl, 0)
            self.delcount[lbl] = data.get('delcount_' + lbl, 0)
            self.intcount[lbl] = data.get('intcount_' + lbl, 0)

    def _label_of(self, counts, confs) -> Tuple[Optional[str], float]:
        res = tt.get_label(counts, confs, self.wanted_labels,
                           return_confidence=True)
        return res if res is not None else (None, 0.0)

    def process(self, out: tt.TrackStepOutput):
        """One frame. Returns (events, track_views)."""
        ids = _host(out.track_id)
        states = _host(out.state)
        tlwh = _host(out.tlwh)
        tsu = _host(out.time_since_update)
        lcnt = _host(out.label_count)
        lcnf = _host(out.label_conf)
        del_ids = _host(out.deleted_id)
        del_lcnt = _host(out.deleted_label_count)
        del_lcnf = _host(out.deleted_label_conf)

        p1, q1 = self.countline[0], self.countline[1]
        events: List[CrossingEvent] = []
        views: List[TrackView] = []

        # deleted tracks first (deepdish.py:1040-1044). The reference
        # OVERWRITES `delcounts` per deleted track in its loop, so only the
        # LAST deleted track of the frame contributes to delcount — faithful
        # replication here for strict count parity (the per-track paths are
        # still all cleared, :1303-1312).
        last_delcount = None
        for slot in np.where(del_ids >= 0)[0]:
            i = int(del_ids[slot])
            last_delcount = None
            if i in self.db and len(self.db[i]) > 1:
                if _any_intersection(p1, q1, self.db[i]):
                    lbl, _ = self._label_of(del_lcnt[slot], del_lcnf[slot])
                    if lbl is not None:
                        last_delcount = lbl
            self.db.pop(i, None)
        if last_delcount is not None:
            self.delcount[last_delcount] += 1

        # live confirmed tracks updated within the last frame
        for slot in range(len(ids)):
            if states[slot] == tt.EMPTY:
                continue
            i = int(ids[slot])
            lbl, conf = self._label_of(lcnt[slot], lcnf[slot])
            if states[slot] != CONFIRMED or tsu[slot] > 1:
                continue
            path = self.db.setdefault(i, [])
            x, y, w, h = tlwh[slot]
            tlbr = np.array([x, y, x + w, y + h])
            bottom_centre = np.array([(tlbr[0] + tlbr[2]) / 2.0, tlbr[3]])
            path.append(bottom_centre)
            crossed = False
            if len(path) > 1:
                p2 = np.array(path[-1])
                q2 = np.array(path[-2])
                cp = cross2(q1 - p1, q2 - p2)
                if _intersect(p1, q1, p2, q2):
                    crossed = True
                    kind = 'pos' if cp >= 0 else 'neg'
                    if lbl is not None:
                        if cp >= 0:
                            self.poscount[lbl] += 1
                        else:
                            self.negcount[lbl] += 1
                        self.intcount[lbl] += 1
                        events.append(CrossingEvent(
                            kind, lbl, i,
                            np.array(path[-2:]).reshape(-1), cp))
            views.append(TrackView(
                track_id=i, tlbr=tlbr, label=lbl, confidence=conf,
                path=np.array(path) if len(path) > 1 else None,
                crossed=crossed))
        return events, views
