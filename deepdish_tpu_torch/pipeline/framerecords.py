"""CVAT annotation merge / tracking-eval subsystem (host side, numpy).

A copy of deepdish_tpu/pipeline/framerecords.py, which uses only
xml.etree and numpy; the port keeps its own copy so that it imports
nothing of the JAX package. It is the host-side re-design of
deepdish/framerecords.py:43-307 for the table-based tracker:

  * `process_boxes` (ref :63-122): per frame, pool human annotations with
    tentative detections — an annotation that overlaps a detection >= 0.9
    (overlap = intersection / smaller-area, ref :36-41) and agrees on label
    absorbs it; unmatched annotations are injected as synthetic detections
    (score 1.0); output order is [matched annotations, detections without
    annotation, annotations without detection].
  * track linkage: `link_frame` maps each track slot's matched detection
    index (from TrackStepOutput) back to this frame's records.
  * `tracking_overrides` (ref :130-184): a lost track whose consumed
    records name exactly one annotation track is force-updated from this
    frame's matching annotation record (tracker/overrides.py) and
    re-confirmed; duplicate tracker tracks tracing the same annotation keep
    only the one with the most recorded detections.
  * `xml_output` (ref :186-257): CVAT 1.1 annotations XML with 'manual'
    tracks for annotated ids and 'automatic' tracks (>= minimum_track_frames
    frames, majority label, final box outside=1) for new ones.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


def overlap_fraction(a_tlbr, b_tlbr) -> float:
    """Intersection area over the smaller box's area (ref :36-41)."""
    ax1, ay1, ax2, ay2 = a_tlbr
    bx1, by1, bx2, by2 = b_tlbr
    inter = max(0.0, min(ax2, bx2) - max(ax1, bx1)) * \
        max(0.0, min(ay2, by2) - max(ay1, by1))
    smaller = min(abs(ax2 - ax1) * abs(ay2 - ay1),
                  abs(bx2 - bx1) * abs(by2 - by1))
    return inter / smaller if smaller > 0 else 0.0


@dataclass
class Record:
    tlbr: np.ndarray
    label_id: Optional[int]
    score: float = 1.0
    order: Optional[int] = None
    # annotation fields (None for detector records)
    annotation_track_id: Optional[int] = None
    annotation_label: Optional[str] = None
    is_outside: bool = False
    is_occluded: bool = False
    is_keyframe: bool = True
    z_order: int = 0
    # tracking linkage
    tracker_id: Optional[int] = None

    @property
    def is_annotation(self) -> bool:
        return self.annotation_track_id is not None


class FrameRecords:
    def __init__(self, detector_id_to_labelname: Dict[int, str],
                 overlap_threshold: float = 0.9,
                 minimum_track_frames: int = 3):
        self.frames: Dict[int, List[Record]] = {}
        self.labels: Dict[str, Dict] = {}
        self.id_to_label = dict(detector_id_to_labelname)
        self.label_to_id = {v: k for k, v in self.id_to_label.items()}
        self.overlap_threshold = overlap_threshold
        self.minimum_track_frames = minimum_track_frames
        # per tracker-id: consumed records + annotation ids seen
        self._track_records: Dict[int, List[Record]] = {}

    # ---- annotation intake (ref deepdish.py:617-641 parse path) ----
    def add_annotation_label_info(self, annot_label: str,
                                  detector_id: Optional[int], color: str):
        self.labels[annot_label] = {'detector_id': detector_id,
                                    'color': color}

    def add_annotated_track(self, frame: int, annot_track_id: int,
                            lbl: str, tlbr, outside: bool, occluded: bool,
                            keyframe: bool, z_order: int):
        det_id = self.labels.get(lbl, {}).get('detector_id')
        rec = Record(tlbr=np.asarray(tlbr, float), label_id=det_id,
                     annotation_track_id=annot_track_id,
                     annotation_label=lbl, is_outside=outside,
                     is_occluded=occluded, is_keyframe=keyframe,
                     z_order=z_order)
        self.frames.setdefault(frame, []).append(rec)

    @classmethod
    def from_cvat_xml(cls, xml_path: str,
                      detector_id_to_labelname: Dict[int, str],
                      **kw) -> "FrameRecords":
        """Parse a CVAT annotations.xml (ref deepdish.py:617-641)."""
        fr = cls(detector_id_to_labelname, **kw)
        tree = ET.parse(xml_path)
        label_to_id = {v: k for k, v in detector_id_to_labelname.items()}
        for l in tree.getroot().findall('./meta/task/labels/label'):
            name = l.find('name').text
            color_el = l.find('color')
            fr.add_annotation_label_info(
                name, label_to_id.get(name),
                color_el.text if color_el is not None else '#000000')
        for t in tree.getroot().findall('./track'):
            lblname = t.get('label')
            track_id = int(t.get('id'))
            for b in t.findall('box'):
                pts = np.array([b.get('xtl'), b.get('ytl'),
                                b.get('xbr'), b.get('ybr')], dtype=float)
                fr.add_annotated_track(
                    int(b.get('frame')), track_id, lblname, pts,
                    b.get('outside') == '1', b.get('occluded') == '1',
                    b.get('keyframe') == '1', int(b.get('z_order') or 0))
        fr.meta = tree.getroot().find('./meta')
        return fr

    # ---- per-frame merge (ref :63-122) ----
    def process_boxes(self, frame: int, boxes_tlwh, labelnames, scores):
        tentatives: List[Record] = []
        for i, (tlwh, name, score) in enumerate(
                zip(boxes_tlwh, labelnames, scores)):
            tlwh = np.asarray(tlwh, float)
            tlbr = np.r_[tlwh[:2], tlwh[:2] + tlwh[2:]]
            tentatives.append(Record(tlbr=tlbr,
                                     label_id=self.label_to_id.get(name),
                                     score=float(score), order=i))
        existing = self.frames.get(frame, [])

        matched_annotations: List[Record] = []
        unmatched_annotations: List[Record] = []
        leftover_tentatives = list(tentatives)
        unhandled: List[Record] = []
        for rec in existing:
            if not rec.is_annotation:
                continue
            hit = None
            for ti, tent in enumerate(leftover_tentatives):
                if overlap_fraction(rec.tlbr, tent.tlbr) >= \
                        self.overlap_threshold and \
                        (rec.label_id == tent.label_id or
                         rec.label_id is None):
                    hit = ti
                    break
            if hit is not None:
                del leftover_tentatives[hit]
                matched_annotations.append(rec)
            elif rec.label_id is not None:
                unmatched_annotations.append(rec)
            else:
                unhandled.append(rec)

        result = (matched_annotations + leftover_tentatives +
                  unmatched_annotations)
        boxes_out, labels_out, scores_out = [], [], []
        for i, rec in enumerate(result):
            rec.order = i
            tlwh = np.r_[rec.tlbr[:2], rec.tlbr[2:] - rec.tlbr[:2]]
            boxes_out.append(tlwh)
            labels_out.append(self.id_to_label[rec.label_id])
            scores_out.append(rec.score)
        self.frames[frame] = result + unhandled
        return boxes_out, labels_out, scores_out

    # ---- track linkage (replaces ref :124-128) ----
    def link_frame(self, frame: int, track_ids, matched_det):
        """After a tracker step: record which track consumed which record.
        track_ids/matched_det: per-slot arrays from TrackStepOutput."""
        recs = self.frames.get(frame, [])
        for slot in range(len(track_ids)):
            d = int(matched_det[slot])
            if d < 0 or d >= len(recs):
                continue
            tid = int(track_ids[slot])
            recs[d].tracker_id = tid
            self._track_records.setdefault(tid, []).append(recs[d])

    def link_new_tracks(self, frame: int, track_ids, states, hits):
        """New tracks (hits == 1) consumed the record at their creation;
        the tracker assigns slots to unmatched detections in detection
        order, mirrored here by matching fresh track ids to unconsumed
        records in order."""
        recs = self.frames.get(frame, [])
        fresh = sorted(int(track_ids[s]) for s in range(len(track_ids))
                       if states[s] != 0 and int(hits[s]) == 1)
        unconsumed = [r for r in recs if r.tracker_id is None
                      and r.order is not None]
        for tid, rec in zip(fresh, unconsumed):
            rec.tracker_id = tid
            self._track_records.setdefault(tid, []).append(rec)

    # ---- lost-track resurrection + duplicate removal (ref :130-184) ----
    def tracking_overrides(self, frame: int, track_ids, states, tsus):
        """Returns (slot_det (T,) int32: detection index to force-update
        each slot with or -1, delete_mask (T,) bool)."""
        T = len(track_ids)
        slot_det = np.full((T,), -1, np.int32)
        recs = self.frames.get(frame, [])
        annot_db: Dict[int, List[Dict]] = {}
        for slot in range(T):
            if states[slot] == 0:
                continue
            tid = int(track_ids[slot])
            consumed = self._track_records.get(tid, [])
            annot_ids = {r.annotation_track_id for r in consumed
                         if r.is_annotation}
            if len(annot_ids) != 1:
                continue
            aid = annot_ids.pop()
            r = next((r for r in recs if r.is_annotation and
                      r.annotation_track_id == aid), None)
            if r is None:
                continue
            n_with_rec = len(consumed)
            annot_db.setdefault(aid, []).append(
                {'slot': slot, 'tracker_id': tid, 'n': n_with_rec})
            if tsus[slot] > 0 and r.order is not None:
                slot_det[slot] = r.order

        delete_mask = np.zeros((T,), bool)
        for aid, entries in annot_db.items():
            best = max(e['n'] for e in entries)
            for e in entries:
                if e['n'] < best:
                    delete_mask[e['slot']] = True
        return slot_det, delete_mask

    # ---- CVAT writer (ref :186-257) ----
    def xml_output(self, meta=None) -> ET.ElementTree:
        root = ET.Element('annotations')
        ET.SubElement(root, 'version').text = '1.1'
        if meta is None:
            meta = getattr(self, 'meta', None)
        if meta is not None:
            root.append(meta)

        annot_db: Dict[int, Dict[int, Record]] = {}
        new_db: Dict[int, Dict[int, Record]] = {}
        for frame, recs in self.frames.items():
            for rec in recs:
                if rec.is_annotation:
                    annot_db.setdefault(
                        rec.annotation_track_id, {})[frame] = rec
                elif rec.tracker_id is not None:
                    new_db.setdefault(rec.tracker_id, {})[frame] = rec

        max_id = 0
        for i, framedb in sorted(annot_db.items()):
            max_id = max(max_id, i)
            track = ET.SubElement(root, 'track',
                                  attrib={'id': str(i), 'source': 'manual'})
            label = None
            for frame, rec in sorted(framedb.items()):
                ET.SubElement(track, 'box', attrib={
                    'frame': str(frame),
                    'occluded': '1' if rec.is_occluded else '0',
                    'outside': '1' if rec.is_outside else '0',
                    'keyframe': '1' if rec.is_keyframe else '0',
                    'z_order': str(rec.z_order),
                    'xtl': str(rec.tlbr[0]), 'ytl': str(rec.tlbr[1]),
                    'xbr': str(rec.tlbr[2]), 'ybr': str(rec.tlbr[3])})
                label = (self.id_to_label.get(rec.label_id)
                         if rec.label_id is not None
                         else rec.annotation_label)
            track.set('label', label or '')

        next_id = max_id + 1
        for _, framedb in sorted(new_db.items()):
            if len(framedb) < self.minimum_track_frames:
                continue
            track = ET.SubElement(root, 'track', attrib={
                'id': str(next_id), 'source': 'automatic'})
            next_id += 1
            label_votes: Dict[int, int] = {}
            box = None
            for frame, rec in sorted(framedb.items()):
                label_votes[rec.label_id] = \
                    label_votes.get(rec.label_id, 0) + 1
                box = ET.SubElement(track, 'box', attrib={
                    'frame': str(frame), 'occluded': '0', 'outside': '0',
                    'keyframe': '1', 'z_order': '0',
                    'xtl': str(rec.tlbr[0]), 'ytl': str(rec.tlbr[1]),
                    'xbr': str(rec.tlbr[2]), 'ybr': str(rec.tlbr[3])})
            if box is not None:
                box.set('outside', '1')  # final box leaves the scene
            best = max(label_votes, key=label_votes.get)
            track.set('label', self.id_to_label[best])

        tree = ET.ElementTree(root)
        ET.indent(tree)
        return tree
