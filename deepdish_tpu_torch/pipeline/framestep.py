"""The per-frame detect -> embed -> track step and the chunked engine.

Port of deepdish_tpu/pipeline/framestep.py `FrameStep` (`_step` :256,
`_run_chunk` :346) for the configuration without background subtraction.
One `step` takes a uint8 RGB frame and the pipeline state through: bilinear
resize to the detector's input, SSD-MobileNetV1, box decode and per-class
NMS, the wanted-label / NaN / clip / spurious-area filters and the
pipeline's class-agnostic NMS, aspect-corrected crops, the MARS embedding,
and `tracker.step` (whose assignment solves run in the CUDA LSAP kernel on
the card).

Reference-fidelity notes (for crossing-count parity), as in the JAX
version:
  * boxes are clipped and truncated to integers like deepdish.py:950-951;
  * any NaN among a frame's candidate boxes drops all of that frame's
    detections (deepdish.py:947-949).

`run_chunk` takes F frames: the detector runs batched over the frames, MARS
over all F * E crops at once, then the tracker steps through the frames in
order.

Each stage runs inside a `torch.profiler.record_function` range
("framestep.upload", "framestep.resize", "ssd.net", "ssd.decode_nms",
"framestep.filter_nms", "framestep.crop_mars", "framestep.tracker"), so a
profiler run splits a frame's time by stage; without a profiler the ranges
record nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .. import tracker as tt
from ..device import resolve_device
from ..models.preprocess import crop_resize_patches_mxu, resize_bilinear_mxu
from ..ops import boxes as boxops
from ..ops import nms as nmsops


class DetectionSnapshot(NamedTuple):
    """Post-NMS detections for rendering and logging (capacity D)."""
    tlwh: torch.Tensor
    label: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor


class PipelineState(NamedTuple):
    table: tt.TrackTable


class FrameStepConfig(NamedTuple):
    nms_max_overlap: float = 0.6        # --nms-max-overlap (deepdish.py:1420)
    spurious_area_frac: float = 0.9     # deepdish.py:952-955
    score_threshold: float = 0.5
    # crop+embed only the first E post-NMS detections (0 = all D); the
    # rest keep zero features: IoU-matched, never appearance-matched
    encode_capacity: int = 0


def _stack(items):
    """A list of NamedTuples of tensors -> one NamedTuple of stacked
    tensors (leading axis = list order)."""
    return type(items[0])(*(torch.stack(x) for x in zip(*items)))


class FrameStep:
    """Binds detector + encoder + tracker on one device (default CUDA)."""

    def __init__(self, detector, encoder, tracker_cfg: tt.TrackerConfig,
                 wanted_labels: Sequence[str], frame_shape,
                 step_cfg: FrameStepConfig = FrameStepConfig(),
                 device=None):
        self.device = resolve_device(device)
        for part in (detector, encoder):
            if part.device != self.device:
                raise ValueError(f"{type(part).__name__} is on "
                                 f"{part.device}, the FrameStep on "
                                 f"{self.device}")
        self.detector = detector
        self.encoder = encoder
        self.tracker_cfg = tracker_cfg
        self.wanted_labels = list(wanted_labels)
        self.step_cfg = step_cfg
        self.frame_h, self.frame_w = int(frame_shape[0]), int(frame_shape[1])

        # detector class -> wanted-vocabulary index or -1 (the adaptor's
        # `labels[i] in wanted_labels` filter, tools/ssd_mobilenet.py:208)
        lut = np.full((max(detector.labels) + 1,), -1, np.int32)
        for idx, name in detector.labels.items():
            if name in self.wanted_labels:
                lut[idx] = self.wanted_labels.index(name)
        self._label_lut = torch.from_numpy(lut).to(self.device)
        D = tracker_cfg.max_detections
        self._enc_cap = min(step_cfg.encode_capacity or D, D)

    # ---- pieces ----

    def _frames(self, frames) -> torch.Tensor:
        with record_function("framestep.upload"):
            t = torch.as_tensor(frames)
            return t.to(self.device, non_blocking=True)

    def _detect_raw(self, frames: torch.Tensor):
        """(F, H, W, 3) uint8 -> raw detector outputs stacked on F."""
        det = self.detector
        with record_function("framestep.resize"):
            resized = resize_bilinear_mxu(frames, det.height, det.width,
                                          det.compute_dtype)
        return det.detect(resized, float(self.frame_w), float(self.frame_h))

    def _filter_and_nms(self, xyxy, classes, scores, valid):
        """Box filters + pipeline NMS -> compacted DetectionSnapshot, for
        (..., K) detector outputs."""
        cfg = self.step_cfg
        H, W = self.frame_h, self.frame_w
        lut = self._label_lut
        vocab = lut[classes.long().clamp(0, lut.shape[0] - 1)]
        valid = valid & (vocab >= 0) & (scores >= cfg.score_threshold)

        raw_tlwh = boxops.xyxy_to_tlwh(xyxy)
        # the reference NaN guard: any NaN candidate drops them all
        any_nan = (valid[..., None] & ~torch.isfinite(raw_tlwh)).flatten(
            -2).any(-1)
        valid = valid & ~any_nan[..., None]

        # int(np.clip(...)) truncation (deepdish.py:950-951)
        x = torch.floor(torch.clamp(raw_tlwh[..., 0], 0, W))
        y = torch.floor(torch.clamp(raw_tlwh[..., 1], 0, H))
        w = torch.floor(torch.minimum(torch.clamp(raw_tlwh[..., 2], min=0),
                                      W - x))
        h = torch.floor(torch.minimum(torch.clamp(raw_tlwh[..., 3], min=0),
                                      H - y))
        tlwh = torch.stack([x, y, w, h], dim=-1)
        valid = valid & (w * h <= cfg.spurious_area_frac * (W * H))
        valid = valid & (w * h > 0)

        # the pipeline's class-agnostic NMS (deepdish.py:995)
        order, _keep = nmsops.nms_tlwh(tlwh, scores, valid,
                                       cfg.nms_max_overlap)
        sel = order[..., :self.tracker_cfg.max_detections].long()
        ok = sel >= 0
        sel = sel.clamp(0, tlwh.shape[-2] - 1)
        return DetectionSnapshot(
            tlwh=torch.where(
                ok[..., None],
                tlwh.gather(-2, sel[..., None].expand(sel.shape + (4,))),
                0.0),
            label=torch.where(ok, vocab.gather(-1, sel), 0),
            score=torch.where(ok, scores.gather(-1, sel), 0.0), valid=ok)

    def _pad_features(self, feats_e: torch.Tensor) -> torch.Tensor:
        """(..., E, F) encoder output -> (..., D, F): slots past the encode
        capacity carry zero features."""
        D = self.tracker_cfg.max_detections
        E = feats_e.shape[-2]
        if E == D:
            return feats_e
        pad = feats_e.new_zeros(feats_e.shape[:-2] + (D - E,
                                                      feats_e.shape[-1]))
        return torch.cat([feats_e, pad], dim=-2)

    def _postprocess_raw(self, frame, xyxy, classes, scores, valid):
        """One frame's tail after the detector: filters, NMS, crop+embed."""
        with record_function("framestep.filter_nms"):
            snap = self._filter_and_nms(xyxy, classes, scores, valid)
        E = self._enc_cap
        with record_function("framestep.crop_mars"):
            feats_e, _ok = self.encoder.encode_boxes(frame, snap.tlwh[:E],
                                                     snap.valid[:E])
        dets = tt.Detections(tlwh=snap.tlwh, confidence=snap.score,
                             label=snap.label,
                             feature=self._pad_features(feats_e),
                             valid=snap.valid)
        return dets, snap

    def _detect_encode_frames(self, frames: torch.Tensor):
        """(F, H, W, 3) -> (Detections, DetectionSnapshot) stacked on F:
        detector and NMS batched over the frames, then one encoder forward
        over all F * E crops."""
        F = frames.shape[0]
        E = self._enc_cap
        raw = self._detect_raw(frames)
        with record_function("framestep.filter_nms"):
            snaps = self._filter_and_nms(*raw)
        with record_function("framestep.crop_mars"):
            patches, ok = crop_resize_patches_mxu(
                frames, snaps.tlwh[:, :E], snaps.valid[:, :E],
                self.encoder.height, self.encoder.width,
                self.encoder.compute_dtype)
            flat = patches.reshape((F * E,) + patches.shape[2:])
            feats = self.encoder.apply(flat)
            feats = torch.where(ok.reshape(F * E)[:, None], feats,
                                torch.zeros_like(feats)).reshape(F, E, -1)
        dets = tt.Detections(tlwh=snaps.tlwh, confidence=snaps.score,
                             label=snaps.label,
                             feature=self._pad_features(feats),
                             valid=snaps.valid)
        return dets, snaps

    # ---- host API ----

    def init_state(self) -> PipelineState:
        return PipelineState(tt.create_table(self.tracker_cfg, self.device))

    @torch.inference_mode()
    def step(self, state: PipelineState, frame_rgb):
        """One uint8 (H, W, 3) frame. Returns (state, TrackStepOutput,
        DetectionSnapshot, raw detector outputs)."""
        frame = self._frames(frame_rgb)
        raw = tuple(r[0] for r in self._detect_raw(frame[None]))
        dets, snap = self._postprocess_raw(frame, *raw)
        with record_function("framestep.tracker"):
            table, out = tt.step(self.tracker_cfg, state.table, dets)
        return PipelineState(table), out, snap, raw

    @torch.inference_mode()
    def run_chunk(self, state: PipelineState, frames_rgb):
        """F uint8 frames (F, H, W, 3). Returns (state, outputs stacked on
        F, snapshots stacked on F)."""
        frames = self._frames(frames_rgb)
        dets, snaps = self._detect_encode_frames(frames)
        table = state.table
        outs = []
        for f in range(frames.shape[0]):
            with record_function("framestep.tracker"):
                table, out = tt.step(self.tracker_cfg, table,
                                     tt.Detections(*(x[f] for x in dets)))
            outs.append(out)
        return PipelineState(table), _stack(outs), snaps
