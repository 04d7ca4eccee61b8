"""The per-frame detect -> embed -> track step and the chunked engine.

Port of deepdish_tpu/pipeline/framestep.py `FrameStep` (`_step` :256,
`_track_only` :263, `_detect_only` :272, `_encode_track` :282,
`_scripted_step` :295, `_run_chunk` :346, `_run_chunk_yuv` :373). One
`step` takes a uint8 RGB frame and the pipeline state through: MOG2
background subtraction (when configured), bilinear resize to the
detector's input (letterboxed for YOLOv3), the detector (SSD-MobileNetV1,
YOLOv5s, YOLOv3 or EfficientDet-Lite0) with its decode and NMS, the
wanted-label / NaN / clip / spurious-area / motion-ratio filters and the
pipeline's class-agnostic NMS, aspect-corrected crops, the MARS embedding,
and `tracker.step` (whose assignment solves run in the CUDA LSAP kernel on
the card).

Reference-fidelity notes (for crossing-count parity), as in the JAX
version:
  * boxes are clipped and truncated to integers like deepdish.py:950-951;
  * any NaN among a frame's candidate boxes drops all of that frame's
    detections (deepdish.py:947-949);
  * the motion-ratio filter accepts a box when the foreground-pixel count
    inside it reaches background_ratio * w * h (deepdish.py:957), from an
    integer integral image of the MOG2 mask.

`run_chunk` takes F frames: background subtraction steps through them in
order (its state is temporal; `_bgsub_frames`), the detector runs batched
over the frames, MARS over all F * E crops at once
(`_detect_encode_frames`), then the tracker steps through the frames in
order (`_track_frames`). The parallel engines (parallel/) call the three
pieces themselves, to batch detect + encode over several streams' frames;
`MultiStreamEngine` tracks its streams with `_track_streams`, one batched
`tracker.step` over all of a shard's streams a frame index.
`run_chunk_yuv` takes I420 frames and converts them on the device first. `detect_only` and `encode_track` split `step` in two for CVAT
mode, where the host merges annotations into the detections in between.

Each stage runs inside a profiler range opened by `device.span`
("framestep.upload", "framestep.bgsub", "framestep.resize",
"<family>.net", "<family>.decode_nms" (ssd, yolov5, yolov3, efficientdet;
Faster R-CNN's are "frcnn.trunk", "frcnn.rpn_nms", "frcnn.crop_block4",
"frcnn.second_nms"), "framestep.filter_nms", "framestep.crop_mars",
"framestep.tracker", around one `tracker.step` (`_track`): one stream's
frame, or in `_track_streams` one frame index of a shard's k streams), so
a profiler run splits a frame's time by stage;
without a profiler the ranges cost one flag check each and record nothing.
Nested in them:
  * in "framestep.tracker", the tracker's stages, which together cover
    `tracker.step`: "framestep.trk_predict" (Kalman predict and the cost
    matrices), "framestep.trk_cascade" (the matching cascade) holding one
    "framestep.trk_level" per cascade level solved (one LSAP launch each),
    "framestep.trk_iou" (the IoU stage) and "framestep.trk_update" (Kalman
    update, lifecycle, new tracks, the gallery);
  * at each host sync, "framestep.sync_<site>" (`device.sync_*`: "trk" in
    the tracker's stages, "nms" in the NMS ranges);
  * in a `parallel.MultiStreamEngine` call, "framestep.call" around the
    whole call and "framestep.yuv_rgb" around its I420 conversion.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as nnf

from .. import tracker as tt
from ..device import resolve_device, span
from ..models.preprocess import crop_resize_patches_mxu, resize_bilinear_mxu
from ..ops import bgsub
from ..ops import boxes as boxops
from ..ops import colorspace
from ..ops import nms as nmsops


class DetectionSnapshot(NamedTuple):
    """Post-NMS detections for rendering and logging (capacity D)."""
    tlwh: torch.Tensor
    label: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor


class PipelineState(NamedTuple):
    table: tt.TrackTable
    bg: Optional[bgsub.MOG2State] = None


class FrameStepConfig(NamedTuple):
    nms_max_overlap: float = 0.6        # --nms-max-overlap (deepdish.py:1420)
    spurious_area_frac: float = 0.9     # deepdish.py:952-955
    score_threshold: float = 0.5
    background_subtraction: bool = False
    background_ratio: float = 0.25      # --background-subtraction-ratio
    background_masking: bool = False    # --enable-background-masking
    # crop+embed only the first E post-NMS detections (0 = all D); the
    # rest keep zero features: IoU-matched, never appearance-matched
    encode_capacity: int = 0


def _stack(items):
    """A list of NamedTuples of tensors -> one NamedTuple of stacked
    tensors (leading axis = list order)."""
    return type(items[0])(*(torch.stack(x) for x in zip(*items)))


class FrameStep:
    """Binds detector + encoder + tracker (+ MOG2) on one device (default
    CUDA)."""

    def __init__(self, detector, encoder, tracker_cfg: tt.TrackerConfig,
                 wanted_labels: Sequence[str], frame_shape,
                 step_cfg: FrameStepConfig = FrameStepConfig(),
                 device=None):
        self.device = resolve_device(device)
        for part in (detector, encoder):
            # a host-scripted detector has no device
            dev = getattr(part, "device", None)
            if dev is not None and dev != self.device:
                raise ValueError(f"{type(part).__name__} is on {dev}, the "
                                 f"FrameStep on {self.device}")
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
        # YOLOv3's aspect-preserving resize onto a gray-128 canvas
        # (tools/yolo.py:141-151): (left, top, new_w, new_h), fixed for the
        # frame size; configuring it also sets the geometry the detector's
        # decode undoes
        self._letterbox = (
            detector.configure_letterbox(self.frame_w, self.frame_h)
            if getattr(detector, "letterbox", False) else None)

    # ---- pieces ----

    def _frames(self, frames) -> torch.Tensor:
        with span("framestep.upload"):
            t = torch.as_tensor(frames)
            return t.to(self.device, non_blocking=True)

    def _apply_bgsub(self, bg, frame):
        """One (H, W, 3) frame -> (new_bg, foreground-count integral image
        (H + 1, W + 1) or None, masked frame)."""
        cfg = self.step_cfg
        if not cfg.background_subtraction:
            return bg, None, frame
        with span("framestep.bgsub"):
            bg, mask = bgsub.update(bg, frame)
            fg = (mask != 0).to(torch.int32)
            # int32 cumsums give int64: exact counts at any frame size
            integral = nnf.pad(fg.cumsum(0).cumsum(1), (1, 0, 1, 0))
            if cfg.background_masking:
                frame = torch.where((mask != 0)[:, :, None], frame, 0)
        return bg, integral, frame

    def _motion_ok(self, integral, x, y, w, h):
        """Foreground count in [y, y+h) x [x, x+w) >= ratio * w * h, for
        (..., K) integer-valued boxes and an (..., H + 1, W + 1) integral
        image (corners truncated to int32, as the JAX version does)."""
        cols = integral.shape[-1]
        flat = integral.flatten(-2)
        xi = x.to(torch.int32)
        yi = y.to(torch.int32)
        x2 = xi + w.to(torch.int32)
        y2 = yi + h.to(torch.int32)

        def at(r, c):
            return flat.gather(-1, (r.long() * cols + c.long()))
        s = at(y2, x2) - at(yi, x2) - at(y2, xi) + at(yi, xi)
        return s >= self.step_cfg.background_ratio * w * h

    def _filter_and_nms(self, integral, xyxy, classes, scores, valid):
        """Box filters + pipeline NMS -> compacted DetectionSnapshot, for
        (..., K) detector outputs and a matching integral image or None."""
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
        if integral is not None:
            valid = valid & self._motion_ok(integral, x, y, w, h)

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

    def _postprocess_raw(self, frame, integral, xyxy, classes, scores,
                         valid):
        """One frame's tail after the detector: filters, NMS, crop+embed."""
        with span("framestep.filter_nms"):
            snap = self._filter_and_nms(integral, xyxy, classes, scores,
                                        valid)
        E = self._enc_cap
        with span("framestep.crop_mars"):
            feats_e, _ok = self.encoder.encode_boxes(frame, snap.tlwh[:E],
                                                     snap.valid[:E])
        dets = tt.Detections(tlwh=snap.tlwh, confidence=snap.score,
                             label=snap.label,
                             feature=self._pad_features(feats_e),
                             valid=snap.valid)
        return dets, snap

    def detector_input(self, frames: torch.Tensor) -> torch.Tensor:
        """(F, H, W, 3) uint8 frames -> the detector's float32 input
        (F, height, width, 3): a bilinear resize, or for a letterboxing
        detector an aspect-preserving resize padded with 128."""
        det = self.detector
        with span("framestep.resize"):
            if self._letterbox is None:
                return resize_bilinear_mxu(frames, det.height, det.width,
                                           det.compute_dtype)
            left, top, nw, nh = self._letterbox
            small = resize_bilinear_mxu(frames, nh, nw, det.compute_dtype)
            return nnf.pad(small, (0, 0, left, det.width - nw - left,
                                   top, det.height - nh - top), value=128.0)

    def _detect_raw(self, frames: torch.Tensor):
        """(F, H, W, 3) uint8 -> raw detector outputs stacked on F."""
        return self.detector.detect(self.detector_input(frames),
                                    float(self.frame_w), float(self.frame_h))

    def _detect_encode_frames(self, frames: torch.Tensor, integrals=None):
        """(F, H, W, 3) -> (Detections, DetectionSnapshot) stacked on F:
        detector and NMS batched over the frames, then one encoder forward
        over all F * E crops."""
        F = frames.shape[0]
        E = self._enc_cap
        raw = self._detect_raw(frames)
        with span("framestep.filter_nms"):
            snaps = self._filter_and_nms(integrals, *raw)
        with span("framestep.crop_mars"):
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

    def _track(self, state: PipelineState, bg, dets):
        """One `tracker.step` on one stream's table, or on a stack of
        streams' tables (`_track_streams`)."""
        with span("framestep.tracker"):
            table, out = tt.step(self.tracker_cfg, state.table, dets)
        return PipelineState(table, bg), out

    # ---- host API ----

    def init_state(self) -> PipelineState:
        bg = (bgsub.init_state(self.frame_h, self.frame_w, self.device)
              if self.step_cfg.background_subtraction else None)
        return PipelineState(tt.create_table(self.tracker_cfg, self.device),
                             bg)

    @torch.inference_mode()
    def step(self, state: PipelineState, frame_rgb):
        """One uint8 (H, W, 3) frame. Returns (state, TrackStepOutput,
        DetectionSnapshot, raw detector outputs)."""
        frame = self._frames(frame_rgb)
        bg, integral, frame = self._apply_bgsub(state.bg, frame)
        raw = tuple(r[0] for r in self._detect_raw(frame[None]))
        dets, snap = self._postprocess_raw(frame, integral, *raw)
        state, out = self._track(state, bg, dets)
        return state, out, snap, raw

    @torch.inference_mode()
    def step_skip(self, state: PipelineState, frame_rgb, raw):
        """Frame-skip step (--object-detector-skip-frames,
        deepdish.py:929-938): reuse the previous RAW detector output, re-run
        bgsub, the filters and crop+embed on the CURRENT frame, then track.
        Returns (state, TrackStepOutput, DetectionSnapshot)."""
        frame = self._frames(frame_rgb)
        bg, integral, frame = self._apply_bgsub(state.bg, frame)
        dets, snap = self._postprocess_raw(frame, integral, *raw)
        state, out = self._track(state, bg, dets)
        return state, out, snap

    @torch.inference_mode()
    def scripted_step(self, state: PipelineState, frame_rgb, xyxy, classes,
                      scores, valid):
        """Host-scripted detections (ScriptedDetector.detect_host, as
        (R, 4) xyxy, (R,) int32 classes, (R,) scores, (R,) bool valid)
        through the same bgsub, filters, NMS, crop+embed and tracker step
        the real detectors feed (deepdish.py:941-1033 with detect_image
        scripted). Returns (state, TrackStepOutput, DetectionSnapshot)."""
        frame = self._frames(frame_rgb)
        raw = tuple(self._frames(a) for a in (xyxy, classes, scores, valid))
        bg, integral, frame = self._apply_bgsub(state.bg, frame)
        dets, snap = self._postprocess_raw(frame, integral, *raw)
        state, out = self._track(state, bg, dets)
        return state, out, snap

    @torch.inference_mode()
    def detect_only(self, state: PipelineState, frame_rgb):
        """CVAT split mode, first half (the host must see the post-NMS
        detections before encoding, deepdish.py:995 -> 1001): bgsub, the
        detector, the filters and NMS on one frame. Returns (new MOG2 state
        or None, DetectionSnapshot)."""
        frame = self._frames(frame_rgb)
        bg, integral, frame = self._apply_bgsub(state.bg, frame)
        raw = tuple(r[0] for r in self._detect_raw(frame[None]))
        with span("framestep.filter_nms"):
            snap = self._filter_and_nms(integral, *raw)
        return bg, snap

    @torch.inference_mode()
    def encode_track(self, state: PipelineState, frame_rgb, tlwh, labels,
                     scores, valid):
        """CVAT split mode, second half: crop and embed the (annotation-
        merged) (D, 4) boxes on the current frame, all D of them (not the
        fused step's encode capacity), then track. Returns (state,
        TrackStepOutput, DetectionSnapshot, Detections)."""
        frame = self._frames(frame_rgb)
        tlwh, labels, scores, valid = (self._frames(a) for a in
                                       (tlwh, labels, scores, valid))
        with span("framestep.crop_mars"):
            feats, _ok = self.encoder.encode_boxes(frame, tlwh, valid)
        dets = tt.Detections(tlwh=tlwh, confidence=scores, label=labels,
                             feature=feats, valid=valid)
        state, out = self._track(state, state.bg, dets)
        snap = DetectionSnapshot(tlwh=tlwh, label=labels, score=scores,
                                 valid=valid)
        return state, out, snap, dets

    def _bgsub_frames(self, bg, frames: torch.Tensor):
        """The chunk's background-subtraction prelude over (F, H, W, 3)
        frames: the MOG2 state steps through them in order (it is
        temporal). Returns (new MOG2 state or None, integral images
        (F, H + 1, W + 1) or None, masked frames)."""
        if not self.step_cfg.background_subtraction:
            return bg, None, frames
        ints, masked = [], []
        for frame in frames:
            bg, integral, frame = self._apply_bgsub(bg, frame)
            ints.append(integral)
            masked.append(frame)
        return bg, torch.stack(ints), torch.stack(masked)

    def _track_frames(self, state: PipelineState, bg, dets):
        """The tracker over F frames' Detections (stacked on F), one frame
        after the other. Returns (state with MOG2 state `bg`, outputs
        stacked on F)."""
        outs = []
        for f in range(dets.valid.shape[0]):
            state, out = self._track(state, bg,
                                     tt.Detections(*(x[f] for x in dets)))
            outs.append(out)
        return state, _stack(outs)

    def _track_streams(self, states, bgs, dets):
        """The tracker over k streams' F frames' Detections (stacked
        (k, F, ...)): their k tables stacked into one, then one batched
        `tracker.step` a frame index over all k streams, the frames in
        order. Each stream's results are `_track_frames`' on it alone.
        Returns (k PipelineStates, each a slice of the stacked table with
        its MOG2 state from `bgs`, outputs stacked (k, F, ...))."""
        stacked = PipelineState(tt.TrackTable(
            *(torch.stack(x) for x in zip(*(st.table for st in states)))))
        outs = []
        for f in range(dets.valid.shape[1]):
            stacked, out = self._track(
                stacked, None, tt.Detections(*(x[:, f] for x in dets)))
            outs.append(out)
        tables = zip(*(x.unbind(0) for x in stacked.table))
        return ([PipelineState(tt.TrackTable(*t), bg)
                 for t, bg in zip(tables, bgs)],
                type(outs[0])(*(torch.stack(x, 1) for x in zip(*outs))))

    @torch.inference_mode()
    def run_chunk(self, state: PipelineState, frames_rgb):
        """F uint8 frames (F, H, W, 3). Returns (state, outputs stacked on
        F, snapshots stacked on F)."""
        frames = self._frames(frames_rgb)
        bg, integrals, frames = self._bgsub_frames(state.bg, frames)
        dets, snaps = self._detect_encode_frames(frames, integrals)
        state, outs = self._track_frames(state, bg, dets)
        return state, outs, snaps

    @torch.inference_mode()
    def run_chunk_yuv(self, state: PipelineState, yuv_frames):
        """F I420 frames (F, H*3/2, W) uint8: half the host-to-device bytes
        of RGB; converted to uint8 RGB on the device, so the frames that
        reach `run_chunk` are the ones the RGB transport would give it."""
        yuv = self._frames(yuv_frames)
        frames = colorspace.yuv420_to_rgb_u8(yuv, self.frame_h,
                                             self.frame_w)
        return self.run_chunk(state, frames)
