"""The per-frame detect -> embed -> track step and the chunked engine.

Port of deepdish_tpu/pipeline/framestep.py `FrameStep` (`_step` :256,
`_track_only` :263, `_scripted_step` :295, `_run_chunk` :346,
`_run_chunk_yuv` :373). One `step` takes a uint8 RGB frame and the pipeline
state through: MOG2 background subtraction (when configured), bilinear
resize to the detector's input, SSD-MobileNetV1, box decode and per-class
NMS, the wanted-label / NaN / clip / spurious-area / motion-ratio filters and
the pipeline's class-agnostic NMS, aspect-corrected crops, the MARS
embedding, and `tracker.step` (whose assignment solves run in the CUDA LSAP
kernel on the card).

Reference-fidelity notes (for crossing-count parity), as in the JAX
version:
  * boxes are clipped and truncated to integers like deepdish.py:950-951;
  * any NaN among a frame's candidate boxes drops all of that frame's
    detections (deepdish.py:947-949);
  * the motion-ratio filter accepts a box when the foreground-pixel count
    inside it reaches background_ratio * w * h (deepdish.py:957), from an
    integer integral image of the MOG2 mask.

`run_chunk` takes F frames: background subtraction steps through them in
order (its state is temporal), the detector runs batched over the frames,
MARS over all F * E crops at once, then the tracker steps through the frames
in order. `run_chunk_yuv` takes I420 frames and converts them on the device
first.

Each stage runs inside a `torch.profiler.record_function` range
("framestep.upload", "framestep.bgsub", "framestep.resize", "ssd.net",
"ssd.decode_nms", "framestep.filter_nms", "framestep.crop_mars",
"framestep.tracker"), so a profiler run splits a frame's time by stage;
without a profiler the ranges record nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as nnf
from torch.profiler import record_function

from .. import tracker as tt
from ..device import resolve_device
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

    # ---- pieces ----

    def _frames(self, frames) -> torch.Tensor:
        with record_function("framestep.upload"):
            t = torch.as_tensor(frames)
            return t.to(self.device, non_blocking=True)

    def _apply_bgsub(self, bg, frame):
        """One (H, W, 3) frame -> (new_bg, foreground-count integral image
        (H + 1, W + 1) or None, masked frame)."""
        cfg = self.step_cfg
        if not cfg.background_subtraction:
            return bg, None, frame
        with record_function("framestep.bgsub"):
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
        with record_function("framestep.filter_nms"):
            snap = self._filter_and_nms(integral, xyxy, classes, scores,
                                        valid)
        E = self._enc_cap
        with record_function("framestep.crop_mars"):
            feats_e, _ok = self.encoder.encode_boxes(frame, snap.tlwh[:E],
                                                     snap.valid[:E])
        dets = tt.Detections(tlwh=snap.tlwh, confidence=snap.score,
                             label=snap.label,
                             feature=self._pad_features(feats_e),
                             valid=snap.valid)
        return dets, snap

    def _detect_raw(self, frames: torch.Tensor):
        """(F, H, W, 3) uint8 -> raw detector outputs stacked on F."""
        det = self.detector
        with record_function("framestep.resize"):
            resized = resize_bilinear_mxu(frames, det.height, det.width,
                                          det.compute_dtype)
        return det.detect(resized, float(self.frame_w), float(self.frame_h))

    def _detect_encode_frames(self, frames: torch.Tensor, integrals=None):
        """(F, H, W, 3) -> (Detections, DetectionSnapshot) stacked on F:
        detector and NMS batched over the frames, then one encoder forward
        over all F * E crops."""
        F = frames.shape[0]
        E = self._enc_cap
        raw = self._detect_raw(frames)
        with record_function("framestep.filter_nms"):
            snaps = self._filter_and_nms(integrals, *raw)
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

    def _track(self, state: PipelineState, bg, dets):
        with record_function("framestep.tracker"):
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
    def run_chunk(self, state: PipelineState, frames_rgb):
        """F uint8 frames (F, H, W, 3). Returns (state, outputs stacked on
        F, snapshots stacked on F)."""
        frames = self._frames(frames_rgb)
        bg, integrals = state.bg, None
        if self.step_cfg.background_subtraction:
            # the MOG2 state is temporal: one frame after the other
            ints, masked = [], []
            for frame in frames:
                bg, integral, frame = self._apply_bgsub(bg, frame)
                ints.append(integral)
                masked.append(frame)
            integrals, frames = torch.stack(ints), torch.stack(masked)
        dets, snaps = self._detect_encode_frames(frames, integrals)
        outs = []
        for f in range(frames.shape[0]):
            state, out = self._track(state, bg,
                                     tt.Detections(*(x[f] for x in dets)))
            outs.append(out)
        return state, _stack(outs), snaps

    @torch.inference_mode()
    def run_chunk_yuv(self, state: PipelineState, yuv_frames):
        """F I420 frames (F, H*3/2, W) uint8: half the host-to-device bytes
        of RGB; converted to uint8 RGB on the device, so the frames that
        reach `run_chunk` are the ones the RGB transport would give it."""
        yuv = self._frames(yuv_frames)
        frames = colorspace.yuv420_to_rgb_u8(yuv, self.frame_h,
                                             self.frame_w)
        return self.run_chunk(state, frames)
