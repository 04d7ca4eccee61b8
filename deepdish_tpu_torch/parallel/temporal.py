"""Temporal sequence parallelism: one hot stream over several devices.

Port of deepdish_tpu/parallel/temporal.py. Stream parallelism
(parallel/multistream.py) scales aggregate throughput but never speeds up a
SINGLE stream. Within one stream's chunk of F frames, the per-frame detector
+ NMS + crop + appearance-encoder work has no temporal state, so it is
split over the mesh's frame axis: each of D devices runs detect + encode
for F/D contiguous frames. Only the compact detections and snapshots
(boxes, scores, labels, features: a few KB a frame, not the frames) are
then moved with `.to()` to the device that holds the track table and
concatenated in frame order; this replaces the JAX engine's `all_gather`.
The sequential tracker then runs over all F frames ONCE, on that device.
(The JAX engine runs the tracker scan replicated on every device only
because SPMD runs one program everywhere; the port keeps a single copy of
the table.)

Constraints, as in the JAX engine:
  * background subtraction must be off: the MOG2 state is a strict
    frame-to-frame recurrence over full-resolution pixel state, which
    would serialize the shards;
  * F must be a multiple of the mesh size.

Semantics are those of `FrameStep.run_chunk` on one device: the detector
and NMS are per frame, the MARS encoder has no cross-sample coupling, and
the tracker consumes the same detections in the same frame order.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import colorspace
from ..pipeline.framestep import FrameStep, PipelineState
from .multistream import Mesh, gather, make_mesh, on, replica


class TemporalChunkEngine:
    """Splits one stream's chunk over the mesh's frame axis."""

    def __init__(self, framestep: FrameStep, mesh: Optional[Mesh] = None,
                 axis_name: str = "frame"):
        if framestep.step_cfg.background_subtraction:
            raise ValueError(
                "temporal sequence parallelism requires background "
                "subtraction off: the MOG2 state is a frame-to-frame "
                "recurrence over full-resolution pixels, which would "
                "serialize the frame shards")
        self.fs = framestep
        self.mesh = mesh if mesh is not None else make_mesh(
            axis_name=axis_name)
        # Honor the caller's axis_name when it exists in a user-supplied
        # mesh; otherwise fall back to the mesh's first axis. Frames are
        # split along that one axis only; on a 2-D mesh the devices of the
        # other axes would merely repeat the work, so the first device of
        # each row along them takes the shard.
        if axis_name in self.mesh.axis_names:
            axis = axis_name
        else:
            axis = self.mesh.axis_names[0]
        self.n_devices = int(self.mesh.shape[axis])
        along = np.moveaxis(self.mesh.devices,
                            self.mesh.axis_names.index(axis), 0)
        devices = list(along.reshape(self.n_devices, -1)[:, 0])
        replicas = {}
        self._steps = [replicas.setdefault(d, replica(framestep, d))
                       for d in devices]

    def _check(self, n_frames: int):
        if n_frames % self.n_devices:
            raise ValueError(
                f"chunk length ({n_frames}) must be a multiple of the "
                f"mesh size ({self.n_devices})")

    @torch.inference_mode()
    def _run(self, state: PipelineState, frames, yuv: bool):
        self._check(frames.shape[0])
        m = frames.shape[0] // self.n_devices
        home = state.table.mean.device
        dets, snaps = [], []
        for d, fs in enumerate(self._steps):
            with on(fs.device):
                x = fs._frames(frames[d * m:(d + 1) * m])
                if yuv:
                    x = colorspace.yuv420_to_rgb_u8(x, fs.frame_h,
                                                    fs.frame_w)
                det, snap = fs._detect_encode_frames(x)
            dets.append(det)
            snaps.append(snap)
        with on(home):
            state, outs = self.fs._track_frames(state, state.bg,
                                                gather(dets, home))
        return state, outs, gather(snaps, home)

    def run_chunk(self, state: PipelineState, frames_rgb):
        """F frames (F, H, W, 3) uint8, F % n_devices == 0. Returns
        (state, outs, snaps) exactly like FrameStep.run_chunk."""
        return self._run(state, frames_rgb, False)

    def run_chunk_yuv(self, state: PipelineState, yuv_frames):
        """F planar I420 frames (F, H*3/2, W) uint8, converted to RGB on
        each shard's device."""
        return self._run(state, yuv_frames, True)
