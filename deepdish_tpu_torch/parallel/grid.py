"""2-D grid parallelism: stream parallelism x temporal parallelism.

Port of deepdish_tpu/parallel/grid.py. Composes the two 1-D engines
(parallel/multistream.py, parallel/temporal.py) over a 2-D `Mesh` with axes
(stream, frame): mesh row g owns S/ds streams, and the F frames of each of
its streams' chunk are split over the row's dt devices, F/dt each. The
per-frame detector + NMS + crop + appearance-encoder work (the FLOPs bulk,
no temporal state) runs on every device of the grid; then the compact
post-NMS detections (a few KB a frame, never pixels) of a row move with
`.to()` to the row's first device, concatenated in frame order, and each
stream's tracker runs there. Nothing crosses between rows: trackers are
independent.

When to choose which engine (each gives, per stream, what
`FrameStep.run_chunk` gives):
  * many streams, throughput       -> MultiStreamEngine (1-D, no moves)
  * ONE hot stream, latency        -> TemporalChunkEngine (1-D, gather)
  * several hot streams on a slice -> GridEngine (this module): e.g. 4
    streams on 16 devices = a (4, 4) mesh gives each stream 4-way frame
    parallelism, where pure stream parallelism would leave 12 devices idle
    and pure temporal parallelism would serialize the streams.

Same constraint as the temporal engine: background subtraction must be
off (the MOG2 state is a strict frame-to-frame recurrence over full-
resolution pixel state, which would serialize the frame shards).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import colorspace
from ..pipeline.framestep import FrameStep, PipelineState
from .multistream import (Mesh, StreamStates, gather, mesh_devices, on,
                          replica, split)


def make_grid_mesh(n_stream_shards: int, n_frame_shards: int,
                   stream_axis: str = "stream",
                   frame_axis: str = "frame", device=None) -> Mesh:
    """A (stream, frame) 2-D mesh over the first ds*dt cards, or over ds*dt
    copies of `device` when one is given."""
    n = n_stream_shards * n_frame_shards
    devs = mesh_devices(n, device, f"a ({n_stream_shards}, "
                                   f"{n_frame_shards}) grid")
    grid = [devs[i * n_frame_shards:(i + 1) * n_frame_shards]
            for i in range(n_stream_shards)]
    return Mesh(grid, (stream_axis, frame_axis))


class GridEngine:
    """S streams, F frames/stream/chunk, split over (stream, frame)."""

    def __init__(self, framestep: FrameStep, n_streams: int,
                 mesh: Optional[Mesh] = None,
                 stream_axis: str = "stream", frame_axis: str = "frame"):
        if framestep.step_cfg.background_subtraction:
            raise ValueError(
                "grid parallelism requires background subtraction off: "
                "the MOG2 state is a frame-to-frame recurrence over full-"
                "resolution pixels, which would serialize the frame shards")
        self.fs = framestep
        self.n_streams = n_streams
        if mesh is None:
            n = len(mesh_devices(None, None, "a grid"))
            mesh = make_grid_mesh(max(n // 2, 1), min(2, n),
                                  stream_axis, frame_axis)
        for ax in (stream_axis, frame_axis):
            if ax not in mesh.axis_names:
                raise ValueError(f"mesh is missing the '{ax}' axis "
                                 f"(has {mesh.axis_names})")
        self.mesh = mesh
        self.stream_axis, self.frame_axis = stream_axis, frame_axis
        self.ds = int(mesh.shape[stream_axis])
        self.dt = int(mesh.shape[frame_axis])
        if n_streams % self.ds:
            raise ValueError(f"n_streams ({n_streams}) must be a multiple "
                             f"of the stream-axis size ({self.ds})")
        self.per_row = n_streams // self.ds
        grid = mesh.devices.transpose(
            [mesh.axis_names.index(stream_axis),
             mesh.axis_names.index(frame_axis)]).reshape(self.ds, self.dt)
        replicas = {}
        self._rows = [[replicas.setdefault(d, replica(framestep, d))
                       for d in row] for row in grid]
        # stacked outputs of all rows land on the first row's home device
        self.out_device = self._rows[0][0].device

    def init_states(self) -> StreamStates:
        """S fresh pipeline states (bg is None: bgsub is rejected in
        __init__), row g's on the row's first device."""
        streams = []
        for row in self._rows:
            with on(row[0].device):
                streams += [row[0].init_state()
                            for _ in range(self.per_row)]
        return StreamStates(tuple(streams))

    def _check(self, frames, ndim_frame):
        if frames.ndim != ndim_frame:
            raise ValueError(f"expected {ndim_frame}-D (S, F, ...) input, "
                             f"got shape {tuple(frames.shape)}")
        S, F = frames.shape[:2]
        if S != self.n_streams:
            raise ValueError(f"got {S} streams, engine built for "
                             f"{self.n_streams}")
        if F % self.dt:
            raise ValueError(f"chunk length ({F}) must be a multiple of "
                             f"the frame-axis size ({self.dt})")

    @torch.inference_mode()
    def _run(self, states: StreamStates, frames, yuv: bool):
        k, m = self.per_row, frames.shape[1] // self.dt
        new, outs, snaps = [], [], []
        for g, row in enumerate(self._rows):
            home = row[0].device
            lo = g * k
            dets, row_snaps = [], []
            for j, fs in enumerate(row):
                with on(fs.device):
                    # the row's k streams' frames [j*m, (j+1)*m) in one
                    # forward, stream-major
                    x = fs._frames(frames[lo:lo + k, j * m:(j + 1) * m])
                    if yuv:
                        x = colorspace.yuv420_to_rgb_u8(x, fs.frame_h,
                                                        fs.frame_w)
                    det, snap = fs._detect_encode_frames(x.flatten(0, 1))
                dets.append(split(det, k))
                row_snaps.append(split(snap, k))
            with on(home):
                for i in range(k):
                    st = states.streams[lo + i]
                    st, out = self.fs._track_frames(
                        st, st.bg, gather([d[i] for d in dets], home))
                    new.append(st)
                    outs.append(out)
                    snaps.append(gather([s[i] for s in row_snaps], home))
        return (StreamStates(tuple(new)),
                _stack_on(outs, self.out_device),
                _stack_on(snaps, self.out_device))

    def run_chunk(self, states: StreamStates, frames_rgb):
        """frames (S, F, H, W, 3) uint8 -> (states, outs, snaps) with outs
        stacked (S, F, ...), per stream identical to FrameStep.run_chunk."""
        self._check(frames_rgb, 5)
        return self._run(states, frames_rgb, False)

    def run_chunk_yuv(self, states: StreamStates, yuv_frames):
        """frames (S, F, H*3/2, W) planar I420 uint8; converted to RGB on
        each device."""
        self._check(yuv_frames, 4)
        return self._run(states, yuv_frames, True)


def _stack_on(items, dev: torch.device):
    """Per-stream NamedTuples of (F, ...) tensors -> one of (S, F, ...) on
    `dev`."""
    return type(items[0])(*(torch.stack([t.to(dev) for t in ts])
                            for ts in zip(*items)))
