"""Multi-stream data parallelism over a mesh of torch devices.

Port of deepdish_tpu/parallel/multistream.py. The reference is strictly
single-stream (SURVEY.md §2.2); the scale-out story (BASELINE.json config
5: "16 concurrent 720p videos") is a batch of streams. Each device of a 1-D
`Mesh` owns S/D streams: their pipeline states live on it and their frames
go to it. Trackers are independent per stream, so no data crosses between
devices apart from the stacked outputs.

The JAX engine `vmap`s `FrameStep._step` / `_run_chunk` over the stream
axis inside a `shard_map`. Here a call runs, on each device:
  * each stream's background-subtraction prelude, in frame order (the MOG2
    state is temporal), when the FrameStep has it on;
  * ONE detect + encode forward over all of the device's S/D * F frames
    (`FrameStep._detect_encode_frames`);
  * the tracker over the device's S/D streams at once
    (`FrameStep._track_streams`): their tables stacked, then one batched
    `tracker.step` a frame index, F in a row, as the JAX engine's `vmap`
    does; each cascade level and the IoU stage solve all S/D streams'
    problems in one LSAP launch (B = S/D).
The results per stream are those of `FrameStep.run_chunk` on that stream
alone; each stream's state comes back as its slice of the stacked table.
A call of `MultiStreamEngine` runs in the profiler range "framestep.call",
its I420 conversion in "framestep.yuv_rgb" (`device.span`).

A mesh may name one device several times (several shards on one card).
Where it names a device other than the FrameStep's, the engine works on a
copy of the FrameStep whose weights and tensors were moved there (weights
replicated, as in the JAX engine).
"""
from __future__ import annotations

import contextlib
import copy
import types
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device, span
from ..ops import colorspace
from ..pipeline.framestep import FrameStep, PipelineState


class Mesh:
    """An n-D grid of torch devices with one name per axis, the port's
    stand-in for `jax.sharding.Mesh`: `devices` is a numpy object array of
    `torch.device`, `axis_names` a tuple and `shape` maps each axis name to
    its size. A device may appear more than once."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        self.devices = np.empty(src.shape, dtype=object)
        for i, d in enumerate(src.flat):
            self.devices.flat[i] = _canonical(resolve_device(d))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device array needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def _canonical(dev: torch.device) -> torch.device:
    """`cuda` -> `cuda:<current>`, so equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_devices(n: Optional[int], device, what: str):
    """n devices for a mesh: n copies of `device` (default one) when one is
    given, else the first n cards present (default all); raises without a
    card, or with fewer cards than asked for."""
    if device is not None:
        return [resolve_device(device)] * (1 if n is None else n)
    resolve_device(None)
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    n = len(cards) if n is None else n
    if len(cards) < n:
        raise ValueError(f"need {n} devices for {what}, have {len(cards)}")
    return cards[:n]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "stream",
              device=None) -> Mesh:
    """A 1-D mesh over the first `n_devices` cards (default all of them),
    or over `n_devices` copies of `device` when one is given
    (`device="cpu"` is the tests' stand-in for several devices)."""
    what = f"a {n_devices}-device '{axis_name}' mesh"
    return Mesh(mesh_devices(n_devices, device, what), (axis_name,))


def _moved(obj, dev: torch.device, memo: dict):
    """A copy of `obj` with every tensor, module and device in it moved to
    `dev`; functions, numbers and strings are shared."""
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, torch.nn.Module):
        new = copy.deepcopy(obj).to(dev)
    elif isinstance(obj, torch.Tensor):
        new = obj.to(dev)
    elif isinstance(obj, torch.device):
        new = dev
    elif isinstance(obj, types.MethodType):
        new = types.MethodType(obj.__func__, _moved(obj.__self__, dev, memo))
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        new = type(obj)(*(_moved(x, dev, memo) for x in obj))
    elif type(obj) in (list, tuple):
        new = type(obj)(_moved(x, dev, memo) for x in obj)
    elif type(obj) is dict:
        new = {k: _moved(v, dev, memo) for k, v in obj.items()}
    elif hasattr(obj, "__dict__") and not isinstance(
            obj, (type, types.FunctionType, types.ModuleType)):
        memo[key] = obj
        attrs = {k: _moved(v, dev, memo) for k, v in vars(obj).items()}
        if any(attrs[k] is not v for k, v in vars(obj).items()):
            new = copy.copy(obj)
            new.__dict__.update(attrs)   # also where __setattr__ is frozen
        else:
            new = obj                    # nothing in it lives on a device
    else:
        new = obj
    memo[key] = new
    return new


def replica(framestep: FrameStep, dev: torch.device) -> FrameStep:
    """`framestep` itself when it runs on `dev`, else a copy of it on `dev`
    (weights, anchors and lookup tables moved)."""
    dev = _canonical(dev)
    if _canonical(framestep.device) == dev:
        return framestep
    return _moved(framestep, dev, {})


def on(dev: torch.device):
    """Makes `dev` the current card while a shard's work is queued, so the
    kernels' launches (which take the current device) go to it."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def gather(parts, dev: torch.device):
    """NamedTuples of tensors stacked on axis 0, one per shard -> one
    NamedTuple concatenated on axis 0 on `dev`."""
    return type(parts[0])(*(torch.cat([t.to(dev) for t in ts])
                            for ts in zip(*parts)))


def split(tree, n: int):
    """A NamedTuple of tensors with leading axis n * m -> its n slices of m,
    in order."""
    m = tree[0].shape[0] // n
    return [type(tree)(*(t[i * m:(i + 1) * m] for t in tree))
            for i in range(n)]


def streams_chunk(fs: FrameStep, states, frames: torch.Tensor):
    """k streams' (k, F, H, W, 3) frames on fs's device: each stream's
    bgsub prelude, ONE detect + encode forward over the k * F frames, then
    ONE batched tracker step over the k streams a frame. Returns (k new
    PipelineStates, outputs stacked (k, F, ...), snapshots stacked
    (k, F, ...))."""
    k, F = frames.shape[:2]
    if fs.step_cfg.background_subtraction:
        preludes = [fs._bgsub_frames(st.bg, x)
                    for st, x in zip(states, frames)]
        flat = torch.cat([p[2] for p in preludes])
        integrals = torch.cat([p[1] for p in preludes])
        bgs = [p[0] for p in preludes]
    else:
        flat, integrals = frames.flatten(0, 1), None
        bgs = [st.bg for st in states]
    dets, snaps = fs._detect_encode_frames(flat, integrals)
    dets, snaps = (type(x)(*(t.reshape((k, F) + t.shape[1:]) for t in x))
                   for x in (dets, snaps))
    new, outs = fs._track_streams(states, bgs, dets)
    return new, outs, snaps


class StreamStates(NamedTuple):
    """The engine's S PipelineStates in stream order; stream s's lives on
    the device of the shard that owns it."""
    streams: tuple

    def stream(self, s: int) -> PipelineState:
        return self.streams[s]


class MultiStreamEngine:
    """S independent pipelines, S/D of them on each mesh device."""

    def __init__(self, framestep: FrameStep, n_streams: int,
                 mesh: Optional[Mesh] = None):
        self.fs = framestep
        self.n_streams = n_streams
        self.mesh = mesh if mesh is not None else make_mesh()
        n_dev = self.mesh.devices.size
        if n_streams % n_dev:
            raise ValueError(f"n_streams ({n_streams}) must be a multiple "
                             f"of the mesh size ({n_dev})")
        self.per_shard = n_streams // n_dev
        replicas = {}
        self._steps = [replicas.setdefault(d, replica(framestep, d))
                       for d in self.mesh.devices.flat]
        # the stacked outputs of all shards land on the first device
        self.out_device = self._steps[0].device

    def init_tables(self) -> StreamStates:
        """S fresh pipeline states, each on its shard's device."""
        streams = []
        for fs in self._steps:
            with on(fs.device):
                streams += [fs.init_state() for _ in range(self.per_shard)]
        return StreamStates(tuple(streams))

    init_states = init_tables

    @torch.inference_mode()
    def _run(self, states: StreamStates, frames, yuv: bool):
        if len(frames) != self.n_streams or \
                len(states.streams) != self.n_streams:
            raise ValueError(f"got {len(frames)} streams' frames and "
                             f"{len(states.streams)} states, engine built "
                             f"for {self.n_streams}")
        with span("framestep.call"):
            k = self.per_shard
            new, outs, snaps = [], [], []
            for d, fs in enumerate(self._steps):
                lo = d * k
                with on(fs.device):
                    x = fs._frames(frames[lo:lo + k])
                    if yuv:
                        with span("framestep.yuv_rgb"):
                            x = colorspace.yuv420_to_rgb_u8(x, fs.frame_h,
                                                            fs.frame_w)
                    st, out, snap = streams_chunk(
                        fs, states.streams[lo:lo + k], x)
                new += st
                outs.append(out)
                snaps.append(snap)
            return (StreamStates(tuple(new)),
                    gather(outs, self.out_device),
                    gather(snaps, self.out_device))

    def step(self, states: StreamStates, frames):
        """frames: (S, H, W, 3) uint8. Returns (states, outs, snaps) with
        outs and snaps stacked (S, ...)."""
        states, outs, snaps = self._run(states, frames[:, None], False)
        return (states, type(outs)(*(t[:, 0] for t in outs)),
                type(snaps)(*(t[:, 0] for t in snaps)))

    def step_chunk(self, states: StreamStates, frames):
        """frames: (S, F, H, W, 3) uint8, F frames per stream in one call.
        Returns (states, outs, snaps) stacked (S, F, ...)."""
        return self._run(states, frames, False)

    def step_chunk_yuv(self, states: StreamStates, yuv_frames):
        """yuv_frames: (S, F, H*3/2, W) uint8 planar I420, the native
        loader's half-bandwidth transport, converted to RGB on each device
        (`ops.colorspace.yuv420_to_rgb_u8`); then `step_chunk`'s path."""
        return self._run(states, yuv_frames, True)
