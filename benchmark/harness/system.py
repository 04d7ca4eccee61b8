"""The system under test: the port's `MultiStreamEngine` built for a cell,
with taps that keep what the comparison reads, and the port's counters.

This module, `faults.py` and `families/*.py` are the only ones that import
the program (`deepdish_tpu_torch`). The taps wrap methods of the engine's FrameStep
and detector: they hold references to what those methods return on the
sampled calls (no copy, no launch), and pass everything through.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Recorder:
    """What the taps keep, by call index and then by key, one entry a mesh
    shard in shard order. `begin(c)` opens call c; only calls in `sampled`
    keep more than the detections."""

    def __init__(self, sampled=()):
        self.sampled = set(sampled)
        self.call = None
        self.calls = {}

    def begin(self, c) -> None:
        self.call = c

    def put(self, key, value, always=False) -> None:
        if self.call is None or not (always or self.call in self.sampled):
            return
        self.calls.setdefault(self.call, {}).setdefault(key, []).append(
            value)

    def shard(self, c: int, d: int) -> dict:
        """What the taps kept of call c on shard d."""
        return {k: v[d] for k, v in self.calls[c].items()}


class System(NamedTuple):
    engine: object
    framestep: object
    tracker_cfg: object
    recorder: Recorder


def build(cell, sd_det, sd_enc, device, dtype, fam) -> System:
    """The cell's engine on `device` with the given served weights."""
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.models import create_box_encoder
    from deepdish_tpu_torch.parallel import MultiStreamEngine, make_mesh
    from deepdish_tpu_torch.pipeline import FrameStep, FrameStepConfig
    cfg, tr = cell.config, cell.traffic
    det = fam.program_detector(cfg, sd_det, device, dtype)
    enc = create_box_encoder("mars", state_dict=sd_enc, device=device,
                             compute_dtype=dtype)
    t = cfg["tracker"]
    tcfg = tt.TrackerConfig(
        max_tracks=int(t["max_tracks"]),
        max_detections=int(t["max_detections"]),
        feature_dim=int(cfg["encoder"]["feature_dim"]),
        gallery_size=int(t["gallery_size"]),
        pending_size=int(t["pending_size"]),
        num_labels=len(tr["labels"]),
        max_cosine_distance=float(t["max_cosine_distance"]),
        max_iou_distance=float(t["max_iou_distance"]),
        max_age=int(t["max_age"]), n_init=int(t["n_init"]),
        gating_threshold=float(t["gating_threshold"]))
    st = cfg["step"]
    fs = FrameStep(det, enc, tcfg, list(tr["labels"]),
                   (int(tr["height"]), int(tr["width"])),
                   FrameStepConfig(
                       nms_max_overlap=float(st["nms_max_overlap"]),
                       spurious_area_frac=float(st["spurious_area_frac"]),
                       score_threshold=float(st["score_threshold"]),
                       background_subtraction=bool(
                           tr["background_subtraction"]),
                       background_ratio=float(tr["background_ratio"]),
                       encode_capacity=int(st["encode_capacity"])),
                   device=device)
    mesh = (make_mesh(cell.chips) if torch.device(device).type == "cuda"
            else make_mesh(cell.chips, device=device))
    engine = MultiStreamEngine(fs, int(tr["streams"]), mesh)
    rec = Recorder()
    _install_taps(fs, rec)
    fam.install_taps(det, rec)
    return System(engine, fs, tcfg, rec)


def _install_taps(fs, rec: Recorder) -> None:
    detect_encode, detect_raw = fs._detect_encode_frames, fs._detect_raw

    def tapped_detect_encode(frames, integrals=None):
        rec.put("rgb", frames)
        rec.put("integral", integrals)
        dets, snaps = detect_encode(frames, integrals)
        rec.put("dets", dets, always=True)
        return dets, snaps

    def tapped_detect_raw(frames):
        raw = detect_raw(frames)
        rec.put("raw", raw)
        return raw
    fs._detect_encode_frames = tapped_detect_encode
    fs._detect_raw = tapped_detect_raw


def counters() -> dict:
    """The port's counters: host syncs of its control flow and LSAP kernel
    launches."""
    from deepdish_tpu_torch import device as devmod
    from deepdish_tpu_torch.kernels import lsap
    return {"host_syncs": devmod.host_syncs, "lsap_launches": lsap.launches}


def counting_state(labels, countline):
    """The port's countline counter of one stream."""
    from deepdish_tpu_torch.pipeline.counting import CountingState
    return CountingState(labels, countline)


def warm_lsap(device) -> None:
    """One solve through the port's LSAP entry, so its kernel is built or
    loaded before the window."""
    from deepdish_tpu_torch.ops.assignment import solve_lsap
    if torch.device(device).type != "cuda":
        return
    k = 64
    cost = torch.rand((1, k, k), device=device)
    sizes = torch.tensor([[k, k]], dtype=torch.int32, device=device)
    solve_lsap(cost, sizes)
    torch.cuda.synchronize()
