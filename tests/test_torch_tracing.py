"""The port's profiler ranges (`device.span`) on the CPU.

A `MultiStreamEngine` of two streams runs `step_chunk_yuv` over scripted
walkers under `torch.profiler` (CPU activity): walker A every frame,
walker B confirmed, missed for two frames and back, so that one frame's
matching cascade solves two levels and another stops after one. The
ranges must nest as the port's docstrings say (`pipeline/framestep.py`,
`device.py`): the tracker's four stages once in every `framestep.tracker`,
each `framestep.trk_level` in a `framestep.trk_cascade` and one a level
solved, one `framestep.sync_<site>` a counted host sync, one
`framestep.call` an engine call. Without a profiler `span` is one shared
no-op context, and a profiled run's track outputs equal an unprofiled
run's bit for bit."""
import collections
import contextlib
from typing import NamedTuple, Optional

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepdish_tpu_torch import device as devmod
from deepdish_tpu_torch import tracker as tt
from deepdish_tpu_torch.models.encoders import make_dummy_encoder
from deepdish_tpu_torch.parallel import MultiStreamEngine, make_mesh
from deepdish_tpu_torch.pipeline import FrameStep
from deepdish_tpu_torch.tracker import matching

H, W, S = 48, 64, 2
CALLS = 8
TRACKER = tt.TrackerConfig(max_tracks=8, max_detections=4, feature_dim=128,
                           gallery_size=8, pending_size=4, num_labels=1,
                           max_cosine_distance=0.2, max_iou_distance=0.7)
STAGES = ("framestep.trk_predict", "framestep.trk_cascade",
          "framestep.trk_iou", "framestep.trk_update")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Walkers:
    """A detector on the CPU whose raw boxes are scripted by call: walker A
    in every frame, walker B away in calls 5 and 6."""

    labels = {0: "person"}
    height, width = 16, 16
    compute_dtype = torch.float32
    device = torch.device("cpu")

    def __init__(self):
        self.call = 0

    def detect(self, images, orig_w, orig_h):
        i = self.call
        self.call += 1
        boxes = [[2 + 3 * i, 4, 12 + 3 * i, 16]]
        if i not in (5, 6):
            boxes.append([50 - 2 * i, 28, 60 - 2 * i, 40])
        xyxy = torch.zeros((images.shape[0], 4, 4))
        xyxy[:, :len(boxes)] = torch.tensor(boxes, dtype=torch.float32)
        valid = torch.zeros((images.shape[0], 4), dtype=torch.bool)
        valid[:, :len(boxes)] = True
        return (xyxy, torch.zeros((images.shape[0], 4), dtype=torch.int32),
                valid.to(torch.float32) * 0.9, valid)


def _run(profiler=None):
    """CALLS engine calls from fresh states; returns the track outputs."""
    fs = FrameStep(Walkers(), make_dummy_encoder("cpu"), TRACKER,
                   ["person"], (H, W), device="cpu")
    eng = MultiStreamEngine(fs, S, make_mesh(1, device="cpu"))
    yuv = torch.full((S, 1, H * 3 // 2, W), 128, dtype=torch.uint8)
    yuv[:, :, :H] = 90
    states, outs = eng.init_tables(), []
    with profiler or contextlib.nullcontext():
        for _ in range(CALLS):
            states, out, _snaps = eng.step_chunk_yuv(states, yuv)
            outs.append(out)
    return outs


class Range(NamedTuple):
    name: str
    start: int
    end: int
    parent: Optional["Range"]


def _ranges(prof):
    """The run's `framestep.*` profiler ranges in start order, each with
    the innermost range around it."""
    spans = sorted((e.start_ns(), -e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and
                   e.name().startswith("framestep."))
    out, open_ = [], []
    for start, neg_duration, name in spans:
        end = start - neg_duration
        while open_ and open_[-1].end < end:
            open_.pop()
        out.append(Range(name, start, end, open_[-1] if open_ else None))
        open_.append(out[-1])
    return out


@pytest.fixture(scope="module")
def traced(one_torch_thread):
    """(profiler ranges, host syncs counted, cascade levels solved, track
    outputs) of a profiled run."""
    solved = []
    plain = matching.masked_min_cost_matching

    def counted(cost, row_mask, row_key, col_mask, max_distance, K):
        solved.append(max_distance == TRACKER.max_cosine_distance)
        return plain(cost, row_mask, row_key, col_mask, max_distance, K)
    matching.masked_min_cost_matching = counted
    try:
        before = devmod.host_syncs
        prof = profile(activities=[ProfilerActivity.CPU])
        outs = _run(prof)
        syncs = devmod.host_syncs - before
    finally:
        matching.masked_min_cost_matching = plain
    return _ranges(prof), syncs, sum(solved), outs


def test_tracker_stages_cover_each_tracker_range(traced):
    ranges = traced[0]
    trackers = [e for e in ranges if e.name == "framestep.tracker"]
    # one batched tracker step a call, over both streams
    assert len(trackers) == CALLS
    for t in trackers:
        assert sorted(e.name for e in ranges
                      if e.parent is t) == sorted(STAGES)
    for e in ranges:
        if e.name in STAGES:
            assert e.parent.name == "framestep.tracker"


def test_cascade_levels_nest_and_count_the_levels_solved(traced):
    ranges, _syncs, solved, _outs = traced
    levels = [e for e in ranges if e.name == "framestep.trk_level"]
    per_cascade = collections.Counter(e.parent.start for e in levels)
    assert all(e.parent.name == "framestep.trk_cascade" for e in levels)
    assert len(levels) == solved
    # the scene makes some frame's cascade solve two levels
    assert max(per_cascade.values()) == 2


def test_one_sync_range_per_counted_sync(traced):
    ranges, syncs, _solved, _outs = traced
    sites = collections.Counter(e.name for e in ranges
                                if e.name.startswith("framestep.sync_"))
    assert sum(sites.values()) == syncs > 0
    assert set(sites) == {"framestep.sync_trk", "framestep.sync_nms"}
    for e in ranges:
        if e.name == "framestep.sync_trk":
            assert e.parent.name in ("framestep.trk_cascade",
                                     "framestep.trk_iou")


def test_engine_call_ranges(traced):
    ranges = traced[0]
    calls = [e for e in ranges if e.name == "framestep.call"]
    assert len(calls) == CALLS
    assert all(e.parent is None for e in calls)
    for e in ranges:
        if e.name == "framestep.yuv_rgb":
            assert e.parent.name == "framestep.call"
    assert sum(e.name == "framestep.yuv_rgb" for e in ranges) == CALLS


def test_spans_off_cost_nothing_and_change_no_output(traced):
    assert not torch.autograd._profiler_enabled()
    off = devmod.span("framestep.tracker")
    assert off is devmod.span("framestep.trk_level")
    assert isinstance(off, contextlib.nullcontext)
    for a, b in zip(traced[3], _run()):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
