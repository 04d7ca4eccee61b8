"""Faults planted in the program's timed path, each of which `correct` has
to catch: the tracker returning its state unchanged, half of a call's
streams' detections left out, every produced box moved by a pixel, and
MOG2 returning its state unchanged. `plant(name)` breaks the program in
this process and returns the function that mends it.

Used by the CPU tests and by `control.py --faults` on the card, at the
cell's own size."""
from __future__ import annotations


def _state_unchanged():
    from deepdish_tpu_torch.pipeline import framestep
    orig = framestep.FrameStep._track

    def frozen(self, state, bg, dets):
        _new, out = orig(self, state, bg, dets)
        return framestep.PipelineState(state.table, bg), out
    return framestep.FrameStep, "_track", frozen


def _half_batch():
    from deepdish_tpu_torch.pipeline import framestep
    orig = framestep.FrameStep._detect_encode_frames

    def half(self, frames, integrals=None):
        dets, snaps = orig(self, frames, integrals)
        n = dets.valid.shape[0] // 2
        valid = dets.valid.clone()
        valid[n:] = False
        return dets._replace(valid=valid), snaps
    return framestep.FrameStep, "_detect_encode_frames", half


def _answer_altered():
    from deepdish_tpu_torch.pipeline import framestep
    orig = framestep.FrameStep._filter_and_nms

    def moved(self, *a):
        snap = orig(self, *a)
        return snap._replace(tlwh=snap.tlwh + 1.0)
    return framestep.FrameStep, "_filter_and_nms", moved


def _mog2_unchanged():
    from deepdish_tpu_torch.ops import bgsub
    orig = bgsub.update

    def frozen(state, frame):
        _new, mask = orig(state, frame)
        return state, mask
    return bgsub, "update", frozen


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered,
          "mog2_unchanged": _mog2_unchanged}


def for_cell(cell) -> list:
    """The faults a cell can have (MOG2's only where it runs MOG2)."""
    return [f for f in FAULTS if f != "mog2_unchanged"
            or cell.traffic["background_subtraction"]]


def plant(name: str):
    """Breaks the program as `name` says; returns the mending function."""
    owner, attr, broken = FAULTS[name]()
    orig = getattr(owner, attr)
    setattr(owner, attr, broken)
    return lambda: setattr(owner, attr, orig)
