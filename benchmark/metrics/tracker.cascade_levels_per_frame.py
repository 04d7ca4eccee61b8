"""Matching-cascade levels solved (the port's `framestep.trk_level`
ranges, one LSAP launch each) over the window, per frame. Layer: tracker
(`tracker/*`, `FrameStep._track_frames`). Moves fps."""


def read(ctx):
    r = ctx["trace"]["ranges"].get("framestep.trk_level")
    return r["count"] / ctx["frames"] if r else None
