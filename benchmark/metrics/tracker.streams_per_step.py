"""Streams a tracker step covers: the window's frames over its count of the
port's `framestep.tracker` ranges (one a `tracker.step`), 1 where each
stream steps alone, the shard's stream count where one batched step a
frame index covers them all. Layer: tracker (`tracker/*`,
`FrameStep._track_frames`). Moves fps."""


def read(ctx):
    r = ctx["trace"]["ranges"].get("framestep.tracker")
    return ctx["frames"] / r["count"] if r and r["count"] else None
