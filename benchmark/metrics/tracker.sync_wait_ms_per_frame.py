"""Host time of the port's `framestep.sync_trk` ranges (the tracker's host
syncs: waiting for the card's queue to drain, and the read) over the
window, per frame, in ms. Layer: tracker (`tracker/*`,
`FrameStep._track_frames`). Moves fps."""
from harness.tracing import range_sum


def read(ctx):
    ms = range_sum(ctx["trace"], ["framestep.sync_trk"], "host_s") * 1e3
    return ms / ctx["frames"] if ms > 0 else None
