"""Host time of the port's `framestep.trk_update` ranges (the tracker's
Kalman update, lifecycle, new tracks and gallery) over the window, per
frame, in ms. Layer: tracker (`tracker/*`, `FrameStep._track_frames`).
Moves fps."""
from harness.tracing import range_sum


def read(ctx):
    ms = range_sum(ctx["trace"], ["framestep.trk_update"], "host_s") * 1e3
    return ms / ctx["frames"] if ms > 0 else None
