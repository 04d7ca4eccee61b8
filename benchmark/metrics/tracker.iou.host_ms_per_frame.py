"""Host time of the port's `framestep.trk_iou` ranges (the tracker's IoU
stage, its sync and LSAP launch included) over the window, per frame, in
ms. Layer: tracker (`tracker/*`, `FrameStep._track_frames`). Moves fps."""
from harness.tracing import range_sum


def read(ctx):
    ms = range_sum(ctx["trace"], ["framestep.trk_iou"], "host_s") * 1e3
    return ms / ctx["frames"] if ms > 0 else None
