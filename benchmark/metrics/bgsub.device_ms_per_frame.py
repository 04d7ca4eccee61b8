"""Device time of the kernels launched inside `framestep.bgsub` over the
window, per frame, in ms. Layer: background subtraction (`ops/bgsub.py`).
Moves fps. Nothing to read where MOG2 is off."""
from harness.tracing import range_sum


def read(ctx):
    ms = range_sum(ctx["trace"], ["framestep.bgsub"], "device_s") * 1e3
    return ms / ctx["frames"] if ms > 0 else None
