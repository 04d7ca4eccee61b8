"""Device time of the kernels launched inside `framestep.crop_mars` over
the window, per frame, in ms. Layer: crop + MARS (`models/mars.py`,
`models/preprocess.py`). Moves fps."""
from harness.tracing import range_sum


def read(ctx):
    ms = range_sum(ctx["trace"], ["framestep.crop_mars"], "device_s") * 1e3
    return ms / ctx["frames"] if ms > 0 else None
