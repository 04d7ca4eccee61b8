"""Device time of the kernels launched inside the detector's ranges
(`frcnn.*` or `ssd.*`) over the window, per frame, in ms. Layer: detector
(`models/faster_rcnn.py`, `models/ssd_mobilenet.py`). Moves fps."""
from harness.tracing import range_sum

PREFIXES = ("frcnn.", "ssd.")


def read(ctx):
    ms = range_sum(ctx["trace"], PREFIXES, "device_s") * 1e3
    return ms / ctx["frames"] if ms > 0 else None
