"""The detector's share of its roofline, in %: the least time one frame's
network FLOPs (the benchmark's own count at the cell's shapes) take at
the H100's dense bf16 peak, over the device time of the detector's
ranges per frame. Layer: detector. Moves fps."""
from harness import peaks
from harness.tracing import range_sum

PREFIXES = ("frcnn.", "ssd.")


def read(ctx):
    s = range_sum(ctx["trace"], PREFIXES, "device_s") / ctx["frames"]
    if s <= 0:
        return None
    return 100.0 * ctx["flops"]["detector"] / peaks.BF16_FLOPS / s
