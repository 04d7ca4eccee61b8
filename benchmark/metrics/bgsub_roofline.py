"""MOG2's share of its roofline, in %: the least time one update's bytes
take at the H100's HBM bandwidth (the state, (H, W, K) weights and
variances and (H, W, K, 3) means in float32, read and written once, and
the uint8 RGB frame read once), over the device time of `framestep.bgsub`
per frame. Layer: background subtraction. Moves fps."""
from harness import peaks
from harness.tracing import range_sum
from reference.bgsub import K


def read(ctx):
    s = range_sum(ctx["trace"], ["framestep.bgsub"], "device_s")
    if s <= 0:
        return None
    tr = ctx["traffic"]
    pixels = int(tr["height"]) * int(tr["width"])
    nbytes = pixels * (2 * 4 * K * (1 + 3 + 1) + 3)
    return 100.0 * nbytes / peaks.HBM_BYTES / (s / ctx["frames"])
