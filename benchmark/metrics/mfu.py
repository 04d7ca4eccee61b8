"""The whole step's share of the H100's dense bf16 peak, in %: one frame's
FLOPs (resize, detector, crops and MARS, the benchmark's own count at the
cell's shapes) times the traced window's frames per second. Layer: whole
step. Moves fps."""
from harness import peaks


def read(ctx):
    fps = ctx["frames"] / ctx["window_s"]
    return 100.0 * ctx["flops"]["step"] * fps / peaks.BF16_FLOPS
