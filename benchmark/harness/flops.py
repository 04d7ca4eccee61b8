"""FLOPs of the contractions a piece of work runs: 2 x the multiply-adds of
every convolution and matrix product, at the shapes it runs them.

A frozen copy of the port's `utils/flops.py` `Count`: torch's
`FlopCounterMode`, a dispatch mode that sees every torch op on any device
(the meta device included, so a count needs no data). The benchmark counts
the plain reference's networks at a cell's shapes, so the count stays the
same whatever implements the work.
"""
from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


class Count(FlopCounterMode):
    """FLOPs of the torch contractions inside the block."""

    def __init__(self):
        super().__init__(display=False)

    @property
    def total(self) -> int:
        return int(self.get_total_flops())


def counted(fn) -> int:
    """FLOPs of `fn()`, run under the meta device (shapes only)."""
    import torch
    with torch.device("meta"):
        with Count() as c:
            fn()
    return c.total


def step_flops(fam, config: dict, frame_h: int, frame_w: int) -> dict:
    """FLOPs of one frame of the frame step at a cell's shapes:
    "detector" (the detector's network at its input size), "resize" (the
    frame to that size) and "encoder" (the crops of `encode_capacity`
    boxes and MARS on them); "step" is their sum."""
    import torch
    from reference.mars import INPUT_SHAPE, MarsNet
    from reference.preprocess import (crop_resize_patches_mxu,
                                      resize_bilinear_mxu)
    E = int(config["step"]["encode_capacity"])
    ph, pw = INPUT_SHAPE[:2]
    size = fam.input_size(config)

    def frame():
        return torch.empty((1, frame_h, frame_w, 3), dtype=torch.uint8)

    def encoder():
        p, _ = crop_resize_patches_mxu(
            frame(), torch.empty((1, E, 4)),
            torch.empty((1, E), dtype=torch.bool), ph, pw, torch.float32)
        MarsNet()(p.reshape((E, ph, pw, 3)))

    out = {"detector": fam.detector_flops(config),
           "resize": counted(lambda: resize_bilinear_mxu(
               frame(), size, size, torch.float32)),
           "encoder": counted(encoder)}
    out["step"] = sum(out.values())
    return out
