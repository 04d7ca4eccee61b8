"""The benchmark's frozen FLOP count equals the port's own
(`deepdish_tpu_torch/utils/flops.py`) at the shapes of every cell, the
held one too, so that a drift of either shows (CPU, float32, full size,
one frame)."""
import pytest
import torch

import bench_tiny
from harness import spec
from harness.flops import step_flops


@pytest.mark.parametrize("cell_name", bench_tiny.CELLS)
def test_frozen_count_equals_the_ports(cell_name):
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.models import create_box_encoder
    from deepdish_tpu_torch.pipeline import FrameStep, FrameStepConfig
    from deepdish_tpu_torch.utils import flops as port_flops
    cell = bench_tiny.cell(cell_name)
    cfg, tr = cell.config, cell.traffic
    fam = spec.family(cfg)
    H, W = int(tr["height"]), int(tr["width"])
    torch.set_num_threads(8)
    det = fam.program_detector(cfg, None, "cpu", torch.float32)
    enc = create_box_encoder("mars", device="cpu",
                             compute_dtype=torch.float32)
    fs = FrameStep(det, enc, tt.TrackerConfig(num_labels=2), ["person"],
                   (H, W), FrameStepConfig(encode_capacity=int(
                       cfg["step"]["encode_capacity"])), device="cpu")
    frames = torch.zeros((1, H, W, 3), dtype=torch.uint8)
    with torch.inference_mode(), port_flops.Count() as c:
        fs._detect_encode_frames(frames)
    ours = step_flops(fam, cfg, H, W)
    assert ours["step"] == c.total
    with torch.inference_mode(), port_flops.Count() as d:
        det.detect(fs.detector_input(frames), float(W), float(H))
    assert ours["detector"] + ours["resize"] == d.total
