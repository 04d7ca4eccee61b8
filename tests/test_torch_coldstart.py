"""The port's cold-start probe (deepdish_tpu_torch/tools/coldstart_probe.py)
on the CPU at a small size: both legs run in fresh subprocesses under
--device cpu and report every term; the kernel-build term is 0 on the CPU
and says so; the two legs' first-chunk track ids are equal to each other
and to a direct `run_chunk` of the same frames on the same FrameStep."""
import json
import math

import numpy as np
import pytest
import torch

from deepdish_tpu_torch.tools import bench
from deepdish_tpu_torch.tools import coldstart_probe as cp
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.timeout(300)
SIZE = ["--chunk", "2", "--height", "96", "--width", "128"]


def test_both_legs_in_fresh_processes(capsys):
    line = cp.main(SIZE + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(line))
    assert line["platform"] == "cpu" and line["device"]["name"] is None
    assert set(line["legs"]) == {"fresh", "cold"}
    for leg, r in line["legs"].items():
        assert r["leg"] == leg and set(r["seconds"]) == set(cp.TERMS)
        assert all(math.isfinite(v) and v >= 0 for v in r["seconds"].values())
        assert r["seconds"]["kernel_build"] == 0.0
        assert r["seconds"]["cuda_context"] == 0.0
        assert "CPU" in r["kernel_build_note"] and r["kernels"] == []
        assert r["process_s"] >= r["seconds"]["first_result"] > 0
        assert r["second_ids_equal"]
    assert line["legs"]["cold"]["build_dir_files"] == []   # nothing built
    assert line["track_ids_equal"]
    fs = bench.build_framestep(device="cpu", height=96, width=128)
    frames = np.random.RandomState(0).randint(
        0, 255, (2, 96, 128, 3)).astype(np.uint8)
    _, outs, _ = fs.run_chunk(fs.init_state(), frames)
    assert line["legs"]["fresh"]["track_ids"] == outs.track_id.tolist()


def test_one_leg_and_the_card_default():
    with pytest.raises(SystemExit):
        cp.main(["--fresh", "--cold"])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cp.main(["--fresh"])
