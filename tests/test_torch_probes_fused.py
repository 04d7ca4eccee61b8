"""The port's fused-step probes (deepdish_tpu_torch/tools/
profile_mars_int8.py and round4_ab_interleaved.py) through their `main`
under --device cpu at a toy size (chunk 1, 96x128, one round of one call,
MARS batches of 2): each prints one JSON line last, with the CPU as its
device, every leg's median / min / max finite and positive, the JAX
tools' ratios, and no LSAP launch (the plain LSAP on the CPU launches no
kernel). round4_ab_interleaved runs each of its four modes, --weights on
a full-integer SSD-MobileNetV1 file that chip_smoke.py's QuantGraph
writes (numpy only), which the real-float leg converts to float and the
real-int8 leg runs on the integer executor. The tools' arithmetic is
held against the JAX package in tests/test_torch_probes.py."""
import json
import math

import numpy as np
import pytest
import torch

import chip_smoke
from deepdish_tpu_torch.tools import profile_mars_int8 as pmi
from deepdish_tpu_torch.tools import round4_ab_interleaved as ab
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.timeout(300)
TOY = dict(chunk=1, height=96, width=128, rounds=1, reps=1)


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert sum(1 for o in out if o.startswith("{")) == 1
    line = json.loads(out[-1])
    assert line["platform"] == "cpu" and line["device"]["name"] is None
    assert line["lsap_launches"] == 0
    return line


def _spread_ok(row, key):
    vals = [row[key], row[f"{key}_min"], row[f"{key}_max"]]
    assert all(math.isfinite(v) and v > 0 for v in vals), row
    assert row[f"{key}_min"] <= row[key] <= row[f"{key}_max"]


def test_profile_mars_int8_prints_one_json_line(capsys):
    assert pmi.main(["--device", "cpu"], batch=2, fused_reps=1, **TOY) == 0
    line = _line(capsys)
    assert line["dot_conv_features_equal"] is True
    assert set(line["standalone"]) == {"bf16", "int8/dot", "int8/conv"}
    for row in line["standalone"].values():
        _spread_ok(row, "ms_per_batch")
    assert set(line["fused"]) == {"cap32", "cap8"}
    for g in line["fused"].values():
        assert set(g["legs"]) == {"mars", "mars-int8"}
        for row in g["legs"].values():
            _spread_ok(row, "ms_per_frame")
    assert set(line["ratios"]) == {"int8/dot / bf16", "int8/conv / bf16",
                                   "fused cap32 int8/bf16",
                                   "fused cap8 int8/bf16"}


@pytest.fixture(scope="module")
def quant_ssd(tmp_path_factory):
    """A full-integer SSD-MobileNetV1 (300, the postprocess op) written by
    chip_smoke.py's QuantGraph, calibrated on two of its images."""
    from deepdish_tpu_torch.models.ssd_mobilenet import INPUT_SIZE
    calib = chip_smoke._calibration_images(INPUT_SIZE, INPUT_SIZE).numpy()
    g = chip_smoke.quantized_ssd_graph(chip_smoke.quant_ssd_donor(),
                                       INPUT_SIZE, calib[:2],
                                       chip_smoke._ssd_pp_options())
    path = str(tmp_path_factory.mktemp("r4") / "ssd_int8.tflite")
    with open(path, "wb") as f:
        f.write(g.tflite())
    return path


MODES = {"weights": ({"rand-float", "real-float", "real-int8"},
                     {"real/rand-float", "int8/float"}),
         "mars_bisect": ({"mars", "mars-int8"},
                         {"batch 2 bf16/int8-conv", "crop bf16/int8"}),
         "mars_cap32": ({"mars", "mars-int8"}, {"cap32 int8/bf16"}),
         "det_int8": ({f"{n}/c{c}" for n, _, _ in ab.DET_LEGS
                       for c in (8, 32)},
                      {f"{n}/c{c}/float" for n, _, _ in ab.DET_LEGS[1:]
                       for c in (8, 32)})}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_round4_mode_prints_one_json_line(mode, quant_ssd, capsys):
    flag = (["--weights", quant_ssd] if mode == "weights"
            else ["--" + mode.replace("_", "-")])
    assert ab.main(["--device", "cpu"] + flag, batches=(2,), probe_n=32,
                   **TOY) == 0
    line = _line(capsys)
    assert line["modes"] == [mode]
    legs_want, ratios_want = MODES[mode]
    g = line[mode]
    groups = {"det_int8": lambda: list(g.values()),
              "mars_bisect": lambda: [g["fused_cap8"]]}.get(
                  mode, lambda: [g])()
    legs = {}
    for grp in groups:
        legs.update(grp["legs"])
        assert len(grp["probe_ms"]) == 1 and grp["probe_ms"][0] > 0
    assert set(legs) == legs_want
    for row in legs.values():
        _spread_ok(row, "ms_per_frame")
    assert set(line["ratios"]) == ratios_want
    assert all(math.isfinite(v) and v > 0 for v in line["ratios"].values())
    if mode == "mars_bisect":
        for row in list(g["standalone"]["2"].values()) + list(
                g["crop"].values()):
            _spread_ok(row, "ms")


def test_fused_legs_carry_the_state(monkeypatch):
    """Each timed call continues from the state the call before it gave,
    across rounds: two rounds of two calls after the untimed one."""
    dev = torch.device("cpu")
    fs = ab.framestep(ab.detector("ssd_mobilenet", dev),
                      ab.encoder("dummy", dev), 8, dev, 96, 128)
    calls = []
    run = fs.run_chunk

    def spy(state, f):
        out = run(state, f)
        calls.append((state, out[0]))
        return out
    monkeypatch.setattr(fs, "run_chunk", spy)
    ab.fused_legs([("dummy", fs)], torch.from_numpy(ab.frames(1, 96, 128)),
                  rounds=2, reps=2)
    assert len(calls) == 5                      # the untimed call, then 4
    for (_, before), (after_in, _) in zip(calls, calls[1:]):
        assert after_in is before
    assert np.isfinite(ab.probe_ms(dev, 16))
