"""The port's CLI against the JAX package's with a full-integer detector
and encoder, on the CPU (tests/test_torch_pipeline.py's
harness: the same cv2-written video, MQTT payloads recorded in both
runtimes; identical counters and, per frame, framenum, track ids, labels
and detection boxes; track boxes within 1 px, confidences within 1e-5
relative), each at --chunk-size 1 and 8:

  * --quantized-inference with a small full-integer detector (three
    convolutions, 1x1 box and class heads, LOGISTIC, DEQUANTIZE and the
    TFLite_Detection_PostProcess op) and --encoder-model on a small
    full-integer encoder (QUANTIZE from float, CONV_2D, int8 ELU,
    MAX_POOL_2D, FULLY_CONNECTED, L2_NORMALIZATION), both written with
    chip_smoke.py's QuantGraph: both CLIs run the byte-exact integer
    executors. The frames are the detector's own 64 x 64, where the frame
    resize is the identity in both packages: at other sizes the float32
    resize sums in another order put some samples on the other side of a
    .5, and the uint8 input, so the detections, differ. The full-width
    graphs are held tensor by tensor in tests/test_torch_qgraph.py; the
    w8a8 CLIs are in tests/test_torch_mars_q.py and test_torch_ssd_q.py."""
import asyncio

import pytest

pytest.importorskip("jax")
pytest.importorskip("flax")

import numpy as np

import chip_smoke
from deepdish_tpu_torch.models import COCO_LABELS
from test_torch_pipeline import (COMMON, RecordingMQTT, _compare, _frames,
                                 _last_counters, _texture_scene, _write_video,
                                 f32_jax, j_amain, p_amain)

__all__ = ["f32_jax"]   # fixture used below


def small_detector(seed=21, size=64, per_cell=3):
    """A small full-integer SSD-shaped detector: uint8 input (1/128, 128),
    QUANTIZE, three 3x3/2 convolutions with relu6, 1x1 box and 91-class
    heads over an 8x8 grid, LOGISTIC, DEQUANTIZE, and the postprocess op
    on a grid of anchors."""
    rng = np.random.RandomState(seed)
    g = chip_smoke.QuantGraph((1, size, size, 3))
    x = g.quantize("input")
    for cin, cout in ((3, 8), (8, 16), (16, 16)):
        x = g.conv(x, rng.normal(0, 1.5 / np.sqrt(9 * cin),
                                 (3, 3, cin, cout)),
                   rng.normal(0, 0.1, cout), stride=2, act=3)
    cells = size // 8
    box = g.conv(x, rng.normal(0, 0.3, (1, 1, 16, per_cell * 4)))
    cls = g.conv(x, rng.normal(0, 2.0, (1, 1, 16, per_cell * 91)),
                 rng.normal(-1.0, 1.0, per_cell * 91))
    yc, xc = np.meshgrid((np.arange(cells) + 0.5) / cells,
                         (np.arange(cells) + 0.5) / cells, indexing="ij")
    anchors = np.stack([np.repeat(yc.ravel(), per_cell),
                        np.repeat(xc.ravel(), per_cell),
                        np.tile([0.2, 0.35, 0.5], cells * cells),
                        np.tile([0.2, 0.25, 0.4], cells * cells)], 1)
    g.detection_postprocess(
        g.unary("dequantize", g.reshape(box, (1, -1, 4))),
        g.unary("dequantize",
                g.unary("logistic", g.reshape(cls, (1, -1, 91)))),
        anchors, chip_smoke._ssd_pp_options())
    g.calibrate(rng.uniform(-1, 1, (4, size, size, 3)))
    return g


def small_encoder(seed=22):
    """A small full-integer encoder: float (1, 32, 16, 3) input, QUANTIZE,
    a 3x3/2 convolution, int8 ELU, MAX_POOL_2D 3x3/2, RESHAPE, a
    32-unit FULLY_CONNECTED, L2_NORMALIZATION and DEQUANTIZE."""
    rng = np.random.RandomState(seed)
    g = chip_smoke.QuantGraph((1, 32, 16, 3), dtype="float32")
    x = g.quantize("input")
    x = g.unary("elu", g.conv(x, rng.normal(0, 0.02, (3, 3, 3, 16)),
                              rng.normal(-1, 0.5, 16), stride=2))
    x = g.reshape(g.pool("maxpool", x, 3, 2), (1, 7 * 3 * 16))
    g.outputs = [g.unary("dequantize", g.unary(
        "l2norm", g.fc(x, rng.normal(0, 0.2, (7 * 3 * 16, 32)))))]
    g.calibrate(rng.uniform(0, 255, (8, 32, 16, 3)))
    return g


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    paths = {"det": str(d / "ssd_mobilenet_small_quant.tflite"),
             "enc": str(d / "mars-small_int8.tflite")}
    for k, g in (("det", small_detector()), ("enc", small_encoder())):
        with open(paths[k], "wb") as f:
            f.write(g.tflite())
    return paths


def _run_both(tmp_path, frames, argv, labels=COCO_LABELS):
    video = tmp_path / "scene.mp4"
    _write_video(video, frames)
    logs = [tmp_path / "jax.log", tmp_path / "port.log"]
    pays = []
    for amain, log in zip((j_amain, p_amain), logs):
        asyncio.run(amain(["--input", str(video), "--log", str(log),
                           "--wanted-labels", ",".join(labels)]
                          + argv + COMMON))
        pays.append(RecordingMQTT.runs[-1])
    n_tracks, n_dets = _compare(*pays)
    assert len(_frames(pays[1])) == len(frames)
    counters = _last_counters(logs[1])
    assert counters == _last_counters(logs[0])
    return n_tracks, n_dets, counters


@pytest.mark.timeout(300)
@pytest.mark.parametrize("chunk", [1, 8])
def test_cli_quantized_inference_matches_jax(tmp_path, small_files, f32_jax,
                                             chunk):
    n_tracks, n_dets, _ = _run_both(
        tmp_path, _texture_scene(64, 64),
        ["--quantized-inference", "--model", small_files["det"],
         "--encoder-model", small_files["enc"], "--score-threshold", "0.3",
         "--chunk-size", str(chunk)])
    assert n_tracks > 0 and n_dets > 0
