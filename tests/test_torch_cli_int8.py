"""The port's CLI with --detector-int8 against the JAX CLI, on the CPU
(tests/test_torch_pipeline.py's harness and texture video), at
--chunk-size 1 and 8, on one quantization (the JAX package's quantize_ssd,
bridged into the port with models/weights.py `ssd_q_from_jax`), with the
SSD's box and class head kernels set to zero: the heads are then the head
biases on both sides whatever the backbone's int8 codes, and the test holds
the CLI's int8 path (registry, quantization, FrameStep, decode, tracker) to
the JAX CLI's payloads. On random weights the two CLIs' int8 detections
differ: the random heads' scores tie within 1e-4, and an int8 code that the
float glue of two libraries moves by one reorders them (2 of 10 frames
identical at --chunk-size 1 in one measured run). The numerics are
tests/test_torch_ssd_q.py's."""
import asyncio
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import torch

import deepdish_tpu.models.ssd_q as jq
from deepdish_tpu.models.weights import load_npz, save_npz
from deepdish_tpu_torch.models import COCO_LABELS
from deepdish_tpu_torch.models import ssd_q as pq
from deepdish_tpu_torch.models import weights as pw
from deepdish_tpu_torch.models.layers import flax_default_init_
from deepdish_tpu_torch.models.ssd_mobilenet import SSDMobileNetV1
from test_torch_pipeline import (COMMON, RecordingMQTT, _compare, _frames,
                                 _last_counters, _texture_scene, _write_video,
                                 f32_jax, j_amain, p_amain)

__all__ = ["f32_jax"]   # fixture used below

F32 = jnp.float32


@pytest.fixture(scope="module")
def flat_heads_npz(tmp_path_factory):
    """A random SSD (flax's draw from a seeded generator) with zero box
    and class head kernels and seeded random class biases: heads that do
    not depend on the backbone."""
    net = SSDMobileNetV1()
    flax_default_init_(net, torch.Generator().manual_seed(0))
    flat = pw.to_flax(net)
    rng = np.random.RandomState(4)
    for key in list(flat):
        if "_head" in key and key.endswith("/kernel"):
            flat[key] = np.zeros_like(flat[key])
        if "cls_head" in key and key.endswith("/bias"):
            flat[key] = rng.normal(-1.0, 1.5, flat[key].shape).astype(
                np.float32)
    path = str(tmp_path_factory.mktemp("ssd") / "ssd_mobilenet.npz")
    save_npz(flat, path)
    return path


@pytest.mark.timeout(300)
@pytest.mark.parametrize("chunk", [1, 8])
def test_cli_detector_int8_matches_jax(tmp_path, flat_heads_npz, f32_jax,
                                       monkeypatch, chunk):
    monkeypatch.setattr(jq, "SSDMobileNetInt8Detector", functools.partial(
        jq.SSDMobileNetInt8Detector, compute_dtype=F32))
    want_q = jq.quantize_ssd(load_npz(flat_heads_npz))
    monkeypatch.setattr(pq, "quantize_ssd",
                        lambda *a, **k: pw.ssd_q_from_jax(want_q))
    video = tmp_path / "texture.mp4"
    _write_video(video, _texture_scene())
    logs = [tmp_path / "jax.log", tmp_path / "port.log"]
    pays = []
    for amain, log in zip((j_amain, p_amain), logs):
        asyncio.run(amain(["--input", str(video), "--detector-int8",
                           "--model", flat_heads_npz, "--encoder-model",
                           "dummy", "--wanted-labels", ",".join(COCO_LABELS),
                           "--score-threshold", "0.3", "--chunk-size",
                           str(chunk), "--log", str(log)] + COMMON))
        pays.append(RecordingMQTT.runs[-1])
    n_tracks, n_dets = _compare(*pays)
    assert len(_frames(pays[1])) == 10
    assert _last_counters(logs[1]) == _last_counters(logs[0])
    assert n_tracks > 0 and n_dets > 0
