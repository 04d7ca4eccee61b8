"""The port's w8a8 MARS encoder (deepdish_tpu_torch/models/mars_q.py)
against the JAX package's (deepdish_tpu/models/mars_q.py), on the CPU:

  * the float mirror equals the port's MarsNet and the JAX mirror (float32
    reordering only);
  * calibration in float32 on the JAX package's synthetic set: the first
    quantized layer's activation scale within 1e-6 relative of JAX's and
    every layer's within 1e-5 (two libraries sum the float32 convolutions
    in another order, and the difference grows with depth and moves with
    the thread count and XLA's configuration: 0.6e-6 to 2.1e-6 measured at
    the deepest layers);
  * with the JAX quantization bridged in (models/weights.py
    `mars_q_from_jax`), so that one quantization is compared: each
    layer's int32 accumulators equal to the JAX contraction's on the same
    int8 input (XLA's int8 convolution and dot_general), and the features
    within 1e-3 cosine distance (the float glue of two libraries rounds
    differently, which moves a few int8 codes by one);
  * the port's own quantization: the int8 kernels and scales equal to
    JAX's on the same weights, the quantized kernels pruned from the base;
  * the encoder factory's 'int8' / 'quant' names and a FrameStep chunk;
  * the CLI with --encoder-model on a .npz named for the w8a8 mode behind
    `--model scripted:bright`, against the JAX CLI at --chunk-size 1 and 8
    (tests/test_torch_pipeline.py's rectangles; one quantization, bridged).
"""
import asyncio
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import torch

import deepdish_tpu.models.mars_q as jm
from deepdish_tpu.models.weights import load_npz
from deepdish_tpu_torch.models import create_box_encoder
from deepdish_tpu_torch.models import mars_q as pm
from deepdish_tpu_torch.models import weights as pw
from deepdish_tpu_torch.models.layers import flax_default_init_
from deepdish_tpu_torch.models.mars import INPUT_SHAPE, MarsNet
from test_torch_pipeline import (COMMON, RecordingMQTT, _compare, _frames,
                                 _last_counters, _rect_scene, _write_video,
                                 f32_jax, j_amain, p_amain, weights)
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

__all__ = ["f32_jax", "weights"]   # fixtures used below

F32 = jnp.float32
_STRIDE2 = ("conv3_1/inner/conv1", "conv3_1/projection",
            "conv4_1/inner/conv1", "conv4_1/projection")


@pytest.fixture(scope="module")
def params():
    """Random MARS weights (flax's draw from a seeded generator) as the
    JAX package's variable tree and as the port's state_dict."""
    net = MarsNet()
    flax_default_init_(net, torch.Generator().manual_seed(0))
    return pw._unflatten(pw.to_flax(net)), net.state_dict()


@pytest.fixture(scope="module")
def patches():
    return np.random.RandomState(3).uniform(
        0, 255, (4,) + INPUT_SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def jax_q(params):
    return jm.quantize_mars(params[0], compute_dtype=F32)


def test_float_mirror_matches_net_and_jax(params, patches):
    variables, sd = params
    x = torch.from_numpy(patches)
    mirror = pm.mars_forward(sd, x).numpy()
    net = MarsNet()
    net.load_state_dict(sd)
    with torch.inference_mode():
        np.testing.assert_allclose(mirror, net.eval()(x).numpy(), atol=1e-6)
    want = np.asarray(jm.mars_forward(variables, jnp.asarray(patches),
                                      compute_dtype=F32))
    np.testing.assert_allclose(mirror, want, rtol=1e-5, atol=1e-6)


def test_calibration_matches_jax(params, jax_q):
    variables, sd = params
    got = pm.calibrate_mars(sd, pm.default_calibration_patches())
    want = jm.calibrate_mars(variables, jm.default_calibration_patches(),
                             F32)
    assert set(got) == set(want) == set(pm.QUANTIZED_LAYERS)
    np.testing.assert_array_equal(pm.default_calibration_patches(),
                                  jm.default_calibration_patches())
    rel = {k: abs(got[k] / want[k] - 1) for k in want}
    assert rel["conv1_2"] <= 1e-6 and max(rel.values()) <= 1e-5, rel


def test_own_quantization_matches_jax(params, jax_q):
    """Kernels and weight scales exactly, activation scales within the
    calibration's 1e-5; the quantized kernels pruned from the base."""
    q = pm.quantize_mars(params[1])
    for path in pm.QUANTIZED_LAYERS:
        np.testing.assert_array_equal(q["wq"][path], jax_q["wq"][path])
        np.testing.assert_array_equal(q["wscale"][path],
                                      jax_q["wscale"][path])
        assert abs(float(q["ascale"][path]) / float(jax_q["ascale"][path])
                   - 1) <= 1e-5
        assert q["base"][f"{pm._name(path)}.weight"].numel() == 0
    assert q["base"]["conv1_1.weight"].numel() > 0


def test_bridged_accumulators_equal_and_features_close(jax_q, patches):
    qp = pm.prepare_qparams(pw.mars_q_from_jax(jax_q), "cpu")
    accs = {}
    got = pm.mars_forward(qp["base"], torch.from_numpy(patches), qparams=qp,
                          acc_sink=accs).numpy()
    assert set(accs) == set(pm.QUANTIZED_LAYERS)
    for path, (v8, acc) in accs.items():
        k8 = jnp.asarray(jax_q["wq"][path])
        x8 = jnp.asarray(v8.numpy())
        if v8.dim() == 4:
            stride = 2 if path in _STRIDE2 else 1
            want = jm._conv_i8_xla(x8, k8, stride)
            np.testing.assert_array_equal(
                np.asarray(jm._conv_i8_dot(x8, k8, stride)),
                np.asarray(want))
        else:
            want = jax.lax.dot_general(x8, k8, (((1,), (0,)), ((), ())),
                                       preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(want),
                                      err_msg=path)
    want = np.asarray(jm.mars_int8_apply(jax_q, jnp.asarray(patches), F32))
    cos = 1.0 - (got * want).sum(1)
    assert np.abs(cos).max() < 1e-3, cos
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_encoder_factory_names_and_framestep(params, jax_q, tmp_path):
    """'int8' / 'quant' names select the w8a8 encoder (random weights for
    a name that is no file, the .npz's weights otherwise); ready qparams
    give the bridged network; a FrameStep chunk runs on it."""
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.models import create_detector
    from deepdish_tpu_torch.pipeline import FrameStep, FrameStepConfig
    for name in ("mars_int8", "mars-quant"):
        enc = create_box_encoder(name, device="cpu")
        assert "wq" in enc.qparams and enc.feature_dim == 128
    path = str(tmp_path / "mars_int8.npz")
    pw.save_npz(pw._flatten(params[0]), path)
    enc = create_box_encoder(path, device="cpu")
    np.testing.assert_array_equal(
        enc.qparams["wq"]["fc1"], pm.quantize_mars(params[1])["wq"]["fc1"])
    enc = pm.make_mars_int8_encoder(qparams=pw.mars_q_from_jax(jax_q),
                                    device="cpu")
    det = create_detector("ssd_mobilenet", device="cpu", max_outputs=8,
                          score_threshold=0.3)
    fs = FrameStep(det, enc, tt.TrackerConfig(
        max_tracks=8, max_detections=4, feature_dim=128, gallery_size=8,
        pending_size=4, num_labels=2), ["person", "car"], (72, 96),
        FrameStepConfig(encode_capacity=2), device="cpu")
    frames = np.random.RandomState(2).randint(0, 255, (3, 72, 96, 3))
    state, outs, snaps = fs.run_chunk(fs.init_state(), torch.from_numpy(
        frames.astype(np.uint8)))
    assert tuple(outs.track_id.shape[:1]) == (3,)
    assert torch.isfinite(outs.tlwh).all()


@pytest.fixture(scope="module")
def mars_int8_npz(weights, tmp_path_factory):
    import shutil
    path = str(tmp_path_factory.mktemp("int8") / "mars_int8.npz")
    shutil.copy(weights["mars"], path)
    return path


@pytest.mark.timeout(300)
@pytest.mark.parametrize("chunk", [1, 8])
def test_cli_mars_int8_matches_jax(tmp_path, mars_int8_npz, f32_jax,
                                   monkeypatch, chunk):
    monkeypatch.setattr(jm, "make_mars_int8_encoder", functools.partial(
        jm.make_mars_int8_encoder, compute_dtype=F32))
    jq = jm.quantize_mars(load_npz(mars_int8_npz), compute_dtype=F32)
    monkeypatch.setattr(pm, "quantize_mars",
                        lambda *a, **k: pw.mars_q_from_jax(jq))
    video = tmp_path / "rects.mp4"
    _write_video(video, _rect_scene(n=32))
    logs = [tmp_path / "jax.log", tmp_path / "port.log"]
    pays = []
    for amain, log in zip((j_amain, p_amain), logs):
        asyncio.run(amain(["--input", str(video), "--model",
                           "scripted:bright", "--encoder-model",
                           mars_int8_npz, "--chunk-size", str(chunk),
                           "--log", str(log)] + COMMON))
        pays.append(RecordingMQTT.runs[-1])
    n_tracks, n_dets = _compare(*pays)
    assert len(_frames(pays[1])) == 32
    counters = _last_counters(logs[1])
    assert counters == _last_counters(logs[0])
    assert counters["poscount_person"] >= 1 and \
        counters["negcount_person"] >= 1
    assert n_tracks > 32 and n_dets > 32
