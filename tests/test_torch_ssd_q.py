"""The port's w8a8 SSD-MobileNetV1 (deepdish_tpu_torch/models/ssd_q.py)
against the JAX package's (deepdish_tpu/models/ssd_q.py), on the CPU:

  * the float mirror equals the port's SSDMobileNetV1 and the JAX mirror;
  * calibration in float32 on two images of the JAX package's synthetic
    set: the activation absmax of the first three blocks within 1e-6
    relative of JAX's and of every layer within 1e-5 (the difference grows
    with depth, as two libraries sum the float32 convolutions in another
    order, and moves with the thread count: 2.4e-6 to 3.5e-6 measured at
    the deepest extras);
  * with the JAX quantization bridged in (models/weights.py
    `ssd_q_from_jax`): each layer's int32 accumulators equal to the JAX
    contraction's (XLA's int8 convolution) on the same int8 input, with
    and without the int8 depthwise convolutions, and the default mode's
    heads within 15% of their RMS of the JAX int8 heads, the JAX package's
    own bound on int8 drift (the float glue of two libraries rounds
    differently, which moves a few int8 codes by one);
  * the port's own quantization: kernels, scales and the shifted scheme's
    corrections equal to JAX's on the same weights;
  * the registry's int8 branch and --detector-calibration-frames;
  * the CLI: tests/test_torch_cli_int8.py.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import torch

import deepdish_tpu.models.ssd_q as jq
from deepdish_tpu.pipeline.runtime import Pipeline as JPipeline
from deepdish_tpu_torch.models import create_detector
from deepdish_tpu_torch.models import ssd_q as pq
from deepdish_tpu_torch.models import weights as pw
from deepdish_tpu_torch.models.layers import flax_default_init_
from deepdish_tpu_torch.models.ssd_mobilenet import SSDMobileNetV1
from deepdish_tpu_torch.pipeline.runtime import Pipeline as PPipeline

F32 = jnp.float32


@pytest.fixture(scope="module")
def params():
    """Random SSD weights (flax's draw from a seeded generator) as the JAX
    package's variable tree and as the port's state_dict."""
    net = SSDMobileNetV1()
    flax_default_init_(net, torch.Generator().manual_seed(0))
    return pw._unflatten(pw.to_flax(net)), net.state_dict()


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(1).uniform(
        0, 255, (2, 300, 300, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def calib():
    return jq.default_calibration_images(2)


@pytest.fixture(scope="module")
def jax_q(params, calib):
    """The JAX package's quantizations with and without the int8
    depthwise convs, on one calibration (it is the same for both)."""
    absmax = jq.calibrate_ssd(params[0], calib)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "calibrate_ssd", lambda *a, **k: absmax)
        return {dw: jq.quantize_ssd(params[0], quantize_dw=dw)
                for dw in (False, True)}


def test_float_mirror_matches_net_and_jax(params, image):
    variables, sd = params
    x = torch.from_numpy(image)
    boxes, logits = pq.ssd_forward(sd, x)
    net = SSDMobileNetV1()
    net.load_state_dict(sd)
    with torch.inference_mode():
        nb, nl = net.eval()(x)
    np.testing.assert_allclose(boxes.numpy(), nb.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(logits.numpy(), nl.numpy(), rtol=1e-5,
                               atol=1e-7)
    jb, jl = jq.ssd_forward(variables, jnp.asarray(image), compute_dtype=F32)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-6)


def test_calibration_matches_jax(params, calib):
    variables, sd = params
    got = pq.calibrate_ssd(sd, calib)
    want = jq.calibrate_ssd(variables, calib)
    assert set(got) == set(want)
    np.testing.assert_array_equal(pq.default_calibration_images(2), calib)
    np.testing.assert_array_equal(pq.default_calibration_images(),
                                  jq.default_calibration_images())
    rel = {k: abs(got[k] / want[k] - 1) for k in want}
    assert max(rel.values()) <= 1e-5, rel
    assert max(rel[f"ds{i}/pw"] for i in (1, 2, 3)) <= 1e-6, rel


@pytest.mark.parametrize("quantize_dw", [False, True])
def test_own_quantization_matches_jax(params, calib, jax_q, quantize_dw):
    q = pq.quantize_ssd(params[1], quantize_dw, calib)
    want = jax_q[quantize_dw]
    assert q["layers"] == {k: tuple(v) for k, v in want["layers"].items()}
    for path in want["wq"]:
        np.testing.assert_array_equal(q["wq"][path], want["wq"][path])
        np.testing.assert_array_equal(q["wscale"][path],
                                      want["wscale"][path])
        assert abs(float(q["ascale"][path]) / float(want["ascale"][path])
                   - 1) <= 1e-5
        assert q["base"][f"{pq._name(path)}.weight"].numel() == 0
    assert set(q["corr"]) == set(want["corr"])
    for path in want["corr"]:
        np.testing.assert_array_equal(q["corr"][path], want["corr"][path])


@pytest.mark.parametrize("quantize_dw", [False, True])
def test_bridged_accumulators_equal_heads_close(jax_q, image, quantize_dw):
    want_q = jax_q[quantize_dw]
    qp = pq.prepare_qparams(pw.ssd_q_from_jax(want_q), "cpu")
    accs = {}
    boxes, logits = pq.ssd_forward(qp["base"], torch.from_numpy(image),
                                   qparams=qp, acc_sink=accs)
    assert set(accs) == set(want_q["layers"])
    paths = list(accs)

    def contractions(xs):
        out = []
        for x, path in zip(xs, paths):
            _, stride, is_dw = want_q["layers"][path]
            out.append(jq._conv_i8(x, jnp.asarray(want_q["wq"][path]),
                                   stride, x.shape[-1] if is_dw else 1))
        return out
    wants = jax.jit(contractions)([jnp.asarray(accs[p][0].numpy())
                                   for p in paths])
    for path, want in zip(paths, wants):
        want = np.asarray(want)
        if want_q["layers"][path][0] == 1:
            want = want + np.asarray(want_q["corr"][path])
        np.testing.assert_array_equal(accs[path][1].numpy(), want,
                                      err_msg=path)
    if quantize_dw:
        return
    jb, jl = jq.ssd_forward(want_q["base"], jnp.asarray(image[:1]),
                            compute_dtype=F32, qparams=want_q)
    for got, ref in ((boxes[:1].numpy(), np.asarray(jb)),
                     (logits[:1].numpy(), np.asarray(jl))):
        rms = float(np.sqrt(np.mean(ref ** 2)))
        assert float(np.sqrt(np.mean((got - ref) ** 2))) < 0.15 * rms


def test_registry_int8_detector_and_calibration_frames(params, tmp_path):
    """An 'int8' SSD name selects the w8a8 detector, whose heads are
    ssd_forward's on its qparams; --detector-calibration-frames loads as in
    the JAX runtime and moves the activation scales."""
    frames = np.random.RandomState(7).uniform(
        0, 255, (2, 300, 300, 3)).astype(np.float32)
    path = str(tmp_path / "frames.npy")
    np.save(path, frames)
    loaded = PPipeline._load_calibration_frames(path)
    np.testing.assert_array_equal(loaded,
                                  JPipeline._load_calibration_frames(path))
    assert loaded.dtype == np.float32
    assert PPipeline._load_calibration_frames(None) is None
    bad = str(tmp_path / "bad.npy")
    np.save(bad, frames[0])
    msgs = []
    for pipe in (PPipeline, JPipeline):
        with pytest.raises(ValueError) as e:
            pipe._load_calibration_frames(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]

    sd = params[1]
    synth = create_detector("ssd_mobilenet_int8", device="cpu",
                            state_dict=sd, max_outputs=8)
    real = create_detector("ssd_mobilenet", detector_int8=True, device="cpu",
                           state_dict=sd, max_outputs=8,
                           calib_images=loaded)
    assert isinstance(synth, pq.SSDMobileNetInt8Detector)
    a_s, a_r = synth.qparams["ascale"], real.qparams["ascale"]
    assert set(a_s) == set(a_r)
    assert any(abs(float(a_s[k]) - float(a_r[k])) > 1e-6 for k in a_s)
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        heads = synth._apply_net(x)
        b, c, s, v = synth.detect(x, 640.0, 360.0)
    ref = pq.ssd_forward(synth.qparams["base"], x, qparams=synth.qparams)
    for got, want in zip(heads, ref):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert b.shape == (2, 8, 4) and c.dtype == torch.int32 and \
        v.dtype == torch.bool
