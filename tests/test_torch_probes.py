"""The port's probes (deepdish_tpu_torch/tools/probe_int8.py,
probe_grouped_conv.py, profile_mars_width.py, decode_probe.py) and the
`impl` choice of its w8a8 MARS (models/mars_q.py) against the JAX package
and the JAX tools, on the CPU with seeded numpy inputs:

  * mars_q: on one quantization (the JAX package's, bridged), the port's
    int32 accumulators with impl "dot" and "conv" equal each other, and
    each equals the JAX package's on the int8 inputs its `mars_forward`
    gives each layer with impl "dot" and "conv" (recorded in JAX's run),
    exactly; the two impls' features are bit-equal; "auto" is "dot";
    `make_mars_int8_encoder(impl=...)` runs through a FrameStep and both
    impls give identical outputs;
  * probe_int8: the int8 steps (int8_matmul or im2col, `>> 7`, int8)
    equal the JAX tool's `f_int8` (`lax.dot_general` /
    `lax.conv_general_dilated` with int32 accumulation), exactly, chained
    twice; the float steps in float32 within 1e-5 of the output's range;
  * probe_grouped_conv: the packed layout's identity (packed crop g's
    channels g*c ... (g+1)*c == the base conv of crop g, within the
    float32 reorder bound) and the base conv in float32 against the JAX
    tool's `conv` within 1e-5 of the range;
  * profile_mars_width: Wide(32, 64, 128) on a MarsNet state dict equals
    MarsNet exactly; Wide(64, 128, 256) on weights bridged from the JAX
    tool's `build_variant(64, 128, 256)` (float32) within
    tests/test_torch_models.py's MARS tolerance (2e-5);
  * decode_probe: both tools' `main` on one small synthesized video: the
    JAX tool's JSON keys (the port adds the device's), `frames`,
    `transport` and `stripe_len` equal; the port's striped frames
    byte-equal to the JAX loader's;
  * each tool's `main` under --device cpu at a toy size prints one JSON
    line last, with the CPU as its device.

The fused-step tools (profile_mars_int8, round4_ab_interleaved) are in
tests/test_torch_probes_fused.py."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import torch
from jax import lax

import deepdish_tpu.models.mars_q as jm
from deepdish_tpu_torch.models import mars_q as pm
from deepdish_tpu_torch.models import weights as pw
from deepdish_tpu_torch.models.layers import flax_default_init_
from deepdish_tpu_torch.models.mars import INPUT_SHAPE, MarsNet
from deepdish_tpu_torch.tools import decode_probe as pdecode
from deepdish_tpu_torch.tools import probe_grouped_conv as pgc
from deepdish_tpu_torch.tools import probe_int8 as pint8
from deepdish_tpu_torch.tools import profile_mars_width as pwidth
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.timeout(300)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = jnp.float32
CPU = torch.device("cpu")


def jax_tool(name):
    """A root tools/<name>.py as a module (the root tools/ is no package);
    sys.path as it was before its import."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


# ---------------------------------------------------------------- mars_q

@pytest.fixture(scope="module")
def bridged():
    """Random MARS weights (flax's draw, seed 0) as the JAX package's
    variable tree, quantized by the JAX package in float32 on 8 of its
    calibration patches; the same quantization bridged into the port."""
    net = MarsNet()
    flax_default_init_(net, torch.Generator().manual_seed(0))
    variables = pw._unflatten(pw.to_flax(net))
    jq = jm.quantize_mars(variables, jm.default_calibration_patches(8), F32)
    return jq, pm.prepare_qparams(pw.mars_q_from_jax(jq), "cpu")


@pytest.fixture(scope="module")
def patches():
    return np.random.RandomState(3).uniform(
        0, 255, (2,) + INPUT_SHAPE).astype(np.float32)


def _jax_conv_records(jq, patches, impl, monkeypatch):
    """JAX's quantized forward with `impl`, recording each int8 conv's
    (int8 input, int32 accumulator) in call order."""
    records = []
    name = "_conv_i8_dot" if impl == "dot" else "_conv_i8_xla"
    inner = getattr(jm, name)

    def record(x8, k8, stride):
        acc = inner(x8, k8, stride)
        records.append((np.array(x8), np.array(acc)))
        return acc
    monkeypatch.setattr(jm, name, record)
    jm.mars_int8_apply(jq, jnp.asarray(patches), F32, impl=impl)
    monkeypatch.undo()
    return records


def test_mars_q_impls_equal_each_other_and_jax(bridged, patches,
                                               monkeypatch):
    jq, qp = bridged
    x = torch.from_numpy(patches)
    accs, feats = {}, {}
    for impl in ("dot", "conv", "auto"):
        accs[impl] = {}
        feats[impl] = pm.mars_forward(qp["base"], x, qparams=qp, impl=impl,
                                      acc_sink=accs[impl])
    # call order, the same in both packages' forwards
    order = list(accs["dot"])
    assert list(accs["conv"]) == order
    assert sorted(order) == sorted(pm.QUANTIZED_LAYERS)
    for path in order:
        for impl in ("conv", "auto"):
            assert torch.equal(accs[impl][path][0], accs["dot"][path][0])
            assert torch.equal(accs[impl][path][1], accs["dot"][path][1]), \
                (impl, path)
    assert torch.equal(feats["dot"], feats["conv"])
    assert torch.equal(feats["dot"], feats["auto"])

    convs = [p for p in order if p != "fc1"]
    for jimpl in ("dot", "conv"):
        records = _jax_conv_records(jq, patches, jimpl, monkeypatch)
        assert len(records) == len(convs)
        for path, (x8, want) in zip(convs, records):
            k8 = jq["wq"][path]
            stride = 2 if want.shape[1] < x8.shape[1] else 1
            got_dot = pm.conv_i8(torch.from_numpy(x8), qp["wmat"][path],
                                 k8.shape[0], k8.shape[1], stride,
                                 k8.shape[3])
            got_conv = pm.conv_i8_direct(torch.from_numpy(x8),
                                         qp["wconv"][path], stride)
            np.testing.assert_array_equal(got_dot.numpy(), want,
                                          err_msg=f"{jimpl} {path}")
            np.testing.assert_array_equal(got_conv.numpy(), want,
                                          err_msg=f"{jimpl} {path}")


def test_mars_int8_encoder_impl_through_framestep():
    from deepdish_tpu_torch import tracker as tt
    from deepdish_tpu_torch.models import COCO_LABELS, create_detector
    from deepdish_tpu_torch.pipeline import FrameStep, FrameStepConfig
    with pytest.raises(ValueError, match="impl"):
        pm.make_mars_int8_encoder(device="cpu", impl="xla")
    det = create_detector("ssd_mobilenet", device="cpu", max_outputs=8,
                          score_threshold=0.01)
    frames = torch.from_numpy(np.random.RandomState(2).randint(
        0, 255, (2, 72, 96, 3)).astype(np.uint8))
    outs = {}
    for impl in ("dot", "conv"):
        enc = pm.make_mars_int8_encoder(
            device="cpu", impl=impl,
            calib_patches=pm.default_calibration_patches(8))
        fs = FrameStep(det, enc, tt.TrackerConfig(
            max_tracks=8, max_detections=4, feature_dim=128, gallery_size=8,
            pending_size=4, num_labels=len(COCO_LABELS)),
            list(COCO_LABELS), (72, 96),
            FrameStepConfig(encode_capacity=2), device="cpu")
        _, out, snap = fs.run_chunk(fs.init_state(), frames)
        outs[impl] = (out, snap)
    assert int(outs["dot"][1].valid.sum()) > 0      # crops were encoded
    for a, b in zip(outs["dot"][0] + outs["dot"][1],
                    outs["conv"][0] + outs["conv"][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- probe_int8

def _jax_int8_matmul(x8, ki):
    y = lax.dot_general(jnp.asarray(x8), jnp.asarray(ki),
                        (((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.int32)
    return (y >> 7).astype(jnp.int8)


def _jax_conv(x, k, int8):
    dn = lax.conv_dimension_numbers(x.shape, k.shape,
                                    ("NHWC", "HWIO", "NHWC"))
    kw = {"preferred_element_type": jnp.int32} if int8 else {}
    y = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k), (1, 1),
                                 "SAME", dimension_numbers=dn, **kw)
    return (y >> 7).astype(jnp.int8) if int8 else y


def _close_in_range(got, want, rel=1e-5):
    want = np.asarray(want)
    span = float(want.max() - want.min())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * span)


def test_probe_int8_steps_match_jax():
    n = 40
    kb, ki = pint8.matmul_weights(n)
    f_float, f_int8 = pint8.matmul_steps(kb, ki, CPU, torch.float32)
    x8 = np.random.RandomState(5).randint(-127, 128, (24, n)).astype(np.int8)
    got = f_int8(f_int8(torch.from_numpy(x8)))
    want = _jax_int8_matmul(_jax_int8_matmul(x8, ki), ki)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.random.RandomState(6).standard_normal((24, n)).astype(np.float32)
    _close_in_range(f_float(torch.from_numpy(x)).numpy(),
                    jnp.asarray(x) @ jnp.asarray(kb))
    for batch, hw, cin, cout, k in ((2, 7, 8, 8, 3), (2, 5, 16, 16, 1)):
        kb, ki = pint8.conv_weights(cin, cout, k)
        f_float, f_int8 = pint8.conv_steps(kb, ki, CPU, torch.float32)
        x8 = np.random.RandomState(7).randint(
            -127, 128, (batch, hw, hw, cin)).astype(np.int8)
        got = f_int8(f_int8(torch.from_numpy(x8)))
        want = _jax_conv(_jax_conv(x8, ki, True), ki, True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        x = np.random.RandomState(8).standard_normal(
            (batch, hw, hw, cin)).astype(np.float32)
        _close_in_range(f_float(torch.from_numpy(x)).numpy(),
                        _jax_conv(x, kb, False))


# ------------------------------------------------------- probe_grouped_conv

def test_grouped_conv_identity_and_base_conv_match_jax():
    jgc = jax_tool("probe_grouped_conv")
    xb, kb, _ = pgc.inputs(8, 9, 7, 8)
    excess, worst = pgc.packed_identity(xb, kb, CPU, torch.float32)
    assert excess <= 0, (excess, worst)
    base = pgc.conv(pgc.nchw(xb, CPU, torch.float32),
                    pgc.to_oihw(kb, CPU, torch.float32), 1)
    want = jgc.conv(jnp.asarray(xb), jnp.asarray(kb), 1)
    _close_in_range(base.permute(0, 2, 3, 1).numpy(), want)
    # the packed kernel as the JAX tool builds it, fgc = 4, per crop
    kp = np.concatenate([kb] * pgc.G, axis=-1)
    packed = jgc.conv(jnp.asarray(pgc.pack(xb)), jnp.asarray(kp), pgc.G)
    got = pgc.conv(pgc.nchw(pgc.pack(xb), CPU, torch.float32),
                   pgc.to_oihw(kp, CPU, torch.float32), pgc.G)
    _close_in_range(got.permute(0, 2, 3, 1).numpy(), packed)


# ------------------------------------------------------- profile_mars_width

def test_wide_equals_marsnet_and_the_jax_variant():
    x = torch.from_numpy(pwidth.patches(2))
    assert pwidth.wide_equals_marsnet(x, CPU, torch.float32)
    with pytest.raises(ValueError, match="widths"):
        pwidth.Wide(32, 96, 128)
    jw = jax_tool("profile_mars_width")
    net = jw.build_variant(64, 128, 256).clone(compute_dtype=F32)
    variables = net.init(jax.random.PRNGKey(0), jnp.asarray(x.numpy()))
    wide = pwidth.Wide(64, 128, 256)
    wide.load_state_dict(pw.mars_from_flax(pw._flatten(variables)))
    with torch.inference_mode():
        got = wide.eval()(x).numpy()
    want = np.asarray(net.apply(variables, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got, want, atol=2e-5)


# ------------------------------------------------------------ decode_probe

def test_decode_probe_matches_jax_tool(tmp_path, capsys):
    from deepdish_tpu_torch.tools.bench import loader_problem
    problem = loader_problem()
    if problem is not None:
        pytest.skip(problem)
    from deepdish_tpu.utils.native import StripedFrameLoader as JStriped
    from deepdish_tpu_torch.utils.native import StripedFrameLoader
    video = str(tmp_path / "v.mp4")
    pdecode.make_video(video, 40, 96, 256)
    argv = ["--video", video, "--frames", "24", "--width", "256",
            "--height", "96", "--stripes", "1,2", "--stripe-len", "7"]
    lines = []
    for main in (jax_tool("decode_probe").main,
                 lambda a: pdecode.main(a + ["--device", "cpu"])):
        assert main(argv) == 0
        out = capsys.readouterr().out.strip().splitlines()
        lines.append(json.loads(out[-1]))
    jline, line = lines
    assert set(line) - set(jline) == {"platform", "device"}
    assert set(jline) <= set(line)
    for key in ("video", "frames", "transport", "stripe_len", "host_cores"):
        assert line[key] == jline[key], key
    assert set(line["striped_fps_by_workers"]) == {"1", "2"}
    frames = []
    for cls in (JStriped, StripedFrameLoader):
        with cls(video, n_workers=2, stripe_len=7, out_w=256,
                 out_h=96) as ld:
            got, chunk = ld.next(24)
            frames.append(chunk[:got].copy())
    assert frames[0].shape[0] == 24
    np.testing.assert_array_equal(frames[1], frames[0])


# --------------------------------------------------- JSON lines at toy size

TOY = {
    "probe_int8": (pint8, ["--device", "cpu"],
                   dict(n=32, convs=(("t", 2, 6, 8, 8, 3),
                                     ("pw", 2, 5, 16, 16, 1)),
                        rounds=1, reps=2)),
    "probe_grouped_conv": (pgc, ["--device", "cpu", "--rounds", "1",
                                 "--reps", "1", "--layers", "2"],
                           dict(shapes=(("toy", 8, 9, 7, 8),))),
    "profile_mars_width": (pwidth, ["--device", "cpu", "--batch", "2",
                                    "--reps", "1"], dict(rounds=1)),
}


@pytest.mark.parametrize("tool", sorted(TOY))
def test_tool_prints_one_json_line(tool, capsys):
    mod, argv, seams = TOY[tool]
    assert mod.main(argv, **seams) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert sum(1 for o in out if o.startswith("{")) == 1
    assert line["platform"] == "cpu" and line["device"]["name"] is None
    rows = line.get("legs") or line.get("shapes") or line.get("variants")
    assert rows
    if tool == "probe_int8":
        assert len(rows) == 3 and line["over_peak"] == []
        assert line["int8_card_equals_cpu"] is None       # no card here
        assert all(r["bf16_ms"] > 0 and r["int8_ms"] > 0 for r in rows)
        assert rows[1]["int8_path"].startswith("im2col")
    elif tool == "probe_grouped_conv":
        assert line["packed_identity_holds"] is True
        assert len(rows[0]["legs"]) == 3
        assert line["memory_format"] == "channels_last"
    else:
        assert line["wide_equals_marsnet"] is True
        assert [r["variant"] for r in rows] == ["stock", "pad2", "pad4"]
        assert rows[0]["vs_stock"] == 1.0
