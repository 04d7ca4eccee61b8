"""The port's integer executor (deepdish_tpu_torch/models/qgraph.py) and
the builtin options of its numpy TFLite reader against the JAX package's
executor (deepdish_tpu/models/qgraph.py) and tf.lite.Interpreter, on the
CPU, on the same numpy inputs:

  * builtin options (models/tflite_meta.py) field by field equal to TF's
    generated schema reader, on files from TF's converter, the legacy
    uint8 builder and chip_smoke.py's full-integer writer;
  * the tiny full-integer graph of tests/test_qgraph.py and the legacy
    full-uint8 graph (tests/pp_builder.py): every tensor byte-equal to the
    JAX executor's and to the BUILTIN_REF interpreter's; the three
    conv_impl forms (portable, mxu, xconv) equal; a batch equal to its
    frames run one at a time;
  * chip_smoke.py's writer: its SSD-MobileNetV1 (at 128 here, the widths
    and ops of the 300 one; the postprocess op) and its per-op graphs run
    by the BUILTIN_REF
    interpreter, every tensor byte-equal between the interpreter, the JAX
    executor and the port's (SOFTMAX's float probabilities within 5e-7,
    a few float32 ulps of 1: the exp of three libraries); its MARS (int8 ELU, which this TF build's reference
    resolver does not register) equal to the JAX executor's in every
    tensor and, op by op on the interpreter's own inputs, to the default
    kernels (exact except CONV_2D / FULLY_CONNECTED within the 1 LSB by
    which TFLite's optimized convolutions round differently);
  * QuantizedSSDDetector (SSD and EfficientDet families, the latter with
    allow / deny / max_results), QuantizedYOLOv5Detector and the quantized
    MARS encoder against the JAX ones: head tensors exact, detections to
    the JAX tests' tolerances (float decode);
  * the registry's `quantized` dispatch and refusals.
The full-width runs on the card are chip_smoke.py's `quantized` phase."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp
import torch

import chip_smoke
import deepdish_tpu.models.registry as j_registry
from deepdish_tpu.models import qgraph as jq
from deepdish_tpu_torch.models import create_box_encoder, create_detector
from deepdish_tpu_torch.models import qgraph as pq
from deepdish_tpu_torch.models import tflite_meta
from deepdish_tpu_torch.models.mars import INPUT_SHAPE, MarsNet
from deepdish_tpu_torch.models.ssd_mobilenet import SSDMobileNetV1
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

RT = tf.lite.experimental.OpResolverType
SSD_SIZE = 128          # full width (300) is chip_smoke.py's


def interpreter(path, x, resolver="BUILTIN_REF"):
    ip = tf.lite.Interpreter(
        model_path=path, experimental_op_resolver_type=getattr(RT, resolver),
        experimental_preserve_all_tensors=True)
    ip.allocate_tensors()
    ip.set_tensor(ip.get_input_details()[0]["index"], x)
    ip.invoke()
    return ip


@functools.lru_cache(maxsize=None)
def jax_env_fn(path):
    """The JAX executor's jitted apply returning every tensor (one compile
    a file)."""
    ex = jq.QGraphExecutor(path, conv_impl="portable")
    run = jax.jit(lambda c, x: ex.apply(c, x, return_env=True))
    return ex, lambda x: run(ex.consts, jnp.asarray(x))


def port_env(path, x, conv_impl="auto"):
    ex = pq.QGraphExecutor(path, conv_impl=conv_impl, device="cpu")
    return ex, ex.apply(torch.from_numpy(np.ascontiguousarray(x)),
                        return_env=True)


def assert_envs_equal(ex, env, jenv_rows, ip=None, softmax_atol=None):
    """Every op output of the port (batch N) equal to the JAX executor's
    (one env a row) and, for row 0, to the interpreter's."""
    for qop in ex.ops:
        ti = qop.outputs[0]
        got = env[ti].numpy()
        pairs = [(r, np.asarray(j[ti])) for r, j in enumerate(jenv_rows)]
        if ip is not None:
            pairs.append((0, ip.get_tensor(ti)))
        for r, ref in pairs:
            row = got[r][None]
            assert row.dtype == ref.dtype, qop.name
            if softmax_atol and qop.code == pq.SOFTMAX:
                np.testing.assert_allclose(row, ref, rtol=0,
                                           atol=softmax_atol,
                                           err_msg=qop.name)
            else:
                np.testing.assert_array_equal(row, ref, err_msg=qop.name)


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def tiny_int8(tmp_path_factory):
    """tests/test_qgraph.py's tiny full-integer graph (MUL, SUB, CONV_2D,
    DEPTHWISE_CONV_2D, residual ADD, RESHAPE, FULLY_CONNECTED)."""
    rng = np.random.RandomState(5)
    k0 = rng.normal(0, 0.4, (3, 3, 3, 8)).astype(np.float32)
    kd = rng.normal(0, 0.4, (3, 3, 8, 1)).astype(np.float32)
    kp = rng.normal(0, 0.4, (1, 1, 8, 8)).astype(np.float32)
    kf = rng.normal(0, 0.2, (8 * 8 * 8, 10)).astype(np.float32)
    b0 = rng.normal(0, 0.1, 8).astype(np.float32)

    class M(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec((1, 16, 16, 3), tf.float32)])
        def __call__(self, img):
            x = img * (2.0 / 255.0) - 1.0
            x = tf.nn.relu6(tf.nn.conv2d(x, k0, 2, "SAME") + b0)
            y = tf.nn.relu6(tf.nn.depthwise_conv2d(x, kd, (1, 1, 1, 1),
                                                   "SAME"))
            x = x + tf.nn.conv2d(y, kp, 1, "SAME")
            return tf.matmul(tf.reshape(x, (1, -1)), kf)

    m = M()
    conv = tf.lite.TFLiteConverter.from_concrete_functions(
        [m.__call__.get_concrete_function()], m)

    def rep():
        r = np.random.RandomState(1)
        for _ in range(8):
            yield [r.uniform(0, 255, (1, 16, 16, 3)).astype(np.float32)]

    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.representative_dataset = rep
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    conv.inference_input_type = tf.uint8
    conv.inference_output_type = tf.float32
    path = str(tmp_path_factory.mktemp("q") / "tiny_int8.tflite")
    with open(path, "wb") as f:
        f.write(conv.convert())
    return path


@pytest.fixture(scope="module")
def legacy_u8(tmp_path_factory):
    from pp_builder import build_legacy_uint8_detector, \
        build_legacy_uint8_model
    d = tmp_path_factory.mktemp("legacy")
    out = {}
    for name, build in (("model", build_legacy_uint8_model),
                        ("detector", build_legacy_uint8_detector)):
        out[name] = str(d / f"legacy_{name}_u8.tflite")
        with open(out[name], "wb") as f:
            f.write(build())
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """chip_smoke.py's full-integer files: SSD-MobileNetV1 at SSD_SIZE with
    the postprocess op, MARS, and the per-op graphs."""
    d = tmp_path_factory.mktemp("written")
    ssd = SSDMobileNetV1()
    chip_smoke._calibrated_init(
        ssd, torch.Generator().manual_seed(0),
        chip_smoke._calibration_images(SSD_SIZE, SSD_SIZE))
    mars = MarsNet()
    chip_smoke._calibrated_init(mars, torch.Generator().manual_seed(1),
                                chip_smoke._calibration_images(128, 64))
    calib = chip_smoke._calibration_images(SSD_SIZE, SSD_SIZE).numpy()
    graphs = {
        "ssd": chip_smoke.quantized_ssd_graph(
            ssd, SSD_SIZE, calib, chip_smoke._ssd_pp_options()),
        "mars": chip_smoke.quantized_mars_graph(
            mars, chip_smoke._calibration_images(128, 64).numpy())}
    graphs.update(chip_smoke.quantized_op_graphs())
    out = {"calib": calib}
    for name, g in graphs.items():
        out[name] = str(d / f"{name.lower()}_int8.tflite")
        with open(out[name], "wb") as f:
            f.write(g.tflite())
    return out


# ---------------------------------------------------------------- options

def _schema_options(path):
    from tensorflow.lite.python import schema_py_generated as fb
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    sg = fb.Model.GetRootAsModel(buf, 0).Subgraphs(0)
    return [sg.Operators(i) for i in range(sg.OperatorsLength())], fb


def test_builtin_options_match_tf_schema(tiny_int8, legacy_u8, written):
    """Every options table the executor reads, field by field, against
    TF's generated reader (which applies the schema's defaults)."""
    seen = set()
    paths = [tiny_int8, legacy_u8["model"], legacy_u8["detector"]] + [
        p for k, p in written.items() if k != "calib"]
    for path in paths:
        model = tflite_meta.read_model(path)
        ops, fb = _schema_options(path)
        assert len(ops) == len(model.operators)
        for ours, theirs in zip(model.operators, ops):
            assert ours.builtin_options_type == theirs.BuiltinOptionsType()
            spec = tflite_meta.OPTION_TABLES.get(ours.builtin_options_type)
            if spec is None:
                continue
            table = getattr(fb, spec[0])()
            raw = theirs.BuiltinOptions()
            table.Init(raw.Bytes, raw.Pos)
            for field, *_ in spec[1]:
                getter = "".join(p.capitalize() for p in field.split("_"))
                assert ours.builtin_options[field] == \
                    getattr(table, getter)(), (path, spec[0], field)
            seen.add(spec[0])
    assert {"Conv2DOptions", "DepthwiseConv2DOptions",
            "FullyConnectedOptions", "Pool2DOptions", "AddOptions",
            "SubOptions", "MulOptions", "ConcatenationOptions",
            "StridedSliceOptions", "ResizeNearestNeighborOptions",
            "SoftmaxOptions"} <= seen


def test_absent_options_read_as_schema_defaults():
    """A missing field is the schema's default (dilation 1, not 0)."""
    opts = tflite_meta.read_options(1, None)
    assert opts["dilation_w_factor"] == opts["dilation_h_factor"] == 1
    assert opts["stride_w"] == 0 and opts["padding"] == 0
    assert tflite_meta.read_options(11, None)["pot_scale_int16"] is True
    assert tflite_meta.read_options(99, None) == {}


# ---------------------------------------------------------------- graphs

def test_tiny_int8_every_tensor_exact(tiny_int8, rng):
    x = rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    ex, env = port_env(tiny_int8, x)
    assert ex.impl == "portable"
    _, jrun = jax_env_fn(tiny_int8)
    ip = interpreter(tiny_int8, x[:1])
    assert_envs_equal(ex, env, [jrun(x[r:r + 1]) for r in range(3)], ip)
    assert len(ex.ops) >= 8


@pytest.mark.parametrize("impl", ["mxu", "xconv"])
def test_tiny_int8_conv_forms_agree(tiny_int8, rng, impl):
    x = rng.randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    ref, env = port_env(tiny_int8, x, "portable")
    ex, got = port_env(tiny_int8, x, impl)
    for qop in ex.ops:
        np.testing.assert_array_equal(got[qop.outputs[0]].numpy(),
                                      env[qop.outputs[0]].numpy())


def test_legacy_uint8_graph_exact(legacy_u8, rng):
    """The legacy per-tensor uint8 scheme (weight zero points), all three
    forms: the mxu and xconv forms need the weight zero point's row sums
    and the static offset maps."""
    path = legacy_u8["model"]
    x = rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    _, jrun = jax_env_fn(path)
    jenvs = [jrun(x[r:r + 1]) for r in range(2)]
    ip = interpreter(path, x[:1])
    for impl in ("portable", "mxu", "xconv"):
        ex, env = port_env(path, x, impl)
        assert all(env[q.outputs[0]].dtype == torch.uint8 for q in ex.ops)
        assert_envs_equal(ex, env, jenvs, ip)


def test_topk_past_the_row_length_matches_jax():
    """Fault found porting the quantized detector: with fewer anchors than
    top_k (the legacy raw-heads file has 64, top_k is 100) the JAX
    package's rank-matrix top-k fills the slots past the row with index 0;
    the port's sort-based one returned only the row and the SSD
    postprocess failed on the shapes."""
    from deepdish_tpu.ops.onehot import topk_desc as j_topk
    from deepdish_tpu_torch.ops.onehot import topk_desc as p_topk
    scores = np.array([0.2, 0.9, 0.2, 0.5, 0.9], np.float32)
    for k in (3, 5, 8):
        vals, idx = p_topk(torch.from_numpy(scores), k)
        jvals, jidx = j_topk(jnp.asarray(scores), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    vals, idx = p_topk(torch.from_numpy(np.stack([scores, scores[::-1]])), 7)
    assert idx.shape == (2, 7) and idx[1, 5:].tolist() == [0, 0]


def test_legacy_uint8_detector(legacy_u8, rng):
    """A raw-heads legacy uint8 detector through QuantizedSSDDetector:
    head tensors equal to the JAX executor's dequantized ones, detections
    the JAX detector's."""
    path = legacy_u8["detector"]
    anchors = np.stack([np.linspace(0.1, 0.9, 64), np.linspace(0.2, 0.8, 64),
                        np.full(64, 0.3), np.full(64, 0.25)],
                       axis=1).astype(np.float32)
    det = pq.QuantizedSSDDetector(path, score_threshold=0.3, max_outputs=8,
                                  anchors=anchors, device="cpu")
    jdet = jq.QuantizedSSDDetector(path, score_threshold=0.3, max_outputs=8,
                                   anchors=anchors)
    x = rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    _compare_detectors(det, jdet, x, env_path=path)


# ---------------------------------------------------------------- writer

def test_writer_ssd_full_width_exact(written):
    """chip_smoke.py's full-integer SSD-MobileNetV1 (full widths, 91
    classes, LOGISTIC, DEQUANTIZE, the postprocess op): the reference
    interpreter runs it, and every tensor of the port equals the
    interpreter's and the JAX executor's."""
    path = written["ssd"]
    x = np.clip(written["calib"][:2] + 0.5, 0, 255).astype(np.uint8)
    ex, env = port_env(path, x)
    assert ex.stopped_at_custom and len(ex.ops) == 65
    _, jrun = jax_env_fn(path)
    ip = interpreter(path, x[:1])
    assert_envs_equal(ex, env, [jrun(x[r:r + 1]) for r in range(2)], ip)
    n = ip.get_tensor(ip.get_output_details()[3]["index"])
    assert float(n[0]) == chip_smoke.TFLITE_MAX_DETECTIONS


def test_writer_mars_exact(written):
    """chip_smoke.py's full-integer MARS (float input, int8 ELU, MAX_POOL,
    MUL + ADD batch norms, L2_NORMALIZATION, DEQUANTIZE): every tensor
    equal to the JAX executor's; op by op on the interpreter's own inputs,
    equal to its default kernels except CONV_2D / FULLY_CONNECTED within
    1 LSB (TFLite's optimized int8 convolutions; the SSD above holds the
    same arithmetic exact against the reference kernels)."""
    path = written["mars"]
    x = np.random.RandomState(3).randint(
        0, 256, (2,) + INPUT_SHAPE).astype(np.float32)
    ex, env = port_env(path, x)
    jex, jrun = jax_env_fn(path)
    assert_envs_equal(ex, env, [jrun(x[r:r + 1]) for r in range(2)])
    ip = interpreter(path, x[:1], "BUILTIN_WITHOUT_DEFAULT_DELEGATES")
    codes = set()
    for qop in ex.ops:
        def get(ti):
            if ti in ex._const_idx:
                return ex._get_const(ti)
            return torch.from_numpy(ip.get_tensor(ti))
        got = ex.run_op(qop, get).numpy()
        ref = ip.get_tensor(qop.outputs[0])
        codes.add(qop.code)
        if qop.code in (pq.CONV, pq.FC):
            assert np.abs(got.astype(np.int64) - ref).max() <= 1, qop.name
        else:
            np.testing.assert_array_equal(got, ref, err_msg=qop.name)
    assert {pq.ELU, pq.MAX_POOL, pq.L2_NORM, pq.QUANTIZE, pq.DEQUANTIZE,
            pq.MUL, pq.ADD, pq.FC, pq.RESHAPE} <= codes


@pytest.mark.parametrize("op", ["LOGISTIC", "RESIZE_NEAREST_NEIGHBOR",
                                "CONCATENATION", "STRIDED_SLICE", "PAD",
                                "TILE", "AVERAGE_POOL_2D", "SUB", "MUL",
                                "SOFTMAX"])
def test_writer_op_graph_exact(written, op):
    path = written[op]
    x = np.random.RandomState(4).randint(-128, 128,
                                         (3, 8, 8, 16)).astype(np.int8)
    ex, env = port_env(path, x)
    _, jrun = jax_env_fn(path)
    ip = interpreter(path, x[:1])
    assert_envs_equal(ex, env, [jrun(x[r:r + 1]) for r in range(3)], ip,
                      softmax_atol=5e-7)


def test_batch_axis_ops_refuse_to_mix_frames(tmp_path):
    """An op on axis 0 cannot carry a batch: it raises for N > 1 and runs
    at N = 1."""
    g = chip_smoke.QuantGraph((1, 8, 8, 16), dtype="int8", qparams=(0.05, 3))
    g.outputs = [g.concat(["input", "input"], 0)]
    g.calibrate(np.zeros((1, 8, 8, 16), np.float32))
    path = str(tmp_path / "concat0.tflite")
    with open(path, "wb") as f:
        f.write(g.tflite())
    ex = pq.QGraphExecutor(path, device="cpu")
    assert ex.apply(torch.zeros((1, 8, 8, 16), dtype=torch.int8))[0] \
        .shape == (2, 8, 8, 16)
    with pytest.raises(NotImplementedError, match="batch axis"):
        ex.apply(torch.zeros((2, 8, 8, 16), dtype=torch.int8))


# ---------------------------------------------------------------- detectors

def _compare_detectors(det, jdet, x, env_path=None, w=640.0, h=360.0):
    """Port detections on the batch x against the JAX detector's frame by
    frame; with `env_path` (a file of the same content) the head tensors
    exactly, against the JAX executor's outputs."""
    xt = torch.from_numpy(x)
    if env_path is not None:
        q = det.quantize_input(xt)
        outs = det.executor.apply(q)
        jex, jrun = jax_env_fn(env_path)
        for i in range(len(x)):
            jenv = jrun(q[i:i + 1].numpy())
            for o, t in zip(outs, jex.output_idxs):
                np.testing.assert_array_equal(o[i:i + 1].numpy(),
                                              np.asarray(jenv[t]))
    got = [t.numpy() for t in det.detect(xt, w, h)]
    for i, f in enumerate(x):
        want = [np.asarray(t) for t in jdet.detect_jit(
            jnp.asarray(f), jnp.float32(w), jnp.float32(h))]
        np.testing.assert_array_equal(got[3][i], want[3])
        np.testing.assert_array_equal(got[1][i][got[3][i]],
                                      want[1][want[3]])
        np.testing.assert_allclose(got[0][i], want[0], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got[2][i], want[2], rtol=1e-5, atol=1e-6)
    return got


@pytest.mark.parametrize("family", ["ssd", "efficientdet"])
def test_quantized_ssd_detector_matches_jax(written, tmp_path, family):
    """Both registries on the written SSD file, named for each family:
    the fused op's anchors, scales, threshold and max_detections, its
    background rule, and (EfficientDet) the allow / deny / max_results
    filter, set from the classes the unfiltered detector finds."""
    import shutil
    name = {"ssd": "ssd_mobilenet_v1_quant_postprocess.tflite",
            "efficientdet": "efficientdet_lite0_int8.tflite"}[family]
    path = str(tmp_path / name)
    shutil.copy(written["ssd"], path)
    x = np.clip(written["calib"][:2] + 0.5, 0, 255).astype(np.uint8)
    kw = dict(quantized=True, score_threshold=0.3, max_outputs=16)
    if family == "efficientdet":
        plain = create_detector(path, device="cpu", **kw)
        _, classes, _, valid = plain.detect(torch.from_numpy(x), 640., 360.)
        found = sorted({plain.labels[int(c)] for c in classes[valid]
                        if int(c) in plain.labels})
        assert len(found) >= 3
        kw.update(label_allow=found[:3] + ["person"], label_deny=found[:1],
                  max_results=2)
    det = create_detector(path, device="cpu", **kw)
    jdet = j_registry.create_detector(path, **kw)
    assert isinstance(det, pq.QuantizedSSDDetector)
    assert det._pp_num_classes == jdet._pp_num_classes == 90
    assert det.detections_cap == jdet.detections_cap
    assert det.labels == jdet.labels
    got = _compare_detectors(det, jdet, x, env_path=written["ssd"])
    assert got[3].sum() > 0
    if family == "efficientdet":
        assert got[3].sum(1).max() <= 2


@pytest.fixture(scope="module")
def yolov5_int8(tmp_path_factory):
    """A small full-integer YOLOv5-shaped file written with chip_smoke's
    QuantGraph: int8 input at scale 1/255, zero point -128 (the
    reference's contract), SiLU as MUL by LOGISTIC, an upsampling
    RESIZE_NEAREST_NEIGHBOR + CONCATENATION, and three raw heads of 3 x 85
    channels at strides 8, 16 and 32 of a 64 x 64 input."""
    rng = np.random.RandomState(11)
    g = chip_smoke.QuantGraph((1, 64, 64, 3), dtype="int8",
                              qparams=(1 / 255, -128))

    def conv(x, cin, cout, k=3, s=1):
        y = g.conv(x, rng.normal(0, 1.0 / np.sqrt(k * k * cin),
                                 (k, k, cin, cout)),
                   rng.normal(0, 0.1, cout), stride=s)
        return g.binary("mul", y, g.unary("logistic", y))
    x = conv(conv(conv("input", 3, 16, s=2), 16, 32, s=2), 32, 32, s=2)
    p4 = conv(x, 32, 48, s=2)
    p5 = conv(p4, 48, 64, s=2)
    up = g.resize_nn(p5, (4, 4))
    p4 = conv(g.concat([p4, up], 3), 112, 48, k=1)
    heads = [g.conv(f, rng.normal(0, 0.3, (1, 1, c, 255)),
                    rng.normal(0, 0.5, 255))
             for f, c in ((x, 32), (p4, 48), (p5, 64))]
    g.outputs = [heads[2], heads[0], heads[1]]
    g.calibrate(rng.uniform(0, 1, (4, 64, 64, 3)))
    path = str(tmp_path_factory.mktemp("y5") / "yolov5s_int8.tflite")
    with open(path, "wb") as f:
        f.write(g.tflite())
    return path


def test_quantized_yolov5_detector_matches_jax(yolov5_int8):
    """The registry's 'yolov5' dispatch on both sides; the truncating
    int8 input cast; the heads sorted by size; detections equal."""
    det = create_detector(yolov5_int8, quantized=True, max_outputs=16,
                          device="cpu")
    jdet = j_registry.create_detector(yolov5_int8, quantized=True,
                                      max_outputs=16)
    assert isinstance(det, pq.QuantizedYOLOv5Detector)
    assert (det.width, det.height) == (jdet.width, jdet.height) == (64, 64)
    x = np.random.RandomState(5).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    q = det.quantize_input(torch.from_numpy(x)).numpy()
    xf = x / np.float32(255.0) / np.float32(det._in_scale) + det._in_zp
    np.testing.assert_array_equal(q, np.clip(xf, -128, 127).astype(np.int8))
    got = _compare_detectors(det, jdet, x, env_path=yolov5_int8)
    assert got[3].sum() > 0


def test_quantized_mars_encoder_matches_jax(written):
    """The encoder factory on the written full-integer MARS: the integer
    datapath on both sides, features equal to the JAX encoder's."""
    from deepdish_tpu.models.encoders import \
        create_box_encoder as j_create_box_encoder
    enc = create_box_encoder(written["mars"], device="cpu")
    jenc = j_create_box_encoder(written["mars"])
    assert isinstance(enc.executor, pq.QGraphExecutor)
    assert enc.image_shape == jenc.image_shape and enc.feature_dim == 128
    patches = np.random.RandomState(9).uniform(
        0, 255, (3,) + INPUT_SHAPE).astype(np.float32)
    with torch.inference_mode():
        got = enc.apply(torch.from_numpy(patches)).numpy()
    _, jrun = jax_env_fn(written["mars"])
    jex = jax_env_fn(written["mars"])[0]
    for i, p in enumerate(patches):
        out = np.asarray(jrun(p[None])[jex.output_idxs[0]], np.float64)
        want = out.reshape(-1) / np.sqrt(1e-8 + np.sum(out * out))
        np.testing.assert_allclose(got[i], want, atol=1e-6)


def test_registry_quantized_refusals(written, tmp_path):
    """--quantized-inference needs an existing full-integer .tflite; a
    YOLOv3 name is not a quantized family; a float file is refused with
    the JAX message."""
    with pytest.raises(ValueError, match="full-integer .tflite"):
        create_detector("ssd_mobilenet", quantized=True, device="cpu")
    import shutil
    y3 = str(tmp_path / "yolov3_int8.tflite")
    shutil.copy(written["ssd"], y3)
    with pytest.raises(NotImplementedError, match="YOLOv5"):
        create_detector(y3, quantized=True, device="cpu")
    g = chip_smoke.QuantGraph((1, 8, 8, 16), dtype="float32")
    g.outputs = [g.unary("softmax", "input")]
    g.calibrate(np.zeros((1, 8, 8, 16), np.float32))
    fpath = str(tmp_path / "ssd_float.tflite")
    with open(fpath, "wb") as f:
        f.write(g.tflite())
    with pytest.raises(ValueError, match="full-integer"):
        pq.QuantizedSSDDetector(fpath, device="cpu")
    with pytest.raises(ValueError, match="conv_impl"):
        pq.QGraphExecutor(written["ssd"], conv_impl="fast", device="cpu")
