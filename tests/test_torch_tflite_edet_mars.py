"""Port parity of the structural weight path for EfficientDet-Lite0 and the
MARS encoder, of the TFLite metadata, flexbuffer and host-executor readers,
and of chip_smoke.py's flatbuffer writer, against the JAX package on the
CPU (tests/test_torch_tflite_ssd.py's helpers and checks):

  * EfficientDet-Lite0: tests/test_efficientdet_real_tflite.py
    `_make_efficientdet_tflite` with a TFLite_Detection_PostProcess op
    (tests/pp_builder.py, the export's normalized anchors and unit scales)
    and packed metadata (tests/test_tflite_meta.py's builders: mean / std
    and a label file): readers, slot lists (the box / class towers bind by
    signature), conversion, and the detector each registry builds from it
    (pixel anchors, scales, thresholds, detections_cap, normalization,
    labels) on two images;
  * MARS: tests/test_convert.py's Keras slim mirror converted to a float
    and a dynamic-range .tflite (pre-activation batch norms as MUL + ADD):
    readers, slots, conversions, and the encoder of each factory (features
    within 2e-5, tests/test_torch_models' MARS tolerance); a full-integer
    MARS (tests/mars_builder.py) runs on both packages' integer datapaths
    with equal integer tensors;
  * the fold round trips of both and the strict failure (MARS, the
    tests/test_convert.py pattern), with no tensorflow;
  * `read_metadata` on tests/test_tflite_meta.py's tiny model with and
    without metadata; `TFLiteHostDetector` on a tiny detection-output
    model with metadata;
  * the flexbuffer map decoder against flatbuffers.flexbuffers.Loads on
    the postprocess options and on hypothesis-drawn maps of int, float and
    bool (and indirect scalars); any other type raises;
  * chip_smoke.py `write_tflite`: a MARS donor's file read alike by the
    JAX reader (TF's schema) and the port's, converting back to the
    donor."""
import functools

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import numpy as np
import torch

import deepdish_tpu.models.encoders as j_encoders
import deepdish_tpu.models.registry as j_registry
from deepdish_tpu.models import convert as jcv
from deepdish_tpu.models import efficientdet as jed
from deepdish_tpu.models.mars import INPUT_SHAPE, MarsNet as JMars
from deepdish_tpu.models.weights import _flatten
from deepdish_tpu_torch.models import convert as pcv
from deepdish_tpu_torch.models import create_box_encoder, create_detector
from deepdish_tpu_torch.models import efficientdet as ped
from deepdish_tpu_torch.models import mars as pmars
from deepdish_tpu_torch.models import tflite_meta
from deepdish_tpu_torch.models import weights as pw
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tflite_ssd import (bind_jax_trace, detector_matches,
                                   fold_roundtrip, image, jax_conversion,
                                   jax_trace, same_flat, same_readers,
                                   same_report, same_slots)

pytestmark = pytest.mark.timeout(300)
F32 = jnp.float32
LABELS = ["person", "bicycle", "car"]


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def jax_f32():
    """The JAX registry's EfficientDet and its MARS factory in float32,
    with the cached trace."""
    with pytest.MonkeyPatch.context() as mp:
        bind_jax_trace(mp)
        mp.setattr(j_registry, "EfficientDetLite0Detector",
                   functools.partial(jed.EfficientDetLite0Detector,
                                     compute_dtype=F32))
        mp.setattr(j_encoders, "make_mars_encoder", functools.partial(
            j_encoders.make_mars_encoder, compute_dtype=F32))
        yield


def _with_metadata(blob, mean, std, labels):
    from test_tflite_meta import (_append_zip, _attach_metadata,
                                  _build_metadata)
    blob = _attach_metadata(blob, _build_metadata(mean, std))
    return _append_zip(blob, {"labels.txt": "\n".join(labels) + "\n"})


# ---------------------------------------------------------------- EfficientDet

@pytest.fixture(scope="module")
def edet_files(tf, tmp_path_factory):
    from pp_builder import append_detection_postprocess
    from test_efficientdet_real_tflite import NC, _make_efficientdet_tflite
    d = tmp_path_factory.mktemp("edet")
    raw = _make_efficientdet_tflite(d)
    anchors = jed.generate_anchors() / float(jed.INPUT_SIZE)
    A = len(anchors)
    blob = append_detection_postprocess(
        open(raw, "rb").read(), anchors, box_shape=(A, 4),
        score_shape=(A, NC), num_classes=NC, y_scale=1.0, x_scale=1.0,
        h_scale=1.0, w_scale=1.0, nms_score_threshold=0.4,
        nms_iou_threshold=0.6, max_detections=25, use_regular_nms=False)
    pp = str(d / "efficientdet_lite0_pp.tflite")
    with open(pp, "wb") as f:
        f.write(_with_metadata(blob, [127.5], [127.5], LABELS))
    return {"raw": raw, "postprocess": pp}


@pytest.mark.parametrize("kind", ["raw", "postprocess"])
def test_efficientdet_readers_match_jax(edet_files, kind):
    pp = same_readers(edet_files[kind])
    assert (pp is not None) == (kind == "postprocess")
    got = tflite_meta.read_metadata(edet_files[kind])
    from deepdish_tpu.models.tflite_meta import read_metadata
    assert got == read_metadata(edet_files[kind])
    if kind == "postprocess":
        assert got == {"mean": [127.5], "std": [127.5],
                       "label_file": "labels.txt", "labels": LABELS}


def test_efficientdet_slots_match_jax():
    with torch.device("meta"):
        _, slots = pcv.trace_slots(ped.EfficientDetLite0(),
                                   (1, 320, 320, 3))
    same_slots(slots, jax_trace(jed.EfficientDetLite0(), (320, 320, 3))[1])


def test_efficientdet_conversion_and_detector_match_jax(edet_files,
                                                        jax_f32):
    path = edet_files["postprocess"]
    jvars, jslots = jax_trace(jed.EfficientDetLite0(), (320, 320, 3))
    got, rep = pcv.load_efficientdet_tflite(path)
    want, wrep = jax_conversion(jslots, jvars, path)
    wrep = jcv._attach_postprocess(path, wrep, jed.generate_anchors()
                                   / float(jed.INPUT_SIZE))
    same_report(rep, wrep)
    assert rep["assigned"] == rep["total"] == len(jslots)
    assert not rep["missing"] and not rep["unused_ops"]
    assert rep["anchors_verified"]
    same_flat(got, want)

    jdet = j_registry.create_detector(path)
    pdet = create_detector(path, device="cpu", compute_dtype=torch.float32)
    assert pdet.labels == jdet.labels == dict(enumerate(LABELS))
    assert pdet.box_scale == jdet.box_scale == (1.0, 1.0, 1.0, 1.0)
    assert pdet.detections_cap == jdet.detections_cap == 25
    assert pdet.score_threshold == jdet.score_threshold == 0.5
    assert pdet.iou_threshold == jdet.iou_threshold
    np.testing.assert_array_equal(pdet.anchors.numpy(),
                                  np.asarray(jdet.anchors))
    assert tuple(pdet.net.norm_mean.tolist()) == jdet.net.norm_mean \
        == (127.5,)
    same_flat(pw.to_flax(pdet.net), want)
    assert 0 < max(detector_matches(jdet, pdet, 320, seeds=(5, 6))) <= 25


def test_efficientdet_fold_roundtrip_matches_jax():
    fold_roundtrip(jed.EfficientDetLite0(), (320, 320, 3),
                   ped.EfficientDetLite0, (1, 320, 320, 3),
                   pw.efficientdet_from_flax, seed=51,
                   x=image(52, 320)[None])


# ---------------------------------------------------------------- MARS

@pytest.fixture(scope="module")
def mars_files(tf, tmp_path_factory):
    from mars_builder import make_mars_int8_tflite
    from test_convert import _keras_mars, _randomize_keras_bn
    d = tmp_path_factory.mktemp("mars")
    model = _keras_mars(tf)
    _randomize_keras_bn(model)
    out = {}
    for kind in ("float", "dynamic"):
        conv = tf.lite.TFLiteConverter.from_keras_model(model)
        if kind == "dynamic":
            conv.optimizations = [tf.lite.Optimize.DEFAULT]
        out[kind] = str(d / f"mars_{kind}.tflite")
        with open(out[kind], "wb") as f:
            f.write(conv.convert())
    out["full_int8"] = make_mars_int8_tflite(d)
    return out


def test_mars_slots_match_jax():
    with torch.device("meta"):
        _, slots = pcv.trace_slots(pmars.MarsNet(), (1,) + INPUT_SHAPE)
    same_slots(slots, jax_trace(JMars(), (1,) + INPUT_SHAPE)[1])
    assert sum(s.kind == "bn" for s in slots) == 6


@pytest.mark.parametrize("kind", ["float", "dynamic", "full_int8"])
def test_mars_readers_match_jax(mars_files, kind):
    same_readers(mars_files[kind])
    # the integer executor takes the full-integer file and refuses the
    # others (which then convert structurally)
    from deepdish_tpu_torch.models.qgraph import QGraphExecutor
    try:
        QGraphExecutor(mars_files[kind], device="cpu")
        accepted = True
    except (NotImplementedError, ValueError):
        accepted = False
    assert accepted == (kind == "full_int8")


@pytest.mark.parametrize("kind", ["float", "dynamic"])
def test_mars_conversion_and_encoder_match_jax(mars_files, jax_f32, kind):
    """load_mars against the JAX conversion; create_box_encoder on the
    file against the JAX factory's (which tries its integer executor
    first and falls back to the same structural conversion)."""
    path = mars_files[kind]
    jvars, jslots = jax_trace(JMars(), (1,) + INPUT_SHAPE)
    got, rep = pcv.load_mars(path)
    want, wrep = jax_conversion(jslots, jvars, path)
    assert rep == wrep and not rep["missing"] and not rep["unused_ops"]
    assert rep["assigned"] == rep["total"] == 23
    same_flat(got, want)
    patches = np.random.RandomState(7).uniform(
        0, 255, (3,) + INPUT_SHAPE).astype(np.float32)
    enc = create_box_encoder(path, device="cpu")
    jenc = j_encoders.create_box_encoder(path)
    with torch.inference_mode():
        feats = enc.apply(torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(feats,
                               np.asarray(jenc.apply(jnp.asarray(patches))),
                               atol=2e-5)


def test_mars_full_integer_raises(mars_files):
    """A full-integer MARS runs on the integer datapath in both packages
    (never on dequantized float weights): the factory's encoder is the
    executor's, every integer tensor equals the JAX executor's, the float
    ELU islands within 2 ulp of 1 (expm1 of two libraries), and the
    features are the JAX encoder's (its output, normalized)."""
    import jax
    from deepdish_tpu.models.qgraph import QGraphExecutor as JQ
    path = mars_files["full_int8"]
    enc = create_box_encoder(path, device="cpu")
    jenc = j_encoders.create_box_encoder(path)
    assert enc.feature_dim == jenc.feature_dim == 128
    patches = np.random.RandomState(8).uniform(
        0, 255, (2,) + INPUT_SHAPE).astype(np.float32)
    ex = enc.executor
    env = ex.apply(torch.from_numpy(patches), return_env=True)
    jex = JQ(path, conv_impl="portable")
    run = jax.jit(lambda c, x: jex.apply(c, x, return_env=True))
    for r in range(len(patches)):
        jenv = run(jex.consts, jnp.asarray(patches[r:r + 1]))
        for qop in ex.ops:
            got = env[qop.outputs[0]][r:r + 1].numpy()
            want = np.asarray(jenv[qop.outputs[0]])
            assert got.dtype == want.dtype, qop.name
            if got.dtype == np.float32 and qop.code == 111:      # ELU
                # expm1 in (-1, 0] of two libraries: within 2 ulp of 1
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1.2e-7, err_msg=qop.name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=qop.name)
        # the JAX encoder's features: the dequantized output, normalized
        out = np.asarray(jenv[jex.output_idxs[0]], np.float64).reshape(-1)
        want = out / np.sqrt(1e-8 + np.sum(out * out))
        with torch.inference_mode():
            feats = enc.apply(torch.from_numpy(patches[r:r + 1])).numpy()
        np.testing.assert_allclose(feats[0], want, atol=1e-6)


def test_mars_fold_roundtrip_matches_jax():
    fold_roundtrip(JMars(), (1,) + INPUT_SHAPE, pmars.MarsNet,
                   (1,) + INPUT_SHAPE, pw.mars_from_flax, seed=61,
                   x=np.random.RandomState(62).uniform(
                       0, 255, (2,) + INPUT_SHAPE).astype(np.float32),
                   strict=True)


def test_writer_mars_roundtrip(tmp_path):
    """chip_smoke.py's numpy-only writer on a MARS donor: TF's schema and
    the port read the file alike, both packages convert it alike, and the
    conversion gives the donor's features."""
    import chip_smoke
    donor = pmars.MarsNet()
    chip_smoke._calibrated_init(donor, torch.Generator().manual_seed(3),
                                chip_smoke._calibration_images(128, 64))
    path = str(tmp_path / "mars_written.tflite")
    with open(path, "wb") as f:
        f.write(chip_smoke.written_tflite(donor, (1,) + INPUT_SHAPE))
    same_readers(path)
    jvars, jslots = jax_trace(JMars(), (1,) + INPUT_SHAPE)
    got, rep = pcv.load_mars(path)
    want, wrep = jax_conversion(jslots, jvars, path)
    assert rep == wrep and rep["assigned"] == rep["total"]
    assert not rep["unused_ops"]
    same_flat(got, want)
    net = pmars.MarsNet()
    net.load_state_dict(pw.mars_from_flax(got))
    x = chip_smoke._calibration_images(128, 64)
    with torch.inference_mode():
        np.testing.assert_allclose(net.eval()(x).numpy(),
                                   donor.eval()(x).numpy(), atol=1e-5)


# ---------------------------------------------------------------- metadata

@pytest.fixture(scope="module")
def tiny_tflite(tf):
    """tests/test_tflite_meta.py's tiny model (a channel mean)."""
    class M(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec((1, 8, 8, 3), tf.float32)])
        def __call__(self, x):
            return tf.reduce_mean(x, axis=(1, 2))

    m = M()
    return tf.lite.TFLiteConverter.from_concrete_functions(
        [m.__call__.get_concrete_function()], m).convert()


@pytest.mark.parametrize("with_meta", [True, False],
                         ids=["metadata", "absent"])
def test_read_metadata_matches_jax(tiny_tflite, tmp_path, with_meta):
    from deepdish_tpu.models.tflite_meta import read_metadata
    blob = (_with_metadata(tiny_tflite, [110.0, 115.0, 120.0], [55.0],
                           LABELS) if with_meta else tiny_tflite)
    path = str(tmp_path / "meta.tflite")
    with open(path, "wb") as f:
        f.write(blob)
    got = tflite_meta.read_metadata(path)
    assert got == read_metadata(path)
    assert got == ({"mean": [110.0, 115.0, 120.0], "std": [55.0],
                    "label_file": "labels.txt", "labels": LABELS}
                   if with_meta else {})


def test_host_detector_matches_jax(tf, tmp_path):
    """TFLiteHostDetector of both packages on a tiny model whose outputs
    are a detection postprocess's (boxes, classes, scores, count), with
    metadata mean / std and labels."""
    from deepdish_tpu.models.tflite_host import TFLiteHostDetector as JHost
    from deepdish_tpu_torch.models.tflite_host import TFLiteHostDetector
    boxes = np.array([[[0.1, 0.1, 0.5, 0.4], [0.2, 0.5, 0.9, 0.8],
                       [0.0, 0.0, 0.3, 0.3], [0.6, 0.1, 0.9, 0.5]]],
                     np.float32)

    class M(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec((1, 32, 32, 3), tf.float32)])
        def __call__(self, x):
            m = tf.reduce_mean(x, axis=(1, 2, 3))
            b = tf.clip_by_value(boxes + 0.01 * m[:, None, None], 0.0, 1.0)
            s = tf.sigmoid(m[:, None] + tf.constant([[2.0, 1.0, -3.0, 0.5]]))
            return (b, tf.constant([[0.0, 2.0, 1.0, 0.0]]), s,
                    tf.constant([4.0]))

    m = M()
    blob = tf.lite.TFLiteConverter.from_concrete_functions(
        [m.__call__.get_concrete_function()], m).convert()
    path = str(tmp_path / "host.tflite")
    with open(path, "wb") as f:
        f.write(_with_metadata(blob, [100.0], [50.0], LABELS))
    kw = dict(wanted_labels=["person", "car"], score_threshold=0.3)
    frame = np.random.RandomState(4).randint(0, 256, (48, 64, 3)).astype(
        np.uint8)
    got = TFLiteHostDetector(path, **kw)
    want = JHost(path, **kw)
    assert (got.mean, got.std, got.labels) == \
        (want.mean, want.std, want.labels) == (100.0, 50.0,
                                               dict(enumerate(LABELS)))
    out = got.detect_host(frame)
    assert out == want.detect_host(frame)
    assert out[1] == ["person", "car", "person"]


# ---------------------------------------------------------------- flexbuffers

def test_flexbuffer_postprocess_options(edet_files):
    from flatbuffers import flexbuffers
    model = tflite_meta.read_model(edet_files["postprocess"])
    opts = [op.custom_options for op in model.operators
            if op.custom_options]
    assert len(opts) == 1
    got = tflite_meta.loads_flexbuffer_map(opts[0])
    assert got == flexbuffers.Loads(opts[0])
    assert got["max_detections"] == 25 and got["use_regular_nms"] is False


def test_flexbuffer_maps_match_loads():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    from flatbuffers import flexbuffers
    keys = st.text(st.characters(min_codepoint=1, max_codepoint=0x7f),
                   min_size=1, max_size=12)
    # (flexbuffers' own Builder fails on floats near the float32 limit)
    values = st.one_of(st.integers(-2 ** 63, 2 ** 63 - 1),
                       st.floats(-1e30, 1e30, allow_nan=False),
                       st.booleans())

    @hyp.settings(max_examples=300, deadline=None)
    @hyp.given(st.dictionaries(keys, values, max_size=12))
    def check(d):
        blob = flexbuffers.Dumps(d)
        got = tflite_meta.loads_flexbuffer_map(blob)
        want = flexbuffers.Loads(blob)
        assert got == want
        assert [type(v) for v in got.values()] == \
            [type(v) for v in want.values()]

    check()
    b = flexbuffers.Builder()
    with b.Map():
        b.IndirectInt("a", -5)
        b.IndirectUInt("b", 2 ** 40)
        b.IndirectFloat("c", 0.1)
        b.UInt("d", 200)
        b.Bool("e", True)
    blob = b.Finish()
    assert tflite_meta.loads_flexbuffer_map(blob) == flexbuffers.Loads(blob)


@pytest.mark.parametrize("obj", [{"s": "text"}, {"v": [1, 2]},
                                 {"m": {"a": 1}}, {"n": None}, 5],
                         ids=["string", "vector", "map", "null", "not_map"])
def test_flexbuffer_other_types_raise(obj):
    from flatbuffers import flexbuffers
    with pytest.raises(ValueError, match="flexbuffer"):
        tflite_meta.loads_flexbuffer_map(flexbuffers.Dumps(obj))
