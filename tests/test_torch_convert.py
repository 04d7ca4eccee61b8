"""Port parity of the name-map weight path (deepdish_tpu_torch/models/
convert.py, the flax templates of models/weights.py, the .pbtxt label
maps, SavedModel directories and MARS .pb / checkpoints) against the JAX
package on the CPU.

  * the port's flax templates have the keys and shapes of the JAX
    package's `_flatten(net.init(...))` (SSD-MobileNetV1, MARS, Faster
    R-CNN at TINY and at the zoo configuration), and the slots derived from
    them without a trace equal `trace_slots`' for every conv;
  * named tensors built in the test (the inverse name maps of
    tests/test_convert.py and tests/test_faster_rcnn.py) convert to flat
    dicts equal to `_flatten` of the JAX conversions key by key and array
    by array, with equal reports (Faster R-CNN at TINY and with a
    resnet_v1_50 (3, 4, 6, 3) layout, SSD unfolded and with one layer's
    batch norm folded, MARS), and the strict failures and the "not a TF-OD
    faster_rcnn" refusal raise alike;
  * with tensorflow installed: an SSD SavedModel directory converts like
    the JAX package's, a directory that is not a TF-OD export goes to the
    host executor with the JAX package's detections, a MARS frozen .pb and
    a TF checkpoint give the JAX encoder's features; without tensorflow
    (blocked in sys.modules) each of these raises ImportError rather than
    running on random weights.

The JAX converter runs with test_torch_frcnn's speed bindings
(`fast_jax_conversion`: a jitted, cached slot trace without its signature
pass, which the name-map converters do not read)."""
import dataclasses
import functools
import sys

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import numpy as np
import torch

from deepdish_tpu.models import convert as jcv
from deepdish_tpu.models import faster_rcnn as jf
from deepdish_tpu.models.mars import MarsNet as JMars
from deepdish_tpu.models.ssd_mobilenet import SSDMobileNetV1 as JSSD
from deepdish_tpu.models.weights import _flatten
from deepdish_tpu_torch.models import convert as pcv
from deepdish_tpu_torch.models import faster_rcnn as pf
from deepdish_tpu_torch.models import mars as pmars
from deepdish_tpu_torch.models import ssd_mobilenet as pssd
from deepdish_tpu_torch.models import weights as pw
from test_convert import _mars_reference_named_tensors, _ssd_tfod_named_tensors
from test_torch_frcnn import (TINY, fast_jax_conversion, port_config,
                              tfod_named_tensors, write_tf1_saved_model)
from test_torch_models import numpy_flax_variables

pytestmark = pytest.mark.timeout(300)
F32 = jnp.float32
RESNET50 = dataclasses.replace(TINY, block_units=(3, 4, 6, 3))
# the configuration convert_faster_rcnn_tfod infers from TINY's tensors
INFERRED_TINY = jf.FasterRCNNConfig(
    input_size=64, stem_features=TINY.stem_features,
    block_units=TINY.block_units, block_features=TINY.block_features,
    num_classes=TINY.num_classes, rpn_features=TINY.rpn_features)


@pytest.fixture(scope="module", autouse=True)
def fast_jax_convert():
    with pytest.MonkeyPatch.context() as mp:
        fast_jax_conversion(mp)
        yield


def _donor(net, shape, seed):
    """`net`'s JAX variables from a numpy seed (non-trivial batch norms)."""
    return numpy_flax_variables(net, jnp.zeros(shape, F32), seed=seed)


def _same_flat(got, want):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- templates

def _template_cases():
    return {
        "ssd": (lambda: pw.ssd_to_flax_template(pssd.SSDMobileNetV1()),
                lambda: (JSSD(), (300, 300, 3))),
        "mars": (lambda: pw.mars_to_flax_template(pmars.MarsNet()),
                 lambda: (JMars(), (1, 128, 64, 3))),
        "frcnn_tiny": (lambda: pw.faster_rcnn_to_flax_template(
            pf.FasterRCNNNet(port_config(TINY))),
            lambda: (jf.FasterRCNNNet(cfg=TINY), (64, 64, 3))),
        "frcnn_zoo": (lambda: pw.faster_rcnn_to_flax_template(
            pf.FasterRCNNNet(pf.FasterRCNNConfig())),
            lambda: (jf.FasterRCNNNet(), (640, 640, 3))),
    }


@pytest.mark.parametrize("case", list(_template_cases()))
def test_template_matches_jax_init(case):
    port, jax_net = _template_cases()[case]
    with torch.device("meta"):
        got = port()
    net, shape = jax_net()
    want = {jax.tree_util.keystr(path, simple=True, separator="/"): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(net.init, jax.random.PRNGKey(0),
                               jnp.zeros(shape, F32)))[0]}
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert not got[k].any()


@pytest.mark.parametrize("family", ["ssd", "frcnn"])
def test_template_slots_match_trace(family):
    """Every conv's and dense layer's path, kernel shape, bias and owning
    batch norm, derived from the template, equal the JAX tracer's."""
    if family == "ssd":
        _, slots = jcv.trace_slots(JSSD(), (300, 300, 3))
        with torch.device("meta"):
            flat = pw.ssd_to_flax_template(pssd.SSDMobileNetV1())
    else:
        _, slots = jcv.trace_slots(jf.FasterRCNNNet(cfg=INFERRED_TINY),
                                   (64, 64, 3))
        flat = pw.faster_rcnn_to_flax_template(
            pf.FasterRCNNNet(port_config(TINY)))
    got = pcv.template_slots(flat)
    assert set(got) == {"/".join(s.path) for s in slots}
    for s in slots:
        g = got["/".join(s.path)]
        assert (g.kind, g.path, g.kernel_shape, g.has_bias, g.bn_path) == \
            (s.kind, s.path, s.kernel_shape, s.has_bias, s.bn_path), s


def test_flax_roundtrip_and_npz(tmp_path):
    """faster_rcnn_to_flax then faster_rcnn_from_flax is the identity, and
    the registry loads such a dict saved as a .npz (at TINY, bound in)."""
    from deepdish_tpu_torch.models import registry
    net = pf.FasterRCNNNet(port_config(TINY))
    torch.manual_seed(0)
    for p in net.parameters():
        torch.nn.init.normal_(p)
    flat = pw.faster_rcnn_to_flax(net)
    back = pw.faster_rcnn_from_flax(flat)
    want = net.state_dict()
    assert back.keys() == want.keys()
    for k in want:
        assert torch.equal(back[k], want[k]), k
    path = str(tmp_path / "faster_rcnn.npz")
    np.savez(path, **flat)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(registry, "FasterRCNNDetector", functools.partial(
            pf.FasterRCNNDetector, config=port_config(TINY)))
        det = registry.create_detector(path, device="cpu")
    got = det.net.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------- Faster R-CNN

def _frcnn_tensors(cfg):
    donor = _donor(jf.FasterRCNNNet(cfg=cfg), (64, 64, 3), 3)
    return tfod_named_tensors(_flatten(donor), cfg), donor


@pytest.fixture(scope="module")
def tiny_tensors():
    return _frcnn_tensors(TINY)


def _same_frcnn_report(got, want):
    assert got["missing"] == want["missing"]
    assert got["unused"] == want["unused"]
    assert got["assigned"] == want["assigned"]
    assert dataclasses.asdict(got["config"]) == \
        dataclasses.asdict(want["config"])


def test_faster_rcnn_conversion_matches_jax(tiny_tensors):
    tensors, donor = tiny_tensors
    got, rep = pcv.convert_faster_rcnn_tfod(tensors, input_size=64)
    want, wrep = jcv.convert_faster_rcnn_tfod(tensors, input_size=64)
    _same_frcnn_report(rep, wrep)
    assert rep["config"] == port_config(INFERRED_TINY)
    assert not rep["missing"] and not rep["unused"]
    _same_flat(got, _flatten(want))
    _same_flat(got, _flatten(donor))


def test_faster_rcnn_conversion_infers_resnet_v1_50():
    """A (3, 4, 6, 3) layout named resnet_v1_50: the units inferred from
    the names, every tensor bound to the donor's leaf."""
    tensors, donor = _frcnn_tensors(RESNET50)
    assert any("/resnet_v1_50/block3/unit_6/" in n for n in tensors)
    got, rep = pcv.convert_faster_rcnn_tfod(tensors, input_size=64)
    assert rep["config"].block_units == (3, 4, 6, 3)
    assert not rep["missing"] and not rep["unused"]
    _same_flat(got, _flatten(donor))


def test_faster_rcnn_strict_failures_match_jax(tiny_tensors):
    tensors, _ = tiny_tensors
    broken = dict(tensors)
    del broken["Conv/biases"]
    del broken["SecondStageBoxPredictor/ClassPredictor/weights"]
    broken["extra/global_step"] = np.zeros((), np.int64)
    broken["not/a/frcnn/var"] = np.zeros(3, np.float32)
    msgs = []
    for convert in (jcv.convert_faster_rcnn_tfod,
                    pcv.convert_faster_rcnn_tfod):
        with pytest.raises(ValueError, match="incomplete") as e:
            convert(broken, input_size=64)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    _, wrep = jcv.convert_faster_rcnn_tfod(broken, input_size=64,
                                           strict=False)
    _, rep = pcv.convert_faster_rcnn_tfod(broken, input_size=64,
                                          strict=False)
    _same_frcnn_report(rep, wrep)
    assert rep["unused"] == ["SecondStageBoxPredictor/ClassPredictor/biases",
                             "not/a/frcnn/var"]
    ssd_like = {"FeatureExtractor/MobilenetV1/Conv2d_0/weights":
                np.zeros((3, 3, 3, 8), np.float32)}
    for convert in (jcv.convert_faster_rcnn_tfod,
                    pcv.convert_faster_rcnn_tfod):
        with pytest.raises(ValueError, match="not a TF-OD faster_rcnn"):
            convert(ssd_like)


# ---------------------------------------------------------------- SSD, MARS

@pytest.fixture(scope="module")
def ssd_donor():
    _, slots = jcv.trace_slots(JSSD(), (300, 300, 3))
    return _donor(JSSD(), (300, 300, 3), 5), slots


def _fold_one(tensors):
    """Drop the batch-norm variables of one pointwise layer (a folded
    export: its batch norm becomes an identity carrying no bias)."""
    return {k: v for k, v in tensors.items()
            if not ("Conv2d_3_pointwise/BatchNorm" in k)}


@pytest.mark.parametrize("variant", ["unfolded", "folded_layer"])
def test_ssd_conversion_matches_jax(ssd_donor, variant):
    donor, slots = ssd_donor
    tensors = _ssd_tfod_named_tensors(donor, slots)
    if variant == "folded_layer":
        tensors = _fold_one(tensors)
    want, wrep = jcv.convert_ssd_tfod(tensors, net=JSSD())
    got, rep = pcv.convert_ssd_tfod(tensors)
    assert rep == wrep and not rep["missing"]
    _same_flat(got, _flatten(want))
    if variant == "unfolded":
        _same_flat(got, _flatten(jax.tree.map(np.asarray, donor)))
    else:
        np.testing.assert_array_equal(
            got["batch_stats/ds3/pw_bn/var"],
            np.full(128, 1 - 1e-3, np.float32))


def test_ssd_strict_failure_matches_jax(ssd_donor):
    donor, slots = ssd_donor
    tensors = _ssd_tfod_named_tensors(donor, slots)
    tensors = {k: v for k, v in tensors.items()
               if "Conv2d_7_pointwise/weights" not in k
               and "BoxPredictor_2/ClassPredictor/weights" not in k}
    msgs = []
    for convert in (functools.partial(jcv.convert_ssd_tfod,
                                      net=JSSD()),
                    pcv.convert_ssd_tfod):
        with pytest.raises(ValueError, match="missing") as e:
            convert(tensors)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    _, wrep = jcv.convert_ssd_tfod(tensors, net=JSSD(),
                                   strict=False)
    _, rep = pcv.convert_ssd_tfod(tensors, strict=False)
    assert rep == wrep and rep["missing"] == ["ds7/pw", "cls_head2"]


@pytest.fixture(scope="module")
def mars_donor():
    return _donor(JMars(), (1, 128, 64, 3), 7)


def test_mars_conversion_matches_jax(mars_donor):
    tensors = _mars_reference_named_tensors(mars_donor)
    fresh = jax.jit(JMars().init)(jax.random.PRNGKey(9),
                                  jnp.zeros((1, 128, 64, 3), F32))
    want, wrep = jcv.convert_mars_pb(tensors, fresh)
    got, rep = pcv.convert_mars_pb(tensors)
    assert rep == wrep and not rep["missing"]
    assert rep["assigned"] == rep["total"]
    _same_flat(got, _flatten(want))
    del tensors["conv3_1/projection/weights"]
    msgs = []
    for convert in (functools.partial(jcv.convert_mars_pb,
                                      variables=fresh),
                    pcv.convert_mars_pb):
        with pytest.raises(ValueError, match="missing") as e:
            convert(tensors)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_mars_tflite_refused(tmp_path):
    """A MARS .tflite that is no flatbuffer fails to convert (never random
    weights); a full-integer one (its conv's activation input quantized)
    runs on the integer datapath (models/qgraph.py), as in the JAX
    package: the features of both factories' encoders agree."""
    import chip_smoke
    from deepdish_tpu.models.encoders import \
        create_box_encoder as j_create_box_encoder
    from deepdish_tpu_torch.models import create_box_encoder
    path = tmp_path / "mars-small128.tflite"
    path.write_bytes(b"\0" * 16)
    for call in (lambda: pcv.load_mars(str(path)),
                 lambda: create_box_encoder(str(path), device="cpu")):
        with pytest.raises(ValueError, match="not a TFLite flatbuffer"):
            call()
    kern = np.arange(-54, 54, dtype=np.int8).tobytes()
    quant = [(2, "f32v", np.array([0.5], np.float32)),
             (3, "i64v", np.array([0], np.int64))]
    conv_options = [(0, "i8", 0), (1, "i32", 1), (2, "i32", 1)]
    blob = chip_smoke._fb_serialize([
        (0, "u32", 3),
        (1, "tables", [[(0, "i8", 3), (2, "i32", 1), (3, "i32", 3)]]),
        (2, "tables", [[
            (0, "tables", [
                [(0, "i32v", np.array([1, 8, 8, 3], np.int32)),
                 (1, "i8", 9), (3, "str", b"input"), (4, "table", quant)],
                [(0, "i32v", np.array([4, 3, 3, 3], np.int32)),
                 (1, "i8", 9), (2, "u32", 1), (3, "str", b"kernel"),
                 (4, "table", quant)],
                [(0, "i32v", np.array([1, 8, 8, 4], np.int32)),
                 (1, "i8", 9), (3, "str", b"out"), (4, "table", quant)]]),
            (1, "i32v", np.array([0], np.int32)),
            (2, "i32v", np.array([2], np.int32)),
            (3, "tables", [[(0, "u32", 0),
                            (1, "i32v", np.array([0, 1], np.int32)),
                            (2, "i32v", np.array([2], np.int32)),
                            (3, "u8", 1), (4, "table", conv_options)]])]]),
        (4, "tables", [[(0, "u8v", b"")], [(0, "u8v", kern)]])])
    path.write_bytes(blob)
    enc = create_box_encoder(str(path), device="cpu")
    jenc = j_create_box_encoder(str(path))
    assert enc.executor.ops[0].code == 3
    assert enc.image_shape == jenc.image_shape == (8, 8, 3)
    assert enc.feature_dim == jenc.feature_dim == 256
    patches = np.random.RandomState(3).uniform(
        -40, 40, (3, 8, 8, 3)).astype(np.float32)
    with torch.inference_mode():
        got = enc.apply(torch.from_numpy(patches)).numpy()
    want = np.asarray(jenc.apply(jnp.asarray(patches)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- TensorFlow

@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def ssd_saved_model(tf, tmp_path_factory, ssd_donor):
    donor, slots = ssd_donor
    out = str(tmp_path_factory.mktemp("ssd") / "ssd_saved_model")
    return write_tf1_saved_model(tf, _ssd_tfod_named_tensors(donor, slots),
                                 out), donor


def test_ssd_saved_model_dir_matches_jax(ssd_saved_model):
    from deepdish_tpu_torch.models import create_detector
    out_dir, donor = ssd_saved_model
    want, _ = jcv.load_ssd_saved_model(out_dir)
    got, rep = pcv.load_ssd_saved_model(out_dir)
    assert not rep["missing"]
    _same_flat(got, _flatten(want))
    det = create_detector(out_dir, device="cpu")
    assert isinstance(det, pssd.SSDMobileNetDetector)
    sd = det.net.state_dict()
    for k, v in pw.ssd_from_flax(_flatten(want)).items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)


def test_non_tfod_saved_model_uses_host_executor(tf, tmp_path):
    """tests/test_saved_model_dir.py's host-executor case through both
    registries: the same detections from detect_host."""
    from deepdish_tpu.models.registry import create_detector as j_create
    from deepdish_tpu_torch.models import create_detector
    from deepdish_tpu_torch.models.saved_model import SavedModelDetector

    class M(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec((1, None, None, 3), tf.uint8)])
        def __call__(self, img):
            n = tf.shape(img)[0]
            return {
                "detection_boxes": tf.zeros((n, 4, 4)) +
                tf.constant([[0.1, 0.1, 0.5, 0.5]]),
                "detection_classes": tf.ones((n, 4)),
                "detection_scores": tf.constant([[0.9, 0.8, 0.2, 0.1]]) +
                tf.zeros((n, 4)),
            }

    m = M()
    out_dir = str(tmp_path / "frcnn_saved_model")
    tf.saved_model.save(m, out_dir, signatures={
        "serving_default": m.__call__.get_concrete_function()})
    labelmap = tmp_path / "map.pbtxt"
    labelmap.write_text('item {\n  id: 1\n  name: "person"\n}\n')
    kw = dict(label_file=str(labelmap), wanted_labels=["person"])
    det = create_detector(out_dir, device="cpu", **kw)
    jdet = j_create(out_dir, **kw)
    assert isinstance(det, SavedModelDetector)
    assert (det.width, det.height, det.labels) == \
        (jdet.width, jdet.height, jdet.labels)
    frame = np.zeros((100, 200, 3), np.uint8)
    got, want = det.detect_host(frame), jdet.detect_host(frame)
    assert got[1:] == want[1:] == ([0, 0], [0.8999999761581421,
                                           0.800000011920929])
    np.testing.assert_array_equal(got[0], want[0])


def _frozen_pb(tf, tensors, path):
    """A frozen GraphDef holding `tensors` as Const nodes (what
    convert_variables_to_constants leaves)."""
    tf1 = tf.compat.v1
    g = tf1.Graph()
    with g.as_default():
        for name, val in tensors.items():
            tf1.constant(np.asarray(val, np.float32), name=name)
    with open(path, "wb") as f:
        f.write(g.as_graph_def().SerializeToString())
    return path


def _checkpoint(tf, tensors, path):
    tf1 = tf.compat.v1
    with tf1.Session(graph=tf1.Graph()) as s:
        vs = {k: tf1.get_variable(k, initializer=np.asarray(v, np.float32))
              for k, v in tensors.items()}
        s.run(tf1.global_variables_initializer())
        tf1.train.Saver(vs).save(s, path)
    return path


@pytest.mark.parametrize("artifact", ["pb", "ckpt"])
def test_mars_artifacts_match_jax(tf, tmp_path, monkeypatch, mars_donor,
                                  artifact):
    """load_mars and create_box_encoder on a MARS frozen .pb / checkpoint:
    the JAX conversion's variables, and the JAX encoder's features in
    float32."""
    from deepdish_tpu.models import encoders as j_encoders
    from deepdish_tpu_torch.models import create_box_encoder
    tensors = _mars_reference_named_tensors(mars_donor)
    if artifact == "pb":
        path = _frozen_pb(tf, tensors, str(tmp_path / "mars-small128.pb"))
    else:
        path = _checkpoint(tf, tensors,
                           str(tmp_path / "mars-small128.ckpt-68577"))
    want, _ = jcv.load_mars(path)
    got, rep = pcv.load_mars(path)
    assert not rep["missing"]
    _same_flat(got, _flatten(want))
    monkeypatch.setattr(j_encoders, "make_mars_encoder", functools.partial(
        j_encoders.make_mars_encoder, compute_dtype=F32))
    patches = np.random.RandomState(2).uniform(
        0, 255, (3, 128, 64, 3)).astype(np.float32)
    enc = create_box_encoder(path, device="cpu")
    with torch.inference_mode():
        feats = enc.apply(torch.from_numpy(patches)).numpy()
    if artifact == "pb":
        jenc = j_encoders.create_box_encoder(path)
        jfeats = np.asarray(jenc.apply(jnp.asarray(patches)))
    else:   # the JAX factory takes no checkpoint: its encoder on load_mars
        jenc = j_encoders.make_mars_encoder(params=want)
        jfeats = np.asarray(jenc.apply(jnp.asarray(patches)))
    np.testing.assert_allclose(feats, jfeats, rtol=1e-5, atol=1e-5)


def test_missing_tensorflow_raises(tmp_path, monkeypatch):
    """Without tensorflow a SavedModel directory, a .pb and a checkpoint
    raise ImportError naming it: never random weights."""
    from deepdish_tpu_torch.models import create_box_encoder, create_detector
    out_dir = tmp_path / "frcnn_saved_model"
    (out_dir / "variables").mkdir(parents=True)
    (out_dir / "variables" / "variables.index").write_bytes(b"\0")
    out_dir = str(out_dir)
    pb = tmp_path / "mars.pb"
    pb.write_bytes(b"\0")
    (tmp_path / "mars.ckpt-1.index").write_bytes(b"\0")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    for call in (lambda: create_detector(out_dir, device="cpu"),
                 lambda: create_box_encoder(str(pb), device="cpu"),
                 lambda: create_box_encoder(str(tmp_path / "mars.ckpt-1"),
                                            device="cpu")):
        with pytest.raises(ImportError, match="tensorflow"):
            call()
