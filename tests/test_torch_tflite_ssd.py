"""Port parity of the structural weight path (deepdish_tpu_torch/models/
convert.py and tflite_meta.py) against the JAX package on the CPU:
SSD-MobileNetV1 at full width, the small TFLite model and the shared
helpers of tests/test_torch_tflite_yolo.py and
tests/test_torch_tflite_edet_mars.py.

The artifacts are the JAX tests' own: tests/test_pipeline_real_tflite.py
`_make_full_ssd_tflite` as float, dynamic-range int8 (per-channel int8
kernels, `quantized_dimension` 0 or 3) and with the TFLite_Detection_PostProcess
op of tests/pp_builder.py; tests/test_convert.py `_make_tflite` float and
int8. Held equal:

  * the readers: `read_tflite` (each op's kind, out_name, kernel and bias
    bit-equal, depth and sig; the tensors dict), `read_tflite_io_quant`
    and `read_tflite_postprocess`;
  * the slot list of `trace_slots` against the JAX tracer's, in order and
    field by field, sig included;
  * each conversion's flat dict against `_flatten` of the JAX package's,
    key by key and exact, and the reports;
  * the fold round trip (`fold_slots_to_ops` then `assign_slots`), with
    no tensorflow (the strict failure in test_torch_tflite_edet_mars);
  * the detector built by each registry from the postprocess flatbuffer
    (op anchors, decode scales, thresholds, detections_cap) on two
    images (`detector_matches`): the raw network outputs within 1e-4 of
    their range (or three times the port's own float32 rounding, measured
    against its float64 run, where that is larger), and `detect` on the
    same raw outputs with valid and classes exact, scores within 1e-6 and
    boxes within 1e-5 relative, tests/test_torch_families.py's decode
    tolerances;
  * `python -m deepdish_tpu_torch.models.convert` against the JAX main.

The JAX tracer runs with its net's init jitted and its result cached per
module (`jax_trace`); its signature pass is kept, since the binding reads
it."""
import functools
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import numpy as np
import torch

import deepdish_tpu.models.registry as j_registry
from deepdish_tpu.models import convert as jcv
from deepdish_tpu.models import ssd_mobilenet as jssd
from deepdish_tpu.models.weights import _flatten, _unflatten, load_npz
from deepdish_tpu_torch.models import convert as pcv
from deepdish_tpu_torch.models import ssd_mobilenet as pssd
from deepdish_tpu_torch.models import weights as pw
from deepdish_tpu_torch.models.layers import BatchNorm, SameConv2d
from test_torch_models import numpy_flax_variables

pytestmark = pytest.mark.timeout(300)
F32 = jnp.float32
ROOT = __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__)))


# ---------------------------------------------------------------- helpers

_JAX_TRACES = {}
_JAX_TRACE_SLOTS = jcv.trace_slots      # before any binding


def jax_trace(net, shape):
    """The JAX package's trace_slots with the net's init jitted, cached per
    (net, shape): (variables, slots), signatures included."""
    key = (type(net), repr(net), tuple(shape))
    if key not in _JAX_TRACES:
        object.__setattr__(net, "init", jax.jit(net.init))
        _JAX_TRACES[key] = _JAX_TRACE_SLOTS(net, shape)
    return _JAX_TRACES[key]


def bind_jax_trace(mp):
    """The JAX converter's trace_slots as `jax_trace` (its loaders, main
    and CLI convert through it)."""
    mp.setattr(jcv, "trace_slots",
               lambda net, shape, rngs=None: jax_trace(net, shape))


def slot_fields(s):
    return (s.kind, tuple(s.path), tuple(s.kernel_shape), s.has_bias,
            None if s.bn_path is None else tuple(s.bn_path), s.bn_eps,
            s.bn_has_scale, s.bn_has_bias, s.sig)


def same_slots(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert slot_fields(g) == slot_fields(w), (g, w)
    assert all(s.sig for s in got if s.kind != "bn")


def same_flat(got, want):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def same_ops(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.kind, g.out_name, g.depth, g.sig) == \
            (w.kind, w.out_name, w.depth, w.sig), w.out_name
        assert g.kernel.dtype == w.kernel.dtype
        np.testing.assert_array_equal(g.kernel, w.kernel, err_msg=w.out_name)
        assert (g.bias is None) == (w.bias is None)
        if w.bias is not None:
            np.testing.assert_array_equal(g.bias, w.bias, err_msg=w.out_name)


def same_readers(path):
    """read_tflite, read_tflite_io_quant and read_tflite_postprocess of
    both packages on one file; returns the JAX postprocess op."""
    jops, jt = jcv.read_tflite(path)
    pops, pt = pcv.read_tflite(path)
    same_ops(pops, jops)
    same_flat(pt, jt)
    assert pcv.read_tflite_io_quant(path) == jcv.read_tflite_io_quant(path)
    jpp, ppp = jcv.read_tflite_postprocess(path), \
        pcv.read_tflite_postprocess(path)
    assert (jpp is None) == (ppp is None)
    if jpp is not None:
        for f in jpp.__dataclass_fields__:
            a, b = getattr(ppp, f), getattr(jpp, f)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b and type(a) is type(b), f
    return jpp


def same_report(got, want):
    g = {k: v for k, v in got.items() if k != "postprocess"}
    w = {k: v for k, v in want.items() if k != "postprocess"}
    assert g == w
    assert ("postprocess" in got) == ("postprocess" in want)


def jax_conversion(jslots, jvars, path):
    """The JAX package's convert_tflite on traced slots: (flat, report)."""
    out, rep = jcv.assign_slots(jslots, jcv.read_tflite(path)[0], jvars)
    return _flatten(out), rep


def fold_roundtrip(jnet, jshape, pnet_cls, pshape, bridge, seed, x,
                   strict=False):
    """fold_slots_to_ops on a seeded donor on both sides (equal op
    streams), assign_slots back onto the port's template (equal to the
    JAX package's), and the port network on the result against the
    donor's (within 2e-4 relative and 2e-4 of the output's range: the
    folded float32 arithmetic through up to 75 layers). With `strict`,
    also the strict failure on a truncated op stream, with the JAX
    package's message (tests/test_convert.py:116's MARS pattern)."""
    jvars, jslots = jax_trace(jnet, jshape)
    donor = _flatten(numpy_flax_variables(jnet, jnp.zeros(jshape, F32),
                                          seed=seed))
    with torch.device("meta"):
        flat, slots = pcv.trace_slots(pnet_cls(), pshape)
    ops = pcv.fold_slots_to_ops(donor, slots)
    same_ops(ops, jcv.fold_slots_to_ops(_unflatten(donor), jslots))
    got, rep = pcv.assign_slots(slots, ops, flat)
    want, wrep = jcv.assign_slots(jslots, ops, jvars)
    assert rep == wrep and rep["assigned"] == rep["total"] == len(slots)
    same_flat(got, _flatten(want))
    nets = []
    for f in (got, donor):
        net = pnet_cls()
        net.load_state_dict(bridge(f))
        nets.append(net.eval())
    with torch.inference_mode():
        outs = [n(torch.from_numpy(x)) for n in nets]
    for a, b in zip(*(o if isinstance(o, (list, tuple)) else [o]
                      for o in outs)):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4,
                                   atol=2e-4 * np.abs(b).max())
    if not strict:
        return
    msgs = []
    for assign, sl, tmpl in ((pcv.assign_slots, slots, flat),
                             (jcv.assign_slots, jslots, jvars)):
        with pytest.raises(ValueError, match="incomplete") as e:
            assign(sl, ops[:-4], tmpl)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


class FixedNet:
    """Stands in for a detector's network: returns the given raw outputs
    (to JAX `apply` as arrays, to the port's call as batch-1 tensors)."""

    def __init__(self, outs):
        self.outs = outs

    def apply(self, params, image):
        return type(self.outs)(jnp.asarray(o) for o in self.outs)

    def __call__(self, image):
        return type(self.outs)(torch.from_numpy(np.array(o))[None]
                               for o in self.outs)


def detector_matches(jdet, pdet, size, seeds=(1, 2)):
    """The detectors each registry built from one file, on two images: the
    raw network outputs within 1e-4 of their range (+ 1e-5),
    tests/test_torch_families.py's tolerance, or within three times the
    float32 rounding of the port's own output (its distance from the
    port's float64 run on the same image) where that is larger: the test
    builders' random weights (scale 0.1-0.2 through up to 170 layers)
    amplify float32 rounding past 1e-4 of the range for EfficientDet-Lite0.
    Then `detect` with both networks swapped for the JAX outputs
    (`FixedNet`), so that the configuration read from the file (anchors,
    scales, thresholds, cap, filters) is held alone, to the families'
    decode tolerances: valid and classes exact, scores within 1e-6 and
    boxes within 1e-5 relative. (Those weights also saturate sigmoids and
    drive the box decode's exp, so a slot-by-slot match of detections on
    the networks' own outputs would test float noise, not the port.)
    Returns the valid slots per image."""
    import copy
    valid = []
    apply = jax.jit(jdet.net.apply)
    for seed in seeds:
        img = image(seed, size)
        want = apply(jdet.params, jnp.asarray(img))
        with torch.inference_mode():
            got = pdet.net(torch.from_numpy(img)[None])
        assert len(got) == len(want)
        exact = None
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            assert g.shape == (1,) + w.shape
            err = np.abs(g[0].numpy() - w).max()
            if err <= 1e-4 * np.abs(w).max() + 1e-5:
                continue
            if exact is None:
                # one thread: the float64 convolutions take torch's
                # fine-grained parallel path, which crawls when the test
                # workers oversubscribe the cores (a 0.5 s forward passed
                # 300 s in a loaded tier-1 run)
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                try:
                    with torch.inference_mode():
                        exact = copy.deepcopy(pdet.net).double()(
                            torch.from_numpy(img)[None].double())
                finally:
                    torch.set_num_threads(threads)
            assert err <= 3 * float((g.double() - exact[i]).abs().max())
        outs = type(want)(np.asarray(w) for w in want)
        nets = jdet.net, pdet.net
        try:
            jdet.net = pdet.net = FixedNet(outs)
            wd = [np.asarray(x) for x in jdet.detect(
                None, None, jnp.float32(1280), jnp.float32(720))]
            gd = [x[0].numpy() for x in pdet.detect(None, 1280.0, 720.0)]
        finally:
            jdet.net, pdet.net = nets
        np.testing.assert_array_equal(gd[3], wd[3])
        np.testing.assert_array_equal(gd[1], wd[1])
        np.testing.assert_allclose(gd[2], wd[2], rtol=1e-6)
        np.testing.assert_allclose(gd[0], wd[0], rtol=1e-5,
                                   atol=1e-5 * np.abs(wd[0]).max())
        valid.append(int(wd[3].sum()))
    return valid


def image(seed, size):
    return np.random.RandomState(seed).randint(
        0, 256, (size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------- SSD

@pytest.fixture(scope="module")
def ssd_files(tmp_path_factory):
    pytest.importorskip("tensorflow")
    from test_pipeline_real_tflite import _make_full_ssd_tflite
    d = tmp_path_factory.mktemp("ssd_tflite")
    return {"float": _make_full_ssd_tflite(d),
            "int8": _make_full_ssd_tflite(d, quantize=True),
            "postprocess": _make_full_ssd_tflite(d, postprocess=True)}


@pytest.fixture(scope="module")
def ssd_trace():
    return jax_trace(jssd.SSDMobileNetV1(), (300, 300, 3))


@pytest.fixture(scope="module")
def jax_f32_registry():
    """The JAX registry with float32 SSD and EfficientDet detectors and
    the cached trace."""
    from deepdish_tpu.models import efficientdet as jed
    with pytest.MonkeyPatch.context() as mp:
        bind_jax_trace(mp)
        mp.setattr(j_registry, "SSDMobileNetDetector", functools.partial(
            jssd.SSDMobileNetDetector, compute_dtype=F32))
        mp.setattr(j_registry, "EfficientDetLite0Detector",
                   functools.partial(jed.EfficientDetLite0Detector,
                                     compute_dtype=F32))
        yield


@pytest.mark.parametrize("kind", ["float", "int8", "postprocess"])
def test_ssd_readers_match_jax(ssd_files, kind):
    pp = same_readers(ssd_files[kind])
    ops, _ = pcv.read_tflite(ssd_files[kind])
    assert sum(o.kind in ("conv", "dw") for o in ops) == 47
    assert (pp is not None) == (kind == "postprocess")
    if kind == "int8":
        # per-channel int8 kernels: CONV on its output axis 0, DEPTHWISE
        # on its channel axis 3
        from deepdish_tpu_torch.models import tflite_meta
        model = tflite_meta.read_model(ssd_files[kind])
        q = [t.quantization for t in model.tensors if t.type == 9]
        assert {x.quantized_dimension for x in q} == {0, 3}
        assert all(x.scale.size > 1 for x in q)


def test_ssd_slots_match_jax(ssd_trace):
    with torch.device("meta"):
        _, slots = pcv.trace_slots(pssd.SSDMobileNetV1(), (1, 300, 300, 3))
    same_slots(slots, ssd_trace[1])


@pytest.mark.parametrize("kind", ["float", "int8", "postprocess"])
def test_ssd_conversion_matches_jax(ssd_files, ssd_trace, kind):
    got, rep = pcv.load_ssd_mobilenet_tflite(ssd_files[kind])
    jflat, jrep = jax_conversion(ssd_trace[1], ssd_trace[0],
                                 ssd_files[kind])
    jrep = jcv._attach_postprocess(ssd_files[kind], jrep,
                                   jssd.generate_anchors())
    same_report(rep, jrep)
    assert rep["assigned"] == rep["total"] == 47
    assert not rep["missing"] and not rep["unused_ops"]
    if kind == "postprocess":
        assert rep["anchors_verified"]
    same_flat(got, jflat)


def test_ssd_fold_roundtrip_matches_jax():
    fold_roundtrip(jssd.SSDMobileNetV1(), (300, 300, 3),
                   pssd.SSDMobileNetV1, (1, 300, 300, 3), pw.ssd_from_flax,
                   seed=21, x=image(22, 300)[None])


def test_ssd_postprocess_detector_matches_jax(ssd_files, jax_f32_registry):
    """Both registries on the postprocess flatbuffer: the op's anchors,
    scales, score threshold max(0.5, 0.55), IoU 0.5 and detections_cap 10;
    then `detect` on two images."""
    from deepdish_tpu_torch.models import create_detector
    path = ssd_files["postprocess"]
    jdet = j_registry.create_detector(path)
    pdet = create_detector(path, device="cpu", compute_dtype=torch.float32)
    pp = pcv.read_tflite_postprocess(path)
    assert pdet.box_scale == jdet.box_scale == (10.0, 10.0, 5.0, 5.0)
    assert pdet.detections_cap == jdet.detections_cap == 10
    assert pdet.score_threshold == jdet.score_threshold == \
        max(0.5, pp.nms_score_threshold)
    assert pdet.iou_threshold == jdet.iou_threshold == pp.nms_iou_threshold
    np.testing.assert_array_equal(pdet.anchors.numpy(),
                                  np.asarray(jdet.anchors))
    sd = pdet.net.state_dict()
    for k, v in pw.ssd_from_flax(_flatten(jdet.params)).items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    valid = detector_matches(jdet, pdet, 300)
    assert 0 < max(valid) <= 10


def test_ssd_detections_cap():
    """detections_cap < max_outputs invalidates the slots past the cap in
    descending-score order, as the JAX postprocess does."""
    rng = np.random.RandomState(3)
    n = 300
    tl = rng.uniform(0, 0.8, (n, 2))
    boxes = np.c_[tl, tl + rng.uniform(0.02, 0.2, (n, 2))].astype(
        np.float32)
    probs = rng.uniform(0, 1, (n, 5)).astype(np.float32)
    kw = dict(top_k=100, score_threshold=0.3, iou_threshold=0.5,
              max_outputs=32, detections_cap=7)
    want = jssd.postprocess_detections(
        jnp.asarray(boxes), jnp.asarray(probs), jnp.float32(640),
        jnp.float32(480), **kw)
    got = pssd.postprocess_detections(
        torch.from_numpy(boxes), torch.from_numpy(probs), 640.0, 480.0, **kw)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].sum() == 7 and not got[3][7:].any()


def test_converter_main_matches_jax(ssd_files, tmp_path, monkeypatch):
    """`python -m deepdish_tpu_torch.models.convert` writes the .npz that
    the JAX package's main writes, and prints its report."""
    bind_jax_trace(monkeypatch)
    path = ssd_files["postprocess"]
    out = tmp_path / "port.npz"
    res = subprocess.run(
        [sys.executable, "-m", "deepdish_tpu_torch.models.convert", path,
         "-o", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert '"assigned": 47' in res.stdout and "saved" in res.stdout
    jout = tmp_path / "jax.npz"
    assert jcv.main([path, "-o", str(jout)]) == 0
    same_flat(_flatten(load_npz(str(out))), _flatten(load_npz(str(jout))))


# ---------------------------------------------------------------- small net

class SmallNet(torch.nn.Module):
    """The port twin of tests/test_convert.py `_SmallNet` (flax names c1,
    bn1, dw, bn2, fc): conv 3x3 + BN + ReLU, depthwise 3x3 + BN + ReLU,
    NHWC flatten, dense 4."""

    def __init__(self):
        super().__init__()
        self.c1 = SameConv2d(3, 8, 3)
        self.bn1 = BatchNorm(8)
        self.dw = SameConv2d(8, 8, 3, groups=8)
        self.bn2 = BatchNorm(8)
        self.fc = torch.nn.Linear(16 * 16 * 8, 4)

    def forward(self, x):
        x = torch.relu(self.bn1(self.c1(x.permute(0, 3, 1, 2))))
        x = torch.relu(self.bn2(self.dw(x)))
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


SMALL_NAMING = pw.FlaxNaming(pw._renamer({}))


@pytest.mark.parametrize("quantize", [False, True],
                         ids=["float", "int8"])
def test_small_tflite_matches_jax(tmp_path, quantize):
    """tests/test_convert.py's small model: readers, slots, conversion and
    the forward pass against the TFLite interpreter's."""
    pytest.importorskip("tensorflow")
    from test_convert import _SmallNet, _make_tflite, _tflite_forward
    path, _ = _make_tflite(tmp_path, quantize=quantize)
    same_readers(path)
    jvars, jslots = jax_trace(_SmallNet().build(), (1, 16, 16, 3))
    with torch.device("meta"):
        _, slots = pcv.trace_slots(SmallNet(), (1, 16, 16, 3), SMALL_NAMING)
    same_slots(slots, jslots)
    with torch.device("meta"):
        got, rep = pcv.convert_tflite(SmallNet(), (1, 16, 16, 3), path,
                                      naming=SMALL_NAMING)
    want, wrep = jcv.assign_slots(jslots, jcv.read_tflite(path)[0], jvars)
    assert rep == wrep and not rep["missing"] and not rep["unused_ops"]
    same_flat(got, _flatten(want))
    net = SmallNet()
    net.load_state_dict(pw._from_flax(got, {}))
    x = np.random.RandomState(5).uniform(-1, 1, (1, 16, 16, 3)).astype(
        np.float32)
    with torch.inference_mode():
        out = net(torch.from_numpy(x)).numpy()
    want = _tflite_forward(path if not quantize else
                           _make_tflite(tmp_path)[0], x)
    tol = 2e-1 if quantize else 1e-4
    np.testing.assert_allclose(out, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def mars_tflite(tmp_path_factory):
    """tests/test_convert.py's Keras slim mirror of MARS as a float
    .tflite (pre-activation batch norms as constant MUL + ADD)."""
    tf = pytest.importorskip("tensorflow")
    from test_convert import _keras_mars, _randomize_keras_bn
    model = _keras_mars(tf)
    _randomize_keras_bn(model)
    path = str(tmp_path_factory.mktemp("mars") / "mars-small128.tflite")
    with open(path, "wb") as f:
        f.write(tf.lite.TFLiteConverter.from_keras_model(model).convert())
    return path


def test_cli_on_tflite_files_matches_jax(tmp_path, ssd_files, mars_tflite,
                                         monkeypatch):
    """Both CLIs with --model on the postprocess SSD .tflite and
    --encoder-model on the MARS .tflite (tests/test_torch_cli_ssd.py's
    pattern: 160x120 drifting texture, 10 frames, --chunk-size 4, float32
    on both sides): identical counters and per-frame MQTT payloads."""
    import asyncio

    from deepdish_tpu_torch.models import COCO_LABELS
    from test_torch_pipeline import (COMMON, RecordingMQTT, _compare,
                                     _frames, _last_counters, _texture_scene,
                                     _write_video, j_amain, p_amain)
    import deepdish_tpu.models.encoders as j_encoders
    import deepdish_tpu.pipeline.runtime as j_runtime
    import deepdish_tpu_torch.pipeline.runtime as p_runtime
    bind_jax_trace(monkeypatch)
    monkeypatch.setattr(j_registry, "SSDMobileNetDetector", functools.partial(
        jssd.SSDMobileNetDetector, compute_dtype=F32))
    monkeypatch.setattr(j_encoders, "make_mars_encoder", functools.partial(
        j_encoders.make_mars_encoder, compute_dtype=F32))
    for mod in (j_runtime, p_runtime):
        monkeypatch.setattr(mod, "MQTTClient", RecordingMQTT)
    RecordingMQTT.runs = []
    video = tmp_path / "texture.mp4"
    _write_video(video, _texture_scene())
    logs = [tmp_path / "jax.log", tmp_path / "port.log"]
    pays = []
    for amain, log in zip((j_amain, p_amain), logs):
        asyncio.run(amain(["--input", str(video),
                           "--model", ssd_files["postprocess"],
                           "--encoder-model", mars_tflite,
                           "--wanted-labels", ",".join(COCO_LABELS),
                           "--score-threshold", "0.3", "--chunk-size", "4",
                           "--log", str(log)] + COMMON))
        pays.append(RecordingMQTT.runs[-1])
    n_tracks, n_dets = _compare(*pays)
    assert len(_frames(pays[1])) == 10
    assert _last_counters(logs[1]) == _last_counters(logs[0])
    assert n_tracks > 0 and n_dets > 0


# ---------------------------------------------------------------- writer

def test_writer_ssd_roundtrip(tmp_path, ssd_trace):
    """chip_smoke.py's numpy-only writer on a full-width SSD donor, heads
    in reverse level order and a postprocess op: TF's schema and the port
    read the file alike, both packages convert it alike (the heads bind
    back by signature), and the converted network gives the donor's
    outputs within 5e-4 of their range (folding changes the float32
    arithmetic through 30 layers)."""
    import chip_smoke
    donor = pssd.SSDMobileNetV1()
    chip_smoke._calibrated_init(donor, torch.Generator().manual_seed(4),
                                chip_smoke._calibration_images(300, 300))
    path = str(tmp_path / "ssd_mobilenet_written.tflite")
    with open(path, "wb") as f:
        f.write(chip_smoke.written_tflite(donor, (1, 300, 300, 3),
                                          chip_smoke._ssd_pp_options()))
    pp = same_readers(path)
    assert pp.max_detections == chip_smoke.TFLITE_MAX_DETECTIONS
    np.testing.assert_array_equal(pp.anchors, pssd.generate_anchors())
    ops, _ = pcv.read_tflite(path)
    heads = [o.out_name.split("/")[0] for o in ops
             if o.out_name.startswith(("box_head", "cls_head"))]
    assert heads[:2] == ["box_head5", "cls_head5"]
    got, rep = pcv.load_ssd_mobilenet_tflite(path)
    want, wrep = jax_conversion(ssd_trace[1], ssd_trace[0], path)
    same_report(rep, jcv._attach_postprocess(path, wrep,
                                             jssd.generate_anchors()))
    assert rep["assigned"] == rep["total"] and rep["anchors_verified"]
    assert not rep["unused_ops"]
    same_flat(got, want)
    net = pssd.SSDMobileNetV1()
    net.load_state_dict(pw.ssd_from_flax(got))
    x = chip_smoke._calibration_images(300, 300)
    with torch.inference_mode():
        for a, b in zip(net.eval()(x), donor.eval()(x)):
            assert float((a - b).abs().max()) <= \
                5e-4 * float(b.abs().max())
