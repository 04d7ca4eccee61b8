"""Port parity of the YOLOv5s, YOLOv3 and EfficientDet-Lite0 detectors
and their CLI runs, against the JAX package on the CPU.

JAX random-init shapes filled from a numpy seed (float32) are bridged into
the port with `models.weights.*_from_flax`; both packages get the same
seeded numpy inputs, the port with device="cpu". YOLOv5s and YOLOv3 run at
input size 128, EfficientDet-Lite0 at its fixed 320. Per family:

  * raw network outputs within |a - b| <= 1e-4 * max|b| + 1e-5 (float32
    convolutions summed in another order);
  * the decode and postprocess fed identical tie-heavy heads (logits on a
    coarse grid, so many scores tie exactly): classes, valid and the pick
    order (which rows, in which order) exact, scores within 1e-6 and boxes
    within 1e-5, relative;
  * `detect` end to end on a seeded image: classes and valid exact;
  * YOLOv3's letterbox geometry and letterboxed input; EfficientDet's
    allow / deny label filter and max_results;
  * the registry's dispatch, keywords and .npz loading;
  * the CLI against the JAX CLI (the tests/test_torch_cli_ssd.py pattern):
    160x120 drifting texture, 10 frames, --chunk-size 4, weights from .npz
    files: identical counters and per-frame MQTT payloads."""
import asyncio
import functools

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp
import numpy as np
import torch

import deepdish_tpu.models.registry as j_registry
import deepdish_tpu_torch.models.registry as p_registry
import deepdish_tpu_torch.models.ssd_q as p_ssd_q
from deepdish_tpu.models import efficientdet as jed
from deepdish_tpu.models import yolov3 as jy3
from deepdish_tpu.models import yolov5 as jy5
from deepdish_tpu.models.weights import _flatten, save_npz
from deepdish_tpu_torch.models import COCO_LABELS
from deepdish_tpu_torch.models import efficientdet as ped
from deepdish_tpu_torch.models import weights as pw
from deepdish_tpu_torch.models import yolov3 as py3
from deepdish_tpu_torch.models import yolov5 as py5
from test_torch_models import numpy_flax_variables
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pipeline import (COMMON, RecordingMQTT, _compare, _frames,
                                 _last_counters, _texture_scene, _write_video,
                                 f32_jax, j_amain, p_amain)

__all__ = ["f32_jax"]   # fixture used below
pytestmark = pytest.mark.timeout(120)   # the CLI runs: 300 each

F32 = jnp.float32
SMALL = 128           # YOLO input size in these tests
FAMILIES = ("yolov5", "yolov3", "efficientdet")
# (JAX net, JAX detector, port detector, weight bridge, input size)
_SPEC = {
    "yolov5": (jy5.YOLOv5s, jy5.YOLOv5Detector, py5.YOLOv5Detector,
               pw.yolov5_from_flax, SMALL),
    "yolov3": (jy3.YOLOv3, jy3.YOLOv3Detector, py3.YOLOv3Detector,
               pw.yolov3_from_flax, SMALL),
    "efficientdet": (jed.EfficientDetLite0, jed.EfficientDetLite0Detector,
                     ped.EfficientDetLite0Detector,
                     pw.efficientdet_from_flax, 320),
}


def _variables(family, seed=0):
    jnet, _, _, _, size = _SPEC[family]
    return numpy_flax_variables(jnet(compute_dtype=F32),
                                jnp.zeros((size, size, 3), F32), seed=seed)


def _pair(family, variables, **kw):
    """(JAX detector, port detector) with the same float32 weights."""
    _, jdet_cls, pdet_cls, bridge, size = _SPEC[family]
    if family != "efficientdet":
        kw["input_size"] = size
    jdet = jdet_cls(params=variables, compute_dtype=F32, **kw)
    pdet = pdet_cls(state_dict=bridge(_flatten(variables)), device="cpu",
                    compute_dtype=torch.float32, **kw)
    return jdet, pdet


class _Pairs(dict):
    """family -> (name, variables, (JAX detector, port detector)), built
    on first use."""

    def __missing__(self, name):
        variables = _variables(name)
        self[name] = (name, variables, _pair(name, variables))
        return self[name]


@pytest.fixture(scope="module")
def pairs():
    return _Pairs()


@pytest.fixture(params=FAMILIES)
def family(request, pairs):
    return pairs[request.param]


def _image(seed, size):
    return np.random.RandomState(seed).randint(
        0, 256, (size, size, 3)).astype(np.float32)


def _tie_heavy(rng, shape, lo=-8, hi=8, step=4.0):
    return (rng.randint(lo, hi, shape) / step).astype(np.float32)


class _FixedNet:
    """Stands in for a network: returns the given outputs (JAX `apply`,
    port call)."""

    def __init__(self, outs, port):
        self.outs, self.port = outs, port

    def apply(self, params, image):
        return [jnp.asarray(o) for o in self.outs] if \
            isinstance(self.outs, list) else \
            tuple(jnp.asarray(o) for o in self.outs)

    def __call__(self, image):
        return self.port


def _heads(family, rng):
    """Tie-heavy raw outputs as numpy (JAX layout) and port tensors."""
    if family == "efficientdet":
        n = len(ped.generate_anchors())
        outs = (rng.normal(0, 0.5, (n, 4)).astype(np.float32),
                _tie_heavy(rng, (n, ped.NUM_CLASSES)))
        return outs, tuple(torch.from_numpy(o)[None] for o in outs)
    strides = py5.STRIDES if family == "yolov5" else py3.STRIDES
    outs = [_tie_heavy(rng, (SMALL // s, SMALL // s, 255)) for s in strides]
    return outs, [torch.from_numpy(o)[None] for o in outs]


def _same_detections(got, want, min_valid=5):
    """classes / valid exact, scores 1e-6 and boxes 1e-5 relative: the
    rows picked and their order agree."""
    got = [g[0].numpy() for g in got]
    want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5,
                               atol=1e-5 * np.abs(want[0]).max())
    assert got[3].sum() >= min_valid


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_tie_heavy_matches_jax(family, seed):
    name, _, (jdet, pdet) = family
    rng = np.random.RandomState(20 + seed)
    outs, port = _heads(name, rng)
    if name == "yolov5":
        kw = dict(score_threshold=0.3, max_outputs=64)
        want = jy5.postprocess_heads([jnp.asarray(o) for o in outs], SMALL,
                                     jnp.float32(640), jnp.float32(480),
                                     **kw)
        got = py5.postprocess_heads(port, SMALL, 640.0, 480.0, **kw)
        return _same_detections(got, want)
    # YOLOv3 (letterboxed 1280x720) and EfficientDet: `detect` with the
    # networks swapped for the fixed heads
    nets = jdet.net, pdet.net
    try:
        jdet.net, pdet.net = _FixedNet(outs, port), _FixedNet(outs, port)
        if name == "yolov3":
            assert jdet.configure_letterbox(1280, 720) == \
                pdet.configure_letterbox(1280, 720) == (0, 28, 128, 72)
        want = jdet.detect(None, None, jnp.float32(1280), jnp.float32(720))
        got = pdet.detect(None, 1280.0, 720.0)
    finally:
        jdet.net, pdet.net = nets
        jdet._lb = pdet._lb = None
    _same_detections(got, want)


def test_network_and_detect_match_jax(family):
    """The raw outputs of the network on a seeded image, then `detect` end
    to end (JAX's decode run on its own raw outputs)."""
    name, variables, (jdet, pdet) = family
    img = _image(1, pdet.width)
    want = jax.jit(jdet.net.apply)(variables, jnp.asarray(img))
    with torch.inference_mode():
        got = pdet.net(torch.from_numpy(img)[None])
        dets = [g[0] for g in pdet.detect(torch.from_numpy(img)[None],
                                          640.0, 480.0)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (1,) + w.shape
        assert np.abs(g[0].numpy() - w).max() <= \
            1e-4 * np.abs(w).max() + 1e-5
    net = jdet.net
    try:
        jdet.net = _FixedNet(list(want) if isinstance(want, list)
                             else tuple(want), None)
        want = jdet.detect(None, None, jnp.float32(640), jnp.float32(480))
    finally:
        jdet.net = net
    np.testing.assert_array_equal(dets[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(dets[1].numpy(), np.asarray(want[1]))
    assert dets[3].sum() > 0
    # scores and pixel boxes from float32 networks (as above)
    np.testing.assert_allclose(dets[2].numpy(), np.asarray(want[2]),
                               atol=1e-4)
    np.testing.assert_allclose(dets[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-2)


class _Canvas:
    """A detector that returns its (letterboxed) input: the JAX and the
    port FrameStep call `detect` with what they fed the network."""
    letterbox = True
    params = None
    labels = {0: "person"}
    compute_dtype = torch.float32
    device = None

    def __init__(self, size):
        self.width = self.height = self.input_size = size
        self._lb = None

    configure_letterbox = py3.YOLOv3Detector.configure_letterbox

    def detect(self, *args):
        return args[-3]


def test_letterbox_matches_jax():
    from deepdish_tpu import tracker as jt
    from deepdish_tpu.models.encoders import create_box_encoder as j_enc
    from deepdish_tpu.pipeline import FrameStep as JFrameStep
    from deepdish_tpu_torch import tracker as pt
    from deepdish_tpu_torch.models import create_box_encoder as p_enc
    from deepdish_tpu_torch.pipeline import FrameStep as PFrameStep
    # the JAX package's 1280x720 geometry (tests/test_models.py:168)
    jdet = jy3.YOLOv3Detector(params={}, compute_dtype=F32)
    pdet = py3.YOLOv3Detector.__new__(py3.YOLOv3Detector)
    pdet.input_size = 416
    assert pdet.configure_letterbox(1280, 720) == \
        jdet.configure_letterbox(1280, 720) == (0, 91, 416, 234)
    kw = dict(max_tracks=4, max_detections=2, num_labels=1, gallery_size=8,
              pending_size=2)
    rng = np.random.RandomState(3)
    for h, w, size in ((96, 128, 416), (120, 64, 128)):
        frame = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        jc, pc = _Canvas(size), _Canvas(size)
        jfs = JFrameStep(jc, j_enc("dummy"), jt.TrackerConfig(**kw),
                         ["person"], (h, w))
        pfs = PFrameStep(pc, p_enc("dummy", device="cpu"),
                         pt.TrackerConfig(**kw), ["person"], (h, w),
                         device="cpu")
        want = np.asarray(jfs._detect_raw({"det": None}, jnp.asarray(frame)))
        got = pfs._detect_raw(torch.from_numpy(frame)[None])[0].numpy()
        assert pc._lb == jc._lb
        left, top, nw, nh = pc._lb
        assert got.shape == want.shape == (size, size, 3)
        np.testing.assert_allclose(got, want, atol=1e-4)
        pad = np.ones((size, size), bool)
        pad[top:top + nh, left:left + nw] = False
        assert pad.any() and (got[pad] == 128.0).all()


LABELS = {0: "person", 1: "car", 2: "dog", 3: "cat"}


def test_label_filter_matches_jax():
    for allow, deny in ((["person", "car"], ["car"]), (["dog"], None),
                        (None, ["person"]), (None, None)):
        want = jed.build_label_filter_lut(LABELS, allow, deny)
        got = ped.build_label_filter_lut(LABELS, allow, deny)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got, np.asarray(want))
        rng = np.random.RandomState(4)
        classes = rng.randint(0, 7, (3, 12)).astype(np.int32)
        valid = rng.uniform(size=(3, 12)) < 0.8
        for max_results in (-1, 0, 3):
            w = [np.asarray(jed.apply_result_filter(
                jnp.asarray(c), jnp.asarray(v), want, max_results))
                for c, v in zip(classes, valid)]
            g = ped.apply_result_filter(
                torch.from_numpy(classes), torch.from_numpy(valid),
                torch.from_numpy(got), max_results)
            np.testing.assert_array_equal(g.numpy(), np.stack(w))


def test_efficientdet_result_filter_matches_jax(pairs):
    """allow / deny and max_results through `detect`, on the network's own
    detections: the JAX detector's result, and the unfiltered run's top
    survivors."""
    name, variables, (jbase, pbase) = pairs["efficientdet"]
    full = {i: LABELS[i % 4] for i in range(128)}
    img = _image(5, 320)
    kw = dict(score_threshold=0.0, top_k=64, label_deny=["person"],
              max_results=3)
    jdet, pdet = _pair(name, variables, **kw)
    outs = []
    for det in (pbase, pdet):
        det.labels = full
        det.finalize_label_filter()
        with torch.inference_mode():
            outs.append([g[0].numpy() for g in det.detect(
                torch.from_numpy(img)[None], 320.0, 320.0)])
    jdet.labels = full
    jdet.finalize_label_filter()
    want = jdet.detect_jit(jnp.asarray(img), jnp.float32(320),
                           jnp.float32(320))
    (_, cls_b, _, val_b), (_, cls_f, _, val_f) = outs
    np.testing.assert_array_equal(val_f, np.asarray(want[3]))
    np.testing.assert_array_equal(cls_f, np.asarray(want[1]))
    assert 0 < val_f.sum() <= 3
    base_keep = [int(c) for c, v in zip(cls_b, val_b)
                 if v and full[int(c)] != "person"][:3]
    assert [int(c) for c, v in zip(cls_f, val_f) if v] == base_keep


class _Stub:
    """Stands in for a detector class in the registry: records its
    keywords."""

    def __init__(self, **kw):
        self.kw = kw
        self.finalized = False

    def finalize_label_filter(self):
        self.finalized = True


def test_registry_dispatch(tmp_path, monkeypatch, pairs):
    """Names select families in the JAX package's order, keywords pass
    through, a weight file that does not convert raises the JAX package's
    message (or runs on random weights with allow_random_weights), an
    'int8' SSD name or detector_int8 selects the w8a8 SSD, and
    --quantized-inference refuses a name that is no .tflite file."""
    for cls in ("YOLOv5Detector", "YOLOv3Detector",
                "EfficientDetLite0Detector", "SSDMobileNetDetector",
                "FasterRCNNDetector"):
        monkeypatch.setattr(p_registry, cls, type(cls, (_Stub,), {}))

    def create(name, **kw):
        det = p_registry.create_detector(name, device="cpu", **kw)
        return type(det).__name__, det

    assert create("yolov5s-fp16")[0] == "YOLOv5Detector"
    assert create("yolov5s", score_threshold=0.1)[1].kw[
        "score_threshold"] == 0.25
    for name in ("yolo.h5", "yolov3-416", "my_yolo_ssd"):
        assert create(name)[0] == "YOLOv3Detector"
    for name in ("efficientdet-lite0", "model.tflite"):
        assert create(name)[0] == "EfficientDetLite0Detector"
    for name in ("ssd_mobilenet", "mobilenet_v2", "x_edgetpu.tflite"):
        assert create(name)[0] == "SSDMobileNetDetector"
    _, ed = create("efficientdet-lite0", label_allow=["person"],
                   label_deny=["car"], max_results=5, score_threshold=0.4)
    assert ed.kw["label_allow"] == ["person"] and \
        ed.kw["label_deny"] == ["car"] and ed.kw["max_results"] == 5
    assert ed.finalized and ed.labels[0] == "person" and \
        ed.kw["score_threshold"] == 0.4
    for name in ("faster_rcnn_resnet101", "frcnn", "yolov5_frcnn"):
        assert create(name)[0] == "FasterRCNNDetector"
    assert create("faster_rcnn", score_threshold=0.4)[1].kw[
        "score_threshold"] == 0.4
    # the int8 SSD: an 'int8' name that is no file, or detector_int8
    monkeypatch.setattr(p_ssd_q, "SSDMobileNetInt8Detector",
                        type("SSDMobileNetInt8Detector", (_Stub,), {}))
    calib = np.zeros((1, 8, 8, 3), np.float32)
    for name, kw in (("ssd_mobilenet_int8", {}),
                     ("ssd_mobilenet", {"detector_int8": True})):
        kind, det = create(name, calib_images=calib, **kw)
        assert kind == "SSDMobileNetInt8Detector"
        assert det.kw["calib_images"] is calib
    # --quantized-inference needs a full-integer .tflite file
    with pytest.raises(ValueError, match="full-integer"):
        create("ssd_mobilenet", quantized=True)
    with pytest.raises(ValueError, match="backend"):
        create("resnet50")
    for fname in ("yolov5s.tflite", "yolo.h5", "ssd_frozen.pb"):
        path = tmp_path / fname
        path.write_bytes(b"not a weight file")
        with pytest.raises(ValueError, match="weight conversion failed|"
                           "not a loadable weight artifact"):
            create(str(path))
        assert create(str(path), allow_random_weights=True)[1].kw[
            "state_dict"] is None
    # a .npz of the JAX variables loads to the bridged weights
    monkeypatch.undo()
    _, variables, _ = pairs["yolov5"]
    path = str(tmp_path / "yolov5s.npz")
    save_npz(variables, path)
    det = p_registry.create_detector(path, input_size=SMALL, device="cpu")
    want = pw.yolov5_from_flax(_flatten(variables))
    got = det.net.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


_CLI_NAMES = {"yolov5": "yolov5s.npz", "yolov3": "yolov3.npz",
              "efficientdet": "efficientdet_lite0.npz"}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", FAMILIES)
def test_cli_family_matches_jax(tmp_path, monkeypatch, pairs, f32_jax,
                                name):
    """Both CLIs on the same video and .npz weights; the JAX side's
    detectors bound to float32 (and both YOLOs to input size 128)."""
    _, variables, _ = pairs[name]
    weights = str(tmp_path / _CLI_NAMES[name])
    save_npz(variables, weights)
    size = {} if name == "efficientdet" else dict(input_size=SMALL)
    for mod, side in ((j_registry, 1), (p_registry, 2)):
        cls = _SPEC[name][side]
        kw = dict(size, compute_dtype=F32) if side == 1 else size
        monkeypatch.setattr(mod, cls.__name__, functools.partial(cls, **kw))
    video = tmp_path / "texture.mp4"
    _write_video(video, _texture_scene())
    logs = [tmp_path / "jax.log", tmp_path / "port.log"]
    pays = []
    for amain, log in zip((j_amain, p_amain), logs):
        asyncio.run(amain(["--input", str(video), "--model", weights,
                           "--encoder-model", "dummy",
                           "--wanted-labels", ",".join(COCO_LABELS),
                           "--score-threshold", "0.3",
                           "--chunk-size", "4", "--log", str(log)]
                          + COMMON))
        pays.append(RecordingMQTT.runs[-1])
    n_tracks, n_dets = _compare(*pays)
    assert len(_frames(pays[1])) == 10
    assert _last_counters(logs[1]) == _last_counters(logs[0])
    assert n_tracks > 0 and n_dets > 0
