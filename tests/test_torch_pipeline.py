"""The port's CLI against the JAX package's, on the CPU.

Both `amain`s run with --device cpu on the same small cv2-written video
(the tests/test_pipeline_e2e.py pattern), with a stand-in for MQTTClient
recording every payload in both runtimes. Identical: the final
pos/neg/int/del counters of --log and, per frame at --mqtt-verbosity 2,
framenum, track ids, labels and detection boxes; track boxes within 1 px,
confidences within 1e-5 relative.

  * Run 1: `--model scripted:bright`, background subtraction on (the
    default), 320x240, 48 frames, MARS from a .npz of JAX random-init
    variables given to both CLIs.
  * Run 2 (tests/test_torch_cli_ssd.py): SSD-MobileNetV1 and MARS from
    .npz files of JAX random-init variables, --chunk-size 1 and 4.

Also: --restore-from-log, a missing --input, the CUDA default, the parsers
(the same flags and defaults, --options-file expansion and its cycle
guard), gallery growth, and the scipy-labelled `scripted:bright` script
against the JAX package's cv2-labelled one.

The JAX package's SSD and MARS default to bf16 networks; the port's run
float32 on the CPU. The JAX side is held to float32 here by binding
compute_dtype in its registry and encoder modules (test-only; the package
is unchanged)."""
import asyncio
import functools
import json

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import cv2
import jax.numpy as jnp
import numpy as np

import deepdish_tpu.models.encoders as j_encoders
import deepdish_tpu.models.registry as j_registry
import deepdish_tpu.pipeline.runtime as j_runtime
import deepdish_tpu_torch.pipeline.runtime as p_runtime
from deepdish_tpu.models import ssd_mobilenet as jssd
from deepdish_tpu.models.mars import INPUT_SHAPE, MarsNet
from deepdish_tpu.models.weights import save_npz
from deepdish_tpu.pipeline.main import amain as j_amain
from deepdish_tpu_torch.pipeline.main import amain as p_amain
from test_torch_models import numpy_flax_variables

F32 = jnp.float32


class RecordingMQTT:
    """MQTTClient stand-in: records every payload published."""
    runs = []

    def __init__(self, *args, **kw):
        self.payloads = []
        RecordingMQTT.runs.append(self.payloads)

    async def connect(self):
        pass

    def publish(self, topic, payload, qos=0):
        self.payloads.append(json.loads(payload))

    async def disconnect(self):
        pass


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    ssd = numpy_flax_variables(jssd.SSDMobileNetV1(compute_dtype=F32),
                               jnp.zeros((300, 300, 3), F32), seed=0)
    mars = numpy_flax_variables(MarsNet(compute_dtype=F32),
                                jnp.zeros((1,) + INPUT_SHAPE, F32), seed=1)
    paths = {"ssd": str(d / "ssd_mobilenet.npz"), "mars": str(d / "mars.npz")}
    save_npz(ssd, paths["ssd"])
    save_npz(mars, paths["mars"])
    return paths


@pytest.fixture
def f32_jax(monkeypatch):
    """The JAX CLI with float32 networks, and both runtimes recording their
    MQTT payloads."""
    monkeypatch.setattr(j_registry, "SSDMobileNetDetector", functools.partial(
        jssd.SSDMobileNetDetector, compute_dtype=F32))
    monkeypatch.setattr(j_encoders, "make_mars_encoder", functools.partial(
        j_encoders.make_mars_encoder, compute_dtype=F32))
    for mod in (j_runtime, p_runtime):
        monkeypatch.setattr(mod, "MQTTClient", RecordingMQTT)
    RecordingMQTT.runs = []


def _write_video(path, frames_bgr, fps=15):
    h, w = frames_bgr[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    for f in frames_bgr:
        vw.write(f)
    vw.release()


def _rect_scene(w=320, h=240, n=48):
    """Two bright rectangles crossing x = w / 2 in opposite directions."""
    frames = []
    for i in range(n):
        f = np.zeros((h, w, 3), np.uint8)
        x1, x2 = 20 + 6 * i, 260 - 6 * i
        f[60:120, x1:x1 + 40] = (0, 0, 255)
        f[140:200, x2:x2 + 40] = (0, 255, 0)
        frames.append(f)
    return frames


def _texture_scene(w=160, h=120, n=10):
    """A random texture drifting 2 px a frame: every frame moves, so
    background subtraction keeps most boxes, and the random-weight SSD's
    detections persist from frame to frame."""
    rng = np.random.RandomState(5)
    base = rng.randint(0, 256, (h, w + 2 * n, 3)).astype(np.uint8)
    base = cv2.GaussianBlur(base, (5, 5), 0)
    return [np.ascontiguousarray(base[:, 2 * i:2 * i + w]) for i in range(n)]


def _frames(payloads):
    return [p for p in payloads if "framenum" in p]


def _last_counters(log):
    with open(log) as f:
        last = json.loads(f.readlines()[-1])
    return {k: v for k, v in last.items() if "count" in k and
            k != "frame_count"}


def _compare(jpay, ppay):
    jf, pf = _frames(jpay), _frames(ppay)
    assert [p["framenum"] for p in pf] == [p["framenum"] for p in jf]
    n_tracks = n_dets = 0
    for a, b in zip(jf, pf):
        fn = a["framenum"]
        assert b.get("detections", []) == a.get("detections", []), fn
        ta, tb = a.get("tracks", []), b.get("tracks", [])
        assert [(t["track_id"], t["label"]) for t in tb] == \
            [(t["track_id"], t["label"]) for t in ta], fn
        for x, y in zip(ta, tb):
            np.testing.assert_allclose(y["bbox"], x["bbox"], atol=1)
            np.testing.assert_allclose(y["confidence"], x["confidence"],
                                       rtol=1e-5)
        n_tracks += len(ta)
        n_dets += len(a.get("detections", []))
    return n_tracks, n_dets


COMMON = ["--device", "cpu", "--disable-graphics", "--streaming", "0",
          "--control-port", "0", "--mqtt-broker", "localhost",
          "--mqtt-verbosity", "2", "--max-detections", "8"]


@pytest.mark.timeout(300)
def test_cli_scripted_bright_matches_jax(tmp_path, weights, f32_jax):
    video = tmp_path / "rects.mp4"
    _write_video(video, _rect_scene())
    logs = [tmp_path / "jax.log", tmp_path / "port.log"]
    pays = []
    for amain, log in zip((j_amain, p_amain), logs):
        asyncio.run(amain(["--input", str(video), "--model",
                           "scripted:bright", "--encoder-model",
                           weights["mars"], "--log", str(log)] + COMMON))
        pays.append(RecordingMQTT.runs[-1])
    n_tracks, n_dets = _compare(*pays)
    assert len(_frames(pays[1])) == 48
    counters = _last_counters(logs[1])
    assert counters == _last_counters(logs[0])
    assert counters["poscount_person"] >= 1 and \
        counters["negcount_person"] >= 1
    assert n_tracks > 48 and n_dets > 48




def test_cli_restore_from_log(tmp_path):
    log = tmp_path / "restore.log"
    log.write_text(json.dumps({
        "poscount_person": 5, "negcount_person": 2, "intcount_person": 7,
        "delcount_person": 1, "frame_count": 99}) + "\n")
    video = tmp_path / "v.mp4"
    _write_video(video, _rect_scene(n=6))
    asyncio.run(p_amain(["--input", str(video), "--log", str(log),
                         "--restore-from-log", "--max-frames", "3",
                         "--model", "scripted:noop", "--encoder-model",
                         "dummy", "--device", "cpu", "--disable-graphics",
                         "--streaming", "0", "--control-port", "0"]))
    lines = [json.loads(line) for line in open(log)]
    assert lines[-1]["poscount_person"] == 5
    assert lines[-1]["negcount_person"] == 2
    assert lines[-1]["delcount_person"] == 1


class _WatchedCapture:
    """cv2.VideoCapture's interface over blank frames that records which
    thread releases it and whether a release overlaps a read."""

    def __init__(self, n_frames):
        import threading
        self.n, self.i = n_frames, 0
        self.reading = 0
        self.overlap = False
        self.released_by = []
        self.released = threading.Event()

    def read(self):
        import time
        self.reading += 1
        time.sleep(0.002)
        self.reading -= 1
        if self.i >= self.n:
            return False, None
        self.i += 1
        return True, np.zeros((48, 64, 3), np.uint8)

    def get(self, prop):
        return {p_runtime.CAP_PROP_FRAME_WIDTH: 64,
                p_runtime.CAP_PROP_FRAME_HEIGHT: 48,
                p_runtime.CAP_PROP_FPS: 15.0}.get(prop, 0)

    def set(self, prop, value):
        return True

    def release(self):
        import threading
        self.overlap |= self.reading > 0
        self.released_by.append(threading.current_thread()
                                is threading.main_thread())
        self.released.set()


def test_cli_capture_released_by_its_thread(monkeypatch, tmp_path):
    """A run stopped by --max-frames leaves the capture to the capture
    thread, which releases it once, never during its own read: a release
    from the event loop while that thread is in cap.read() can deadlock
    inside OpenCV."""
    from deepdish_tpu_torch.pipeline import main as p_main
    caps = []

    class WatchedPipeline(p_runtime.Pipeline):
        def _open_capture(self, source):
            caps.append(_WatchedCapture(40))
            return caps[-1]

    monkeypatch.setattr(p_main, "Pipeline", WatchedPipeline)
    asyncio.run(p_amain(["--input", "synthetic://blank", "--max-frames",
                         "3", "--model", "scripted:noop", "--encoder-model",
                         "dummy", "--device", "cpu", "--disable-graphics",
                         "--streaming", "0", "--control-port", "0",
                         "--log", str(tmp_path / "run.log")]))
    cap, = caps
    assert cap.released.wait(10)
    assert cap.released_by == [False] and not cap.overlap


def test_cli_missing_input_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="--input"):
        asyncio.run(p_amain(["--input", str(tmp_path / "nope.mp4"),
                             "--device", "cpu", "--disable-graphics",
                             "--model", "scripted:noop", "--encoder-model",
                             "dummy", "--control-port", "0"]))


def test_cli_needs_a_card_unless_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    video = tmp_path / "v.mp4"
    _write_video(video, _rect_scene(n=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(p_amain(["--input", str(video), "--disable-graphics",
                             "--model", "scripted:noop", "--encoder-model",
                             "dummy", "--control-port", "0"]))


@pytest.mark.parametrize("argv", [
    ["--quantized-inference"],
    ["--detector-int8", "--detector-calibration-frames", "missing.npy"]],
    ids=["quantized", "int8"])
def test_cli_later_slices_raise(tmp_path, argv):
    """The quantized switches (ported in a later slice than the CLI) reach
    the registry and fail as the JAX CLI does on what they are given: a
    --model that is no full-integer .tflite, a calibration file that does
    not exist."""
    argv = [str(tmp_path / a) if a.endswith(".npy") else a for a in argv]
    errors = []
    for amain, extra in ((j_amain, []), (p_amain, ["--device", "cpu"])):
        with pytest.raises((ValueError, FileNotFoundError)) as e:
            asyncio.run(amain(["--input", str(tmp_path), "--control-port",
                               "0", "--disable-graphics", "--streaming",
                               "0"] + extra + argv))
        errors.append((type(e.value), str(e.value)))
    assert errors[1] == errors[0]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_flags_and_defaults():
    from deepdish_tpu.pipeline.config import build_parser as j_build
    from deepdish_tpu_torch.pipeline.config import build_parser as p_build
    ja, pa = _actions(j_build()), _actions(p_build())
    assert sorted(pa) == sorted(ja)
    for dest, a in ja.items():
        b = pa[dest]
        for attr in ("option_strings", "default", "nargs", "const",
                     "choices", "required", "metavar" if dest != "device"
                     else "dest"):
            assert getattr(b, attr) == getattr(a, attr), (dest, attr)
        assert type(b) is type(a), dest
        if a.type in (int, float, None):
            assert b.type is a.type, dest
        else:                      # --streaming's predicate
            for word in ("0", "false", "False", "", "1", "yes"):
                assert b.type(word) == a.type(word), (dest, word)


def test_get_arguments_and_options_files(tmp_path, monkeypatch):
    from deepdish_tpu.pipeline import config as jcfg
    from deepdish_tpu_torch.pipeline import config as pcfg
    (tmp_path / "a.opts").write_text(
        "# comment\n--model 'scripted:bright' --max-age 9\n"
        "--options-file b.opts\n")
    (tmp_path / "b.opts").write_text('--wanted-labels "person,car"\n')
    monkeypatch.setenv("DEEPDISHHOME", str(tmp_path))
    argv = ["--options-file", "a.opts", "--chunk-size", "4"]
    pa, ja = pcfg.get_arguments(argv), jcfg.get_arguments(argv)
    assert vars(pa) == vars(ja)
    assert (pa.model, pa.max_age, pa.wanted_labels, pa.chunk_size) == \
        ("scripted:bright", 9, "person,car", 4)
    assert pa.deepsorthome == str(tmp_path)
    assert pcfg.quoted_split('a "b c" \'d e\'') == \
        jcfg.quoted_split('a "b c" \'d e\'') == ["a", "b c", "d e"]
    (tmp_path / "b.opts").write_text("--options-file=a.opts\n")
    with pytest.raises(ValueError, match="cycle"):
        pcfg.get_arguments(argv)


def test_gallery_growth_matches_jax():
    import torch
    from deepdish_tpu import tracker as jt
    from deepdish_tpu_torch import tracker as pt
    kw = dict(max_tracks=4, max_detections=2, feature_dim=8, gallery_size=6,
              pending_size=2, num_labels=1)
    jcfg, pcfg = jt.TrackerConfig(**kw), pt.TrackerConfig(**kw)
    rng = np.random.RandomState(4)
    jtab = jt.create_table(jcfg)
    counts = np.array([0, 3, 6, 2], np.int32)
    jtab = jtab._replace(
        gallery=jnp.asarray(rng.normal(size=(4, 6, 8)).astype(np.float32)),
        gallery_count=jnp.asarray(counts))
    ptab = pt.TrackTable(*(torch.from_numpy(np.array(x)) for x in jtab))
    assert pt.gallery_pressure(pcfg, ptab) == \
        jt.gallery_pressure(jcfg, jtab) == 6
    assert pt.gallery_overflow(pcfg, ptab) == \
        jt.gallery_overflow(jcfg, jtab) == 0
    jcfg2, jtab2 = jt.grow_gallery(jcfg, jtab, 12)
    pcfg2, ptab2 = pt.grow_gallery(pcfg, ptab, 12)
    assert pcfg2.gallery_size == jcfg2.gallery_size == 12
    for a, b in zip(ptab2, jtab2):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="only grow"):
        pt.grow_gallery(pcfg, ptab, 4)
    wrapped = ptab._replace(gallery_count=torch.tensor([0, 9, 6, 7],
                                                       dtype=torch.int32))
    jwrapped = jtab._replace(gallery_count=jnp.asarray([0, 9, 6, 7],
                                                       jnp.int32))
    assert pt.gallery_overflow(pcfg, wrapped) == \
        jt.gallery_overflow(jcfg, jwrapped) == 4
    with pytest.raises(ValueError, match="wrapped"):
        pt.grow_gallery(pcfg, wrapped, 12)


def test_bright_blob_script_matches_jax():
    """The port labels with scipy.ndimage, the JAX package with cv2's
    4-connected components: the same boxes, in the same order, the same
    scores, on scenes with touching, diagonal-only and too-small blobs."""
    from deepdish_tpu.models.registry import _bright_blob_script as j_script
    from deepdish_tpu_torch.models.registry import \
        _bright_blob_script as p_script
    rng = np.random.RandomState(6)
    n_boxes = 0
    for _ in range(8):
        f = rng.randint(0, 120, (120, 160, 3)).astype(np.uint8)
        for _ in range(rng.randint(2, 9)):
            x, y = rng.randint(0, 150), rng.randint(0, 110)
            w, h = rng.randint(4, 50), rng.randint(4, 50)
            f[y:y + h, x:x + w, rng.randint(0, 3)] = rng.randint(151, 256)
        # two blocks that touch only at a corner: two components at
        # 4-connectivity
        f[90:110, 10:30] = 200
        f[110:130, 30:50] = 200
        got, want = p_script(f), j_script(f)
        assert got[0] == want[0] and got[1] == want[1]
        np.testing.assert_allclose(got[2], want[2], rtol=1e-12)
        n_boxes += len(got[0])
    assert n_boxes > 16
    assert p_script(np.zeros((40, 40, 3), np.uint8)) == ([], [], [])


def test_label_files(tmp_path):
    from deepdish_tpu.models.registry import load_labels as j_load
    from deepdish_tpu_torch.models.registry import (_detection_labels,
                                                    load_labels)
    path = tmp_path / "labels.txt"
    path.write_text("person\ncar\nbus\n")
    assert load_labels(str(path)) == j_load(str(path)) == \
        ["person", "car", "bus"]
    assert load_labels(None) == j_load(None)
    assert _detection_labels(str(path)) == {0: "person", 1: "car", 2: "bus"}
    # a .pbtxt label map: 1-based ids shifted to the 0-based contract
    from deepdish_tpu.models.registry import _detection_labels as j_labels
    pbtxt = tmp_path / "map.pbtxt"
    pbtxt.write_text('item {\n  id: 1\n  name: "person"\n}\n'
                     'item { id: 3 name: "x" display_name: "dog" }\n')
    assert _detection_labels(str(pbtxt)) == j_labels(str(pbtxt)) == \
        {0: "person", 2: "dog"}
    missing = str(tmp_path / "missing.pbtxt")
    assert _detection_labels(missing) == j_labels(missing)


def test_module_entry_point(tmp_path):
    """`python -m deepdish_tpu_torch.pipeline.main` in a fresh process:
    runs with --device cpu, and without it fails for want of a card."""
    import os
    import subprocess
    import sys

    import torch
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    video = tmp_path / "v.mp4"
    _write_video(video, _rect_scene(n=4))
    env = dict(os.environ, PYTHONPATH=root)
    argv = [sys.executable, "-m", "deepdish_tpu_torch.pipeline.main",
            "--input", str(video), "--model", "scripted:noop",
            "--encoder-model", "dummy", "--disable-graphics", "--streaming",
            "0", "--control-port", "0", "--log", str(tmp_path / "log")]
    ok = subprocess.run(argv + ["--device", "cpu"], capture_output=True,
                        text=True, timeout=120, env=env, cwd=tmp_path)
    assert ok.returncode == 0, ok.stderr
    assert "Frame 4:" in ok.stdout
    if torch.cuda.is_available():
        return
    bad = subprocess.run(argv, capture_output=True, text=True, timeout=120,
                         env=env, cwd=tmp_path)
    assert bad.returncode != 0 and "CUDA" in bad.stderr
