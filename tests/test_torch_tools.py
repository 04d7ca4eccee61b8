"""The port's last tools against the JAX package's, on the CPU:
`ops/geometry` (segment intersection, crossing direction, polyline hits),
`tools/mot_features` (MOTChallenge re-ID features) and
`tools/multistream_demo` (N videos through the multi-stream engine).

  * geometry: seeded random float32 segments (leading shapes (N,) and
    (A, B)) plus the hand cases of tests/test_ops_boxes_geometry.py and
    parallel, colinear-overlap, touching-end and zero-length pairs, and the
    polyline validity mask: booleans and signs exact.
  * mot_features: tests/test_mot_tool.py's three-frame synthetic sequence;
    `main` with `--model dummy --device cpu` in both packages, and
    `extract_sequence` with the same numpy-made float32 MARS on both
    sides (bridged with `mars_from_flax`): det.txt rows exact, features
    within 1e-5.
  * multistream_demo: tests/test_multistream_demo.py's three videos
    (`make_video`), SSD-MobileNetV1 and MARS from .npz files of the same
    numpy-made float32 variables (tests/test_torch_pipeline.py's
    `weights`), every COCO label wanted at threshold 0.3 so the random
    detector's boxes reach the trackers: `streams`, `frames` and every
    stream's counters equal to the JAX demo's, and frame by frame the
    track ids, states and matches each stream's counter was given (boxes
    within 1e-3: float32 Kalman means). The JAX demo's networks are
    held to float32 by binding compute_dtype in its registry and encoder
    modules (test-only; the package is unchanged)."""
import functools

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import cv2
import jax.numpy as jnp
import numpy as np
import torch

import deepdish_tpu.models.encoders as j_encoders
import deepdish_tpu.models.registry as j_registry
from deepdish_tpu.models import ssd_mobilenet as jssd
from deepdish_tpu.models.encoders import make_dummy_encoder as j_dummy
from deepdish_tpu.models.encoders import make_mars_encoder as j_mars
from deepdish_tpu.models.mars import INPUT_SHAPE, MarsNet
from deepdish_tpu.models.weights import _flatten, save_npz
from deepdish_tpu.ops import geometry as jgeo
from deepdish_tpu.tools import mot_features as j_mot
from deepdish_tpu.tools import multistream_demo as j_demo
from deepdish_tpu_torch.models import COCO_LABELS
from deepdish_tpu_torch.models.encoders import make_dummy_encoder as p_dummy
from deepdish_tpu_torch.models.encoders import make_mars_encoder as p_mars
from deepdish_tpu_torch.models.weights import mars_from_flax
from deepdish_tpu_torch.ops import geometry as pgeo
from deepdish_tpu_torch.tools import mot_features as p_mot
from deepdish_tpu_torch.tools import multistream_demo as p_demo
from test_pipeline_e2e import make_video
from test_torch_models import numpy_flax_variables
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

F32 = jnp.float32


# ---- ops/geometry ----

def _both(fn, *args):
    """fn of both packages on the same float32 arrays, as numpy."""
    j = np.asarray(getattr(jgeo, fn)(*(jnp.asarray(a) for a in args)))
    p = getattr(pgeo, fn)(*(torch.from_numpy(np.asarray(a)) for a in args))
    return j, p.numpy()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("shape", [(4000,), (40, 60)])
def test_geometry_random_segments_match_jax(shape):
    rng = np.random.RandomState(5)
    p, pr, q, qs = (rng.uniform(-10, 10, shape + (2,)).astype(np.float32)
                    for _ in range(4))
    # integer grid points too: parallel and colinear pairs, shared ends
    g = rng.randint(-3, 4, (4,) + shape + (2,)).astype(np.float32)
    for args in ((p, pr, q, qs), tuple(g)):
        j, t = _both("segments_intersect", *args)
        assert t.dtype == np.bool_ and t.shape == shape
        np.testing.assert_array_equal(t, j)
        assert 0 < t.sum() < t.size
        j, t = _both("crossing_direction", *args[:3])
        np.testing.assert_array_equal(t, j)


@pytest.mark.timeout(120)
def test_geometry_hand_cases_match_jax():
    f = lambda x: np.array(x, np.float32)   # noqa: E731
    p1, q1 = f([0, 0]), f([1, 0])
    cases = [
        # tools/intersection.py:35-57's cases
        ((p1, q1, f([1, -1]), f([0, 1])), True),
        ((p1, q1, f([1, 2]), f([1, 1])), False),
        ((p1, q1, f([1.01, 0]), f([2, 0])), False),      # colinear, apart
        ((f([1, 2]), f([1, 1]), f([1, 2]), f([1, 3])), True),
        ((p1, q1, f([0, 1]), f([1, 1])), False),         # parallel
        ((p1, q1, f([0.5, 0]), f([3, 0])), True),        # colinear overlap
        ((p1, q1, f([1, 0]), f([2, 1])), True),          # touching ends
        ((p1, q1, f([0.5, 0]), f([0.5, 0])), True),      # zero length on it
        ((p1, q1, f([0.5, 1]), f([0.5, 1])), False),     # zero length off
        ((p1, p1, f([0, 0]), f([0, 0])), True),          # both points
    ]
    for args, want in cases:
        j, t = _both("segments_intersect", *args)
        assert bool(t) == bool(j) == want, args
    pts1 = f([[1, 2], [1, 1], [1, -1], [1, -2]])
    pts2 = f([[1, 2], [1, 1], [3, 1], [3, -2]])
    for pts, want in ((pts1, True), (pts2, False)):
        j, t = _both("any_intersection", p1, q1, pts)
        assert bool(t) == bool(j) == want
    for valid, want in (([True, True, False, False], False),
                        ([True] * 4, True)):
        j = jgeo.any_intersection(p1, q1, jnp.asarray(pts1),
                                  jnp.asarray(valid))
        t = pgeo.any_intersection(torch.from_numpy(p1),
                                  torch.from_numpy(q1),
                                  torch.from_numpy(pts1),
                                  torch.tensor(valid))
        assert bool(t) == bool(j) == want
    a, b = f([0, 0]), f([0, 10])             # vertical countline
    for q, sign in ((f([-5, 5]), 1.0), (f([5, 5]), -1.0), (f([0, 7]), 0.0)):
        j, t = _both("crossing_direction", a, b, q)
        assert float(t) == float(j) == sign
    # the float64 eps decides parallelism on float32 inputs too
    assert pgeo._EPS == jgeo._EPS == float(np.finfo(np.float64).eps)


# ---- tools/mot_features ----

@pytest.fixture(scope="module")
def mot_dir(tmp_path_factory):
    """tests/test_mot_tool.py's synthetic MOTChallenge sequence."""
    root = tmp_path_factory.mktemp("mot")
    seq = root / "mot" / "SEQ-01"
    (seq / "img1").mkdir(parents=True)
    (seq / "det").mkdir(parents=True)
    rng = np.random.RandomState(0)
    dets = []
    for f in range(1, 4):
        img = rng.randint(0, 255, size=(120, 160, 3)).astype(np.uint8)
        cv2.imwrite(str(seq / "img1" / f"{f:06d}.jpg"), img)
        # det.txt rows: frame, id, x, y, w, h, conf, -1, -1, -1
        dets.append([f, -1, 10 + f, 20, 30, 60, 0.9, -1, -1, -1])
        dets.append([f, -1, 80, 30, 25, 50, 0.8, -1, -1, -1])
    np.savetxt(str(seq / "det" / "det.txt"), np.array(dets), delimiter=",")
    return root / "mot"


@pytest.mark.timeout(300)
def test_mot_features_main_matches_jax(mot_dir, tmp_path):
    outs = []
    for main, name in ((j_mot.main, "jax"), (p_mot.main, "port")):
        main(["--mot_dir", str(mot_dir), "--output_dir",
              str(tmp_path / name), "--model", "dummy", "--device", "cpu"])
        outs.append(np.load(str(tmp_path / name / "SEQ-01.npy")))
    j, p = outs
    assert p.shape == j.shape == (6, 10 + 128)
    np.testing.assert_array_equal(p[:, :10], j[:, :10])
    np.testing.assert_allclose(p[:, 10:], j[:, 10:], atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(p[:, 10:], axis=1), 1.0,
                               atol=1e-4)


@pytest.mark.timeout(300)
def test_mot_features_extract_sequence_mars_matches_jax(mot_dir):
    mars_vars = numpy_flax_variables(MarsNet(compute_dtype=F32),
                                     jnp.zeros((1,) + INPUT_SHAPE, F32),
                                     seed=1)
    jenc = j_mars(params=mars_vars, compute_dtype=F32)
    penc = p_mars(state_dict=mars_from_flax(_flatten(mars_vars)),
                  device="cpu", compute_dtype=torch.float32)
    seq = str(mot_dir / "SEQ-01")
    det = str(mot_dir / "SEQ-01" / "det" / "det.txt")
    j = j_mot.extract_sequence(jenc, seq, det, batch_capacity=4)
    p = p_mot.extract_sequence(penc, seq, det, batch_capacity=4)
    assert p.shape == j.shape == (6, 10 + 128)
    np.testing.assert_array_equal(p[:, :10], j[:, :10])
    np.testing.assert_allclose(p[:, 10:], j[:, 10:], atol=1e-5)
    # the dummy encoder through the same padded batches of the default 32
    j = j_mot.extract_sequence(j_dummy(), seq, det)
    p = p_mot.extract_sequence(p_dummy(device="cpu"), seq, det)
    np.testing.assert_allclose(p, j, atol=1e-5)


# ---- tools/multistream_demo ----

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
    """The JAX demo with float32 networks."""
    monkeypatch.setattr(j_registry, "SSDMobileNetDetector", functools.partial(
        jssd.SSDMobileNetDetector, compute_dtype=F32))
    monkeypatch.setattr(j_encoders, "make_mars_encoder", functools.partial(
        j_encoders.make_mars_encoder, compute_dtype=F32))


def _recording(counting_module, monkeypatch):
    """Binds a CountingState that records every track output it is given
    (stream by stream, frame by frame) into the demo's counting module;
    returns the list the records go to."""
    seen = []

    class Recording(counting_module.CountingState):
        def __init__(self, *args):
            super().__init__(*args)
            self.outs = []
            seen.append(self.outs)

        def process(self, out):
            self.outs.append({k: np.asarray(getattr(out, k)) for k in
                              ("track_id", "state", "matched_det", "tlwh")})
            return super().process(out)

    monkeypatch.setattr(counting_module, "CountingState", Recording)
    return seen


@pytest.mark.timeout(600)
def test_multistream_demo_matches_jax(tmp_path, weights, f32_jax,
                                      monkeypatch):
    """Two chunks of 8 frames a stream: the counters and, frame by frame,
    the track outputs each stream's counter was given."""
    import deepdish_tpu.pipeline.counting as j_counting
    import deepdish_tpu_torch.pipeline.counting as p_counting
    paths = []
    for i in range(3):
        p = tmp_path / f"v{i}.mp4"
        make_video(p)
        paths.append(str(p))
    argv = ["--inputs", *paths, "--model", weights["ssd"],
            "--encoder-model", weights["mars"],
            "--wanted-labels", ",".join(COCO_LABELS),
            "--score-threshold", "0.3", "--width", "192", "--height", "96",
            "--max-frames", "16", "--device", "cpu"]
    j_seen = _recording(j_counting, monkeypatch)
    p_seen = _recording(p_counting, monkeypatch)
    j = j_demo.main(argv)
    p = p_demo.main(argv)
    assert p["streams"] == j["streams"] == 3
    assert p["frames"] == j["frames"] == 48
    assert len(p["per_stream"]) == 3
    assert p["per_stream"] == j["per_stream"]
    assert [len(s) for s in p_seen] == [len(s) for s in j_seen] == [16] * 3
    matched = 0
    for s, (ps, js) in enumerate(zip(p_seen, j_seen)):
        for f, (po, jo) in enumerate(zip(ps, js)):
            for k in ("track_id", "state", "matched_det"):
                np.testing.assert_array_equal(
                    po[k], jo[k], err_msg=f"stream {s} frame {f} {k}")
            np.testing.assert_allclose(po["tlwh"], jo["tlwh"], rtol=1e-5,
                                       atol=1e-3)
            matched += int((po["matched_det"] >= 0).sum())
        assert (ps[-1]["state"] == 2).any(), f"stream {s}: none confirmed"
    assert matched > 0


def test_multistream_demo_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        p_demo.main(["--inputs", str(tmp_path / "none.mp4"),
                     "--encoder-model", "dummy"])
