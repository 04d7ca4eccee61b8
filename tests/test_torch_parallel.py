"""The port's MultiStreamEngine against deepdish_tpu's, on the CPU.

Both engines shard S = 4 streams over a mesh of two devices: the JAX one
over two of the 8 virtual CPU devices of tests/conftest.py (`make_mesh(2)`),
the port's over two copies of the CPU device (`make_mesh(2,
device="cpu")`). The networks are tests/test_torch_framestep.py's float32
SSD-MobileNetV1 and MARS made from the same numpy seeds on both sides
(`numpy_flax_variables`, bridged with `ssd_from_flax` / `mars_from_flax`),
every COCO label wanted at threshold 0.3.

The streams are that file's 96x128 frames (one random image plus small
per-frame noise, so tracks confirm and the cascade runs) as they are,
flipped left-right, rolled 72 px along x and turned by 180 degrees: four
different scenes. Like that file's, the inputs were chosen so that no
score sits within float32 noise of the 0.3 threshold and no box edge
within it of an integer (`test_inputs_have_margins` checks it on the
port's raw outputs; a roll of 40 px put an edge 7.6e-6 from an integer),
so no detection flips between the two packages' float32 runs, nor between
the port's batch of a device's streams and its single-stream run.

Held exactly: track ids, states, `matched_det` and the integer-truncated
post-NMS boxes and their valid mask, for `step`, `step_chunk` (F = 3) and
`step_chunk_yuv`; Kalman means within 1e-4 (float32 arithmetic in two
orders). The JAX engines are built and run once for the module: their
`shard_map` compiles are most of the file's time."""
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import cv2
import jax.numpy as jnp
import numpy as np
import torch

from deepdish_tpu import tracker as jt
from deepdish_tpu.models import ssd_mobilenet as jssd
from deepdish_tpu.models.encoders import make_mars_encoder as j_mars
from deepdish_tpu.models.mars import INPUT_SHAPE, MarsNet
from deepdish_tpu.models.weights import _flatten
from deepdish_tpu.parallel import MultiStreamEngine as JEngine
from deepdish_tpu.parallel import make_mesh as j_make_mesh
from deepdish_tpu.pipeline import FrameStep as JFrameStep
from deepdish_tpu.pipeline import FrameStepConfig as JConfig
from deepdish_tpu_torch import tracker as pt
from deepdish_tpu_torch.models import COCO_LABELS
from deepdish_tpu_torch.models import ssd_mobilenet as pssd
from deepdish_tpu_torch.models.encoders import make_mars_encoder as p_mars
from deepdish_tpu_torch.models.weights import mars_from_flax, ssd_from_flax
from deepdish_tpu_torch.parallel import MultiStreamEngine as PEngine
from deepdish_tpu_torch.parallel import make_mesh as p_make_mesh
from deepdish_tpu_torch.pipeline import FrameStep as PFrameStep
from deepdish_tpu_torch.pipeline import FrameStepConfig as PConfig
from test_torch_models import numpy_flax_variables
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

F32 = jnp.float32
H, W = 96, 128
S, F = 4, 3
WANTED = COCO_LABELS
TRACKER = dict(max_tracks=16, max_detections=8, gallery_size=32,
               num_labels=len(WANTED), max_age=10)
INTS = ("track_id", "state", "matched_det", "deleted_id", "hits")


def build_pair():
    """Both packages' float32 FrameSteps on the same numpy-made weights."""
    ssd_vars = numpy_flax_variables(jssd.SSDMobileNetV1(compute_dtype=F32),
                                    jnp.zeros((300, 300, 3), F32), seed=0)
    mars_vars = numpy_flax_variables(MarsNet(compute_dtype=F32),
                                     jnp.zeros((1,) + INPUT_SHAPE, F32),
                                     seed=1)
    jdet = jssd.SSDMobileNetDetector(params=ssd_vars, compute_dtype=F32,
                                     score_threshold=0.3)
    jdet.labels = {i: n for i, n in enumerate(COCO_LABELS)}
    jfs = JFrameStep(jdet, j_mars(params=mars_vars, compute_dtype=F32),
                     jt.TrackerConfig(**TRACKER), WANTED, (H, W),
                     JConfig(score_threshold=0.3))
    pdet = pssd.SSDMobileNetDetector(
        state_dict=ssd_from_flax(_flatten(ssd_vars)), device="cpu",
        compute_dtype=torch.float32, score_threshold=0.3)
    pdet.labels = dict(jdet.labels)
    penc = p_mars(state_dict=mars_from_flax(_flatten(mars_vars)),
                  device="cpu", compute_dtype=torch.float32)
    pfs = PFrameStep(pdet, penc, pt.TrackerConfig(**TRACKER), WANTED, (H, W),
                     PConfig(score_threshold=0.3), device="cpu")
    return jfs, pfs


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def stream_frames(n=F):
    """(S, n, H, W, 3), n <= 8: test_torch_framestep.py's base image with
    8 frames of noise, as they are, flipped left-right, rolled 72 px along
    x and turned by 180 degrees."""
    rng = np.random.RandomState(2)
    base = rng.randint(0, 256, (H, W, 3))
    noise = rng.randint(-4, 5, (8, H, W, 3))
    frames = np.clip(base[None] + noise, 0, 255).astype(np.uint8)[:n]
    return np.ascontiguousarray(np.stack([
        frames, frames[:, :, ::-1], np.roll(frames, 72, axis=2),
        frames[:, ::-1, ::-1]]))


def to_i420(frames):
    """(..., H, W, 3) RGB -> (..., H*3/2, W) planar I420 (cv2)."""
    flat = frames.reshape((-1, H, W, 3))
    out = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420) for f in flat])
    return out.reshape(frames.shape[:-3] + out.shape[1:])


@pytest.fixture(scope="module")
def frames():
    return stream_frames()


@pytest.fixture(scope="module")
def engines(pair):
    jfs, pfs = pair
    return (JEngine(jfs, n_streams=S, mesh=j_make_mesh(2)),
            PEngine(pfs, n_streams=S, mesh=p_make_mesh(2, device="cpu")))


@pytest.fixture(scope="module")
def runs(engines, frames):
    """Both engines' step (frame 0), step_chunk and step_chunk_yuv, each
    from fresh states: name -> ((JAX states, outs, snaps), (port ...))."""
    je, pe = engines
    yuv = to_i420(frames)
    out = {}
    for name, call, x in (("step", "step", frames[:, 0]),
                          ("chunk", "step_chunk", frames),
                          ("yuv", "step_chunk_yuv", yuv)):
        out[name] = (getattr(je, call)(je.init_states(), x),
                     getattr(pe, call)(pe.init_states(), x))
    return out


def _assert_stream(s, jres, pres, per_frame):
    """Stream s of the JAX engine's (states, outs, snaps) against the
    port's."""
    (js, jo, jsnap), (ps, po, psnap) = jres, pres
    for name in INTS:
        np.testing.assert_array_equal(
            getattr(po, name)[s].numpy(), np.asarray(getattr(jo, name))[s],
            err_msg=f"stream {s} {name}")
    for name in ("valid", "label", "tlwh"):
        np.testing.assert_array_equal(
            getattr(psnap, name)[s].numpy(),
            np.asarray(getattr(jsnap, name))[s],
            err_msg=f"stream {s} snapshot {name}")
    np.testing.assert_allclose(ps.stream(s).table.mean.numpy(),
                               np.asarray(js.table.mean)[s], atol=1e-4)
    np.testing.assert_array_equal(ps.stream(s).table.track_id.numpy(),
                                  np.asarray(js.table.track_id)[s])
    assert tuple(po.track_id.shape[:-1]) == ((S, F) if per_frame else (S,))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["step", "chunk", "yuv"])
def test_engine_matches_jax(runs, name):
    jres, pres = runs[name]
    for s in range(S):
        _assert_stream(s, jres, pres, name != "step")
    po, psnap = pres[1], pres[2]
    assert int(psnap.valid.sum()) >= S * (1 if name == "step" else F)
    if name != "step":
        assert int((po.matched_det >= 0).sum()) > 0


@pytest.mark.timeout(300)
def test_engine_equals_run_chunk_per_stream(pair, runs, frames):
    """Each stream of the engine's chunk is the port's own single-stream
    `FrameStep.run_chunk`; `step` is the chunk's first frame, and the
    YUV path is the chunk on the frames the port converts the I420 to."""
    from deepdish_tpu_torch.ops.colorspace import yuv420_to_rgb_u8
    _, pfs = pair
    _, (cs, co, csnap) = runs["chunk"]
    _, (ss, so, ssnap) = runs["step"]
    _, (ys, yo, ysnap) = runs["yuv"]
    rgb = yuv420_to_rgb_u8(torch.from_numpy(to_i420(frames)), H, W)
    for s in range(S):
        state, outs, snaps = pfs.run_chunk(pfs.init_state(), frames[s])
        for name in INTS:
            np.testing.assert_array_equal(getattr(co, name)[s].numpy(),
                                          getattr(outs, name).numpy())
            np.testing.assert_array_equal(getattr(so, name)[s].numpy(),
                                          getattr(outs, name)[0].numpy())
        for name in ("valid", "label", "tlwh"):
            np.testing.assert_array_equal(getattr(csnap, name)[s].numpy(),
                                          getattr(snaps, name).numpy())
        for a, b in zip(cs.stream(s).table, state.table):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        _, youts, ysnaps = pfs.run_chunk(pfs.init_state(), rgb[s])
        for name in INTS:
            np.testing.assert_array_equal(getattr(yo, name)[s].numpy(),
                                          getattr(youts, name).numpy())
        np.testing.assert_array_equal(ysnap.tlwh[s].numpy(),
                                      ysnaps.tlwh.numpy())


def test_inputs_have_margins(pair):
    """On all 8 frames of every stream, no score of the port's raw detector
    outputs lies within 1e-2 of the 0.3 threshold, and no box coordinate
    that the clip leaves as it is (x, y, w, h before truncation) lies
    within 2e-4 of an integer (the closest is 5.5e-4): float32 noise
    cannot flip a detection or a truncated box."""
    from deepdish_tpu_torch.ops.boxes import xyxy_to_tlwh
    _, pfs = pair
    with torch.inference_mode():
        x = pfs._frames(stream_frames(8).reshape((-1, H, W, 3)))
        xyxy, classes, scores, valid = pfs._detect_raw(x)
    assert float((scores[valid] - 0.3).abs().min()) > 1e-2
    t = xyxy_to_tlwh(xyxy)[valid & (scores >= 0.3)]
    x0 = torch.floor(t[:, 0].clamp(0, W))
    y0 = torch.floor(t[:, 1].clamp(0, H))
    free = torch.cat([t[:, 0][(t[:, 0] > 0) & (t[:, 0] < W)],
                      t[:, 1][(t[:, 1] > 0) & (t[:, 1] < H)],
                      t[:, 2][(t[:, 2] > 0) & (t[:, 2] < W - x0)],
                      t[:, 3][(t[:, 3] > 0) & (t[:, 3] < H - y0)]])
    assert len(free) > 100
    assert float((free - free.round()).abs().min()) > 2e-4


def test_states_stay_on_their_shard(engines, runs):
    _, pe = engines
    _, (states, _, _) = runs["chunk"]
    k = S // pe.mesh.devices.size
    for s, st in enumerate(states.streams):
        want = pe.mesh.devices.flat[s // k]
        assert all(t.device == want for t in st.table)
    # each stream has its own slice of its shard's table: no two alias
    ptrs = {st.table.mean.data_ptr() for st in states.streams}
    assert len(ptrs) == S


@pytest.mark.timeout(120)
def test_n_streams_must_divide(pair):
    """The JAX engine's ValueError, word for word."""
    jfs, pfs = pair
    with pytest.raises(ValueError, match="multiple of the mesh size") as p:
        PEngine(pfs, n_streams=3, mesh=p_make_mesh(2, device="cpu"))
    with pytest.raises(ValueError) as j:
        JEngine(jfs, n_streams=3, mesh=j_make_mesh(2))
    assert str(p.value) == str(j.value)


def test_mesh_needs_a_card_unless_cpu():
    mesh = p_make_mesh(3, device="cpu")
    assert mesh.shape == {"stream": 3}
    assert [d.type for d in mesh.devices.flat] == ["cpu"] * 3
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        p_make_mesh()


@pytest.mark.timeout(600)
def test_quantized_detector_in_multistream_engine(tmp_path):
    """The port's integer executor (QuantizedSSDDetector on a full-integer
    .tflite written by tensorflow's converter) in the multi-stream engine:
    one `step` of S = 2 streams over two CPU shards, each stream equal to
    the single-stream `step` (a port of tests/test_qgraph.py::
    test_quantized_detector_in_multistream_engine, which checks the JAX
    engine)."""
    from test_pipeline_real_tflite import _make_full_ssd_tflite
    from deepdish_tpu_torch.models import create_box_encoder, create_detector
    from deepdish_tpu_torch.models.qgraph import QuantizedSSDDetector
    path = _make_full_ssd_tflite(tmp_path, full_int8=True)
    det = create_detector(str(path), max_outputs=8, quantized=True,
                          score_threshold=0.3, device="cpu")
    assert isinstance(det, QuantizedSSDDetector)
    enc = create_box_encoder("dummy", device="cpu")
    cfg = pt.TrackerConfig(max_tracks=8, max_detections=4, gallery_size=8,
                           pending_size=4, num_labels=2, max_age=5)
    fs = PFrameStep(det, enc, cfg, ["person"], (72, 96), device="cpu")
    eng = PEngine(fs, n_streams=2, mesh=p_make_mesh(2, device="cpu"))
    frames = np.random.RandomState(0).randint(
        0, 255, size=(2, 72, 96, 3)).astype(np.uint8)
    states, outs, snaps = eng.step(eng.init_states(), frames)
    assert tuple(outs.track_id.shape) == (2, 8)
    for s in range(2):
        _, out, snap, _ = fs.step(fs.init_state(), frames[s])
        for name in INTS:
            np.testing.assert_array_equal(getattr(outs, name)[s].numpy(),
                                          getattr(out, name).numpy())
        for name in ("valid", "label", "tlwh"):
            np.testing.assert_array_equal(getattr(snaps, name)[s].numpy(),
                                          getattr(snap, name).numpy())


def test_replica_is_a_moved_copy(pair, frames):
    """A mesh device other than the FrameStep's gets a copy whose modules,
    tensors and devices were moved (here CPU to CPU, the one device type
    this box has): its own weights, the same outputs; the FrameStep's own
    device gets the FrameStep itself."""
    from deepdish_tpu_torch.parallel.multistream import _moved, replica
    _, pfs = pair
    assert replica(pfs, torch.device("cpu")) is pfs
    copy = _moved(pfs, torch.device("cpu"), {})
    assert copy is not pfs and copy.detector is not pfs.detector
    assert copy.detector.net is not pfs.detector.net
    assert copy.encoder._apply_fn is not pfs.encoder._apply_fn
    assert copy.tracker_cfg is pfs.tracker_cfg       # nothing to move
    a = pfs.run_chunk(pfs.init_state(), frames[1])
    b = copy.run_chunk(copy.init_state(), frames[1])
    for x, y in zip(a[1] + a[2], b[1] + b[2]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def bgsub_frames():
    """(S, 16, H, W, 3): the module's 8 frames a stream twice over, with a
    bright 30 x 24 block moving 6 px a frame along x, for MOG2 to see."""
    frames = np.concatenate([stream_frames(8)] * 2, axis=1)
    for k in range(frames.shape[1]):
        x = 4 + 6 * k
        frames[:, k, 20:50, x:x + 24] = 230
    return frames


@pytest.mark.timeout(600)
def test_engine_with_bgsub_matches_jax_and_run_chunk(pair):
    """Background subtraction on (each stream's MOG2 prelude, in frame
    order) in both engines, the module's networks: two step_chunk calls
    of 8 frames, S = 4 on two shards. Track ids, states, matched_det,
    deleted_id and hits equal the JAX engine's and each stream's own
    run_chunk over the same two chunks, exactly. MARS embeds the first two
    detections of a frame (encode capacity 2), which keeps the test's
    CPU time down."""
    jfs, pfs = pair
    cfg = dict(score_threshold=0.3, background_subtraction=True,
               encode_capacity=2)
    jbg = JFrameStep(jfs.detector, jfs.encoder, jt.TrackerConfig(**TRACKER),
                     WANTED, (H, W), JConfig(**cfg))
    pbg = PFrameStep(pfs.detector, pfs.encoder, pt.TrackerConfig(**TRACKER),
                     WANTED, (H, W), PConfig(**cfg), device="cpu")
    je = JEngine(jbg, n_streams=S, mesh=j_make_mesh(2))
    pe = PEngine(pbg, n_streams=S, mesh=p_make_mesh(2, device="cpu"))
    frames = bgsub_frames()
    jst, pst = je.init_states(), pe.init_states()
    refs = [pbg.init_state() for _ in range(S)]
    n_valid = 0
    for c in range(2):
        x = np.ascontiguousarray(frames[:, 8 * c:8 * (c + 1)])
        jst, jo, _ = je.step_chunk(jst, x)
        pst, po, psnap = pe.step_chunk(pst, x)
        n_valid += int(psnap.valid.sum())
        for s in range(S):
            refs[s], ro, _ = pbg.run_chunk(refs[s], x[s])
            for name in INTS:
                got = getattr(po, name)[s].numpy()
                np.testing.assert_array_equal(
                    got, np.asarray(getattr(jo, name))[s],
                    err_msg=f"chunk {c} stream {s} {name} vs JAX")
                np.testing.assert_array_equal(
                    got, getattr(ro, name).numpy(),
                    err_msg=f"chunk {c} stream {s} {name} vs run_chunk")
    assert n_valid > 0
    assert int((po.matched_det >= 0).sum()) > 0
