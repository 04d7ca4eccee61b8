"""The whole slice: deepdish_tpu_torch's FrameStep (`step`, `run_chunk`)
against deepdish_tpu's on 96x128 frames, float32 models with the same
numpy-made weights on both sides, plus the port's chunk-vs-sequential
equality and the countline counters.

The frames are one random image plus small per-frame noise, so detections
persist and tracks confirm, which drives the appearance cascade as well as
the IoU stage. Post-NMS boxes are truncated to integers and compared
exactly; the inputs (seed, threshold 0.3) were chosen so that no score sits
within float32 noise of a threshold and no box edge within it of an integer,
so no detection flips between the two float32 runs."""
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX models are flax modules

import numpy as np
import jax.numpy as jnp
import torch

from deepdish_tpu import tracker as jt
from deepdish_tpu.models import ssd_mobilenet as jssd
from deepdish_tpu.models.encoders import make_mars_encoder as j_mars
from deepdish_tpu.models.mars import INPUT_SHAPE, MarsNet
from deepdish_tpu.models.weights import _flatten
from deepdish_tpu.pipeline import FrameStep as JFrameStep
from deepdish_tpu.pipeline import FrameStepConfig as JConfig
from deepdish_tpu.pipeline.counting import CountingState as JCounting
from deepdish_tpu_torch import tracker as pt
from deepdish_tpu_torch.models import COCO_LABELS
from deepdish_tpu_torch.models import ssd_mobilenet as pssd
from deepdish_tpu_torch.models.encoders import make_mars_encoder as p_mars
from deepdish_tpu_torch.models.weights import mars_from_flax, ssd_from_flax
from deepdish_tpu_torch.pipeline import FrameStep as PFrameStep
from deepdish_tpu_torch.pipeline import FrameStepConfig as PConfig
from deepdish_tpu_torch.pipeline.counting import CountingState as PCounting
from test_torch_models import numpy_flax_variables
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

F32 = jnp.float32
H, W = 96, 128
N_FRAMES = 6
WANTED = COCO_LABELS
TRACKER = dict(max_tracks=16, max_detections=8, gallery_size=32,
               num_labels=len(WANTED), max_age=10)


@pytest.fixture(scope="module")
def pair():
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
def frames():
    rng = np.random.RandomState(2)
    base = rng.randint(0, 256, (H, W, 3))
    noise = rng.randint(-4, 5, (N_FRAMES, H, W, 3))
    return np.clip(base[None] + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def runs(pair, frames):
    """Per-frame outputs of both packages' `step` and the port's
    `run_chunk` over the same frames."""
    jfs, pfs = pair
    js, ps = jfs.init_state(), pfs.init_state()
    jouts, pouts = [], []
    for f in frames:
        js, jo, jsnap, _ = jfs.step(js, f)
        ps, po, psnap, _ = pfs.step(ps, f)
        jouts.append((jo, jsnap))
        pouts.append((po, psnap))
    pc_state, couts, csnaps = pfs.run_chunk(pfs.init_state(), frames)
    return jouts, pouts, (couts, csnaps), (js, ps, pc_state)


def test_step_matches_jax(runs):
    jouts, pouts, _, _ = runs
    n_dets = n_matched = 0
    for i, ((jo, jsnap), (po, psnap)) in enumerate(zip(jouts, pouts)):
        for name in ("valid", "label", "tlwh"):
            np.testing.assert_array_equal(
                getattr(psnap, name).numpy(), np.asarray(getattr(jsnap, name)),
                err_msg=f"frame {i} snapshot {name}")
        # scores are sigmoids of float32 logits of two conv stacks
        np.testing.assert_allclose(psnap.score.numpy(),
                                   np.asarray(jsnap.score), atol=1e-4)
        for name in ("track_id", "state", "matched_det", "deleted_id",
                     "hits", "label_count"):
            np.testing.assert_array_equal(
                getattr(po, name).numpy(), np.asarray(getattr(jo, name)),
                err_msg=f"frame {i} {name}")
        np.testing.assert_allclose(po.tlwh.numpy(), np.asarray(jo.tlwh),
                                   rtol=1e-5, atol=1e-3)
        n_dets += int(psnap.valid.sum())
        n_matched += int((po.matched_det >= 0).sum())
    assert n_dets >= N_FRAMES and n_matched > 0
    assert (pouts[-1][0].state.numpy() == pt.CONFIRMED).any()


def test_chunk_equals_sequential(runs):
    _, pouts, (couts, csnaps), (_, ps, pc_state) = runs
    for i, (po, psnap) in enumerate(pouts):
        for name in ("track_id", "state", "matched_det", "deleted_id"):
            np.testing.assert_array_equal(getattr(couts, name)[i].numpy(),
                                          getattr(po, name).numpy(),
                                          err_msg=f"frame {i} {name}")
        np.testing.assert_array_equal(csnaps.tlwh[i].numpy(),
                                      psnap.tlwh.numpy())
        np.testing.assert_array_equal(csnaps.valid[i].numpy(),
                                      psnap.valid.numpy())
    np.testing.assert_array_equal(pc_state.table.state.numpy(),
                                  ps.table.state.numpy())
    # the chunk embeds all crops in one batch: float32 features may differ
    # in the last bits from per-frame batches
    np.testing.assert_allclose(pc_state.table.mean.numpy(),
                               ps.table.mean.numpy(), rtol=1e-5, atol=1e-3)


def test_final_tables_match(runs):
    _, _, _, (js, ps, _) = runs
    for name in ("state", "track_id", "hits", "gallery_count",
                 "pending_count", "next_id"):
        np.testing.assert_array_equal(getattr(ps.table, name).numpy(),
                                      np.asarray(getattr(js.table, name)))
    # gallery rows are unit MARS features: 2e-5 as in test_torch_models
    np.testing.assert_allclose(ps.table.gallery.numpy(),
                               np.asarray(js.table.gallery), atol=2e-5)


def test_encode_capacity_matches_jax(pair, frames):
    """encode_capacity = 3 embeds only the 3 best detections; the rest keep
    zero features (IoU-matched only)."""
    jfs, pfs = pair
    jfs3 = JFrameStep(jfs.detector, jfs.encoder, jfs.tracker_cfg, WANTED,
                      (H, W), JConfig(score_threshold=0.3, encode_capacity=3))
    pfs3 = PFrameStep(pfs.detector, pfs.encoder, pfs.tracker_cfg, WANTED,
                      (H, W), PConfig(score_threshold=0.3, encode_capacity=3),
                      device="cpu")
    js, ps = jfs3.init_state(), pfs3.init_state()
    for i, f in enumerate(frames[:4]):
        js, jo, _, _ = jfs3.step(js, f)
        ps, po, _, _ = pfs3.step(ps, f)
        for name in ("track_id", "state", "matched_det"):
            np.testing.assert_array_equal(getattr(po, name).numpy(),
                                          np.asarray(getattr(jo, name)),
                                          err_msg=f"frame {i} {name}")
    _, couts, _ = pfs3.run_chunk(pfs3.init_state(), frames[:4])
    np.testing.assert_array_equal(couts.matched_det[-1].numpy(),
                                  po.matched_det.numpy())


def test_framestep_needs_a_device(pair):
    _, pfs = pair
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PFrameStep(pfs.detector, pfs.encoder, pfs.tracker_cfg, WANTED,
                   (H, W))


def test_counting_crossings():
    """Objects walking across a vertical countline: the port's counters
    equal the JAX package's, and every walker is counted once."""
    rng = np.random.RandomState(3)
    kw = dict(max_tracks=16, max_detections=8, feature_dim=16,
              gallery_size=32, num_labels=2, max_age=5)
    jcfg, pcfg = jt.TrackerConfig(**kw), pt.TrackerConfig(**kw)
    jtab, ptab = jt.create_table(jcfg), pt.create_table(pcfg, device="cpu")
    line = np.array([[300.0, 0.0], [300.0, 600.0]])
    jc, pc = JCounting(["person", "car"], line), PCounting(["person", "car"],
                                                           line)
    walkers = [dict(x=100.0 + 30 * k, y=80.0 + 110 * k, vx=(8.0, -8.0)[k % 2]
                    * 1.0, label=k % 2,
                    feat=rng.normal(size=16).astype(np.float32))
               for k in range(4)]
    for w in walkers:
        if w["vx"] < 0:
            w["x"] += 320.0          # start right of the line, walk left
    for _ in range(40):
        boxes, confs, labels, feats = [], [], [], []
        for w in walkers:
            w["x"] += w["vx"]
            boxes.append([w["x"], w["y"], 40.0, 80.0])
            confs.append(0.9)
            labels.append(w["label"])
            feats.append(w["feat"] + rng.normal(0, 0.02, 16))
        cols = (boxes, confs, labels, feats)
        jtab, jo = jt.step(jcfg, jtab, jt.pack_detections(jcfg, *cols))
        ptab, po = pt.step(pcfg, ptab,
                           pt.pack_detections(pcfg, *cols, device="cpu"))
        jc.process(jo)
        pc.process(po)
    assert pc.counters_payload() == jc.counters_payload()
    payload = pc.counters_payload()
    assert payload["poscount_person"] + payload["negcount_person"] == 2
    assert payload["intcount_car"] == 2


# ---- background subtraction on: step, step_skip, scripted_step, run_chunk,
# run_chunk_yuv, and the checkpoint exchange ----

N_BG = 6


@pytest.fixture(scope="module")
def bg_pair(pair):
    """Both packages' FrameSteps with MOG2 and the motion-ratio filter on,
    the same float32 networks as `pair`."""
    jfs, pfs = pair
    jcfg = JConfig(score_threshold=0.3, background_subtraction=True)
    pcfg = PConfig(score_threshold=0.3, background_subtraction=True)
    return (JFrameStep(jfs.detector, jfs.encoder, jfs.tracker_cfg, WANTED,
                       (H, W), jcfg),
            PFrameStep(pfs.detector, pfs.encoder, pfs.tracker_cfg, WANTED,
                       (H, W), pcfg, device="cpu"))


@pytest.fixture(scope="module")
def bg_frames(frames):
    """The first of `frames` drifting 2 px a frame, with a bright block
    moving 6 px a frame: the scene moves, so the detector's boxes keep
    passing the motion filter after frame 1 and tracks confirm."""
    out = np.stack([np.roll(frames[0], 2 * i, axis=1)
                    for i in range(N_FRAMES)])
    for i in range(N_FRAMES):
        out[i, 30:70, 10 + 6 * i:50 + 6 * i] = 230
    return out


def _assert_same(i, po, psnap, jo, jsnap):
    for name in ("valid", "label", "tlwh"):
        np.testing.assert_array_equal(
            getattr(psnap, name).numpy(), np.asarray(getattr(jsnap, name)),
            err_msg=f"frame {i} snapshot {name}")
    for name in ("track_id", "state", "matched_det", "deleted_id", "hits"):
        np.testing.assert_array_equal(
            getattr(po, name).numpy(), np.asarray(getattr(jo, name)),
            err_msg=f"frame {i} {name}")


@pytest.fixture(scope="module")
def bg_runs(bg_pair, bg_frames):
    jfs, pfs = bg_pair
    js, ps = jfs.init_state(), pfs.init_state()
    seq = []
    for f in bg_frames:
        js, jo, jsnap, _ = jfs.step(js, f)
        ps, po, psnap, _ = pfs.step(ps, f)
        seq.append((po, psnap, jo, jsnap))
    return seq, (js, ps)


def test_bgsub_step_matches_jax(bg_runs):
    seq, (js, ps) = bg_runs
    kept_after_first = 0
    for i, (po, psnap, jo, jsnap) in enumerate(seq):
        _assert_same(i, po, psnap, jo, jsnap)
        if i:
            kept_after_first += int(psnap.valid.sum())
    assert kept_after_first > 0, "no box passed the motion filter"
    assert (seq[-1][0].state.numpy() == pt.CONFIRMED).any()
    for a, b in zip(ps.bg, js.bg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_bgsub_chunk_equals_sequential(bg_pair, bg_frames, bg_runs):
    """run_chunk (MOG2 scanned frame by frame, the detector batched) gives
    the sequential steps' outputs; run_chunk_yuv on I420 frames gives
    run_chunk's on the frames it converts them to."""
    import cv2
    from deepdish_tpu_torch.ops.colorspace import yuv420_to_rgb_u8
    _, pfs = bg_pair
    seq, (_, ps) = bg_runs
    cstate, couts, csnaps = pfs.run_chunk(pfs.init_state(), bg_frames)
    for i, (po, psnap, _, _) in enumerate(seq):
        for name in ("track_id", "state", "matched_det"):
            np.testing.assert_array_equal(getattr(couts, name)[i].numpy(),
                                          getattr(po, name).numpy(),
                                          err_msg=f"frame {i} {name}")
        np.testing.assert_array_equal(csnaps.tlwh[i].numpy(),
                                      psnap.tlwh.numpy())
    for a, b in zip(cstate.bg, ps.bg):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    yuv = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420)
                    for f in bg_frames])
    rgb = yuv420_to_rgb_u8(torch.from_numpy(yuv), H, W)
    _, yo, ysnap = pfs.run_chunk_yuv(pfs.init_state(), yuv)
    _, ro, rsnap = pfs.run_chunk(pfs.init_state(), rgb)
    for a, b in zip(yo + ysnap, ro + rsnap):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(ysnap.valid[1:].sum()) > 0


def test_step_skip_matches_jax(bg_pair, bg_frames):
    """--object-detector-skip-frames: frame 0's raw detector output reused
    on frames 1..3, with bgsub, the filters and crop+embed on each."""
    jfs, pfs = bg_pair
    js, ps = jfs.init_state(), pfs.init_state()
    js, _, _, jraw = jfs.step(js, bg_frames[0])
    ps, _, _, praw = pfs.step(ps, bg_frames[0])
    for i in range(1, 4):
        js, jo, jsnap = jfs.step_skip(js, bg_frames[i], jraw)
        ps, po, psnap = pfs.step_skip(ps, bg_frames[i], praw)
        _assert_same(i, po, psnap, jo, jsnap)


def _scripted_boxes(i, R=32):
    """Host-scripted raw detections: two overlapping boxes over the moving
    block (NMS keeps one) and one elsewhere."""
    xyxy = np.zeros((R, 4), np.float32)
    cls = np.zeros((R,), np.int32)
    scr = np.zeros((R,), np.float32)
    val = np.zeros((R,), bool)
    x = 10 + 6 * i
    rows = [(x, 30, x + 40, 70, 0, 0.9), (x + 2.5, 31.5, x + 38, 69, 2, 0.8),
            (80, 70, 120, 95, 0, 0.7)]
    for k, (a, b, c, d, lab, s) in enumerate(rows):
        xyxy[k] = (a, b, c, d)
        cls[k], scr[k], val[k] = lab, s, True
    return xyxy, cls, scr, val


def test_scripted_step_matches_jax(bg_pair, bg_frames):
    jfs, pfs = bg_pair
    js, ps = jfs.init_state(), pfs.init_state()
    for i, f in enumerate(bg_frames):
        raw = _scripted_boxes(i)
        js, jo, jsnap = jfs.scripted_step(js, f, *raw)
        ps, po, psnap = pfs.scripted_step(ps, f, *raw)
        _assert_same(i, po, psnap, jo, jsnap)
    assert (po.state.numpy() == pt.CONFIRMED).any()


def test_checkpoint_exchange(bg_pair, bg_frames, tmp_path):
    """A JAX checkpoint restores in the port and a port checkpoint in the
    JAX package (same .npz keys, tracker and MOG2 state); after either
    exchange the next frames give the same outputs as the run that kept
    its own state."""
    from deepdish_tpu.pipeline import checkpoint as jck
    from deepdish_tpu_torch.pipeline import checkpoint as pck
    jfs, pfs = bg_pair
    js, ps = jfs.init_state(), pfs.init_state()
    for f in bg_frames[:3]:
        js, _, _, _ = jfs.step(js, f)
        ps, _, _, _ = pfs.step(ps, f)
    counters = {"poscount_person": 2, "negcount_person": 1}
    jck.save_state(str(tmp_path / "j.npz"), js, counters, 3)
    pck.save_state(str(tmp_path / "p.npz"), ps, counters, 3)
    p_from_j, pc, pn = pck.load_state(str(tmp_path / "j.npz"),
                                      pfs.init_state())
    j_from_p, jc, jn = jck.load_state(str(tmp_path / "p.npz"),
                                      jfs.init_state())
    assert pc == jc == counters and pn == jn == 3
    assert p_from_j.table.state.device.type == "cpu"
    for i, f in enumerate(bg_frames[3:]):
        js, jo, jsnap, _ = jfs.step(js, f)
        ps, po, psnap, _ = pfs.step(ps, f)
        p_from_j, po2, psnap2, _ = pfs.step(p_from_j, f)
        j_from_p, jo2, jsnap2, _ = jfs.step(j_from_p, f)
        _assert_same(i, po2, psnap2, jo, jsnap)
        _assert_same(i, po, psnap, jo2, jsnap2)
