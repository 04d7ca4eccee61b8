"""CVAT split mode of the port against the JAX package's, on the CPU.

  * `pipeline/framerecords.py` (a copy in the port): the overlap fraction,
    `process_boxes` and the XML writer and reader give the same results;
  * `tracker/overrides.py`: `force_update_slots` and `delete_slots` on a
    seeded table (stepped by the JAX tracker, then handed to both): every
    field identical (the Kalman update included), the normalized pending
    features within one float32 ulp;
  * both CLIs with --output-cvat-dir on a video, and with --input-cvat-dir
    plus --output-cvat-dir on a JPEG sequence and an annotations.xml the
    test writes, with `FrameStep.detect_only` replaced on both sides by the
    same scripted colour-threshold boxes (the tests/test_cvat.py pattern):
    the written annotations.xml files are byte-identical, and so are the
    counters, the per-frame MQTT payloads (as tests/test_torch_pipeline.py
    compares them) and the number of track overrides.

MARS runs in float32 on both sides from the same .npz of JAX variables
(the `weights` and `f32_jax` fixtures of tests/test_torch_pipeline.py)."""
import asyncio
import functools
import os
import xml.etree.ElementTree as ET

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import cv2
import jax.numpy as jnp
import numpy as np
import torch

import deepdish_tpu.pipeline.runtime as j_runtime
import deepdish_tpu_torch.pipeline.runtime as p_runtime
from deepdish_tpu import tracker as jt
from deepdish_tpu.pipeline import framerecords as jfr
from deepdish_tpu.pipeline.framestep import DetectionSnapshot as JSnap
from deepdish_tpu.pipeline.framestep import FrameStep as JFrameStep
from deepdish_tpu.tracker import overrides as jov
from deepdish_tpu_torch import tracker as pt
from deepdish_tpu_torch.pipeline import framerecords as pfr
from deepdish_tpu_torch.pipeline.framestep import DetectionSnapshot as PSnap
from deepdish_tpu_torch.pipeline.framestep import FrameStep as PFrameStep
from deepdish_tpu_torch.tracker import overrides as pov
from test_torch_pipeline import (COMMON, RecordingMQTT, _compare, _frames,
                                 _last_counters, _write_video, f32_jax,
                                 j_amain, p_amain, weights)

__all__ = ["f32_jax", "weights"]   # fixtures used below
pytestmark = pytest.mark.timeout(120)   # the CLI runs: 300 each

LABELS = {0: "person", 1: "car"}
W, H = 320, 240


# ---------------------------------------------------------------- records

def _both(fn):
    return fn(jfr), fn(pfr)


def test_overlap_fraction_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(200):
        tl = rng.uniform(0, 100, (2, 2))
        a, b = (np.r_[t, t + rng.uniform(0, 60, 2)] for t in tl)
        assert pfr.overlap_fraction(a, b) == jfr.overlap_fraction(a, b)
    z = np.array([5.0, 5.0, 5.0, 9.0])          # zero area
    assert pfr.overlap_fraction(z, z) == jfr.overlap_fraction(z, z) == 0.0


def _annotated(mod, minimum_track_frames=3):
    fr = mod.FrameRecords(LABELS, minimum_track_frames=minimum_track_frames)
    fr.add_annotation_label_info("person", 0, "#ff0000")
    fr.add_annotation_label_info("car", 1, "#00ff00")
    fr.add_annotation_label_info("bike", None, "#0000ff")
    for f in range(1, 6):
        fr.add_annotated_track(f, 7, "person", [10 + f, 10, 50 + f, 90],
                               False, False, True, 0)
        fr.add_annotated_track(f, 8, "car", [200, 200, 240, 280],
                               f == 5, f == 3, f % 2 == 1, 1)
        fr.add_annotated_track(f, 9, "bike", [120, 20, 150, 60], False,
                               False, True, 0)
    return fr


def _process(fr):
    """Detections against the annotations: one absorbed by annotation 7,
    one with the wrong label beside annotation 8, one on its own, then a
    tracker consuming every record."""
    out = []
    for f in range(1, 6):
        boxes = [np.array([11 + f, 11, 38, 78], float),
                 np.array([201, 201, 38, 78], float),
                 np.array([60, 150, 20, 30], float)]
        out.append(fr.process_boxes(f, boxes, ["person", "person", "car"],
                                    [0.8, 0.7, 0.6]))
        for rec in fr.frames[f]:
            if not rec.is_annotation:
                rec.tracker_id = 40 + rec.order
    return out


def test_process_boxes_matches_jax():
    jrec, prec = _both(_annotated)
    jout, pout = _process(jrec), _process(prec)
    for (jb, jl, js), (pb, pl, ps) in zip(jout, pout):
        assert pl == jl and ps == js
        np.testing.assert_array_equal(np.array(pb), np.array(jb))
    assert len(jout[0][0]) == 4          # absorbed, 2 detections, injected
    for f in range(1, 6):
        assert len(prec.frames[f]) == len(jrec.frames[f])
        for a, b in zip(prec.frames[f], jrec.frames[f]):
            _same_record(a, b)


def _same_record(a, b):
    np.testing.assert_array_equal(a.tlbr, b.tlbr)
    rest = [k for k in vars(b) if k != "tlbr"]
    assert [getattr(a, k) for k in rest] == [getattr(b, k) for k in rest]


def _xml_bytes(tree):
    import io
    buf = io.BytesIO()
    tree.write(buf, xml_declaration=True, encoding="utf-8",
               short_empty_elements=False)
    return buf.getvalue()


def test_xml_roundtrip_matches_jax(tmp_path):
    jrec, prec = _both(functools.partial(_annotated, minimum_track_frames=2))
    _process(jrec), _process(prec)
    jtree, ptree = jrec.xml_output(), prec.xml_output()
    assert _xml_bytes(ptree) == _xml_bytes(jtree)
    root = ptree.getroot()
    assert {t.get("source") for t in root.findall("track")} == \
        {"manual", "automatic"}
    path = tmp_path / "annotations.xml"
    path.write_bytes(_xml_bytes(jtree))
    jback = jfr.FrameRecords.from_cvat_xml(str(path), LABELS)
    pback = pfr.FrameRecords.from_cvat_xml(str(path), LABELS)
    assert pback.labels == jback.labels
    assert sorted(pback.frames) == sorted(jback.frames)
    for f in jback.frames:
        for a, b in zip(pback.frames[f], jback.frames[f]):
            _same_record(a, b)
    assert _xml_bytes(pback.xml_output()) == _xml_bytes(jback.xml_output())


# -------------------------------------------------------------- overrides

_KW = dict(max_tracks=8, max_detections=4, feature_dim=16, gallery_size=8,
           pending_size=4, num_labels=2, max_age=5)


@pytest.fixture(scope="module")
def seeded_table():
    """A JAX tracker table after 6 frames of 4 drifting objects (some
    confirmed, some tentative, a few misses), the frame's detections, and
    the same table and detections as port tensors."""
    cfg = jt.TrackerConfig(**_KW)
    rng = np.random.RandomState(3)
    table = jt.create_table(cfg)
    pos = rng.uniform(50, 300, (4, 2))
    feat = rng.normal(size=(4, 16))
    for i in range(6):
        ks = [k for k in range(4) if i == 5 or rng.uniform() > 0.15]
        boxes = [np.r_[pos[k] + 5 * i + rng.normal(0, 1, 2), 30, 60]
                 for k in ks]
        feats = [(feat[k] + rng.normal(0, 0.05, 16)).astype(np.float32)
                 for k in ks]
        dets = jt.pack_detections(cfg, boxes, [0.9] * len(ks),
                                  [k % 2 for k in ks], feats)
        table, _ = jt.step(cfg, table, dets)
    ptable = pt.TrackTable(*(torch.from_numpy(np.array(x)) for x in table))
    pdets = pt.Detections(*(torch.from_numpy(np.array(x)) for x in dets))
    return cfg, table, dets, ptable, pdets


def _check_table(got, want):
    """Every field identical, except the pending features, which both
    normalize to unit rows in their own summation order: within 1e-7 (a
    float32 ulp of an entry of a unit row)."""
    for name, a, b in zip(got._fields, got, want):
        if name == "pending":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


def test_force_update_slots_matches_jax(seeded_table):
    cfg, table, dets, ptable, pdets = seeded_table
    live = np.flatnonzero(np.asarray(table.state) != jt.EMPTY)
    assert len(live) >= 3
    slot_det = np.full((cfg.max_tracks,), -1, np.int32)
    slot_det[live[:3]] = [2, 0, 3]        # includes an invalid det slot
    want = jov.force_update_slots(cfg, table, jnp.asarray(slot_det), dets)
    got = pov.force_update_slots(cfg, ptable, torch.from_numpy(slot_det),
                                 pdets)
    _check_table(got, want)
    assert (got.state.numpy()[live[:3]] == pt.CONFIRMED).all()
    assert (got.time_since_update.numpy()[live[:3]] == 0).all()


def test_delete_slots_matches_jax(seeded_table):
    cfg, table, _, ptable, _ = seeded_table
    live = np.flatnonzero(np.asarray(table.state) != jt.EMPTY)
    mask = np.zeros((cfg.max_tracks,), bool)
    mask[live[::2]] = True
    mask[-1] = True                        # an empty slot too
    want = jov.delete_slots(cfg, table, jnp.asarray(mask))
    got = pov.delete_slots(cfg, ptable, torch.from_numpy(mask))
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert (got.track_id.numpy()[mask] == -1).all()


# -------------------------------------------------------------------- CLI

def _rect_boxes(frame_rgb):
    """Colour-threshold detector: tlwh boxes of the red and green blocks
    (tests/test_pipeline_e2e.py's detect_rects_rgb)."""
    boxes = []
    for ch in (0, 1):
        ys, xs = np.nonzero(frame_rgb[:, :, ch] > 128)
        if len(xs) > 10:
            boxes.append([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                          ys.max() - ys.min() + 1])
    return boxes


def _scripted(D, frame_rgb):
    boxes = _rect_boxes(np.asarray(frame_rgb))[:D]
    tlwh = np.zeros((D, 4), np.float32)
    score = np.zeros((D,), np.float32)
    valid = np.zeros((D,), bool)
    for i, b in enumerate(boxes):
        tlwh[i], score[i], valid[i] = b, 0.9, True
    return tlwh, np.zeros((D,), np.int32), score, valid


def _j_detect_only(self, state, frame_rgb):
    D = self.tracker_cfg.max_detections
    return state.bg, JSnap(*_scripted(D, frame_rgb))


def _p_detect_only(self, state, frame_rgb):
    D = self.tracker_cfg.max_detections
    return state.bg, PSnap(*(torch.from_numpy(a).to(self.device)
                             for a in _scripted(D, frame_rgb)))


@pytest.fixture
def scripted_cvat(monkeypatch, f32_jax):
    """Both CLIs with the scripted detect_only, no warm-up (the detector
    never runs), and their override calls counted."""
    monkeypatch.setattr(JFrameStep, "detect_only", _j_detect_only)
    monkeypatch.setattr(PFrameStep, "detect_only", _p_detect_only)
    calls = {}
    for side, mod in (("jax", j_runtime), ("port", p_runtime)):
        monkeypatch.setattr(mod.Pipeline, "_warmup", lambda self, d: None)
        for fn in ("force_update_slots", "delete_slots"):
            def counted(*a, _f=getattr(mod, fn), _k=(side, fn)):
                calls[_k] = calls.get(_k, 0) + 1
                return _f(*a)
            monkeypatch.setattr(mod, fn, counted)
    return calls


def _run_both(tmp_path, argv_of):
    """Both CLIs; returns (xml bytes, payloads, log) per side."""
    res = []
    for side, amain in (("jax", j_amain), ("port", p_amain)):
        out, log = tmp_path / f"{side}_out", tmp_path / f"{side}.log"
        asyncio.run(amain(argv_of(out) + ["--log", str(log)]))
        res.append(((out / "annotations.xml").read_bytes(),
                    RecordingMQTT.runs[-1], log))
    return res


def _rect_frames(n, red_until=None):
    """BGR frames: a red block walking right, a green one walking left;
    the red one leaves the scene after frame `red_until` (1-based)."""
    frames = []
    for i in range(n):
        f = np.zeros((H, W, 3), np.uint8)
        if red_until is None or i < red_until:
            cv2.rectangle(f, (20 + 6 * i, 60), (60 + 6 * i, 120),
                          (0, 0, 255), -1)
        cv2.rectangle(f, (260 - 6 * i, 140), (300 - 6 * i, 200),
                      (0, 255, 0), -1)
        frames.append(f)
    return frames


def _check_runs(runs):
    (jxml, jpay, jlog), (pxml, ppay, plog) = runs
    assert pxml == jxml
    n_tracks, _ = _compare(jpay, ppay)
    assert _last_counters(plog) == _last_counters(jlog)
    return ET.fromstring(pxml), n_tracks


CVAT_COMMON = ["--model", "scripted:noop", "--wanted-labels", "person",
               "--disable-background-subtraction"]


@pytest.mark.timeout(300)
def test_cli_output_cvat_matches_jax(tmp_path, weights, scripted_cvat):
    video = tmp_path / "rects.mp4"
    _write_video(video, _rect_frames(24))
    # graphics on: each CLI also writes one image a frame
    common = [a for a in COMMON if a != "--disable-graphics"]
    runs = _run_both(tmp_path, lambda out: [
        "--input", str(video), "--output-cvat-dir", str(out),
        "--encoder-model", weights["mars"]] + CVAT_COMMON + common)
    root, n_tracks = _check_runs(runs)
    autos = [t for t in root.findall("track")
             if t.get("source") == "automatic"]
    assert len(autos) == 2 and n_tracks > 24
    assert all(len(t.findall("box")) >= 10 for t in autos)
    for side in ("jax", "port"):
        images = os.listdir(tmp_path / f"{side}_out" / "images")
        assert "frame_000001.jpg" in images and len(images) == 24


def _write_cvat_input(d, n=14, red_until=8):
    """images/frame_%06d.jpg from 1, and an annotations.xml with one
    person track: on the red block while it is in the scene, then jumping
    away from it, so that the annotated track is lost, force-updated and
    its duplicate deleted."""
    (d / "images").mkdir(parents=True)
    for i, f in enumerate(_rect_frames(n, red_until)):
        cv2.imwrite(str(d / "images" / f"frame_{i + 1:06d}.jpg"), f)
    root = ET.Element("annotations")
    labels = ET.SubElement(ET.SubElement(ET.SubElement(
        root, "meta"), "task"), "labels")
    lab = ET.SubElement(labels, "label")
    ET.SubElement(lab, "name").text = "person"
    ET.SubElement(lab, "color").text = "#ff0000"
    track = ET.SubElement(root, "track", attrib={"id": "3",
                                                 "label": "person"})
    for f in range(1, n + 1):
        x, y = (20 + 6 * (f - 1), 60) if f <= red_until else \
            (40 + 4 * f, 170)
        ET.SubElement(track, "box", attrib={
            "frame": str(f), "outside": "0", "occluded": "0",
            "keyframe": "1", "z_order": "0", "xtl": str(x), "ytl": str(y),
            "xbr": str(x + 40), "ybr": str(y + 60)})
    ET.ElementTree(root).write(str(d / "annotations.xml"))


@pytest.mark.timeout(300)
def test_cli_input_cvat_matches_jax(tmp_path, weights, scripted_cvat):
    cvat_in = tmp_path / "cvat_in"
    _write_cvat_input(cvat_in)
    runs = _run_both(tmp_path, lambda out: [
        "--input-cvat-dir", str(cvat_in), "--output-cvat-dir", str(out),
        "--encoder-model", weights["mars"]] + CVAT_COMMON + COMMON)
    root, _ = _check_runs(runs)
    assert len(_frames(runs[1][1])) == 14
    manual = [t for t in root.findall("track") if t.get("source") == "manual"]
    assert [t.get("id") for t in manual] == ["3"]
    assert len(manual[0].findall("box")) == 14
    calls = scripted_cvat
    for fn in ("force_update_slots", "delete_slots"):
        assert calls.get(("port", fn), 0) == calls.get(("jax", fn), 0) > 0, \
            calls
