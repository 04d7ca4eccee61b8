"""Detector registry: deepdish_tpu/models/registry.py (`create_detector`
:183) without the quantized paths, which are still to be ported.

The reference picks its detector backend by model-filename substring
(deepdish.py:482-502). As in the JAX package, 'scripted:<name>' gives a
weightless host-scripted detector; a directory named '*saved_model*' a
TF-OD SSD or Faster R-CNN converted from its variables (models/convert.py),
else the host SavedModel executor; then 'faster_rcnn' / 'frcnn' Faster
R-CNN, 'yolov5' YOLOv5s, 'yolo' YOLOv3, 'efficientdet' (or a non-SSD
'.tflite' name) EfficientDet-Lite0, and 'ssd' / 'mobilenet' / 'edgetpu'
SSD-MobileNetV1. Weights come from a .tflite flatbuffer (SSD, YOLOv5s,
EfficientDet-Lite0; structural conversion, with the fused postprocess op's
anchors, decode scales, thresholds and max_detections and, for
EfficientDet, the metadata's normalization and packed labels), a Keras .h5
(YOLOv3), a SavedModel directory, a flat .npz of the JAX package's
variables, or random init; a weight file that does not convert raises
unless --allow-random-weights. `.pbtxt` label maps give 1-based ids.
Still to be ported, and raising here: the quantized paths
(--quantized-inference, --detector-int8; ROADMAP.md §1 item 8).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .efficientdet import EfficientDetLite0Detector
from .faster_rcnn import FasterRCNNDetector
from .ssd_mobilenet import SSDMobileNetDetector
from .yolov3 import YOLOv3Detector
from .yolov5 import YOLOv5Detector

# COCO labelmap (91-entry TF-OD style with background dropped), the label
# vocabulary behind the reference's coco_labelmap.txt
COCO_LABELS = [
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "sofa", "pottedplant", "bed", "diningtable", "toilet", "tvmonitor",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

_LATER = "waits for a later slice of the port (ROADMAP.md §1)"


def load_labels(label_file: Optional[str]) -> Sequence[str]:
    if label_file and os.path.exists(label_file):
        with open(label_file) as f:
            return [line.strip() for line in f]
    return list(COCO_LABELS)


def _detection_labels(label_file: Optional[str]):
    """Label dict for 0-based background-stripped class ids. A .pbtxt
    label map (the SavedModel family's, tools/saved_model.py:70-103) has
    1-based ids, shifted to the 0-based contract; a plain text file is one
    name per line; default COCO's."""
    if label_file and label_file.endswith(".pbtxt") \
            and os.path.exists(label_file):
        from .labelmap import load_pbtxt_labelmap
        return {i - 1: n for i, n in
                load_pbtxt_labelmap(label_file).items()}
    return dict(enumerate(load_labels(label_file)))


def _bright_blob_script(frame_rgb, thresh=150, min_area=400):
    """Weightless host detector: bright 4-connected components -> person
    boxes. Makes `--model scripted:bright` produce real detections (and so
    crossings) on scenes of bright rectangles on a dark background
    (demos/make_demo_video.py), with no model files.

    The JAX package labels with cv2.connectedComponentsWithStats; the
    port keeps cv2 off its device path, so this labels with scipy.ndimage
    (also in raster order, so the boxes come out in cv2's order) and takes
    each component's box from find_objects and its area from bincount."""
    from scipy import ndimage
    frame = np.asarray(frame_rgb)
    mask = frame.max(axis=-1) > thresh
    labels, n = ndimage.label(mask)          # 4-connectivity in 2-D
    areas = np.bincount(labels.ravel(), minlength=n + 1)
    boxes, names, scores = [], [], []
    for i, (ys, xs) in enumerate(ndimage.find_objects(labels), start=1):
        area = areas[i]
        if area >= min_area:
            boxes.append((float(xs.start), float(ys.start),
                          float(xs.stop - xs.start),
                          float(ys.stop - ys.start)))
            names.append("person")
            scores.append(min(1.0, area / (frame.shape[0] * frame.shape[1])
                              * 20 + 0.5))
    return boxes, names, scores


#: name -> script registry for `create_detector("scripted:<name>")`: the
#: test and demo seam of the reference's dummy/constant encoder backends
#: (tools/generate_detections.py:86-116,182-189). "noop" and "bright" are
#: built in, so `--model scripted:bright` drives the whole pipeline with no
#: weights and no in-process registration.
SCRIPTS = {"noop": lambda frame_rgb: ([], [], []),
           "bright": _bright_blob_script}


def register_script(name, script):
    """Register `script(frame_rgb) -> (boxes_tlwh, label_names, scores)`
    under `name` so `--model scripted:<name>` selects it."""
    SCRIPTS[name] = script


class ScriptedDetector:
    """Host-driven detector for tests and demos without weights: the caller
    provides frame_rgb -> (boxes_tlwh, label_names, scores), the duck-typed
    contract of the reference adaptors (tools/ssd_mobilenet.py:198-213).
    The pipeline routes these boxes through the same filter + NMS +
    crop/embed + track step the real detectors feed
    (FrameStep.scripted_step). It runs on the host and has no device."""

    def __init__(self, script, wanted_labels=None, width=320, height=320):
        self.script = script
        self.width, self.height = width, height
        self.use_edgetpu = False
        names = list(wanted_labels or ["person"])
        self.labels = dict(enumerate(names))
        self.label_offset = 0
        self._name_to_class = {n: i for i, n in self.labels.items()}

    def detect_host(self, frame_rgb):
        """(boxes_tlwh, class_idx, scores) from the host script."""
        boxes, names, scores = self.script(frame_rgb)
        classes = [self._name_to_class.get(n, -1) for n in names]
        return boxes, classes, scores


def _family(name: str) -> str:
    """The weight family a model name selects (the JAX package's order)."""
    if "faster_rcnn" in name or "frcnn" in name:
        return "faster_rcnn"
    if "yolov5" in name:
        return "yolov5"
    if "yolo" in name:
        return "yolov3"
    if "efficientdet" in name or ("tflite" in name and not _is_ssd(name)):
        return "efficientdet"
    return "ssd"


def _is_ssd(name: str) -> bool:
    # 'edgetpu' names are Coral SSD exports (deepdish.py:483-485)
    return "ssd" in name or "mobilenet" in name or "edgetpu" in name


def _load_real_weights(path: str, family: str):
    """A real weight artifact (TFLite flatbuffer, Keras .h5, or a .npz of
    the JAX package's variables) as the port state_dict of `family`.
    Returns (state_dict, extras); state_dict is None when the path is not
    a loadable artifact for the family. extras carries the flatbuffer's
    fused TFLite_Detection_PostProcess parameters (embedded anchors,
    decode scales, NMS options) when the file ends in that custom op, the
    artifacts the reference ships (tools/ssd_mobilenet.py:100-127,
    tools/tflite_object_detector.py:154-172)."""
    from . import convert as cv
    from . import weights as w
    bridge = {"yolov5": w.yolov5_from_flax, "yolov3": w.yolov3_from_flax,
              "efficientdet": w.efficientdet_from_flax,
              "faster_rcnn": w.faster_rcnn_from_flax,
              "ssd": w.ssd_from_flax}[family]
    if path.endswith(".npz"):
        return bridge(w._flatten(w.load_npz(path))), {}
    if path.endswith(".tflite"):
        loader = {"yolov5": cv.load_yolov5_tflite,
                  "efficientdet": cv.load_efficientdet_tflite,
                  "ssd": cv.load_ssd_mobilenet_tflite}.get(family)
        if loader is not None:
            flat, report = loader(path)
            extras = {}
            pp = report.get("postprocess")
            if pp is not None:
                extras["postprocess"] = pp
                if report.get("anchors_verified") is False:
                    print("note: generated anchors differ from the "
                          "flatbuffer's embedded anchor table "
                          f"({report.get('anchors_max_abs_diff')}); "
                          "using the embedded anchors.")
            return bridge(flat), extras
    if path.endswith(".h5") and family == "yolov3":
        return bridge(cv.load_yolov3_h5(path)[0]), {}
    return None, {}


def _pp_det_kw(pp, score_threshold, anchor_scale=1.0):
    """Detector keywords from a fused TFLite_Detection_PostProcess op, the
    file's own configuration (the reference consumes the op's outputs:
    tools/ssd_mobilenet.py:100-127, tools/tflite_object_detector.py:
    154-172): the embedded anchor table, the decode scales, the larger of
    the CLI's and the op's score threshold, the op's NMS IoU, and its
    max_detections as the validity cap (the op emits at most that many
    boxes, so slots past it are invalid)."""
    return dict(anchors=pp.anchors * anchor_scale, box_scale=pp.scales,
                score_threshold=max(score_threshold,
                                    pp.nms_score_threshold),
                iou_threshold=pp.nms_iou_threshold,
                detections_cap=pp.max_detections)


def _load_weights(model_name: str, family: str, allow_random_weights: bool):
    """(state_dict, extras) from the weight file `model_name`, with the
    JAX package's fail-loudly contract: a file that does not convert, or
    that no converter of the family reads, raises unless
    `allow_random_weights` (then random init)."""
    try:
        state_dict, extras = _load_real_weights(model_name, family)
    except Exception as e:
        if not allow_random_weights:
            raise ValueError(
                f"weight conversion failed for {model_name} (inferred "
                f"family {family!r}): {e}. If the family is wrong, "
                "rename the file or convert offline with `python -m "
                "deepdish_tpu_torch.models.convert --family ...`; pass "
                "--allow-random-weights to run without pre-trained "
                "weights.") from e
        print(f"weight conversion failed for {model_name} ({e}); "
              "running with random-init weights")
        return None, {}
    if state_dict is None:
        # the file exists but no converter reads it (a .pb, or an .h5 of
        # a family other than yolov3): the same contract
        if not allow_random_weights:
            raise ValueError(
                f"{model_name} is not a loadable weight artifact for "
                f"inferred family {family!r} (supported: .tflite, "
                ".npz, yolov3 .h5). Convert offline with `python -m "
                "deepdish_tpu_torch.models.convert` or pass "
                "--allow-random-weights to run without pre-trained "
                "weights.")
        print(f"{model_name} not recognized as a weight artifact; "
              "running with random-init weights")
    return state_dict, extras


def _saved_model_detector(model_dir, wanted_labels, label_file,
                          score_threshold, max_outputs, device, **kw):
    """A SavedModel directory (deepdish.py:489): a TF-OD SSD or
    faster_rcnn_resnet_v1 export converts through its variables checkpoint
    to the port's detector (Faster R-CNN with the checkpoint's config);
    anything else runs on the host SavedModel executor, which feeds the
    frame step like a scripted detector (tools/saved_model.py:9-103).
    Without tensorflow this raises ImportError, never random weights."""
    from . import convert as cvm
    common = dict(max_outputs=max_outputs, score_threshold=score_threshold,
                  device=device, **kw)
    try:
        flat, _rep = cvm.load_ssd_saved_model(model_dir)
    except ImportError:
        raise
    except Exception as ssd_err:
        try:
            flat, rep = cvm.load_faster_rcnn_saved_model(model_dir)
        except Exception as e:
            print(f"SavedModel dir is neither a TF-OD SSD export "
                  f"({ssd_err}) nor a faster_rcnn_resnet_v1 export ({e}); "
                  "using the host SavedModel executor")
            from .saved_model import SavedModelDetector
            return SavedModelDetector(model_dir, label_file=label_file,
                                      wanted_labels=wanted_labels,
                                      score_threshold=score_threshold)
        from .weights import faster_rcnn_from_flax
        det = FasterRCNNDetector(state_dict=faster_rcnn_from_flax(flat),
                                 config=rep["config"], **common)
        det.labels = _detection_labels(label_file)
        det.label_offset = 0
        return det
    from .weights import ssd_from_flax
    det = SSDMobileNetDetector(state_dict=ssd_from_flax(flat), **common)
    det.labels = dict(enumerate(load_labels(label_file)))
    det.label_offset = 0
    return det


def create_detector(model_name: str = "ssd_mobilenet", wanted_labels=None,
                    label_file=None, score_threshold: float = 0.5,
                    state_dict=None, max_outputs: int = 32,
                    allow_random_weights: bool = False,
                    quantized: bool = False, detector_int8: bool = False,
                    calib_images=None, label_allow=None, label_deny=None,
                    max_results: int = -1, device=None, **kw):
    """Substring dispatch like deepdish.py:482-502, with the JAX package's
    keywords and order: 'scripted:<name>' gives a ScriptedDetector; a
    '*saved_model*' directory a converted TF-OD SSD or Faster R-CNN, else
    the host SavedModel executor; then 'faster_rcnn' / 'frcnn', 'yolov5',
    'yolo', 'efficientdet' (or a non-SSD '.tflite' name) and 'ssd' /
    'mobilenet' / 'edgetpu' give that family's detector on `device`
    (default CUDA), with weights from `state_dict`, the weight file named
    by `model_name` (.tflite, yolov3 .h5 or a .npz of the JAX package's
    variables, converted on load; a .tflite's postprocess op and metadata
    configure the detector), or random init (`generator` and
    `compute_dtype` in **kw). A weight file that does not convert raises
    unless `allow_random_weights`. `label_allow`, `label_deny` and
    `max_results` configure EfficientDet's result filter; `calib_images`
    belongs to the int8 SSD, which is not ported yet. The quantized paths
    raise NotImplementedError."""
    del calib_images
    name = (model_name or "ssd_mobilenet").lower()
    if "scripted" in name:
        key = name.split("scripted:", 1)[1] if "scripted:" in name else None
        script = SCRIPTS.get(key) if key is not None else \
            (next(iter(SCRIPTS.values())) if SCRIPTS else None)
        if script is None:
            raise ValueError(f"no registered script for model {model_name!r}"
                             " (use models.registry.register_script)")
        return ScriptedDetector(script, wanted_labels=wanted_labels)
    if quantized:
        raise NotImplementedError(f"--quantized-inference {_LATER}, with "
                                  "models/qgraph.py (item 8)")
    is_file = bool(model_name) and os.path.isfile(model_name)
    if model_name and os.path.isdir(model_name):
        if "saved_model" in name:
            return _saved_model_detector(
                model_name, wanted_labels=wanted_labels,
                label_file=label_file, score_threshold=score_threshold,
                max_outputs=max_outputs, device=device, **kw)
        if not allow_random_weights:
            raise ValueError(
                f"{model_name} is a directory; SavedModel directories are "
                "selected by the 'saved_model' substring (deepdish.py:489) "
                "- rename the path or pass --allow-random-weights to run "
                "without pre-trained weights.")
    family = _family(name)
    extras = {}
    if state_dict is None and is_file:
        state_dict, extras = _load_weights(model_name, family,
                                           allow_random_weights)
    pp = extras.get("postprocess")
    common = dict(state_dict=state_dict, max_outputs=max_outputs,
                  device=device, **kw)
    if family == "faster_rcnn":
        # the reference's SavedModel default family (tools/saved_model.py)
        # at the zoo configuration; weights from a .npz of the JAX
        # package's variables or random init
        det = FasterRCNNDetector(score_threshold=score_threshold, **common)
        det.labels = _detection_labels(label_file)
        det.label_offset = 0
        return det
    labels = None
    if family == "yolov5":
        det = YOLOv5Detector(score_threshold=max(score_threshold, 0.25),
                             **common)
    elif family == "yolov3":          # yolov3 / yolo.h5 (deepdish.py:486)
        det = YOLOv3Detector(score_threshold=score_threshold, **common)
    elif family == "efficientdet":
        # metadata-driven configuration like the reference's generic
        # TFLite detector (tools/tflite_object_detector.py:117-137): the
        # normalization mean / std and packed labels of the flatbuffer when
        # present, else the EfficientDet-Lite export values
        meta = {"mean": (127.0,), "std": (128.0,), "labels": None}
        if is_file and model_name.endswith(".tflite"):
            try:
                from .tflite_meta import read_metadata
                meta.update(read_metadata(model_name))
            except Exception as e:
                print(f"tflite metadata unavailable ({e}); using defaults")
        det_kw = dict(score_threshold=score_threshold,
                      label_allow=label_allow, label_deny=label_deny,
                      max_results=max_results)
        if pp is not None:
            # the float decode works in pixels, so the op's normalized
            # anchors are scaled by the model input size
            from .efficientdet import INPUT_SIZE as _EDET_SIZE
            det_kw.update(_pp_det_kw(pp, score_threshold,
                                     anchor_scale=float(_EDET_SIZE)))
        det = EfficientDetLite0Detector(norm_mean=meta["mean"],
                                        norm_std=meta["std"], **det_kw,
                                        **common)
        labels = meta.get("labels")
    elif _is_ssd(name):
        if detector_int8 or (not is_file and "int8" in name):
            raise NotImplementedError(f"--detector-int8 {_LATER}, with "
                                      "models/ssd_q.py (item 8)")
        det_kw = dict(score_threshold=score_threshold)
        if pp is not None:
            # (the op's fast NMS is class-agnostic; the pipeline's own
            # class-agnostic NMS, deepdish.py:995, covers that stage)
            det_kw.update(_pp_det_kw(pp, score_threshold))
        det = SSDMobileNetDetector(**det_kw, **common)
    else:
        raise ValueError(
            f"cannot determine detector backend from {model_name!r}")
    # the reference adaptor's +1 labelmap offset is already applied:
    # COCO_LABELS has no background entry
    det.labels = dict(enumerate(labels or load_labels(label_file)))
    det.label_offset = 0
    if family == "efficientdet":
        det.finalize_label_filter()
    return det
