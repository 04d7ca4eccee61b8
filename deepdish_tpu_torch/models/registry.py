"""Detector registry: the SSD-MobileNet and scripted subsets of
deepdish_tpu/models/registry.py (`create_detector` :183).

The reference picks its detector backend by model-filename substring
(deepdish.py:482-502). This port has the SSD-MobileNetV1 family ('ssd',
'mobilenet', 'edgetpu') and the weightless host-scripted detectors
('scripted:<name>'); the other families and the quantized paths come in
later slices and raise here.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .ssd_mobilenet import SSDMobileNetDetector

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
    """Label dict for 0-based background-stripped class ids from a plain
    text file (one name per line), or COCO's."""
    if label_file and label_file.endswith(".pbtxt"):
        raise NotImplementedError(f".pbtxt label maps ({label_file}) "
                                  f"{_LATER}, with models/labelmap.py")
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


def create_detector(model_name: str = "ssd_mobilenet", wanted_labels=None,
                    label_file=None, score_threshold: float = 0.5,
                    state_dict=None, max_outputs: int = 32,
                    allow_random_weights: bool = False,
                    quantized: bool = False, detector_int8: bool = False,
                    calib_images=None, label_allow=None, label_deny=None,
                    max_results: int = -1, device=None, **kw):
    """Substring dispatch like deepdish.py:482-502, with the JAX package's
    keywords. 'scripted:<name>' gives a ScriptedDetector; an 'ssd' /
    'mobilenet' / 'edgetpu' name gives SSD-MobileNetV1 on `device` (default
    CUDA) with weights from `state_dict`, a flat .npz of the JAX package's
    variables named by `model_name`, or random init (`generator` in **kw).
    A weight file that is not such an .npz raises unless
    `allow_random_weights`. `label_allow`, `label_deny` and `max_results`
    belong to the EfficientDet family and `calib_images` to the int8 SSD,
    as in the JAX package: the SSD ignores them."""
    del calib_images, label_allow, label_deny, max_results
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
                                  "models/qgraph.py (item 16)")
    is_file = bool(model_name) and os.path.isfile(model_name)
    if detector_int8 or (not is_file and "int8" in name):
        raise NotImplementedError(f"--detector-int8 {_LATER}, with "
                                  "models/ssd_q.py (item 16)")
    if not ("ssd" in name or "mobilenet" in name or "edgetpu" in name):
        raise ValueError(f"{model_name!r}: the port has the SSD-MobileNetV1 "
                         f"detector only; other families {_LATER}")
    if state_dict is None and is_file:
        if name.endswith(".npz"):
            from .weights import _flatten, load_npz, ssd_from_flax
            state_dict = ssd_from_flax(_flatten(load_npz(model_name)))
        elif not allow_random_weights:
            raise ValueError(
                f"{model_name}: the port loads SSD weights from a .npz of "
                "the JAX package's variables (convert other artifacts with "
                "the JAX package first); pass --allow-random-weights to run "
                "without pre-trained weights")
        else:
            print(f"{model_name} not recognized as a weight artifact; "
                  "running with random-init weights")
    det = SSDMobileNetDetector(state_dict=state_dict, max_outputs=max_outputs,
                               score_threshold=score_threshold,
                               device=device, **kw)
    # the reference adaptor's +1 labelmap offset is already applied:
    # COCO_LABELS has no background entry
    det.labels = dict(enumerate(load_labels(label_file)))
    det.label_offset = 0
    return det
