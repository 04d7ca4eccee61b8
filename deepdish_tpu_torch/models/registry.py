"""Detector registry: the SSD-MobileNet subset of
deepdish_tpu/models/registry.py (`create_detector` :183).

The reference picks its detector backend by model-filename substring
(deepdish.py:482-502). This slice of the port has the SSD-MobileNetV1
family ('ssd', 'mobilenet'); the other families come in later slices and
raise here.
"""
from __future__ import annotations

import os

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


def create_detector(model_name: str = "ssd_mobilenet",
                    score_threshold: float = 0.5, state_dict=None,
                    max_outputs: int = 32, device=None, **kw):
    """SSD-MobileNetV1 by name substring, with weights from `state_dict`, a
    flat .npz of the JAX package's variables named by `model_name`, or
    random init (`generator` in **kw). Labels are COCO's."""
    name = (model_name or "ssd_mobilenet").lower()
    if not ("ssd" in name or "mobilenet" in name):
        raise ValueError(f"{model_name!r}: this slice of the port has the "
                         "SSD-MobileNetV1 detector only")
    if state_dict is None and model_name and os.path.isfile(model_name):
        if not name.endswith(".npz"):
            raise ValueError(f"{model_name}: the port loads SSD weights from "
                             "a .npz of the JAX package's variables")
        from .weights import _flatten, load_npz, ssd_from_flax
        state_dict = ssd_from_flax(_flatten(load_npz(model_name)))
    det = SSDMobileNetDetector(state_dict=state_dict, max_outputs=max_outputs,
                               score_threshold=score_threshold,
                               device=device, **kw)
    # the reference adaptor's +1 labelmap offset is already applied:
    # COCO_LABELS has no background entry
    det.labels = dict(enumerate(COCO_LABELS))
    return det
