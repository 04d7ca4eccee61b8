"""TF SavedModel detector adaptor (host-side, gated on tensorflow).

A copy of deepdish_tpu/models/saved_model.py (`SavedModelDetector` :20),
importing tensorflow inside its methods only: where tensorflow is not
installed, constructing it raises ImportError. Capability parity with the
reference's SAVED_MODEL path (tools/saved_model.py:9-103): loads a TF2 object-detection SavedModel
(e.g. Faster-RCNN), introspects its serving signature, and exposes the
uniform detector contract. This is a host CPU executor — the reference's
SavedModel path likewise runs outside the accelerator family the rest of
the pipeline targets; the port's runtime routes any detector with
`detect_host` through the scripted path (FrameStep.scripted_step), which
feeds its boxes to the same filters, NMS, crop+embed and tracker step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .labelmap import load_pbtxt_labelmap


class SavedModelDetector:
    """Host detector: detect_host(frame_rgb) -> (tlwh list, labels, scores).

    Matches tools/saved_model.py: signature-introspected inputs, label map
    from pbtxt, score threshold + wanted-labels filtering.
    """

    def __init__(self, model_dir: str, label_file: Optional[str] = None,
                 wanted_labels=None, score_threshold: float = 0.5):
        import tensorflow as tf  # gated
        self.model = tf.saved_model.load(model_dir)
        self.fn = self.model.signatures["serving_default"]
        spec = list(self.fn.structured_input_signature[1].values())[0]
        self.input_dtype = spec.dtype
        self.label_names = (load_pbtxt_labelmap(label_file)
                            if label_file else {})
        self.wanted_labels = list(wanted_labels or ["person"])
        # pipeline contract (same as ScriptedDetector): labels maps the
        # CLASS INDICES detect_host emits (wanted-vocab positions)
        self.labels = {i: n for i, n in enumerate(self.wanted_labels)}
        self.label_offset = 0
        self.use_edgetpu = False
        shape = getattr(spec, "shape", None)
        self.height = int(shape[1]) if shape is not None and \
            shape.rank == 4 and shape[1] is not None else 640
        self.width = int(shape[2]) if shape is not None and \
            shape.rank == 4 and shape[2] is not None else 640
        self.score_threshold = score_threshold

    def detect_host(self, frame_rgb: np.ndarray):
        """(tlwh, wanted-vocab class indices, scores) — the contract the
        pipeline's scripted device path consumes (runtime._scripted_one)."""
        import tensorflow as tf
        inp = tf.convert_to_tensor(frame_rgb[None].astype(
            self.input_dtype.as_numpy_dtype))
        out = self.fn(inp)
        boxes = out["detection_boxes"][0].numpy()     # normalized yxyx
        classes = out["detection_classes"][0].numpy().astype(int)
        scores = out["detection_scores"][0].numpy()
        h, w = frame_rgb.shape[:2]
        tlwh, labels, out_scores = [], [], []
        for b, c, s in zip(boxes, classes, scores):
            if s < self.score_threshold:
                continue
            name = self.label_names.get(int(c), str(int(c)))
            if name not in self.wanted_labels:
                continue
            y1, x1, y2, x2 = b
            tlwh.append([x1 * w, y1 * h, (x2 - x1) * w, (y2 - y1) * h])
            labels.append(self.wanted_labels.index(name))
            out_scores.append(float(s))
        return tlwh, labels, out_scores
