"""Host-side executor for real TFLite detector files (needs tensorflow).

Port of deepdish_tpu/models/tflite_host.py (`TFLiteHostDetector` :21),
capability parity with the reference's generic metadata-driven TFLite path
(tools/tflite.py:9-41 + tools/tflite_object_detector.py:41-295): where
tensorflow is installed and a `.tflite` flatbuffer is at hand, this wraps
the TF interpreter, sorts the TFLITE_DETECTION_POST_PROCESS outputs by
tensor-name suffix index (tflite_object_detector.py:154-172), normalizes
the input by dtype, and exposes `detect_host(frame_rgb)` with score / allow
/ max_results filtering, the duck-typed contract of a scripted detector.
It runs on the host, not on the card's path: the port's detectors convert
the same files (models/convert.py), and nothing falls back to this.
tensorflow and cv2 are imported inside the functions that use them; the
metadata is read with models/tflite_meta.py.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


class TFLiteHostDetector:
    def __init__(self, model_path: str, labels: Sequence[str] = (),
                 wanted_labels=None, score_threshold: float = 0.5,
                 max_results: int = 32, mean: float = None,
                 std: float = None, num_threads: int = 4):
        import tensorflow as tf
        # metadata-driven configuration (tflite_object_detector.py:117-137):
        # mean/std from NormalizationOptions, labels from the packed
        # associated file; explicit arguments override.
        try:
            from .tflite_meta import read_metadata
            meta = read_metadata(model_path)
        except Exception:
            meta = {"mean": [127.5], "std": [127.5], "labels": None}
        if mean is None:
            mean = float(np.mean(meta.get("mean", [127.5])))
        if std is None:
            std = float(np.mean(meta.get("std", [127.5])))
        if not labels and meta.get("labels"):
            labels = meta["labels"]
        self.interp = tf.lite.Interpreter(model_path=model_path,
                                          num_threads=num_threads)
        self.interp.allocate_tensors()
        self.input_detail = self.interp.get_input_details()[0]
        _, self.height, self.width, _ = self.input_detail["shape"].tolist()
        # sort outputs: TFLITE_DETECTION_POST_PROCESS emits
        # location/category/score/count whose deterministic order is the
        # trailing index of the output tensor name.
        outs = self.interp.get_output_details()

        def key(d):
            name = d["name"]
            digits = "".join(ch for ch in name.split(":")[-1]
                             if ch.isdigit())
            return int(digits) if digits else 0
        self.output_details = sorted(outs, key=key)
        self.labels = dict(enumerate(labels)) if not isinstance(
            labels, dict) else labels
        self.wanted_labels = wanted_labels or ["person"]
        self.score_threshold = score_threshold
        self.max_results = max_results
        self.mean, self.std = mean, std

    def detect_host(self, frame_rgb: np.ndarray):
        import cv2
        h, w = frame_rgb.shape[:2]
        resized = cv2.resize(frame_rgb, (self.width, self.height))
        if self.input_detail["dtype"] == np.uint8:
            inp = resized[None].astype(np.uint8)
        else:
            inp = ((resized[None].astype(np.float32) - self.mean) /
                   self.std)
        self.interp.set_tensor(self.input_detail["index"], inp)
        self.interp.invoke()
        boxes = self.interp.get_tensor(self.output_details[0]["index"])[0]
        classes = self.interp.get_tensor(self.output_details[1]["index"])[0]
        scores = self.interp.get_tensor(self.output_details[2]["index"])[0]
        tlwh, labels, out_scores = [], [], []
        for b, c, s in zip(boxes, classes, scores):
            if s < self.score_threshold or len(tlwh) >= self.max_results:
                continue
            name = self.labels.get(int(c), str(int(c)))
            if name not in self.wanted_labels:
                continue
            y1, x1, y2, x2 = b
            tlwh.append([x1 * w, y1 * h, (x2 - x1) * w, (y2 - y1) * h])
            labels.append(name)
            out_scores.append(float(s))
        return tlwh, labels, out_scores
