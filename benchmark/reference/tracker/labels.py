"""Host-side label voting for tracks (Dirichlet-multinomial expectation).

A copy of deepdish_tpu/tracker/labels.py (numpy only; the port keeps its
own copy rather than import the JAX package). Port of the semantics of
deep_sort/track.py:154-188 (`get_label`) over the label-histogram arrays
the device step maintains, including the motorbike-vs-bicycle bias
workaround with factor 4. Runs on host because the result only feeds
rendering/counting, not the hot loop.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

MOTORBIKE_BICYCLE_FACTOR = 4  # track.py:175


def get_label(label_count: np.ndarray, label_conf: np.ndarray,
              labels: Sequence[str],
              return_confidence: bool = False):
    """label_count/label_conf: (L,) per-label vote count and confidence sum."""
    count = np.asarray(label_count)
    conf = np.asarray(label_conf)
    seen = count > 0
    if not seen.any():
        return (None, 0) if return_confidence else None

    lbls = [labels[i] for i in np.where(seen)[0]]
    c = count[seen].astype(np.float64)
    alphas = conf[seen] / c  # average confidence per label
    probs = (alphas + c) / (c.sum() + alphas.sum())
    # Reference sorts (prob, label) tuples descending (track.py:172).
    expected = sorted(zip(probs.tolist(), lbls), reverse=True)

    def avg(lbl):
        i = labels.index(lbl)
        return conf[i] / count[i]

    if len(expected) > 1:
        if expected[0][1] == 'motorbike' and expected[1][1] == 'bicycle':
            if expected[0][0] > expected[1][0] * MOTORBIKE_BICYCLE_FACTOR:
                return (('motorbike', avg('motorbike'))
                        if return_confidence else 'motorbike')
            else:
                return (('bicycle', avg('bicycle'))
                        if return_confidence else 'bicycle')
    top = expected[0][1]
    return (top, avg(top)) if return_confidence else top
