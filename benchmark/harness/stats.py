"""Rates and percentiles over a window: frozen copies of the port's
`tools/bench.py` `rate` and `percentiles`, reduced to what a cell reports."""
from __future__ import annotations

import numpy as np


def rate(frames: int, seconds: float) -> float:
    """All frames over all seconds of the window."""
    return frames / seconds


def percentiles(ms) -> dict:
    ms = np.asarray(ms, np.float64)
    return {"p50": float(np.percentile(ms, 50)),
            "p90": float(np.percentile(ms, 90)),
            "p99": float(np.percentile(ms, 99)),
            "min": float(ms.min()), "max": float(ms.max()),
            "mean": float(ms.mean()), "n": int(ms.size)}
