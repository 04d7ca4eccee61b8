from .types import (CONFIRMED, EMPTY, TENTATIVE, Detections, TrackStepOutput,
                    TrackTable, TrackerConfig, create_table, pack_detections)
from .tracker import step
from .labels import get_label

__all__ = [
    "CONFIRMED", "EMPTY", "TENTATIVE", "Detections", "TrackStepOutput",
    "TrackTable", "TrackerConfig", "create_table", "pack_detections",
    "step", "get_label",
]
