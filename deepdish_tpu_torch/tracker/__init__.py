from .types import (CONFIRMED, EMPTY, TENTATIVE, Detections, TrackStepOutput,
                    TrackTable, TrackerConfig, create_table, gallery_overflow,
                    gallery_pressure, grow_gallery, pack_detections)
from .tracker import step
from .labels import get_label

__all__ = [
    "CONFIRMED", "EMPTY", "TENTATIVE", "Detections", "TrackStepOutput",
    "TrackTable", "TrackerConfig", "create_table", "gallery_overflow",
    "gallery_pressure", "grow_gallery", "pack_detections", "step",
    "get_label",
]
