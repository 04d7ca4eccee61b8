from .encoders import create_box_encoder, make_mars_encoder
from .registry import COCO_LABELS, create_detector
from .ssd_mobilenet import SSDMobileNetDetector

__all__ = ["create_box_encoder", "make_mars_encoder", "COCO_LABELS",
           "create_detector", "SSDMobileNetDetector"]
