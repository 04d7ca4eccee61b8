from .efficientdet import EfficientDetLite0Detector
from .encoders import create_box_encoder, make_mars_encoder
from .registry import (COCO_LABELS, SCRIPTS, ScriptedDetector,
                       create_detector, load_labels, register_script)
from .ssd_mobilenet import SSDMobileNetDetector
from .yolov3 import YOLOv3Detector
from .yolov5 import YOLOv5Detector

__all__ = ["create_box_encoder", "make_mars_encoder", "COCO_LABELS",
           "SCRIPTS", "ScriptedDetector", "create_detector", "load_labels",
           "register_script", "EfficientDetLite0Detector",
           "SSDMobileNetDetector", "YOLOv3Detector", "YOLOv5Detector"]
