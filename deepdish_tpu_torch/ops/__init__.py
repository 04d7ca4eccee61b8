from . import assignment, boxes, distance, geometry, kalman, nms  # noqa: F401
