"""deepdish_tpu_torch: the PyTorch/CUDA port of deepdish_tpu.

Same tracking-by-detection pipeline (frame -> detector (SSD-MobileNetV1,
YOLOv5s, YOLOv3 or EfficientDet-Lite0) -> NMS -> crop + MARS embedding ->
Deep SORT tracker -> countline analytics, and the CVAT annotation merge),
written in eager PyTorch for an NVIDIA H100. The layout mirrors the JAX package
(`ops/`, `tracker/`, `models/`, `pipeline/`, `parallel/`, `tools/`) so each
module's counterpart is found by name; hand-written CUDA kernels live in `csrc/` with their Python
wrappers in `kernels/`.

The port imports torch and numpy only: nothing of JAX, flax or
`deepdish_tpu`. Entry points run on CUDA unless the caller passes
`device="cpu"`; without a card they raise (see `device.py`).
"""

__version__ = "0.1.0"
