"""YOLOv5s detector: CSP backbone, SPPF, PANet neck, 3-scale head, decode.

Port of deepdish_tpu/models/yolov5.py (`YOLOv5s` :107, `decode_head` :151,
`postprocess_heads` :166, `YOLOv5Detector` :193), the capability behind the
reference's yolov5s TFLite models (tools/yolov5.py:37-146) with the v5s
depth/width multiples (0.33 / 0.50) and the COCO anchors of
detectors/yolov5/yolov5s.yaml:6-10. The decode is the reference's
(yolov5.py:120-131): xywh -> xyxy, confidence = obj * cls, argmax class,
score threshold, boxes scaled to the image; NMS is left to the pipeline's
class-agnostic stage, as in the reference.

The network runs NCHW inside; its public input is NHWC (N, S, S, 3) in
[0, 255] and its heads are returned NHWC, (N, H, W, 3 * (5 + nc)), so that
the decode's (H, W, 3, 5 + nc) reshape assigns anchors and classes as the
JAX package does. Module names follow the flax ones (stem, down1, c3_1, ...,
head_p3), with flax's auto-named children as cv1 / cv2 / cv3 / m.<i>
(ConvBlock_0/1/2, Bottleneck_<i>), which is what the weight bridge
(models/weights.py `yolov5_from_flax`) maps.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device, span
from ..ops.onehot import gather_rows, topk_desc
from .layers import BatchNorm, flax_default_init_
from .preprocess import default_compute_dtype

INPUT_SIZE = 320  # reference yolov5s tflite exports are 320x320
NUM_CLASSES = 80
# detectors/yolov5/yolov5s.yaml:6-10
ANCHORS = np.array([
    [[10, 13], [16, 30], [33, 23]],       # P3/8
    [[30, 61], [62, 45], [59, 119]],      # P4/16
    [[116, 90], [156, 198], [373, 326]],  # P5/32
], np.float32)
STRIDES = (8, 16, 32)


class ConvBlock(nn.Module):
    """Conv (k//2 padding on both sides unless given) + BN (eps 1e-3) +
    SiLU."""

    def __init__(self, cin, cout, kernel=1, stride=1, padding=-1):
        super().__init__()
        pad = kernel // 2 if padding < 0 else padding
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, shortcut=True):
        super().__init__()
        self.cv1 = ConvBlock(cin, cout, 1)
        self.cv2 = ConvBlock(cout, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, cin, cout, n=1, shortcut=True):
        super().__init__()
        c_ = cout // 2
        self.cv1 = ConvBlock(cin, c_, 1)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut)
                               for _ in range(n))
        self.cv2 = ConvBlock(cin, c_, 1)
        self.cv3 = ConvBlock(2 * c_, cout, 1)

    def forward(self, x):
        a = self.cv1(x)
        for b in self.m:
            a = b(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class SPPF(nn.Module):
    def __init__(self, cin, cout, pool=5):
        super().__init__()
        c_ = cin // 2
        self.pool = pool
        self.cv1 = ConvBlock(cin, c_, 1)
        self.cv2 = ConvBlock(4 * c_, cout, 1)

    def forward(self, x):
        x = self.cv1(x)
        p = self.pool // 2
        m1 = F.max_pool2d(x, self.pool, 1, p)
        m2 = F.max_pool2d(m1, self.pool, 1, p)
        m3 = F.max_pool2d(m2, self.pool, 1, p)
        return self.cv2(torch.cat([x, m1, m2, m3], 1))


def upsample2(x):
    """Nearest-neighbour x2 of an NCHW tensor (jnp.repeat on both axes)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YOLOv5s(nn.Module):
    """(N, S, S, 3) NHWC in [0, 255] -> [(N, S/8, S/8, 3 * (5 + nc)),
    (N, S/16, ...), (N, S/32, ...)] raw heads, float32, NHWC."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.stem = ConvBlock(3, 32, 6, 2, padding=2)      # P1/2
        self.down1 = ConvBlock(32, 64, 3, 2)               # P2/4
        self.c3_1 = C3(64, 64, 1)
        self.down2 = ConvBlock(64, 128, 3, 2)              # P3/8
        self.c3_2 = C3(128, 128, 2)
        self.down3 = ConvBlock(128, 256, 3, 2)             # P4/16
        self.c3_3 = C3(256, 256, 3)
        self.down4 = ConvBlock(256, 512, 3, 2)             # P5/32
        self.c3_4 = C3(512, 512, 1)
        self.sppf = SPPF(512, 512)
        self.neck_cv1 = ConvBlock(512, 256, 1)
        self.neck_c3_1 = C3(512, 256, 1, shortcut=False)
        self.neck_cv2 = ConvBlock(256, 128, 1)
        self.neck_c3_2 = C3(256, 128, 1, shortcut=False)
        self.neck_down1 = ConvBlock(128, 128, 3, 2)
        self.neck_c3_3 = C3(256, 256, 1, shortcut=False)
        self.neck_down2 = ConvBlock(256, 256, 3, 2)
        self.neck_c3_4 = C3(512, 512, 1, shortcut=False)
        no = 3 * (5 + num_classes)
        self.head_p3 = nn.Conv2d(128, no, 1)
        self.head_p4 = nn.Conv2d(256, no, 1)
        self.head_p5 = nn.Conv2d(512, no, 1)

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        dt = self.stem.conv.weight.dtype
        x = (image.to(dt) / 255.0).permute(0, 3, 1, 2)
        x = self.c3_1(self.down1(self.stem(x)))
        p3 = self.c3_2(self.down2(x))
        p4 = self.c3_3(self.down3(p3))
        p5 = self.sppf(self.c3_4(self.down4(p4)))
        u5 = self.neck_cv1(p5)
        n4 = self.neck_c3_1(torch.cat([upsample2(u5), p4], 1))
        u4 = self.neck_cv2(n4)
        o3 = self.neck_c3_2(torch.cat([upsample2(u4), p3], 1))
        o4 = self.neck_c3_3(torch.cat([self.neck_down1(o3), u4], 1))
        o5 = self.neck_c3_4(torch.cat([self.neck_down2(o4), u5], 1))
        return [h(o).permute(0, 2, 3, 1).float() for h, o in (
            (self.head_p3, o3), (self.head_p4, o4), (self.head_p5, o5))]


def _grid(h: int, w: int, device) -> torch.Tensor:
    """(H, W, 1, 2) cell offsets (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([gx, gy], -1)[:, :, None, :]


def decode_head(head: torch.Tensor, anchors: torch.Tensor, stride: int,
                input_size: int, num_classes: int = NUM_CLASSES):
    """One scale (..., H, W, 3 * (5 + nc)) -> (..., H * W * 3, 5 + nc) rows
    [x, y, w, h, obj, cls...], xywh normalized to [0, 1] like the TFLite
    export."""
    H, W = head.shape[-3], head.shape[-2]
    x = torch.sigmoid(head.reshape(head.shape[:-1] + (3, 5 + num_classes)))
    xy = (x[..., 0:2] * 2.0 - 0.5 + _grid(H, W, head.device)) \
        * stride / input_size
    wh = torch.square(x[..., 2:4] * 2.0) * anchors / input_size
    out = torch.cat([xy, wh, x[..., 4:]], -1)
    return out.reshape(head.shape[:-3] + (-1, 5 + num_classes))


def postprocess_heads(heads, input_size, orig_w, orig_h, *,
                      score_threshold, max_outputs):
    """The reference decode (yolov5.py:120-131) on raw heads, per level
    (..., H, W, A * (5 + nc)) ordered stride 8 / 16 / 32: xywh -> xyxy,
    conf = obj * cls, argmax class, threshold, top max_outputs (ties to
    the lower row), scale to the image. Returns (xyxy, classes int32,
    scores, valid), each (..., max_outputs[, 4])."""
    rows = torch.cat([
        decode_head(h, torch.from_numpy(ANCHORS[i]).to(h.device),
                    STRIDES[i], input_size)
        for i, h in enumerate(heads)], -2)
    conf = rows[..., 5:] * rows[..., 4:5]
    scores, classes = conf.amax(-1), conf.argmax(-1)   # first max on ties
    ok = scores >= score_threshold
    top_scores, idx = topk_desc(torch.where(ok, scores, -1.0), max_outputs)
    top = gather_rows(rows[..., :4], idx)
    xy, wh = top[..., 0:2], top[..., 2:4]
    scale = torch.tensor([orig_w, orig_h, orig_w, orig_h],
                         dtype=torch.float32, device=rows.device)
    xyxy = torch.cat([xy - wh / 2, xy + wh / 2], -1) * scale
    return (xyxy, classes.gather(-1, idx).to(torch.int32), top_scores,
            top_scores >= score_threshold)


class YOLOv5Detector:
    """YOLOv5s with the reference's decode, on `device` (default CUDA).
    `state_dict` is the network's weights (e.g. from
    `models.weights.yolov5_from_flax`); without it they are random, drawn
    like flax's defaults from `generator` (a CPU generator; default seeded
    with 0)."""

    def __init__(self, state_dict=None, max_outputs: int = 64,
                 score_threshold: float = 0.25,
                 input_size: int = INPUT_SIZE,
                 compute_dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.width = self.height = input_size
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else default_compute_dtype(self.device))
        net = YOLOv5s()
        if state_dict is not None:
            net.load_state_dict(state_dict)
        else:
            flax_default_init_(net, generator if generator is not None
                               else torch.Generator().manual_seed(0))
        self.net = net.to(self.device, self.compute_dtype).eval()
        self.net.requires_grad_(False)
        self.max_outputs = max_outputs
        self.score_threshold = score_threshold
        self.input_size = input_size
        self.labels = {}

    def detect(self, images_resized: torch.Tensor, orig_w: float,
               orig_h: float):
        """(N, S, S, 3) -> fixed-capacity (boxes_xyxy (N, K, 4) pixels,
        classes (N, K) int32, scores (N, K), valid (N, K)), K =
        max_outputs."""
        with span("yolov5.net"):
            heads = self.net(images_resized)
        with span("yolov5.decode_nms"):
            return postprocess_heads(heads, self.input_size, orig_w, orig_h,
                                     score_threshold=self.score_threshold,
                                     max_outputs=self.max_outputs)
