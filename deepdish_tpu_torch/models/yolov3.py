"""YOLOv3 detector: Darknet-53, a 3-scale FPN head, the anchor decode,
per-class NMS and the letterbox.

Port of deepdish_tpu/models/yolov3.py (`ConvBN` :37, `Darknet53` :70,
`YOLOv3` :109, `decode_head` :131, `YOLOv3Detector` :149), the capability
behind the reference's Keras YOLOv3 path (tools/yolo.py:153-240, network of
yolo3/model.py:70-116): conv-BN-LeakyReLU 0.1 with darknet's top-left
padding at stride 2, residual stages 1/2/8/8/4, the sigmoid/exp anchor
decode with the COCO anchors (tools/yolo.py:160), score = obj * class
prob, top 100, per-class greedy NMS at IoU 0.45 (tools/yolo.py:111-124).

Letterboxing: the frame is scaled preserving aspect ratio onto a gray-128
canvas (tools/yolo.py:141-151). `configure_letterbox(frame_w, frame_h)`
fixes the geometry once per frame size (FrameStep calls it), and `detect`
maps boxes back to frame coordinates (tools/yolo.py:78-86).

The network runs NCHW inside; heads come back NHWC (N, H, W, 3 * (5 + nc))
ordered stride 32 / 16 / 8. Module names follow the flax ones (backbone.stem,
backbone.down<i>, backbone.res<i>_<j>, head<i>, up<i>_conv), with flax's
auto-named ConvBN_<k> as convs.<k> and Conv_0 as conv, which is what the
weight bridge (models/weights.py `yolov3_from_flax`) maps.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device, span
from ..ops import nms as nmsops
from ..ops.onehot import gather_rows, stable_argsort, topk_desc
from .layers import BatchNorm, flax_default_init_
from .preprocess import default_compute_dtype
from .yolov5 import _grid, upsample2

INPUT_SIZE = 416
NUM_CLASSES = 80
# tools/yolo.py:160; masks: scale 0 (stride 32) -> anchors 6-8, etc.
ANCHORS = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                    [59, 119], [116, 90], [156, 198], [373, 326]],
                   np.float32)
MASKS = ((6, 7, 8), (3, 4, 5), (0, 1, 2))
STRIDES = (32, 16, 8)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, kernel=3, stride=1):
        super().__init__()
        self.stride = stride
        # darknet pads top-left by one and runs a VALID conv at stride 2
        pad = 0 if stride == 2 else kernel // 2
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        if self.stride == 2:
            x = F.pad(x, (1, 0, 1, 0))
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class Residual(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.convs = nn.ModuleList([ConvBN(c, c // 2, 1), ConvBN(c // 2, c)])

    def forward(self, x):
        return x + self.convs[1](self.convs[0](x))


_STAGES = [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]


class Darknet53(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 32, 3)
        cin = 32
        for ci, (c, n) in enumerate(_STAGES):
            setattr(self, f"down{ci}", ConvBN(cin, c, 3, 2))
            for ri in range(n):
                setattr(self, f"res{ci}_{ri}", Residual(c))
            cin = c

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for ci, (_, n) in enumerate(_STAGES):
            x = getattr(self, f"down{ci}")(x)
            for ri in range(n):
                x = getattr(self, f"res{ci}_{ri}")(x)
            if ci >= 2:
                feats.append(x)   # strides 8, 16, 32
        return feats


class HeadBlock(nn.Module):
    """5 alternating convs + output conv (yolo3/model.py make_last_layers);
    returns (branch, head)."""

    def __init__(self, cin, features, out_ch):
        super().__init__()
        f = features
        self.convs = nn.ModuleList([
            ConvBN(cin, f, 1), ConvBN(f, 2 * f, 3), ConvBN(2 * f, f, 1),
            ConvBN(f, 2 * f, 3), ConvBN(2 * f, f, 1), ConvBN(f, 2 * f, 3)])
        self.conv = nn.Conv2d(2 * f, out_ch, 1)

    def forward(self, x):
        for c in self.convs[:5]:
            x = c(x)
        return x, self.conv(self.convs[5](x))


class YOLOv3(nn.Module):
    """(N, S, S, 3) NHWC in [0, 255] -> [(N, S/32, S/32, 3 * (5 + nc)),
    (N, S/16, ...), (N, S/8, ...)] raw heads, float32, NHWC."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        no = 3 * (5 + num_classes)
        self.backbone = Darknet53()
        self.head0 = HeadBlock(1024, 512, no)
        self.up0_conv = ConvBN(512, 256, 1)
        self.head1 = HeadBlock(256 + 512, 256, no)
        self.up1_conv = ConvBN(256, 128, 1)
        self.head2 = HeadBlock(128 + 256, 128, no)

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        dt = self.backbone.stem.conv.weight.dtype
        x = (image.to(dt) / 255.0).permute(0, 3, 1, 2)
        s8, s16, s32 = self.backbone(x)
        b5, y0 = self.head0(s32)
        x = torch.cat([upsample2(self.up0_conv(b5)), s16], 1)
        b4, y1 = self.head1(x)
        x = torch.cat([upsample2(self.up1_conv(b4)), s8], 1)
        _, y2 = self.head2(x)
        return [y.permute(0, 2, 3, 1).float() for y in (y0, y1, y2)]


def decode_head(head: torch.Tensor, anchors: torch.Tensor, input_size: int,
                num_classes: int = NUM_CLASSES):
    """yolo_head decode (yolo3/model.py:90-116): xy = (sigmoid(t_xy) +
    grid) / grid size; wh = exp(t_wh) * anchor / input_size; obj and cls
    sigmoid. (..., H, W, 3 * (5 + nc)) -> (..., H * W * 3, 5 + nc)
    normalized rows."""
    H, W = head.shape[-3], head.shape[-2]
    x = head.reshape(head.shape[:-1] + (3, 5 + num_classes))
    size = torch.tensor([W, H], dtype=torch.float32, device=head.device)
    xy = (torch.sigmoid(x[..., 0:2]) + _grid(H, W, head.device)) / size
    wh = torch.exp(torch.clamp(x[..., 2:4], -10, 10)) * anchors / input_size
    out = torch.cat([xy, wh, torch.sigmoid(x[..., 4:5]),
                     torch.sigmoid(x[..., 5:])], -1)
    return out.reshape(head.shape[:-3] + (-1, 5 + num_classes))


class YOLOv3Detector:
    """YOLOv3 with the reference's postprocess, on `device` (default CUDA).
    `state_dict` is the network's weights (e.g. from
    `models.weights.yolov3_from_flax`); without it they are random, drawn
    like flax's defaults from `generator` (a CPU generator; default seeded
    with 0)."""

    letterbox = True

    def __init__(self, state_dict=None, max_outputs: int = 32,
                 score_threshold: float = 0.5, nms_threshold: float = 0.45,
                 top_k: int = 100, input_size: int = INPUT_SIZE,
                 compute_dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.width = self.height = input_size
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else default_compute_dtype(self.device))
        net = YOLOv3()
        if state_dict is not None:
            net.load_state_dict(state_dict)
        else:
            flax_default_init_(net, generator if generator is not None
                               else torch.Generator().manual_seed(0))
        self.net = net.to(self.device, self.compute_dtype).eval()
        self.net.requires_grad_(False)
        self.anchors = [torch.from_numpy(ANCHORS[list(m)]).to(self.device)
                        for m in MASKS]
        self.max_outputs = max_outputs
        self.score_threshold = score_threshold
        self.nms_threshold = nms_threshold
        self.top_k = top_k
        self.input_size = input_size
        self.labels = {}
        self._lb = None  # (left, top, new_w, new_h) in input pixels

    def configure_letterbox(self, frame_w: int, frame_h: int):
        """Static letterbox geometry for a frame size (tools/yolo.py:141-151:
        aspect-preserving scale onto gray 128)."""
        scale = min(self.input_size / frame_w, self.input_size / frame_h)
        nw = int(round(frame_w * scale))
        nh = int(round(frame_h * scale))
        self._lb = ((self.input_size - nw) // 2,
                    (self.input_size - nh) // 2, nw, nh)
        return self._lb

    def detect(self, images_resized: torch.Tensor, orig_w: float,
               orig_h: float):
        """(N, S, S, 3) letterboxed frames -> fixed-capacity (boxes_xyxy
        (N, K, 4) frame pixels, classes (N, K) int32, scores (N, K), valid
        (N, K)), K = max_outputs, kept boxes first in score order."""
        with span("yolov3.net"):
            heads = self.net(images_resized)
        with span("yolov3.decode_nms"):
            rows = torch.cat([decode_head(h, a, self.input_size)
                              for h, a in zip(heads, self.anchors)], -2)
            conf = rows[..., 5:] * rows[..., 4:5]
            scores, classes = conf.amax(-1), conf.argmax(-1)
            top_scores, idx = topk_desc(scores, self.top_k)
            top = gather_rows(rows[..., :4], idx)
            xy, wh = top[..., 0:2], top[..., 2:4]
            if self._lb is not None:
                # undo the letterbox (tools/yolo.py:78-86): boxes are
                # normalized to the padded input; map back to the frame
                left, top_, nw, nh = self._lb
                IN = float(self.input_size)
                off = torch.from_numpy(np.array(
                    [left / IN, top_ / IN], np.float32)).to(xy.device)
                sc = torch.from_numpy(np.array(
                    [IN / nw, IN / nh], np.float32)).to(xy.device)
                xy = (xy - off) * sc
                wh = wh * sc
            scale = torch.tensor([orig_w, orig_h, orig_w, orig_h],
                                 dtype=torch.float32, device=xy.device)
            xyxy = torch.cat([xy - wh / 2, xy + wh / 2], -1) * scale
            top_classes = classes.gather(-1, idx).to(torch.int32)
            ok = top_scores >= self.score_threshold
            _, keep = nmsops.nms_xyxy_per_class(
                xyxy, top_scores, top_classes, ok, self.nms_threshold)
            pos = torch.arange(self.top_k, device=xy.device)
            order = stable_argsort(torch.where(keep, pos, self.top_k))[
                ..., :self.max_outputs]
            return (gather_rows(xyxy, order), top_classes.gather(-1, order),
                    top_scores.gather(-1, order), keep.gather(-1, order))
