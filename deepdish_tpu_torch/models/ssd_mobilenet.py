"""SSD-MobileNetV1 detector: backbone, heads, anchor decode, per-class NMS.

Port of deepdish_tpu/models/ssd_mobilenet.py (`SSDMobileNetV1` :72,
`generate_anchors` :113, `decode_boxes` :144, `postprocess_detections`
:162, `SSDMobileNetDetector` :207). The output contract is the TFLite
detection postprocess's: boxes in original-image pixels, 0-based class ids
(background stripped), sigmoid scores, fixed capacity `max_outputs`.

The network runs NCHW inside; its public input is NHWC (N, 300, 300, 3) and
the heads are permuted back to NHWC before the (-1, 4) / (-1, 91) reshape,
so anchors keep the JAX package's order. Module names follow the flax ones
(conv0, ds1..ds13, extra*_1x1/3x3, box_head*, cls_head*), which is what the
weight bridge (models/weights.py `ssd_from_flax`) maps.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..device import resolve_device
from ..ops import nms as nmsops
from ..ops.onehot import stable_argsort, topk_desc
from .layers import BatchNorm, SameConv2d, flax_default_init_
from .preprocess import default_compute_dtype

INPUT_SIZE = 300
NUM_CLASSES = 90  # COCO without background
BOX_SCALE = (10.0, 10.0, 5.0, 5.0)

_BACKBONE = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
             (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
             (1024, 2), (1024, 1)]
_EXTRAS = [(256, 512), (128, 256), (128, 256), (64, 128)]
_BOXES_PER_LOC = [3, 6, 6, 6, 6, 6]


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


class _ConvBN(nn.Module):
    def __init__(self, cin, cout, kernel=3, stride=1):
        super().__init__()
        self.conv = SameConv2d(cin, cout, kernel, stride)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return _relu6(self.bn(self.conv(x)))


class _DepthwiseSeparable(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.dw = SameConv2d(cin, cin, 3, stride, groups=cin)
        self.dw_bn = BatchNorm(cin)
        self.pw = SameConv2d(cin, cout, 1)
        self.pw_bn = BatchNorm(cout)

    def forward(self, x):
        x = _relu6(self.dw_bn(self.dw(x)))
        return _relu6(self.pw_bn(self.pw(x)))

    def fused_args(self):
        """This block as `ops.dsconv.fused_dsconv` takes it (NHWC layouts,
        batch norms folded with `fold_bn`): (dw_k (3, 3, Cin), dw_scale,
        dw_bias, pw_k (Cin, Cout), pw_scale, pw_bias), on the block's
        device, the vectors float32."""
        # ops.dsconv imports models.layers, so it is imported here
        from ..ops.dsconv import fold_bn
        dev = self.dw.weight.device

        def fold(bn):
            s, b = fold_bn(*(t.detach().double().cpu().numpy() for t in (
                bn.weight, bn.bias, bn.running_mean, bn.running_var)),
                eps=bn.eps)
            return tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                         for v in (s, b))
        dw_k = self.dw.weight.detach()[:, 0].permute(1, 2, 0).contiguous()
        pw_k = self.pw.weight.detach()[:, :, 0, 0].t().contiguous()
        return (dw_k, *fold(self.dw_bn), pw_k, *fold(self.pw_bn))


class SSDMobileNetV1(nn.Module):
    """(N, 300, 300, 3) NHWC in [0, 255] -> (box_encodings (N, A, 4),
    class_logits (N, A, NUM_CLASSES + 1)), both float32."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.num_classes = num_classes
        self.conv0 = _ConvBN(3, 32, 3, 2)
        cin = 32
        for i, (c, s) in enumerate(_BACKBONE):
            setattr(self, f"ds{i + 1}", _DepthwiseSeparable(cin, c, s))
            cin = c
        for i, (c1, c2) in enumerate(_EXTRAS):
            setattr(self, f"extra{i}_1x1", _ConvBN(cin, c1, 1, 1))
            setattr(self, f"extra{i}_3x3", _ConvBN(c1, c2, 3, 2))
            cin = c2
        feat_ch = [512, 1024] + [c2 for _, c2 in _EXTRAS]
        for i, (c, a) in enumerate(zip(feat_ch, _BOXES_PER_LOC)):
            setattr(self, f"box_head{i}", SameConv2d(c, a * 4, 1, bias=True))
            setattr(self, f"cls_head{i}",
                    SameConv2d(c, a * (num_classes + 1), 1, bias=True))

    def forward(self, image: torch.Tensor):
        dt = self.conv0.conv.weight.dtype
        # float graphs take (2/255)x - 1 (the TFLite uint8 model takes raw
        # 0..255); normalised here, in the compute dtype
        x = (image.to(dt) * (2.0 / 255.0)) - 1.0
        x = x.permute(0, 3, 1, 2)
        x = self.conv0(x)
        feats: List[torch.Tensor] = []
        for i in range(len(_BACKBONE)):
            x = getattr(self, f"ds{i + 1}")(x)
            if i == 10:              # conv11 output, 19x19x512
                feats.append(x)
        feats.append(x)              # conv13 output, 10x10x1024
        for i in range(len(_EXTRAS)):
            x = getattr(self, f"extra{i}_1x1")(x)
            x = getattr(self, f"extra{i}_3x3")(x)
            feats.append(x)
        n = image.shape[0]
        box_out, cls_out = [], []
        for i, f in enumerate(feats):
            b = getattr(self, f"box_head{i}")(f).permute(0, 2, 3, 1)
            c = getattr(self, f"cls_head{i}")(f).permute(0, 2, 3, 1)
            box_out.append(b.reshape(n, -1, 4))
            cls_out.append(c.reshape(n, -1, self.num_classes + 1))
        return (torch.cat(box_out, 1).float(), torch.cat(cls_out, 1).float())


def generate_anchors(input_size: int = INPUT_SIZE) -> np.ndarray:
    """TF-OD ssd_anchor_generator anchors as (A, 4) [ycenter, xcenter, h, w]
    in normalized coords (a copy of the JAX package's numpy generator)."""
    feat_sizes = [max(1, math.ceil(input_size / stride))
                  for stride in (16, 32, 64, 128, 256, 512)]
    min_scale, max_scale, n = 0.2, 0.95, 6
    scales = [min_scale + (max_scale - min_scale) * i / (n - 1)
              for i in range(n)] + [1.0]
    aspect = [1.0, 2.0, 0.5, 3.0, 1.0 / 3.0]
    anchors = []
    for layer, fs in enumerate(feat_sizes):
        sk = scales[layer]
        sk1 = scales[layer + 1]
        if layer == 0:  # reduce_boxes_in_lowest_layer
            layer_boxes = [(0.1, 1.0), (sk, 2.0), (sk, 0.5)]
        else:
            layer_boxes = [(sk, a) for a in aspect]
            layer_boxes.append((math.sqrt(sk * sk1), 1.0))
        for y in range(fs):
            for x in range(fs):
                cy = (y + 0.5) / fs
                cx = (x + 0.5) / fs
                for scale, ar in layer_boxes:
                    anchors.append((cy, cx, scale / math.sqrt(ar),
                                    scale * math.sqrt(ar)))
    return np.asarray(anchors, np.float32)


def decode_boxes(box_encodings: torch.Tensor, anchors: torch.Tensor,
                 box_scale=BOX_SCALE) -> torch.Tensor:
    """(..., A, 4) (ty, tx, th, tw) -> normalized (ymin, xmin, ymax, xmax)."""
    ya, xa, ha, wa = anchors.unbind(-1)
    ty = box_encodings[..., 0] / box_scale[0]
    tx = box_encodings[..., 1] / box_scale[1]
    th = box_encodings[..., 2] / box_scale[2]
    tw = box_encodings[..., 3] / box_scale[3]
    ycenter = ty * ha + ya
    xcenter = tx * wa + xa
    h = torch.exp(th) * ha
    w = torch.exp(tw) * wa
    return torch.stack([ycenter - h / 2, xcenter - w / 2,
                        ycenter + h / 2, xcenter + w / 2], dim=-1)


def postprocess_detections(boxes, probs, orig_w, orig_h, *, top_k,
                           score_threshold, iou_threshold, max_outputs,
                           detections_cap=None):
    """The reference SSD postprocess (tools/ssd_mobilenet.py:100-150) on
    decoded boxes (..., N, 4) yxyx and probs (..., N, C) without the
    background column: NaN scrub -> top-k -> confidence filter -> xyxy in
    original pixels -> per-class NMS -> compaction to max_outputs slots in
    descending-score order; with `detections_cap` < max_outputs (a fused
    postprocess op's max_detections) the slots past the cap are invalid.
    Returns (xyxy, classes int32, scores, valid)."""
    scores = probs.amax(-1)
    classes = probs.argmax(-1).to(torch.int32)
    bad = torch.isnan(boxes).any(-1) | torch.isnan(scores)
    scores = torch.where(bad, torch.zeros_like(scores), scores)

    top_scores, idx = topk_desc(scores, top_k)
    top_boxes = boxes.gather(-2, idx[..., None].expand(idx.shape + (4,)))
    top_classes = classes.gather(-1, idx)
    conf_ok = top_scores >= score_threshold

    scale = torch.tensor([orig_w, orig_h, orig_w, orig_h],
                         dtype=torch.float32, device=boxes.device)
    xyxy = top_boxes[..., [1, 0, 3, 2]] * scale

    _, keep = nmsops.nms_xyxy_per_class(xyxy, top_scores, top_classes,
                                        conf_ok, iou_threshold)

    K = max_outputs
    pos = torch.arange(top_k, device=boxes.device)
    order = stable_argsort(torch.where(keep, pos, top_k))[..., :K]
    valid = keep.gather(-1, order)
    if detections_cap is not None and detections_cap < K:
        # slots are in descending-score order, so this keeps exactly the
        # boxes the fused op would have emitted
        valid = valid & (torch.arange(K, device=valid.device)
                         < detections_cap)
    return (xyxy.gather(-2, order[..., None].expand(order.shape + (4,))),
            top_classes.gather(-1, order), top_scores.gather(-1, order),
            valid)


class SSDMobileNetDetector:
    """SSD-MobileNetV1 with the reference's postprocessing, on `device`
    (default CUDA). `state_dict` is the network's weights (for example from
    `models.weights.ssd_from_flax`); without it the weights are random,
    drawn like flax's defaults from `generator` (a CPU generator; default
    seeded with 0). `anchors` (normalized (A, 4) [yc, xc, h, w]),
    `box_scale` and `detections_cap` are what a fused
    TFLite_Detection_PostProcess op sets: its embedded anchor table and
    decode scales override the generated ones, and slots past its
    max_detections are invalid (the shapes stay max_outputs)."""

    def __init__(self, state_dict=None, max_outputs: int = 32,
                 top_k: int = 100, score_threshold: float = 0.5,
                 iou_threshold: float = 0.5,
                 compute_dtype: Optional[torch.dtype] = None,
                 anchors=None, box_scale=None, detections_cap=None,
                 device=None, generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.width = self.height = INPUT_SIZE
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else default_compute_dtype(self.device))
        net = SSDMobileNetV1()
        if state_dict is not None:
            net.load_state_dict(state_dict)
        else:
            flax_default_init_(net, generator if generator is not None
                               else torch.Generator().manual_seed(0))
        self.net = net.to(self.device, self.compute_dtype).eval()
        self.net.requires_grad_(False)
        self.anchors = torch.from_numpy(np.asarray(
            anchors if anchors is not None else generate_anchors(),
            np.float32)).to(self.device)
        self.box_scale = tuple(box_scale) if box_scale else BOX_SCALE
        self.detections_cap = detections_cap
        self.max_outputs = max_outputs
        self.top_k = top_k
        self.score_threshold = score_threshold
        self.iou_threshold = iou_threshold
        self.labels = {}

    def detect(self, images_resized: torch.Tensor, orig_w: float,
               orig_h: float):
        """(N, 300, 300, 3) float/uint8 -> fixed-capacity (boxes_xyxy
        (N, K, 4) in original pixels, classes (N, K) int32, scores (N, K),
        valid (N, K) bool), K = max_outputs."""
        with record_function("ssd.net"):
            box_enc, logits = self.net(images_resized)
        with record_function("ssd.decode_nms"):
            boxes = decode_boxes(box_enc, self.anchors, self.box_scale)
            probs = torch.sigmoid(logits)[..., 1:]      # strip background
            return postprocess_detections(
                boxes, probs, orig_w, orig_h, top_k=self.top_k,
                score_threshold=self.score_threshold,
                iou_threshold=self.iou_threshold,
                max_outputs=self.max_outputs,
                detections_cap=self.detections_cap)
