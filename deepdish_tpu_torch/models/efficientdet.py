"""EfficientDet-Lite0 detector: EfficientNet-Lite0, BiFPN, box and class
heads, anchor decode, per-class NMS and the result filters.

Port of deepdish_tpu/models/efficientdet.py (`EfficientNetLite0` :91,
`BiFPNLayer` :139, `EfficientDetLite0` :166, `generate_anchors` :209,
`build_label_filter_lut` :227, `apply_result_filter` :250,
`EfficientDetLite0Detector` :264), the capability behind the reference's
metadata-driven TFLite detector (tools/tflite_object_detector.py:41-295):
an EfficientNet-Lite0 backbone (MBConv without squeeze-excite, ReLU6), three
sum-fusion BiFPN layers of 64 channels over P3-P7, per-level box and class
heads three separable convs deep, the SSD-style anchor decode (scales 1),
per-class NMS, and the reference's allow / deny label lists and
max_results. The input is normalized with the model metadata's mean and std
(default 127 / 128, tools/tflite_object_detector.py:117-131).

Padding follows flax's "SAME": the stride-2 convolutions pad
asymmetrically (`layers.SameConv2d`), and the BiFPN's 3x3 stride-2 max pool
pads with -inf the same way (10 -> 5 pads (0, 1)), which
`F.max_pool2d(padding=...)` cannot express, so `_down2` pads explicitly
(`layers.max_pool_same`).
The network runs NCHW inside and permutes its heads to NHWC before the
(-1, 4) / (-1, nc) reshape, so anchors keep the JAX package's order. Module
names follow the flax ones, which is what the weight bridge
(models/weights.py `efficientdet_from_flax`) maps.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..device import resolve_device
from ..ops import nms as nmsops
from ..ops.onehot import gather_rows, stable_argsort, topk_desc
from .layers import BatchNorm, SameConv2d, flax_default_init_, max_pool_same
from .preprocess import default_compute_dtype

INPUT_SIZE = 320
NUM_CLASSES = 90
FPN_CH = 64
FPN_REPEATS = 3
HEAD_REPEATS = 3
ANCHOR_SCALE = 3.0
NUM_SCALES = 3
ASPECTS = (1.0, 2.0, 0.5)
LEVELS = (3, 4, 5, 6, 7)


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


class _ConvBN(nn.Module):
    def __init__(self, cin, cout, kernel=3, stride=1, act=True):
        super().__init__()
        self.act = act
        self.conv = SameConv2d(cin, cout, kernel, stride)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return _relu6(x) if self.act else x


class _MBConvLite(nn.Module):
    """MBConv without squeeze-excite, ReLU6 (EfficientNet-Lite)."""

    def __init__(self, cin, cout, expand, kernel, stride):
        super().__init__()
        cmid = cin * expand
        self.expand = _ConvBN(cin, cmid, 1) if expand != 1 else None
        self.dw = SameConv2d(cmid, cmid, kernel, stride, groups=cmid)
        self.dw_bn = BatchNorm(cmid)
        self.project = SameConv2d(cmid, cout, 1)
        self.project_bn = BatchNorm(cout)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = x if self.expand is None else self.expand(x)
        y = _relu6(self.dw_bn(self.dw(y)))
        y = self.project_bn(self.project(y))
        return x + y if self.residual else y


_BLOCKS = [  # (expand, channels, repeats, stride, kernel)
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3)]
_FEATURE_BLOCKS = {2: 3, 4: 4, 6: 5}   # block index -> pyramid level


class EfficientNetLite0(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = _ConvBN(3, 32, 3, 2)
        cin = 32
        for bi, (e, c, r, s, k) in enumerate(_BLOCKS):
            for ri in range(r):
                setattr(self, f"b{bi}_{ri}",
                        _MBConvLite(cin, c, e, k, s if ri == 0 else 1))
                cin = c

    def forward(self, x):
        feats = {}
        x = self.stem(x)
        for bi, (_, _, r, _, _) in enumerate(_BLOCKS):
            for ri in range(r):
                x = getattr(self, f"b{bi}_{ri}")(x)
            if bi in _FEATURE_BLOCKS:
                feats[_FEATURE_BLOCKS[bi]] = x   # strides 8, 16, 32
        return feats


class _SepConvBN(nn.Module):
    def __init__(self, cin, cout, act=False):
        super().__init__()
        self.act = act
        self.dw = SameConv2d(cin, cin, 3, groups=cin)
        self.pw = SameConv2d(cin, cout, 1, bias=True)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        x = self.bn(self.pw(self.dw(x)))
        return _relu6(x) if self.act else x


def _down2(x):
    """3x3 stride-2 max pool with flax's SAME padding."""
    return max_pool_same(x, 3, 2)


def _up_to(x, like):
    """Nearest-neighbour x2 of x cropped to the grid of `like` (odd sizes
    crop the repeat)."""
    y = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return y[..., :like.shape[-2], :like.shape[-1]]


class BiFPNLayer(nn.Module):
    """Sum-fusion BiFPN layer over P3..P7."""

    _NODES = ("td6", "td5", "td4", "out3", "out4", "out5", "out6", "out7")

    def __init__(self):
        super().__init__()
        for name in self._NODES:
            setattr(self, name, _SepConvBN(FPN_CH, FPN_CH))

    def forward(self, p):
        p3, p4, p5, p6, p7 = p
        td6 = self.td6(_relu6(p6 + _up_to(p7, p6)))
        td5 = self.td5(_relu6(p5 + _up_to(td6, p5)))
        td4 = self.td4(_relu6(p4 + _up_to(td5, p4)))
        o3 = self.out3(_relu6(p3 + _up_to(td4, p3)))
        o4 = self.out4(_relu6(p4 + td4 + _down2(o3)))
        o5 = self.out5(_relu6(p5 + td5 + _down2(o4)))
        o6 = self.out6(_relu6(p6 + td6 + _down2(o5)))
        o7 = self.out7(_relu6(p7 + _down2(o6)))
        return [o3, o4, o5, o6, o7]


class EfficientDetLite0(nn.Module):
    """(N, 320, 320, 3) NHWC in [0, 255] -> (box_encodings (N, A, 4),
    class_logits (N, A, nc)), float32, A = 19206."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 norm_mean=(127.0,), norm_std=(128.0,)):
        super().__init__()
        self.num_classes = num_classes
        self.register_buffer("norm_mean", torch.tensor(norm_mean),
                             persistent=False)
        self.register_buffer("norm_std", torch.tensor(norm_std),
                             persistent=False)
        self.backbone = EfficientNetLite0()
        for level, cin in ((3, 40), (4, 112), (5, 320), (6, 320)):
            setattr(self, f"lat{level}", _ConvBN(cin, FPN_CH, 1, act=False))
        for i in range(FPN_REPEATS):
            setattr(self, f"bifpn{i}", BiFPNLayer())
        na = NUM_SCALES * len(ASPECTS)
        for li in range(len(LEVELS)):
            for hi in range(HEAD_REPEATS):
                setattr(self, f"boxh{hi}_l{li}",
                        _SepConvBN(FPN_CH, FPN_CH, act=True))
                setattr(self, f"clsh{hi}_l{li}",
                        _SepConvBN(FPN_CH, FPN_CH, act=True))
            setattr(self, f"box_pred_l{li}",
                    SameConv2d(FPN_CH, na * 4, 3, bias=True))
            setattr(self, f"cls_pred_l{li}",
                    SameConv2d(FPN_CH, na * num_classes, 3, bias=True))

    def forward(self, image: torch.Tensor):
        dt = self.backbone.stem.conv.weight.dtype
        x = (image.to(dt) - self.norm_mean.to(dt)) / self.norm_std.to(dt)
        feats = self.backbone(x.permute(0, 3, 1, 2))
        # the lateral convs in the JAX package's call order (lat3 ... lat6),
        # which models/convert.py's trace_slots records
        p3 = self.lat3(feats[3])
        p4 = self.lat4(feats[4])
        p5 = self.lat5(feats[5])
        p6 = _down2(self.lat6(feats[5]))
        p = [p3, p4, p5, p6, _down2(p6)]
        for i in range(FPN_REPEATS):
            p = getattr(self, f"bifpn{i}")(p)
        n = image.shape[0]
        box_out, cls_out = [], []
        for li, f in enumerate(p):
            b, c = f, f
            for hi in range(HEAD_REPEATS):
                b = getattr(self, f"boxh{hi}_l{li}")(b)
                c = getattr(self, f"clsh{hi}_l{li}")(c)
            b = getattr(self, f"box_pred_l{li}")(b).permute(0, 2, 3, 1)
            c = getattr(self, f"cls_pred_l{li}")(c).permute(0, 2, 3, 1)
            box_out.append(b.reshape(n, -1, 4))
            cls_out.append(c.reshape(n, -1, self.num_classes))
        return (torch.cat(box_out, 1).float(), torch.cat(cls_out, 1).float())


def generate_anchors(input_size: int = INPUT_SIZE) -> np.ndarray:
    """(A, 4) [ycenter, xcenter, h, w] in pixels (EfficientDet convention;
    a copy of the JAX package's numpy generator)."""
    anchors = []
    for level in LEVELS:
        stride = 2 ** level
        fs = math.ceil(input_size / stride)
        for y in range(fs):
            for x in range(fs):
                cy = (y + 0.5) * stride
                cx = (x + 0.5) * stride
                for si in range(NUM_SCALES):
                    scale = ANCHOR_SCALE * stride * 2 ** (si / NUM_SCALES)
                    for ar in ASPECTS:
                        anchors.append((cy, cx, scale / math.sqrt(ar),
                                        scale * math.sqrt(ar)))
    return np.asarray(anchors, np.float32)


def build_label_filter_lut(labels, label_allow, label_deny):
    """Class id -> keep? (numpy bool) for the reference's allow / deny
    lists (tools/tflite_object_detector.py:47-53, 275-289: deny first, then
    allow), or None when both are unset. One extra trailing slot stands for
    class ids with no label entry: such names are in neither list, so they
    are kept under a deny-only filter and dropped when an allow list is
    set."""
    if not label_allow and not label_deny:
        return None
    n = max(labels) + 1 if labels else 0
    lut = np.full((n + 1,), label_allow is None, bool)
    for idx, name in labels.items():
        keep = True
        if label_deny and name in label_deny:
            keep = False
        if label_allow is not None and name not in label_allow:
            keep = False
        lut[idx] = keep
    return lut


def apply_result_filter(classes, valid, lut, max_results):
    """The reference's result filtering (tools/tflite_object_detector.py:
    270-295) on (..., K) slots in descending-score order: allow / deny by
    class through `lut` (a bool tensor, or None), then at most
    `max_results` top-scored survivors."""
    if lut is not None:
        n = lut.shape[0] - 1          # trailing slot = unknown class ids
        valid = valid & lut[classes.long().clamp(max=n)]
    if max_results and max_results > 0:
        valid = valid & (valid.to(torch.int32).cumsum(-1) <= max_results)
    return valid


class EfficientDetLite0Detector:
    """EfficientDet-Lite0 with the metadata-driven postprocess of
    tools/tflite_object_detector.py:234-295, on `device` (default CUDA).
    `state_dict` is the network's weights (e.g. from
    `models.weights.efficientdet_from_flax`); without it they are random,
    drawn like flax's defaults from `generator` (a CPU generator; default
    seeded with 0). `anchors` (pixel units), `box_scale` and
    `detections_cap` are what a fused TFLite_Detection_PostProcess op sets;
    `label_allow`, `label_deny` and `max_results` resolve into the result
    filter once `labels` is set (`finalize_label_filter`)."""

    def __init__(self, state_dict=None, max_outputs: int = 32,
                 top_k: int = 100, score_threshold: float = 0.5,
                 iou_threshold: float = 0.5,
                 compute_dtype: Optional[torch.dtype] = None,
                 norm_mean=(127.0,), norm_std=(128.0,),
                 anchors=None, box_scale=None, detections_cap=None,
                 label_allow=None, label_deny=None, max_results: int = -1,
                 device=None, generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.width = self.height = INPUT_SIZE
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else default_compute_dtype(self.device))
        net = EfficientDetLite0(norm_mean=tuple(norm_mean),
                                norm_std=tuple(norm_std))
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
        # EfficientDet exports decode with scales (1, 1, 1, 1)
        self.box_scale = tuple(box_scale) if box_scale else (1.0,) * 4
        self.max_outputs = max_outputs
        self.top_k = top_k
        self.score_threshold = score_threshold
        self.iou_threshold = iou_threshold
        self.detections_cap = detections_cap
        self.label_allow = list(label_allow) if label_allow else None
        self.label_deny = list(label_deny) if label_deny else None
        self.max_results = max_results
        self.labels = {}
        self._filter_lut = None

    def finalize_label_filter(self):
        lut = build_label_filter_lut(self.labels, self.label_allow,
                                     self.label_deny)
        self._filter_lut = (None if lut is None
                            else torch.from_numpy(lut).to(self.device))

    def detect(self, images_resized: torch.Tensor, orig_w: float,
               orig_h: float):
        """(N, 320, 320, 3) -> fixed-capacity (boxes_xyxy (N, K, 4) pixels,
        classes (N, K) int32, scores (N, K), valid (N, K)), K =
        max_outputs, kept boxes first in score order."""
        with record_function("efficientdet.net"):
            box_enc, logits = self.net(images_resized)
        with record_function("efficientdet.decode_nms"):
            probs = torch.sigmoid(logits)
            scores, classes = probs.amax(-1), probs.argmax(-1)
            top_scores, idx = topk_desc(scores, self.top_k)
            enc = gather_rows(box_enc, idx)
            ya, xa, ha, wa = self.anchors[idx].unbind(-1)
            sy, sx, sh, sw_ = self.box_scale
            ycenter = enc[..., 0] / sy * ha + ya
            xcenter = enc[..., 1] / sx * wa + xa
            h = torch.exp(enc[..., 2] / sh) * ha
            w = torch.exp(enc[..., 3] / sw_) * wa
            # float32 ratios, as the JAX package divides float32 sizes
            sw = float(np.float32(orig_w) / np.float32(self.width))
            sh_ = float(np.float32(orig_h) / np.float32(self.height))
            xyxy = torch.stack([(xcenter - w / 2) * sw,
                                (ycenter - h / 2) * sh_,
                                (xcenter + w / 2) * sw,
                                (ycenter + h / 2) * sh_], -1)
            top_classes = classes.gather(-1, idx).to(torch.int32)
            conf_ok = top_scores >= self.score_threshold
            _, keep = nmsops.nms_xyxy_per_class(
                xyxy, top_scores, top_classes, conf_ok, self.iou_threshold)
            K = self.max_outputs
            pos = torch.arange(self.top_k, device=xyxy.device)
            order = stable_argsort(torch.where(keep, pos, self.top_k))[
                ..., :K]
            valid = keep.gather(-1, order)
            if self.detections_cap is not None and self.detections_cap < K:
                # descending-score slots: keep what the fused op emits
                valid = valid & (torch.arange(K, device=valid.device)
                                 < self.detections_cap)
            out_classes = top_classes.gather(-1, order)
            valid = apply_result_filter(out_classes, valid, self._filter_lut,
                                        self.max_results)
            return (gather_rows(xyxy, order), out_classes,
                    top_scores.gather(-1, order), valid)
