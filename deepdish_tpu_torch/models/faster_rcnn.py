"""Faster R-CNN (ResNet-v1 C4): trunk, RPN, proposal NMS, ROI crops, block4
box head and the second-stage postprocess, batched over frames.

Port of deepdish_tpu/models/faster_rcnn.py (`FasterRCNNConfig` :45,
`generate_rpn_anchors` :94, `decode_rcnn_boxes` :117, `crop_and_resize`
:135, `_iou_yxyx` :170, `_BottleneckV1` :183, `_ResNetBlock` :213,
`FasterRCNNNet` :229, `FasterRCNNDetector` :414), the TF-OD
faster_rcnn_resnet_v1 meta-architecture behind the reference's SavedModel
default (faster_rcnn_resnet101_v1_640x640):

  * slim resnet_v1 bottlenecks with the stride on the 3x3 conv of a
    block's LAST unit (torchvision puts it on the first), TF SAME padding
    (`layers.SameConv2d`, `layers.max_pool_same`), batch norms with eps
    1e-5, channel-mean input normalisation;
  * RPN heads permuted NCHW -> NHWC before the (-1, 4) / (-1, 2) reshape,
    so anchors (aspect-major per cell) keep the JAX package's order;
  * the RPN keeps the top `pre_nms_topk` by objectness (ties to the lower
    index, `topk_desc`) and both NMS stages pick in
    tf.image.non_max_suppression order (`_greedy(tie_high=False)`);
  * crop_and_resize as two contractions of separable bilinear weights
    (extrapolation 0), the weights cast to the feature map's dtype;
  * one deliberate deviation there: the last sample of a crop sits
    exactly on the box's far edge. TF's and JAX's float position of that
    sample lands one ulp past the map's last row for 4-24% of the
    proposals clipped to the image edge (by the order of rounding: XLA's
    fused multiply-adds vary with its fusion), which zeroes the crop's
    last row; the port's range decision does not depend on rounding, so
    the card, the CPU, a batch and a single frame agree;
  * second stage "argmax" (one candidate per proposal) or "per_class"
    (TF-OD's _postprocess_box_classifier exactly), as in the JAX module.

Every function carries a leading frame axis (B): the JAX package vmaps the
detector over a chunk's frames; here the frames go through the RPN
selection, both NMS stages and block4 together (block4 runs on B * P ROIs).
Module names follow the flax ones (conv1, conv1_bn, block<b>/unit_<u>/
{shortcut,conv1,conv2,conv3}[_bn], rpn_conv, rpn_box, rpn_cls, cls_head,
box_head), so the weight bridge (models/weights.py `faster_rcnn_from_flax`)
needs no renames. The argmax stage takes each proposal's box row by index
where JAX contracts a one-hot, which differs only when another class's row
holds an inf or NaN.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf
from torch import nn

from ..device import resolve_device, span
from ..ops.nms import _greedy
from ..ops.onehot import gather_rows, stable_argsort, topk_desc
from .layers import BatchNorm, SameConv2d, flax_default_init_, max_pool_same
from .preprocess import default_compute_dtype

# resnet_v1 channel means (RGB), the TF-OD feature extractor's `preprocess`
CHANNEL_MEANS = (123.68, 116.779, 103.939)
BOX_SCALE = (10.0, 10.0, 5.0, 5.0)


@dataclass(frozen=True)
class FasterRCNNConfig:
    """Architecture and meta-architecture settings; the defaults are the
    faster_rcnn_resnet101_v1_640x640 zoo configuration (a copy of the JAX
    package's)."""
    input_size: int = 640
    stem_features: int = 64
    block_units: Tuple[int, ...] = (3, 4, 23, 3)       # resnet101
    block_features: Tuple[int, ...] = (256, 512, 1024, 2048)
    block_strides: Tuple[int, ...] = (2, 2, 1, 1)      # C4: stride-16 trunk
    num_classes: int = 90
    # first stage
    anchor_base: float = 256.0
    anchor_scales: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.0)
    anchor_aspects: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_stride: int = 16
    rpn_features: int = 512
    pre_nms_topk: int = 1024
    max_proposals: int = 300          # first_stage_max_proposals
    rpn_iou_threshold: float = 0.7
    crop_size: int = 14
    # second stage: "argmax" (one candidate per proposal) or "per_class"
    nms_iou_threshold: float = 0.6
    second_stage_mode: str = "argmax"
    max_detections_per_class: int = 100

    @property
    def anchors_per_cell(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_aspects)


def generate_rpn_anchors(cfg: FasterRCNNConfig) -> np.ndarray:
    """TF-OD GridAnchorGenerator anchors (N, 4) [ycenter, xcenter, h, w] in
    input pixels: centres at (row, col) * stride, aspect-major and
    scale-minor per cell (a copy of the JAX package's numpy generator)."""
    fs = cfg.input_size // cfg.anchor_stride
    per_cell = [(cfg.anchor_base * s / np.sqrt(a),
                 cfg.anchor_base * s * np.sqrt(a))
                for a in cfg.anchor_aspects for s in cfg.anchor_scales]
    anchors = []
    for y in range(fs):
        for x in range(fs):
            for h, w in per_cell:
                anchors.append((y * cfg.anchor_stride, x * cfg.anchor_stride,
                                h, w))
    return np.asarray(anchors, np.float32)


def decode_rcnn_boxes(encodings: torch.Tensor, anchors_ychw: torch.Tensor,
                      box_scale=BOX_SCALE) -> torch.Tensor:
    """faster_rcnn_box_coder decode: (..., N, 4) (ty, tx, th, tw) against
    (..., N, 4) (ycenter, xcenter, h, w) -> (ymin, xmin, ymax, xmax) in the
    anchors' units."""
    ya, xa, ha, wa = anchors_ychw.unbind(-1)
    ty = encodings[..., 0] / box_scale[0]
    tx = encodings[..., 1] / box_scale[1]
    th = encodings[..., 2] / box_scale[2]
    tw = encodings[..., 3] / box_scale[3]
    ycenter = ty * ha + ya
    xcenter = tx * wa + xa
    h = torch.exp(th) * ha
    w = torch.exp(tw) * wa
    return torch.stack([ycenter - h / 2, xcenter - w / 2,
                        ycenter + h / 2, xcenter + w / 2], dim=-1)


def _interp_weights(lo, hi, n: int, extent: int) -> torch.Tensor:
    """(..., P) box edges normalised to the map -> (..., P, n, extent)
    bilinear weights of n sample points at TF's positions lo * (extent -
    1) + i * (hi - lo) * (extent - 1) / (n - 1), the last one exactly at
    hi * (extent - 1); points outside the map get all-zero rows
    (extrapolation 0)."""
    steps = torch.arange(n, dtype=torch.float32, device=lo.device)
    pos = (lo[..., None] * (extent - 1)
           + steps * ((hi - lo) * (extent - 1))[..., None] / (n - 1))
    pos = torch.cat([pos[..., :-1], (hi * (extent - 1))[..., None]], -1)
    grid = torch.arange(extent, dtype=torch.float32, device=lo.device)
    w = torch.clamp(1.0 - torch.abs(pos[..., None] - grid), min=0.0)
    in_range = (pos >= 0.0) & (pos <= extent - 1)
    return w * in_range[..., None]
def crop_and_resize(fmap: torch.Tensor, boxes_yxyx: torch.Tensor,
                    crop_h: int, crop_w: int) -> torch.Tensor:
    """tf.image.crop_and_resize (bilinear, extrapolation 0) as two
    contractions. fmap (B, Hf, Wf, C); boxes_yxyx (B, P, 4) normalised to
    the map. Returns (B, P, crop_h, crop_w, C) in fmap's dtype."""
    Hf, Wf = fmap.shape[-3], fmap.shape[-2]
    boxes = boxes_yxyx.float()
    wy = _interp_weights(boxes[..., 0], boxes[..., 2], crop_h, Hf)
    wx = _interp_weights(boxes[..., 1], boxes[..., 3], crop_w, Wf)
    rows = torch.einsum("bpih,bhwc->bpiwc", wy.to(fmap.dtype), fmap)
    return torch.einsum("bpiwc,bpjw->bpijc", rows, wx.to(fmap.dtype))


def _iou_yxyx(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) (ymin, xmin, ymax, xmax) boxes without
    the +1 px convention (tf.image.non_max_suppression's criterion)."""
    tl = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    br = torch.minimum(boxes[..., :, None, 2:4], boxes[..., None, :, 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))
    denom = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def _conv_bn(parent: nn.Module, name: str, cin: int, cout: int, k: int,
             stride: int) -> None:
    """A bias-free SAME conv and its batch norm, registered on `parent` as
    `<name>` and `<name>_bn` (the flax module names)."""
    setattr(parent, name, SameConv2d(cin, cout, k, stride))
    setattr(parent, f"{name}_bn", BatchNorm(cout, eps=1e-5))


def _apply_conv_bn(parent: nn.Module, name: str, x, relu=True):
    x = getattr(parent, f"{name}_bn")(getattr(parent, name)(x))
    return torch.relu(x) if relu else x


class _BottleneckV1(nn.Module):
    """slim resnet_v1 bottleneck: 1x1 reduce -> 3x3 (the stride) -> 1x1
    expand, a projection shortcut when the width or stride changes."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        mid = features // 4
        self.project = cin != features or stride != 1
        if self.project:
            _conv_bn(self, "shortcut", cin, features, 1, stride)
        _conv_bn(self, "conv1", cin, mid, 1, 1)
        _conv_bn(self, "conv2", mid, mid, 3, stride)
        _conv_bn(self, "conv3", mid, features, 1, 1)

    def forward(self, x):
        shortcut = (_apply_conv_bn(self, "shortcut", x, relu=False)
                    if self.project else x)
        h = _apply_conv_bn(self, "conv1", x)
        h = _apply_conv_bn(self, "conv2", h)
        h = _apply_conv_bn(self, "conv3", h, relu=False)
        return torch.relu(shortcut + h)


class _ResNetBlock(nn.Module):
    """slim resnet_v1_block: `units` bottlenecks, the stride on the LAST."""

    def __init__(self, units: int, cin: int, features: int, stride: int):
        super().__init__()
        self.units = units
        for i in range(units):
            setattr(self, f"unit_{i + 1}", _BottleneckV1(
                cin if i == 0 else features, features,
                stride if i == units - 1 else 1))

    def forward(self, x):
        for i in range(self.units):
            x = getattr(self, f"unit_{i + 1}")(x)
        return x


class FasterRCNNNet(nn.Module):
    """(B, S, S, 3) NHWC images in [0, 255] -> fixed-capacity (boxes yxyx
    normalised (B, K, 4), classes int32 0-based without background (B, K),
    scores (B, K), valid (B, K)), K = max_outputs; with
    `with_intermediates` also the dict of the JAX package's intermediates
    (fmap NHWC, rpn_box, rpn_cls, proposals, prop_valid, probs2, box2,
    prop_ychw), each with the frame axis."""

    def __init__(self, cfg: FasterRCNNConfig = FasterRCNNConfig(),
                 max_outputs: int = 32, score_threshold: float = 0.5):
        super().__init__()
        self.cfg = cfg
        self.max_outputs = max_outputs
        self.score_threshold = score_threshold
        _conv_bn(self, "conv1", 3, cfg.stem_features, 7, 2)
        cin = cfg.stem_features
        for b in range(4):
            setattr(self, f"block{b + 1}", _ResNetBlock(
                cfg.block_units[b], cin, cfg.block_features[b],
                cfg.block_strides[b]))
            cin = cfg.block_features[b]
        a = cfg.anchors_per_cell
        c4 = cfg.block_features[2]
        self.rpn_conv = SameConv2d(c4, cfg.rpn_features, 3, bias=True)
        self.rpn_box = SameConv2d(cfg.rpn_features, a * 4, 1, bias=True)
        self.rpn_cls = SameConv2d(cfg.rpn_features, a * 2, 1, bias=True)
        self.cls_head = nn.Linear(cin, cfg.num_classes + 1)
        self.box_head = nn.Linear(cin, cfg.num_classes * 4)
        self.register_buffer("anchors", None, persistent=False)
        self.register_buffer("channel_means", None, persistent=False)
        self.reset_constants()

    def reset_constants(self) -> None:
        """The anchors and channel means in float32 on the weights' device
        (after a cast of the module to the compute dtype)."""
        dev = self.conv1.weight.device
        self.anchors = torch.from_numpy(
            generate_rpn_anchors(self.cfg)).to(dev)
        self.channel_means = torch.tensor(CHANNEL_MEANS, device=dev)

    def forward(self, image: torch.Tensor, with_intermediates: bool = False):
        with span("frcnn.trunk"):
            fmap = self.trunk(image)
        inter = {"fmap": fmap}
        with span("frcnn.rpn_nms"):
            proposals, prop_valid = self.proposals(fmap, inter)
        out = self.second_stage(fmap, proposals, prop_valid, inter)
        if with_intermediates:
            return out, inter
        return out

    def trunk(self, image: torch.Tensor) -> torch.Tensor:
        """The first-stage feature extractor (output stride 16): (B, S, S,
        3) -> fmap (B, Hf, Wf, C4), NHWC."""
        dt = self.conv1.weight.dtype
        x = (image.float() - self.channel_means).to(dt)
        x = _apply_conv_bn(self, "conv1", x.permute(0, 3, 1, 2))
        x = max_pool_same(x, 3, 2)
        for b in range(3):
            x = getattr(self, f"block{b + 1}")(x)
        return x.permute(0, 2, 3, 1)

    def second_stage(self, fmap, proposals, prop_valid, inter=None):
        """ROI crops of fmap (B, Hf, Wf, C4) at proposals (B, P, 4), block4,
        the box and class heads and the postprocess -> fixed-capacity
        detections; fills `inter` (probs2, box2, prop_ychw) when given."""
        cfg = self.cfg
        B, P = proposals.shape[:2]
        with span("frcnn.crop_block4"):
            crops = crop_and_resize(fmap, proposals, cfg.crop_size,
                                    cfg.crop_size)
            crops = crops.reshape((B * P,) + crops.shape[2:])
            crops = max_pool_same(crops.permute(0, 3, 1, 2), 2, 2)
            pooled = self.block4(crops).mean(dim=(2, 3))      # (B * P, C5)
            nc = cfg.num_classes
            cls = self.cls_head(pooled).float().reshape(B, P, nc + 1)
            box = self.box_head(pooled).float().reshape(B, P, nc, 4)

        with span("frcnn.second_nms"):
            probs = torch.softmax(cls, dim=-1)[..., 1:]   # strip background
            py = (proposals[..., 0] + proposals[..., 2]) / 2
            px = (proposals[..., 1] + proposals[..., 3]) / 2
            ph = proposals[..., 2] - proposals[..., 0]
            pw = proposals[..., 3] - proposals[..., 1]
            prop_ychw = torch.stack([py, px, ph, pw], dim=-1)
            if inter is not None:
                inter.update(probs2=probs, box2=box, prop_ychw=prop_ychw)
            post = (self._postprocess_per_class
                    if cfg.second_stage_mode == "per_class"
                    else self._postprocess_argmax)
            return post(probs, box, prop_ychw, prop_valid)

    def proposals(self, fmap, inter=None):
        """RPN heads and proposal selection on fmap (B, Hf, Wf, C4):
        (proposals (B, P, 4) normalised yxyx, prop_valid (B, P)); fills
        `inter` (rpn_box, rpn_cls, proposals, prop_valid) when given."""
        return self.select_proposals(*self.rpn_heads(fmap), inter)

    def rpn_heads(self, fmap):
        """(box encodings (B, N, 4), objectness logits (B, N, 2)) in
        anchor order, float32."""
        B = fmap.shape[0]
        rpn = torch.relu(self.rpn_conv(fmap.permute(0, 3, 1, 2)))
        box_enc = self.rpn_box(rpn).permute(0, 2, 3, 1).reshape(
            B, -1, 4).float()
        cls_logits = self.rpn_cls(rpn).permute(0, 2, 3, 1).reshape(
            B, -1, 2).float()
        return box_enc, cls_logits

    def select_proposals(self, box_enc, cls_logits, inter=None):
        """Decode (input pixels, float32), the top pre_nms_topk by
        objectness, NMS, and the kept boxes compacted in score order."""
        cfg = self.cfg
        objness = torch.softmax(cls_logits, dim=-1)[..., 1]
        boxes = torch.clamp(decode_rcnn_boxes(box_enc, self.anchors), 0.0,
                            float(cfg.input_size))
        k = min(cfg.pre_nms_topk, boxes.shape[1])
        top_scores, top_idx = topk_desc(objness, k)
        top_boxes = gather_rows(boxes, top_idx)
        _, keep = _greedy(_iou_yxyx(top_boxes), top_scores,
                          torch.ones_like(top_scores, dtype=torch.bool),
                          cfg.rpn_iou_threshold, tie_high=False)
        # the kept proposals compacted in descending-score order
        P = min(cfg.max_proposals, k)
        pos = torch.arange(k, device=box_enc.device)
        order = stable_argsort(torch.where(keep, pos, k))[:, :P]
        proposals = gather_rows(top_boxes, order) / float(cfg.input_size)
        prop_valid = keep.gather(-1, order)
        if inter is not None:
            inter.update(rpn_box=box_enc, rpn_cls=cls_logits,
                         proposals=proposals, prop_valid=prop_valid)
        return proposals, prop_valid

    def _top_outputs(self, boxes, classes, scores, keep):
        """The top max_outputs kept candidates by score (ties to the lower
        index), as (boxes, classes, scores, valid). With fewer candidates
        than max_outputs the rest are invalid zero slots (JAX's rank-matrix
        top-k repeats candidate 0 there)."""
        short = self.max_outputs - scores.shape[-1]
        if short > 0:
            boxes = nnf.pad(boxes, (0, 0, 0, short))
            classes, scores, keep = (nnf.pad(x, (0, short))
                                     for x in (classes, scores, keep))
        masked = torch.where(keep, scores, torch.full_like(scores, -1.0))
        _, order = topk_desc(masked, self.max_outputs)
        return (gather_rows(boxes, order), classes.gather(-1, order),
                scores.gather(-1, order), keep.gather(-1, order))

    def _postprocess_argmax(self, probs, box, prop_ychw, prop_valid):
        """One candidate per proposal: its argmax class and that class's
        refined box, per-class NMS by the class-offset trick."""
        cfg = self.cfg
        scores, classes = probs.max(dim=-1)
        classes = classes.to(torch.int32)
        deltas = box.gather(-2, classes.long()[..., None, None].expand(
            classes.shape + (1, 4)))[..., 0, :]
        final = torch.clamp(decode_rcnn_boxes(deltas, prop_ychw), 0.0, 1.0)

        bad = torch.isnan(final).any(-1) | torch.isnan(scores)
        scores = torch.where(bad | ~prop_valid, torch.zeros_like(scores),
                             scores)
        conf_ok = scores >= self.score_threshold
        shifted = final + classes.float()[..., None] * 4.0
        same = classes[..., :, None] == classes[..., None, :]
        iou = torch.where(same, _iou_yxyx(shifted), 0.0)
        _, keep = _greedy(iou, scores, conf_ok, cfg.nms_iou_threshold,
                          tie_high=False)
        return self._top_outputs(final, classes, scores, keep)

    def _postprocess_per_class(self, probs, box, prop_ychw, prop_valid):
        """TF-OD _postprocess_box_classifier: every (proposal, class) pair
        is a candidate with that class's refined box; NMS per class, at
        most max_detections_per_class survivors per class, then the top
        max_outputs over all classes."""
        cfg = self.cfg
        B, P, nc = probs.shape
        anchors_rep = prop_ychw.repeat_interleave(nc, dim=1)
        final = decode_rcnn_boxes(box.reshape(B, P * nc, 4), anchors_rep)
        final = torch.clamp(final, 0.0, 1.0).reshape(B, P, nc, 4)

        bad = torch.isnan(final).any(-1) | torch.isnan(probs)
        scores = torch.where(bad | ~prop_valid[..., None],
                             torch.zeros_like(probs), probs)
        conf_ok = scores >= self.score_threshold

        boxes_c = final.transpose(1, 2)                # (B, nc, P, 4)
        scores_c = scores.transpose(1, 2)              # (B, nc, P)
        _, keep_c = _greedy(_iou_yxyx(boxes_c), scores_c,
                            conf_ok.transpose(1, 2), cfg.nms_iou_threshold,
                            tie_high=False)
        cap = cfg.max_detections_per_class
        if cap and cap < P:
            # survivors ranked per class by score (stable)
            inf = torch.full_like(scores_c, float("inf"))
            order = stable_argsort(torch.where(keep_c, -scores_c, inf))
            rank = torch.empty_like(order).scatter_(
                -1, order, torch.arange(P, device=order.device).expand_as(
                    order).contiguous())
            keep_c = keep_c & (rank < cap)
        flat_classes = torch.arange(nc, dtype=torch.int32,
                                    device=probs.device).repeat_interleave(P)
        return self._top_outputs(boxes_c.reshape(B, nc * P, 4),
                                 flat_classes.expand(B, nc * P),
                                 scores_c.reshape(B, nc * P),
                                 keep_c.reshape(B, nc * P))


class FasterRCNNDetector:
    """Faster R-CNN with the port's detector contract on `device` (default
    CUDA). `config` (default: the 640x640 ResNet-101 zoo model) may come
    from a checkpoint (`models.convert.convert_faster_rcnn_tfod`);
    `state_dict` is the network's weights (for example from
    `models.weights.faster_rcnn_from_flax`), without it random ones drawn
    like flax's defaults from `generator` (a CPU generator; default seeded
    with 0)."""

    def __init__(self, state_dict=None, max_outputs: int = 32,
                 score_threshold: float = 0.5,
                 config: Optional[FasterRCNNConfig] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        cfg = config or FasterRCNNConfig()
        self.cfg = cfg
        self.width = self.height = cfg.input_size
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else default_compute_dtype(self.device))
        net = FasterRCNNNet(cfg, max_outputs=max_outputs,
                            score_threshold=score_threshold)
        if state_dict is not None:
            net.load_state_dict(state_dict)
        else:
            flax_default_init_(net, generator if generator is not None
                               else torch.Generator().manual_seed(0))
        self.net = net.to(self.device, self.compute_dtype).eval()
        self.net.requires_grad_(False)
        self.net.reset_constants()
        self.max_outputs = max_outputs
        self.score_threshold = score_threshold
        self.labels = {}

    def detect(self, images_resized: torch.Tensor, orig_w: float,
               orig_h: float):
        """(B, S, S, 3) float/uint8 -> fixed-capacity (boxes_xyxy (B, K, 4)
        in original pixels, classes (B, K) int32, scores (B, K), valid
        (B, K) bool), K = max_outputs."""
        boxes_n, classes, scores, valid = self.net(images_resized)
        scale = torch.tensor([orig_w, orig_h, orig_w, orig_h],
                             dtype=torch.float32, device=boxes_n.device)
        return boxes_n[..., [1, 0, 3, 2]] * scale, classes, scores, valid
