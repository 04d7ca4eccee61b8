"""The Faster R-CNN (ResNet-v1 C4) family: the program's detector, its
taps, the plain reference's network and the checks of what the program's
detector made.

Checks of one frame (`check_frame`):
  * `det_gap` (`det_rms`): the RPN's box encodings and objectness logits
    against the reference's float32 trunk and RPN on the reference's own
    RGB frame and resize (largest |difference|, or the RMS of the
    differences, over the reference's RMS, the worse head);
  * `det2_gap` (`det2_rms`): the second stage at the program's own
    proposals, measured alike: its class
    log-probabilities (centred over the classes) and box deltas against
    the reference's crops of its own float32 feature map, block4 and
    heads at those proposals;
  * `post_off`: the reference's proposal selection (top-k and NMS) on the
    program's RPN outputs, and its second-stage postprocess (argmax,
    decode, per-class NMS, top outputs, pixel scale) on the program's
    second-stage outputs, against the program's proposals and raw
    detections: elements that differ.

The proposals are chaotic under rounding (greedy NMS among near-tied
random anchors), so the second stage is judged at the program's
proposals, and the proposal choice by the selection alone.
"""
from __future__ import annotations

import torch

from harness import readout
from harness import weights as W
from harness.flops import Count
from reference import faster_rcnn as ref_fr
from reference.coco import COCO_LABELS
from reference.layers import max_pool_same
from reference.preprocess import resize_bilinear_mxu


def net_config(config: dict) -> ref_fr.FasterRCNNConfig:
    d = dict(config["detector"])
    for k in ("block_units", "block_features", "block_strides",
              "anchor_scales", "anchor_aspects"):
        d[k] = tuple(d[k])
    return ref_fr.FasterRCNNConfig(**d)


def reference_net(config: dict) -> torch.nn.Module:
    net = ref_fr.FasterRCNNNet(
        net_config(config), max_outputs=int(config["detector_outputs"]),
        score_threshold=float(config["step"]["score_threshold"]))
    return net.eval()


def make_weights(config: dict, tr: dict, seed: int, device, waves, dtype):
    """(served state dict, float32 reference net holding the same values):
    flax's draw from the seed, batch norms calibrated on two walker frames
    of `waves` (one wave of the unrolled scene, `scene.scene`) resized to
    the input and two noise images with their biases at
    `calibration.bn_shift`; then the read-out fitted (`fit_readout`)."""
    with torch.device(device):
        net = reference_net(config)
    W.draw(net, seed, salt=3)
    size = net.cfg.input_size
    W.calibrate(net, torch.cat([
        resize_bilinear_mxu(W.calibration_frames(tr, waves), size, size,
                            torch.float32),
        W.noise_images(2, size, size, seed, 4, device)]),
        float(config["calibration"]["bn_shift"]))
    fit_readout(net, tr, waves)
    sd = W.served(net, dtype)
    net.load_state_dict(sd)
    net.requires_grad_(False)
    return sd, net


def fit_readout(net, tr: dict, waves) -> None:
    """Both stages read the walkers out (`harness/readout.py`), fitted on
    the frames of `waves`:
      * the RPN: each anchor shape's objectness logit rises with the
        anchor's overlap with a walker (-4 at an IoU of 0.3, +4 at 0.7;
        the background logit is 0) and its box encoding is fitted to the
        best walker's where the overlap passes 0.3;
      * the second stage, at the proposals the fitted RPN makes: the
        person logit rises with the proposal's overlap (-4 at 0.3, +4 at
        0.7; the background logit is 0) and the person box deltas are
        fitted to the best walker's where it passes 0.3. Every other
        class is never reported."""
    cfg = net.cfg
    H, Wd = int(tr["height"]), int(tr["width"])
    size = cfg.input_size
    frames = range(waves.shape[0])
    a = cfg.anchors_per_cell
    # the RPN, one fit for each anchor shape
    x = resize_bilinear_mxu(waves, size, size, torch.float32)
    fmap = torch.cat([net.trunk(x[i:i + 8])
                      for i in range(0, x.shape[0], 8)])
    rpn = torch.relu(net.rpn_conv(fmap.permute(0, 3, 1, 2)))
    feats = rpn.permute(0, 2, 3, 1).reshape(-1, rpn.shape[1])
    walkers = readout.walker_boxes(tr, frames, size / Wd, size / H,
                                   waves.device)
    anchors = net.anchors.reshape(-1, a, 4)
    for k in range(a):
        score, enc, best = (torch.cat(t) for t in zip(*(
            readout.targets(anchors[:, k], w, 0.5, ref_fr.BOX_SCALE)
            for w in walkers)))
        ws, bs = readout.ridge(feats, score[:, None])
        net.rpn_cls.weight[2 * k] = 0.0
        net.rpn_cls.bias[2 * k] = 0.0
        net.rpn_cls.weight[2 * k + 1, :, 0, 0] = ws[0]
        net.rpn_cls.bias[2 * k + 1] = bs[0]
        pos = best > 0.3
        if int(pos.sum()) > feats.shape[1]:
            wb, bb = readout.ridge(feats[pos], enc[pos])
            net.rpn_box.weight[4 * k:4 * k + 4, :, 0, 0] = wb
            net.rpn_box.bias[4 * k:4 * k + 4] = bb
    del rpn, feats
    # the second stage at the fitted RPN's proposals
    walkers = readout.walker_boxes(tr, frames, 1.0 / Wd, 1.0 / H,
                                   waves.device)
    pooled, score, enc, best = [], [], [], []
    for i in frames:
        props, valid = net.select_proposals(*net.rpn_heads(fmap[i:i + 1]))
        props = props[0][valid[0]]
        pooled.append(_pooled(net, fmap[i:i + 1], props[None])[0])
        ychw = torch.stack([(props[:, 0] + props[:, 2]) / 2,
                            (props[:, 1] + props[:, 3]) / 2,
                            props[:, 2] - props[:, 0],
                            props[:, 3] - props[:, 1]], dim=-1)
        t = readout.targets(ychw, walkers[i], 0.5, ref_fr.BOX_SCALE)
        score.append(t[0])
        enc.append(t[1])
        best.append(t[2])
    pooled, score = torch.cat(pooled), torch.cat(score)
    enc, best = torch.cat(enc), torch.cat(best)
    ws, bs = readout.ridge(pooled, score[:, None])
    net.cls_head.weight.zero_()
    net.cls_head.bias.fill_(readout.NEVER)
    net.cls_head.bias[0] = 0.0
    net.cls_head.weight[1] = ws[0]
    net.cls_head.bias[1] = bs[0]
    pos = best > 0.3
    wb, bb = readout.ridge(pooled[pos], enc[pos])
    net.box_head.weight[0:4] = wb
    net.box_head.bias[0:4] = bb


def _pooled(net, fmap, proposals):
    """The second stage's pooled block4 features (B, P, C5) at given
    proposals."""
    cfg = net.cfg
    B, P = proposals.shape[:2]
    crops = ref_fr.crop_and_resize(fmap, proposals, cfg.crop_size,
                                   cfg.crop_size)
    crops = crops.reshape((B * P,) + crops.shape[2:])
    crops = max_pool_same(crops.permute(0, 3, 1, 2), 2, 2)
    return net.block4(crops).mean(dim=(2, 3)).reshape(B, P, -1)


def program_detector(config: dict, sd: dict, device, dtype):
    from deepdish_tpu_torch.models import create_detector
    from deepdish_tpu_torch.models.faster_rcnn import FasterRCNNConfig
    d = dict(config["detector"])
    for k in ("block_units", "block_features", "block_strides",
              "anchor_scales", "anchor_aspects"):
        d[k] = tuple(d[k])
    return create_detector("faster_rcnn", state_dict=sd,
                           config=FasterRCNNConfig(**d),
                           max_outputs=int(config["detector_outputs"]),
                           score_threshold=float(
                               config["step"]["score_threshold"]),
                           compute_dtype=dtype, device=device)


def install_taps(det, rec) -> None:
    """Keeps the RPN's outputs and the second stage's inputs and outputs of
    the sampled calls."""
    net = det.net
    rpn, second = net.rpn_heads, net.second_stage

    def tapped_rpn(fmap):
        out = rpn(fmap)
        rec.put("rpn", out)
        return out

    def tapped_second(fmap, proposals, prop_valid, inter=None):
        inter = {} if inter is None else inter
        out = second(fmap, proposals, prop_valid, inter)
        rec.put("second", (proposals, prop_valid, inter["probs2"],
                           inter["box2"], out))
        return out
    net.rpn_heads = tapped_rpn
    net.second_stage = tapped_second


def labels(config: dict) -> dict:
    return dict(enumerate(COCO_LABELS))


def _heads2(net, fmap, proposals):
    """The second stage's network at given proposals: (class logits
    (B, P, C + 1), box deltas (B, P, C, 4)), float32."""
    B, P = proposals.shape[:2]
    pooled = _pooled(net, fmap, proposals).reshape(B * P, -1)
    nc = net.cfg.num_classes
    return (net.cls_head(pooled).float().reshape(B, P, nc + 1),
            net.box_head(pooled).float().reshape(B, P, nc, 4))


def input_size(config: dict) -> int:
    return int(config["detector"]["input_size"])


def detector_flops(config: dict) -> int:
    """FLOPs of the trunk, the RPN and the second stage at max_proposals
    proposals on one frame at the input size, counted on the meta
    device."""
    with torch.device("meta"):
        net = reference_net(config)
        cfg = net.cfg
        x = torch.empty((1, cfg.input_size, cfg.input_size, 3))
        props = torch.empty((1, cfg.max_proposals, 4))
        with Count() as c:
            fmap = net.trunk(x)
            net.rpn_heads(fmap)
            _heads2(net, fmap, props)
    return c.total


def _gaps(pairs):
    """(largest |p - r| over the RMS of r, RMS of p - r over the RMS of
    r), each the worst over the (p, r) pairs."""
    top, rms_gap = 0.0, 0.0
    for p, r in pairs:
        d = p.double() - r.double()
        rms = max(float(r.double().pow(2).mean().sqrt()), 1e-30)
        top = max(top, float(d.abs().max()) / rms)
        rms_gap = max(rms_gap, float(d.pow(2).mean().sqrt()) / rms)
    return top, rms_gap


def _centred(logp: torch.Tensor) -> torch.Tensor:
    return logp - logp.mean(-1, keepdim=True)


class Checker:
    """The reference's detector pieces for one configuration."""

    def __init__(self, config: dict, net, device):
        self.config = config
        self.net = net

    @staticmethod
    def heads(net, rgb: torch.Tensor):
        """(n, H, W, 3) uint8 -> `net`'s (fmap, (RPN box encodings,
        objectness logits))."""
        size = net.cfg.input_size
        fmap = net.trunk(resize_bilinear_mxu(rgb, size, size, torch.float32))
        return fmap, net.rpn_heads(fmap)

    def check_frame(self, call: dict, i: int, rgb: torch.Tensor,
                    frame_w: int, frame_h: int, control=None) -> dict:
        """Numbers of frame i of a sampled call (`call` holds the taps),
        `rgb` the reference's (1, H, W, 3) frame. With `control` (a copy
        of the reference net in a lower precision), that net's outputs
        stand in for the program's, at the program's proposals."""
        net = self.net
        sl = slice(i, i + 1)
        props, pvalid, probs2, box2, out2 = call["second"]
        props, pvalid = props[sl], pvalid[sl]
        fmap_r, rpn_r = self.heads(net, rgb)
        if control is None:
            rpn_p = tuple(x[sl] for x in call["rpn"])
            lp_p, box_p = torch.log(probs2[sl]), box2[sl]
        else:
            fmap_c, rpn_p = self.heads(control, rgb)
            cls_c, box_p = _heads2(control, fmap_c, props)
            lp_p = torch.log_softmax(cls_c, -1)[..., 1:]
        cls_r, box_r = _heads2(net, fmap_r, props)
        lp_r = torch.log_softmax(cls_r, -1)[..., 1:]
        ok = pvalid[..., None]
        top, rms = _gaps(zip(rpn_p, rpn_r))
        top2, rms2 = _gaps([
            (torch.where(ok, _centred(lp_p), 0.0),
             torch.where(ok, _centred(lp_r), 0.0)),
            (torch.where(ok[..., None], box_p, 0.0),
             torch.where(ok[..., None], box_r, 0.0))])
        out = {"det_gap": top, "det_rms": rms, "det2_gap": top2,
               "det2_rms": rms2}
        if control is None:
            sel = net.select_proposals(*rpn_p)
            off = sum(int((a != b).sum()) for a, b in zip(sel, (props,
                                                                 pvalid)))
            py = (props[..., 0] + props[..., 2]) / 2
            px = (props[..., 1] + props[..., 3]) / 2
            ph = props[..., 2] - props[..., 0]
            pw = props[..., 3] - props[..., 1]
            ychw = torch.stack([py, px, ph, pw], dim=-1)
            post = net._postprocess_argmax(probs2[sl], box2[sl], ychw,
                                           pvalid)
            scale = torch.tensor([frame_w, frame_h, frame_w, frame_h],
                                 dtype=torch.float32, device=rgb.device)
            ref = (post[0][..., [1, 0, 3, 2]] * scale,) + tuple(post[1:])
            raw = [x[sl] for x in call["raw"]]
            off += sum(int((a != b).sum()) for a, b in zip(ref, raw))
            out["post_off"] = off
        return out
