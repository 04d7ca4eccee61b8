"""The SSD-MobileNetV1 family: the program's detector, its taps, the plain
reference's network and the checks of what the program's detector made.

Checks of one frame (`check_frame`):
  * `det_gap` (`det_rms`): the network's box encodings and class logits
    against the reference's float32 network on the reference's own RGB
    frame and resize, as the largest |difference| (the RMS of the
    differences) over the reference's RMS, the worse of the two heads;
  * `post_off`: the box decode, top-k, score filter and per-class NMS of
    the reference run on the program's own network outputs, against the
    program's raw detections: elements that differ.
"""
from __future__ import annotations

import math

import torch

from harness import readout
from harness import weights as W
from harness.flops import Count
from reference import ssd_mobilenet as ref_ssd
from reference.coco import COCO_LABELS
from reference.preprocess import resize_bilinear_mxu

INPUT = ref_ssd.INPUT_SIZE


def reference_net(config: dict) -> torch.nn.Module:
    return ref_ssd.SSDMobileNetV1(int(config["detector"]["num_classes"])
                                  ).eval()


def make_weights(config: dict, tr: dict, seed: int, device, waves, dtype):
    """(served state dict, float32 reference net holding the same values):
    flax's draw from the seed, batch norms calibrated on two walker frames
    of `waves` (one wave of the unrolled scene, `scene.scene`) resized to
    the input and two noise images, with their biases at
    `calibration.bn_shift`; then the read-out fitted (`fit_readout`)."""
    with torch.device(device):
        net = reference_net(config)
    W.draw(net, seed, salt=1)
    W.calibrate(net, torch.cat([
        resize_bilinear_mxu(W.calibration_frames(tr, waves), INPUT, INPUT,
                            torch.float32),
        W.noise_images(2, INPUT, INPUT, seed, 2, device)]),
        float(config["calibration"]["bn_shift"]))
    fit_readout(net, tr, waves)
    sd = W.served(net, dtype)
    net.load_state_dict(sd)
    net.requires_grad_(False)
    return sd, net


def fit_readout(net, tr: dict, waves) -> None:
    """The lowest feature map's heads read the walkers out
    (`harness/readout.py`): at its first anchor of each cell (scale 0.1,
    square; about a walker's size), the person logit is fitted to rise
    with the anchor's overlap with a walker (from -4 at an IoU of 0.1 to
    +4 at 0.5) and the box encoding to the best walker's; every other
    class logit of every anchor is never reported."""
    H, Wd = int(tr["height"]), int(tr["width"])
    anchors = torch.from_numpy(ref_ssd.generate_anchors()).to(waves.device)
    per_cell = net.cls_head0.weight.shape[0] // (net.num_classes + 1)
    cells = math.ceil(INPUT / 16) ** 2          # 19 x 19 at 300
    first = anchors[:cells * per_cell:per_cell]
    feats = {}
    hook = net.cls_head0.register_forward_pre_hook(
        lambda m, a: feats.__setitem__("x", a[0]))
    try:
        net(resize_bilinear_mxu(waves, INPUT, INPUT, torch.float32))
    finally:
        hook.remove()
    x = feats["x"].float().permute(0, 2, 3, 1).reshape(-1,
                                                       feats["x"].shape[1])
    walkers = readout.walker_boxes(tr, range(waves.shape[0]), 1.0 / Wd,
                                   1.0 / H, waves.device)
    score, enc, best = zip(*(readout.targets(first, w, 0.3,
                                             ref_ssd.BOX_SCALE)
                             for w in walkers))
    score, enc, best = torch.cat(score), torch.cat(enc), torch.cat(best)
    ws, bs = readout.ridge(x, score[:, None])
    pos = best > 0.2
    C1 = net.num_classes + 1
    for i in range(6):
        head = getattr(net, f"cls_head{i}")
        for a in range(head.weight.shape[0] // C1):
            head.weight[a * C1 + 1:(a + 1) * C1] = 0.0
            head.bias[a * C1 + 1:(a + 1) * C1] = readout.NEVER
    net.cls_head0.weight[1, :, 0, 0] = ws[0]
    net.cls_head0.bias[1] = bs[0]
    if bool(pos.any()):
        wb, bb = readout.ridge(x[pos], enc[pos])
        net.box_head0.weight[0:4, :, 0, 0] = wb
        net.box_head0.bias[0:4] = bb


def program_detector(config: dict, sd: dict, device, dtype):
    from deepdish_tpu_torch.models import create_detector
    d = config["detector"]
    return create_detector("ssd_mobilenet", state_dict=sd,
                           top_k=int(d["top_k"]),
                           iou_threshold=float(d["iou_threshold"]),
                           max_outputs=int(config["detector_outputs"]),
                           score_threshold=float(
                               config["step"]["score_threshold"]),
                           compute_dtype=dtype, device=device)


def install_taps(det, rec) -> None:
    """Keeps the network's raw outputs of the sampled calls."""
    orig = det._apply_net

    def tapped(images):
        out = orig(images)
        rec.put("net", out)
        return out
    det._apply_net = tapped


def labels(config: dict) -> dict:
    return dict(enumerate(COCO_LABELS))


def input_size(config: dict) -> int:
    return INPUT


def detector_flops(config: dict) -> int:
    """FLOPs of the network on one frame at its input size, counted on
    the meta device."""
    with torch.device("meta"):
        net = reference_net(config)
        with Count() as c:
            net(torch.empty((1, INPUT, INPUT, 3)))
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


class Checker:
    """The reference's detector pieces for one configuration."""

    def __init__(self, config: dict, net, device):
        self.config = config
        self.net = net
        self.anchors = torch.from_numpy(ref_ssd.generate_anchors()).to(
            device)

    def heads(self, rgb: torch.Tensor):
        """(n, H, W, 3) uint8 -> the network's (box encodings, logits)."""
        return self.net(resize_bilinear_mxu(rgb, INPUT, INPUT,
                                            torch.float32))

    def check_frame(self, call: dict, i: int, rgb: torch.Tensor,
                    frame_w: int, frame_h: int, control=None) -> dict:
        """Numbers of frame i of a sampled call (`call` holds the taps),
        `rgb` the reference's (1, H, W, 3) frame. With `control` (a copy
        of the reference net in a lower precision), that net's outputs
        stand in for the program's."""
        box_r, logit_r = self.heads(rgb)
        if control is None:
            box_p, logit_p = (call["net"][0][i:i + 1],
                              call["net"][1][i:i + 1])
        else:
            box_p, logit_p = control(resize_bilinear_mxu(
                rgb, INPUT, INPUT, torch.float32))
        top, rms = _gaps([(box_p, box_r), (logit_p, logit_r)])
        out = {"det_gap": top, "det_rms": rms}
        if control is None:
            c = self.config
            boxes = ref_ssd.decode_boxes(box_p, self.anchors)
            probs = torch.sigmoid(logit_p)[..., 1:]
            ref = ref_ssd.postprocess_detections(
                boxes, probs, float(frame_w), float(frame_h),
                top_k=int(c["detector"]["top_k"]),
                score_threshold=float(c["step"]["score_threshold"]),
                iou_threshold=float(c["detector"]["iou_threshold"]),
                max_outputs=int(c["detector_outputs"]))
            raw = [x[i:i + 1] for x in call["raw"]]
            out["post_off"] = sum(int((a != b).sum())
                                  for a, b in zip(ref, raw))
        return out
