"""w8a8 int8 SSD-MobileNetV1: the throughput mode behind `--detector-int8`
(or a model name with "int8" that is no file, e.g. `--model
ssd_mobilenet_int8`).

Port of deepdish_tpu/models/ssd_q.py (`ssd_forward` :131,
`calibrate_ssd` :238, `quantize_ssd` :256, `SSDMobileNetInt8Detector`
:291). Two integer stories coexist, as in the JAX package: models/qgraph.py
replays a full-integer TFLite file byte-exactly (the fidelity mode); this
module is the fast mode: the same post-training w8a8 recipe as the int8
MARS encoder (models/mars_q.py), with weights symmetric per output channel
in int8, activations int8, the contractions exact int8 x int8 -> int32,
and the glue (batch norms, relu6, decode) in the compute dtype (bf16 on the
card by default, float32 on the CPU and for parity).

Every quantized layer's input is a relu6 output, non-negative and at most
6, which allows two activation schemes:
  * 1x1 layers (the pointwise convs, the extras' 1x1s, the box and class
    heads) have no spatial padding, so the shifted scheme keeps 8 bits:
    q = round(x * 254/a) - 127 in [-127, 127], and conv(x) = s_a *
    (conv_i8(q, w8) + 127 * sum(w8)), the per-channel correction sum(w8)
    precomputed at quantize time;
  * 3x3 layers (the extras' 3x3s, and the depthwise convs with
    quantize_dw=True) use symmetric q = round(x * 127/a), so that zero
    padding stays x = 0 exactly.
The per-layer range a comes from a float32 calibration pass (absmax of
the layer's input, capped at relu6's 6). The stem (3 input channels, input
in [-1, 1]) and, by default, the depthwise convs stay in the compute dtype.

Contractions: models/qgraph.py's `int8_matmul` (torch._int_mm on the card,
an exact float64 matmul on the CPU), over the input itself for 1x1 layers
and over im2col patches for the 3x3s; a quantized depthwise conv sums its
9 taps in int32. The accumulators equal the JAX package's int32 ones bit for bit.
Tensors are NHWC; `params` is an SSDMobileNetV1 state_dict and the
quantized layers keep their flax paths ("ds1/pw", "extra0_3x3/Conv_0").
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .layers import flax_default_init_, same_pad
from .mars_q import conv_i8, conv_nhwc
from .qgraph import int8_weight
from .ssd_mobilenet import (INPUT_SIZE, NUM_CLASSES, SSDMobileNetDetector,
                            SSDMobileNetV1)

_EPS = 1e-3          # the port BatchNorm's (flax's) epsilon
_RELU6_MAX = 6.0

# backbone (features, stride) per depthwise-separable block
_CFG = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
        (1024, 1))
_EXTRAS = ((256, 512), (128, 256), (128, 256), (64, 128))
_BOXES_PER_LOC = (3, 6, 6, 6, 6, 6)


def _quantized_layers(quantize_dw: bool = False) -> Dict[str, Any]:
    """path -> (kernel size, stride, is_dw). 1x1 entries run the shifted
    8-bit scheme; 3x3 entries the symmetric one."""
    layers: Dict[str, Any] = {}
    for i in range(len(_CFG)):
        layers[f"ds{i + 1}/pw"] = (1, 1, False)
        if quantize_dw:
            layers[f"ds{i + 1}/dw"] = (3, _CFG[i][1], True)
    for i in range(len(_EXTRAS)):
        layers[f"extra{i}_1x1/Conv_0"] = (1, 1, False)
        layers[f"extra{i}_3x3/Conv_0"] = (3, 2, False)
    for i in range(len(_BOXES_PER_LOC)):
        layers[f"box_head{i}"] = (1, 1, False)
        layers[f"cls_head{i}"] = (1, 1, False)
    return layers


def _name(path: str) -> str:
    """A flax module path as the port's dotted state_dict prefix."""
    return path.replace("/Conv_0", ".conv").replace(
        "/BatchNorm_0", ".bn").replace("/", ".")


def _bn_ab(params, path: str):
    """Inference BatchNorm folded to y = x*a + b (float32 a, b)."""
    p = _name(path)
    a = params[f"{p}.weight"].float() * torch.rsqrt(
        params[f"{p}.running_var"].float() + _EPS)
    b = params[f"{p}.bias"].float() - params[f"{p}.running_mean"].float() * a
    return a, b


def _q_shift(x, a):
    """8-bit shifted quantization of a [0, a] activation (1x1 layers)."""
    m = float(np.float32(254.0) / np.float32(a))
    return torch.clamp(torch.round(x.float() * m) - 127.0, -127, 127).to(
        torch.int8)


def _q_sym(x, a):
    """Symmetric quantization of a [0, a] activation (padded 3x3/dw)."""
    m = float(np.float32(127.0) / np.float32(a))
    return torch.clamp(torch.round(x.float() * m), -127, 127).to(torch.int8)


def _dw_i8(x8, k8, stride):
    """Exact int8 depthwise 3x3 SAME: the taps' int32 products summed."""
    n, h, w, c = x8.shape
    kh, kw = k8.shape[:2]
    ph, pw = same_pad(h, stride, kh), same_pad(w, stride, kw)
    ho, wo = -(-h // stride), -(-w // stride)
    xp = F.pad(x8.to(torch.int32), (0, 0, pw[0], pw[1], ph[0], ph[1]))
    k = k8.reshape(kh * kw, c).to(torch.int32)
    acc = None
    for t in range(kh * kw):
        dy, dx = divmod(t, kw)
        tap = xp[:, dy: dy + (ho - 1) * stride + 1: stride,
                 dx: dx + (wo - 1) * stride + 1: stride, :] * k[t]
        acc = tap if acc is None else acc + tap
    return acc.long()


def prepare_qparams(qparams: Dict[str, Any], device) -> Dict[str, Any]:
    """qparams (from `quantize_ssd` or `weights.ssd_q_from_jax`) with the
    base weights on `device`, each int8 kernel as `int8_matmul`'s
    right-hand matrix there ("wmat"; depthwise kernels as int8 tensors)
    and the 1x1 corrections as tensors."""
    dev = torch.device(device)
    out = dict(qparams)
    out["base"] = {k: v.to(dev) for k, v in qparams["base"].items()}
    out["wmat"] = {}
    for p, w in qparams["wq"].items():
        if qparams["layers"][p][2]:
            out["wmat"][p] = torch.from_numpy(w).to(dev)
        else:
            out["wmat"][p] = int8_weight(w.reshape(-1, w.shape[-1]), dev)
    out["corr_t"] = {p: torch.from_numpy(np.asarray(c, np.int64)).to(dev)
                     for p, c in qparams["corr"].items()}
    return out


def ssd_forward(params, image, *, compute_dtype=torch.float32,
                qparams: Optional[Dict[str, Any]] = None,
                num_classes: int = NUM_CLASSES,
                sink: Optional[dict] = None,
                acc_sink: Optional[dict] = None):
    """SSDMobileNetV1 forward shared by three modes, as in the JAX package:

    * float mirror (qparams=None, sink=None): the math of
      models.ssd_mobilenet.SSDMobileNetV1;
    * calibration (sink={}): the float forward recording the absmax input
      of every quantizable conv into `sink`;
    * quantized (qparams from `prepare_qparams`): int8 convs, float glue.

    params: an SSDMobileNetV1 state_dict on the image's device; image
    (300, 300, 3) or (N, 300, 300, 3), raw 0..255. Returns (box_encodings
    (..., A, 4), class_logits (..., A, C+1)) float32. `acc_sink`
    (quantized mode) receives each layer's (int8 input, int32
    accumulator)."""
    dt = compute_dtype
    P = params
    squeeze = image.dim() == 3
    if squeeze:
        image = image[None]
    qlayers = qparams["layers"] if qparams is not None else {}

    def conv_layer(path, v, k, stride, groups=1, shifted=False):
        """One convolution in the current mode (pre-BN, compute dtype)."""
        if sink is not None:
            sink[path] = v.float().abs().amax()
        if qparams is not None and path in qlayers:
            k8 = qparams["wq"][path]
            s_w = torch.from_numpy(np.asarray(qparams["wscale"][path],
                                              np.float32)).to(v.device)
            a = np.float32(qparams["ascale"][path])
            if shifted:
                v8 = _q_shift(v, a)
            else:
                v8 = _q_sym(v, a)
            if groups > 1:
                acc = _dw_i8(v8, qparams["wmat"][path], stride)
            else:
                acc = conv_i8(v8, qparams["wmat"][path], k, k, stride,
                              k8.shape[-1])
            if shifted:
                acc = acc + qparams["corr_t"][path]
                s_a = np.float32(a / np.float32(254.0))
            else:
                s_a = np.float32(a / np.float32(127.0))
            if acc_sink is not None:
                acc_sink[path] = (v8, acc)
            return (acc.float() * (s_w * float(s_a))).to(dt)
        w = P[f"{_name(path)}.weight"].to(dt)
        return conv_nhwc(v, w, stride, groups)

    def bn_relu6(path, v):
        a, b = _bn_ab(P, path)
        return torch.clamp(v * a.to(dt) + b.to(dt), 0.0, 6.0)

    x = (image.to(dt) * (2.0 / 255.0)) - 1.0
    # stem: always float (3 input channels, [-1, 1] range)
    x = bn_relu6("conv0/BatchNorm_0",
                 conv_nhwc(x, P["conv0.conv.weight"].to(dt), 2))

    feats = []
    for i, (_, s) in enumerate(_CFG):
        name = f"ds{i + 1}"
        cin = x.shape[-1]
        x = conv_layer(f"{name}/dw", x, 3, s, groups=cin)
        x = bn_relu6(f"{name}/dw_bn", x)
        x = conv_layer(f"{name}/pw", x, 1, 1, shifted=True)
        x = bn_relu6(f"{name}/pw_bn", x)
        if i == 10:                  # conv11 output, 19x19x512
            feats.append(x)
    feats.append(x)                  # conv13 output, 10x10x1024

    for i in range(len(_EXTRAS)):
        x = conv_layer(f"extra{i}_1x1/Conv_0", x, 1, 1, shifted=True)
        x = bn_relu6(f"extra{i}_1x1/BatchNorm_0", x)
        x = conv_layer(f"extra{i}_3x3/Conv_0", x, 3, 2)
        x = bn_relu6(f"extra{i}_3x3/BatchNorm_0", x)
        feats.append(x)

    n = image.shape[0]
    box_out, cls_out = [], []
    for i, f in enumerate(feats):
        b = conv_layer(f"box_head{i}", f, 1, 1, shifted=True)
        b = b + P[f"box_head{i}.bias"].to(dt)
        c = conv_layer(f"cls_head{i}", f, 1, 1, shifted=True)
        c = c + P[f"cls_head{i}.bias"].to(dt)
        box_out.append(b.reshape(n, -1, 4))
        cls_out.append(c.reshape(n, -1, num_classes + 1))
    boxes = torch.cat(box_out, 1).float()
    logits = torch.cat(cls_out, 1).float()
    if squeeze:
        boxes, logits = boxes[0], logits[0]
    return boxes, logits


def default_calibration_images(n: int = 8, seed: int = 0) -> np.ndarray:
    """Deterministic synthetic calibration set (the JAX package's): noise,
    gradients and flat tones spanning the pixel range."""
    rng = np.random.RandomState(seed)
    s = INPUT_SIZE
    noise = rng.randint(0, 256, size=(n // 2, s, s, 3))
    ramp = np.linspace(0, 255, s)[None, None, :, None]
    grads = np.broadcast_to(ramp, (n // 4, s, s, 3)).copy()
    tones = rng.randint(0, 256, size=(n - n // 2 - n // 4, 1, 1, 3))
    tones = np.broadcast_to(tones, (tones.shape[0], s, s, 3)).copy()
    return np.concatenate([noise, grads, tones]).astype(np.float32)


@torch.inference_mode()
def calibrate_ssd(params, images=None,
                  compute_dtype=torch.float32) -> Dict[str, float]:
    """Absmax input of every quantizable conv over the calibration set,
    capped by the relu6 bound (params: a state_dict; the images go to its
    device)."""
    if images is None:
        images = default_calibration_images()
    dev = next(iter(params.values())).device
    sink: Dict[str, Any] = {}
    ssd_forward(params, torch.as_tensor(np.asarray(images, np.float32)).to(
        dev), compute_dtype=compute_dtype, sink=sink)
    return {k: min(float(v), _RELU6_MAX) for k, v in sink.items()}


def quantize_ssd(params, quantize_dw: bool = False,
                 calib_images=None) -> Dict[str, Any]:
    """Post-training w8a8 quantization -> qparams for ssd_forward:

    {"base": the state_dict with the quantized kernels pruned (empty),
     "layers": {path: (k, stride, is_dw)}, "wq": int8 kernels (HWIO
     numpy; depthwise (3, 3, 1, C)), "wscale": per-output-channel float32,
     "ascale": per-layer activation absmax (relu6-capped) float32,
     "corr": 127 * sum(w8) int32 per channel (shifted 1x1s only)}."""
    absmax = calibrate_ssd(params, calib_images)
    layers = _quantized_layers(quantize_dw)
    base = dict(params)
    wq, wscale, corr, ascale = {}, {}, {}, {}
    for path, (k, _stride, _is_dw) in layers.items():
        key = f"{_name(path)}.weight"
        w = params[key].detach().float().cpu().permute(2, 3, 1, 0).numpy()
        s = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / 127.0
        s = np.where(s == 0.0, 1.0, s).astype(np.float32)
        w8 = np.clip(np.round(w / s), -127, 127).astype(np.int8)
        wq[path] = w8
        wscale[path] = s
        if k == 1:                   # shifted scheme: per-channel shift sum
            corr[path] = (127 * w8.astype(np.int64).sum(axis=(0, 1, 2))
                          ).astype(np.int32)
        a = absmax.get(path, 0.0)
        ascale[path] = np.float32(a if a > 0 else _RELU6_MAX)
        base[key] = base[key].new_zeros((0,))
    return {"base": base, "layers": layers, "wq": wq, "wscale": wscale,
            "ascale": ascale, "corr": corr}


class SSDMobileNetInt8Detector(SSDMobileNetDetector):
    """SSDMobileNetDetector with the backbone and head convs on the int8
    path; decode and per-class NMS (models/ssd_mobilenet.py) unchanged.
    The float weights (`state_dict`, else random init) are quantized here
    with a float32 calibration on `calib_images` (default the synthetic
    set), or pass ready `qparams` (e.g. `weights.ssd_q_from_jax`)."""

    def __init__(self, state_dict=None, quantize_dw: bool = False,
                 calib_images=None, qparams=None,
                 generator: Optional[torch.Generator] = None, **kw):
        if state_dict is None and qparams is None:
            net = SSDMobileNetV1()
            flax_default_init_(net, generator if generator is not None
                               else torch.Generator().manual_seed(0))
            state_dict = net.state_dict()
        super().__init__(state_dict=state_dict, **kw)
        self.quantize_dw = quantize_dw
        if qparams is None:
            # quantized from the float32 weights, not the compute dtype's
            params = {k: v.detach().float().to(self.device)
                      for k, v in state_dict.items()}
            qparams = quantize_ssd(params, quantize_dw, calib_images)
        self.qparams = prepare_qparams(qparams, self.device)

    def _apply_net(self, images_resized):
        return ssd_forward(self.qparams["base"], images_resized,
                           compute_dtype=self.compute_dtype,
                           qparams=self.qparams,
                           num_classes=self.net.num_classes)
