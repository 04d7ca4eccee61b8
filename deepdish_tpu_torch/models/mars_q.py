"""Post-training int8 (w8a8) MARS encoder: the throughput mode behind
`--encoder-model mars_int8`.

Port of deepdish_tpu/models/mars_q.py (`mars_forward` :127,
`calibrate_mars` :209, `quantize_mars` :229, `make_mars_int8_encoder`
:262). The reference serves its appearance encoder as a quantized TFLite
artifact (tools/generate_detections.py:151-177); this is the same MARS
network (models/mars.py) with every hot matmul after the 3-channel stem
(the 3x3 / 1x1 convolutions and the 16384x128 dense layer) run as an
exact int8 x int8 -> int32 contraction.

Scheme (post-training, as in the JAX package):
  * weights: symmetric per-output-channel int8, s_w[c] = absmax(W[.., c])
    / 127;
  * activations: symmetric per-tensor int8 (zero point 0, so SAME zero
    padding stays exact), s_a = absmax / 127 from a calibration pass that
    records the absmax input of every quantized layer;
  * everything else (stem conv, batch norms, ELU, max-pool, residual adds,
    the final L2 norm) runs in the compute dtype: bf16 on the card by
    default, float32 on the CPU and for parity.

Two exact int8 contractions of the convolutions, chosen by `impl` as in
the JAX package (the dense layer is `int8_matmul` in both); each gives the
JAX package's int32 accumulators bit for bit:
  * "dot": zero-pad, im2col by slicing, then models/qgraph.py's
    `int8_matmul`: one `torch._int_mm` (cuBLASLt int8, int32 accumulators)
    per layer on the card, an exact float64 matmul on the CPU;
  * "conv": a direct convolution of the int8 codes in float64 with cuDNN
    off (models/qgraph.py's "xconv"): torch has no int8 convolution on
    CUDA, every product and partial sum is an integer far below 2^53, and
    without cuDNN no Winograd or FFT algorithm rounds the sum;
  * "auto": "dot" on every device. The JAX package resolves "auto" to
    "conv" from a TPU v5e measurement (deepdish_tpu/models/mars_q.py:24-33)
    that says nothing of this card; `tools/profile_mars_int8.py` times both
    impls on it, and "auto" keeps the path the CLI has always run.
Tensors are NHWC as in the JAX version; `params` is a MarsNet state_dict
(flat, dotted names) and the quantized layers keep their flax paths
("conv2_1/inner/conv1").
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .layers import flax_default_init_, same_pad
from .mars import FEATURE_DIM, INPUT_SHAPE, MarsNet
from .preprocess import default_compute_dtype
from .qgraph import int8_matmul, int8_weight

_EPS = 1e-3  # slim batch_norm epsilon (models/mars.py)

# (name, increase_dim, is_first) for the six residual blocks, in order.
_BLOCKS = (("conv2_1", False, True), ("conv2_3", False, False),
           ("conv3_1", True, False), ("conv3_3", False, False),
           ("conv4_1", True, False), ("conv4_3", False, False))

#: layers whose matmul runs int8 (flax paths); the stem conv1_1 stays float
#: (3 input channels, and pixel inputs need no calibration of their own).
QUANTIZED_LAYERS = ("conv1_2",) + tuple(
    f"{n}/inner/conv{i}" for n, _, _ in _BLOCKS for i in (1, 2)) + tuple(
    f"{n}/projection" for n, inc, _ in _BLOCKS if inc) + ("fc1",)


def _name(path: str) -> str:
    """A flax module path as the port's dotted state_dict prefix."""
    return path.replace("/", ".")


def _bn_ab(params, path: str):
    """Inference BN as y = x*a + b in float32 (slim's learn no scale: the
    weight is ones)."""
    p = _name(path)
    a = torch.rsqrt(params[f"{p}.running_var"].float() + _EPS) \
        * params[f"{p}.weight"].float()
    b = params[f"{p}.bias"].float() - params[f"{p}.running_mean"].float() * a
    return a, b


def conv_nhwc(x, w_oihw, stride=1, groups=1):
    """TF SAME convolution of NHWC x with an OIHW kernel."""
    v = x.permute(0, 3, 1, 2)
    ph = same_pad(v.shape[2], stride, w_oihw.shape[2])
    pw = same_pad(v.shape[3], stride, w_oihw.shape[3])
    if any(ph) or any(pw):
        v = F.pad(v, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(v, w_oihw, stride=stride, groups=groups) \
        .permute(0, 2, 3, 1)


def conv_i8(x8, wmat, kh, kw, stride, co):
    """Exact SAME int8 convolution: x8 (N, H, W, Cin) int8 zero-padded,
    im2col by slicing, `int8_matmul` against wmat (the (kh*kw*Cin, Cout)
    kernel from `int8_weight`) -> (N, Ho, Wo, Cout) int64."""
    n, h, w, _ = x8.shape
    ph, pw = same_pad(h, stride, kh), same_pad(w, stride, kw)
    ho, wo = -(-h // stride), -(-w // stride)
    xp = F.pad(x8, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    taps = [xp[:, dy: dy + (ho - 1) * stride + 1: stride,
               dx: dx + (wo - 1) * stride + 1: stride, :]
            for dy in range(kh) for dx in range(kw)]
    p = taps[0] if len(taps) == 1 else torch.stack(taps, 3)
    acc = int8_matmul(p.reshape(n * ho * wo, -1), wmat, co)
    return acc.reshape(n, ho, wo, co)


def conv_i8_direct(x8, w64, stride):
    """Exact SAME int8 convolution as one direct float64 convolution with
    cuDNN off: x8 (N, H, W, Cin) int8, w64 the (Cout, Cin, kh, kw) float64
    kernel (`prepare_qparams`' "wconv") -> (N, Ho, Wo, Cout) int64."""
    v = x8.permute(0, 3, 1, 2).double()
    ph = same_pad(v.shape[2], stride, w64.shape[2])
    pw = same_pad(v.shape[3], stride, w64.shape[3])
    v = F.pad(v, (pw[0], pw[1], ph[0], ph[1]))
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(v, w64, stride=stride)
    return acc.permute(0, 2, 3, 1).long()


def _quantize_act(x, s_in):
    """Symmetric int8: round(x * (1 / s_in)) (half to even), clamped."""
    recip = float(np.float32(1.0) / np.float32(s_in))
    return torch.clamp(torch.round(x.float() * recip), -127, 127).to(
        torch.int8)


def prepare_qparams(qparams: Dict[str, Any], device) -> Dict[str, Any]:
    """qparams (from `quantize_mars` or `weights.mars_q_from_jax`) with the
    base weights on `device`, each int8 kernel as `int8_matmul`'s
    right-hand matrix there ("wmat", impl "dot") and each int8 conv kernel
    as a float64 OIHW tensor there ("wconv", impl "conv"); the quantized
    forward reads these."""
    dev = torch.device(device)
    out = dict(qparams)
    out["base"] = {k: v.to(dev) for k, v in qparams["base"].items()}
    out["wmat"] = {p: int8_weight(w.reshape(-1, w.shape[-1]), dev)
                   for p, w in qparams["wq"].items()}
    out["wconv"] = {p: torch.from_numpy(np.asarray(w)).permute(3, 2, 0, 1)
                    .to(dev, torch.float64).contiguous()
                    for p, w in qparams["wq"].items() if np.ndim(w) == 4}
    return out


IMPLS = ("auto", "dot", "conv")


def _resolve_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return "dot" if impl == "auto" else impl


def mars_forward(params, images, *, compute_dtype=torch.float32,
                 qparams: Optional[Dict[str, Any]] = None,
                 impl: str = "auto", sink: Optional[dict] = None,
                 acc_sink: Optional[dict] = None):
    """One forward shared by three modes, as in the JAX package:

    * float mirror (qparams=None, sink=None): the math of
      models.mars.MarsNet;
    * calibration (sink={}): the float forward recording the absmax input
      of every QUANTIZED_LAYERS entry into `sink` (float32 tensors);
    * quantized (qparams from `prepare_qparams`): int8 matmuls, float glue.

    params: a MarsNet state_dict on the images' device; images (N, 128,
    64, 3) NHWC in [0, 255]. `impl` picks the convolutions' int8
    contraction (module docstring). `acc_sink` (quantized mode) receives
    each layer's (int8 input, int32 accumulator)."""
    dt = compute_dtype
    P = params
    impl = _resolve_impl(impl)

    def bn(path, v):
        a, b = _bn_ab(P, path)
        return v * a.to(dt) + b.to(dt)

    def matmul(path, v, stride=1):
        """Conv (4-D v) or dense (2-D v) for the current mode."""
        if sink is not None and path in QUANTIZED_LAYERS:
            sink[path] = v.float().abs().amax()
        if qparams is not None and path in QUANTIZED_LAYERS:
            s_in = qparams["ascale"][path]
            k8 = qparams["wq"][path]
            s_w = torch.from_numpy(np.asarray(qparams["wscale"][path],
                                              np.float32)).to(v.device)
            v8 = _quantize_act(v, s_in)
            if v.dim() == 4 and impl == "conv":
                acc = conv_i8_direct(v8, qparams["wconv"][path], stride)
            elif v.dim() == 4:
                kh, kw, _, co = k8.shape
                acc = conv_i8(v8, qparams["wmat"][path], kh, kw, stride, co)
            else:
                acc = int8_matmul(v8, qparams["wmat"][path], k8.shape[1])
            if acc_sink is not None:
                acc_sink[path] = (v8, acc)
            scale = s_w * float(np.float32(s_in))
            return (acc.float() * scale).to(dt)
        w = P[f"{_name(path)}.weight"].to(dt)
        if v.dim() == 4:
            return conv_nhwc(v, w, stride)
        return v @ w.t()

    def residual(name, v, increase, is_first):
        pre = v if is_first else F.elu(bn(f"{name}/pre_bn", v))
        stride = 2 if increase else 1
        y = matmul(f"{name}/inner/conv1", pre, stride)
        y = F.elu(bn(f"{name}/inner/bn1", y))
        y = matmul(f"{name}/inner/conv2", y)
        y = y + P[f"{name}.inner.conv2.bias"].to(dt)
        if increase:
            return matmul(f"{name}/projection", v, 2) + y
        return v + y

    x = images.to(dt)
    x = F.elu(bn("conv1_1_bn", matmul("conv1_1", x)))
    x = F.elu(bn("conv1_2_bn", matmul("conv1_2", x)))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    for name, inc, first in _BLOCKS:
        x = residual(name, x, inc, first)
    x = x.reshape(x.shape[0], -1)
    x = F.elu(bn("fc1_bn", matmul("fc1", x)))
    x = bn("ball", x).float()
    norm = torch.sqrt(1e-8 + torch.sum(x * x, dim=1, keepdim=True))
    return x / norm


def default_calibration_patches(n: int = 64, seed: int = 0) -> np.ndarray:
    """Deterministic synthetic calibration set (the JAX package's): noise,
    flat tones and gradients spanning the pixel range."""
    rng = np.random.RandomState(seed)
    h, w, c = INPUT_SHAPE
    noise = rng.randint(0, 256, size=(n // 2, h, w, c))
    ramp = np.linspace(0, 255, w)[None, None, :, None]
    grads = np.broadcast_to(ramp, (n // 4, h, w, c)).copy()
    tones = rng.randint(0, 256, size=(n - n // 2 - n // 4, 1, 1, c))
    tones = np.broadcast_to(tones, (tones.shape[0], h, w, c)).copy()
    return np.concatenate([noise, grads, tones]).astype(np.float32)


@torch.inference_mode()
def calibrate_mars(params, patches, compute_dtype=torch.float32,
                   batch: int = 64) -> Dict[str, float]:
    """Absmax of every quantized layer's input over the calibration set
    (params: a MarsNet state_dict; the patches go to its device)."""
    dev = next(iter(params.values())).device
    out: Dict[str, float] = {}
    for i in range(0, len(patches), batch):
        sink: Dict[str, Any] = {}
        mars_forward(params, torch.as_tensor(
            np.asarray(patches[i:i + batch], np.float32)).to(dev),
            compute_dtype=compute_dtype, sink=sink)
        for k, v in sink.items():
            out[k] = max(out.get(k, 0.0), float(v))
    return out


def _kernel_hwio(params, path: str) -> np.ndarray:
    """A layer's float kernel in the JAX package's layout (HWIO / (in,
    out)) as float32 numpy."""
    w = params[f"{_name(path)}.weight"].detach().float().cpu()
    return (w.permute(2, 3, 1, 0) if w.dim() == 4 else w.t()).numpy()


def quantize_mars(params, calib_patches: Optional[np.ndarray] = None,
                  compute_dtype=torch.float32) -> Dict[str, Any]:
    """Post-training quantization -> qparams for mars_forward:

    {"base": the state_dict with the quantized kernels pruned (empty),
     "wq": int8 kernels (HWIO / (in, out) numpy), "wscale": per-output-
     channel float32, "ascale": per-layer input absmax/127 float32}."""
    if calib_patches is None:
        calib_patches = default_calibration_patches()
    absmax = calibrate_mars(params, calib_patches, compute_dtype)
    wq, wscale, ascale = {}, {}, {}
    base = dict(params)
    for path in QUANTIZED_LAYERS:
        w = _kernel_hwio(params, path)
        s = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / 127.0
        s = np.where(s == 0.0, 1.0, s).astype(np.float32)
        wq[path] = np.clip(np.round(w / s), -127, 127).astype(np.int8)
        wscale[path] = s
        a = absmax.get(path, 0.0)
        ascale[path] = np.float32((a if a > 0 else 1.0) / 127.0)
        key = f"{_name(path)}.weight"
        base[key] = base[key].new_zeros((0,))
    return {"base": base, "wq": wq, "wscale": wscale, "ascale": ascale}


def mars_int8_apply(qparams, patches, compute_dtype=torch.float32,
                    impl: str = "auto"):
    """Features of (N, 128, 64, 3) patches through the int8 network
    (qparams from `prepare_qparams`)."""
    return mars_forward(qparams["base"], patches,
                        compute_dtype=compute_dtype, qparams=qparams,
                        impl=impl)


def make_mars_int8_encoder(state_dict=None, calib_patches=None,
                           compute_dtype: Optional[torch.dtype] = None,
                           device=None,
                           generator: Optional[torch.Generator] = None,
                           qparams: Optional[Dict[str, Any]] = None,
                           impl: str = "auto"):
    """EncoderSpec running MARS with int8 matmuls on `device` (default
    CUDA); drop-in for FrameStep. Float weights from `state_dict` (else
    random, drawn like flax's defaults from `generator`, default seeded
    with 0) are quantized here, calibrated in the compute dtype; or pass
    ready `qparams` (e.g. `weights.mars_q_from_jax`). `impl` picks the
    convolutions' contraction (module docstring)."""
    from .encoders import EncoderSpec
    _resolve_impl(impl)
    dev = resolve_device(device)
    dtype = (compute_dtype if compute_dtype is not None
             else default_compute_dtype(dev))
    if qparams is None:
        if state_dict is None:
            net = MarsNet()
            flax_default_init_(net, generator if generator is not None
                               else torch.Generator().manual_seed(0))
            state_dict = net.state_dict()
        params = {k: v.detach().to(dev) for k, v in state_dict.items()}
        qparams = quantize_mars(params, calib_patches, dtype)
    qp = prepare_qparams(qparams, dev)

    @torch.inference_mode()
    def apply_fn(patches):
        return mars_int8_apply(qp, patches, dtype, impl)

    spec = EncoderSpec(INPUT_SHAPE, FEATURE_DIM, apply_fn, dev, dtype)
    spec.qparams = qp
    return spec
