"""Quantized-graph executor: run full-integer TFLite artifacts with TFLite's
own integer arithmetic, byte-exact, on a batch.

Port of deepdish_tpu/models/qgraph.py (`QGraphExecutor` :131,
`QuantizedSSDDetector` :444, `QuantizedYOLOv5Detector` :582,
`make_quantized_mars_encoder` :634). The reference's real detector and
encoder artifacts are full-integer quantized (uint8 input, int8
activations and weights, int32 biases: tools/ssd_mobilenet.py:100-103,
tools/yolov5.py:102-118, tools/generate_detections.py:151-177). This module
replays the flatbuffer's op stream with gemmlowp fixed-point requantization
(ops/intmath.py), so every intermediate tensor is bit-equal to the TFLite
reference kernels' and to the JAX executor's.

Both quantization schemes run: per-channel int8 exports and the legacy
per-tensor full-uint8 scheme (uint8 weights WITH zero points), normalized
into the int8 domain at load (a -128 shift, bijective in q - zp).

Differences from the JAX executor:
  * the flatbuffer is read with numpy (models/tflite_meta.py), options
    included; no tensorflow;
  * the executor takes a leading batch axis natively (the JAX one is
    written for batch 1 and vmapped by its callers): every op keeps axis 0
    as the batch, and an op that would mix frames (a RESHAPE, CONCAT,
    TILE, STRIDED_SLICE or PAD on axis 0) raises for a batch above 1;
  * the integer contractions (CONV_2D and FULLY_CONNECTED; the JAX
    package's int32 `dot_general` / `conv_general_dilated`) are library
    calls that are exact by construction, chosen once by device
    (`conv_impl`, the JAX names):
      - "portable": zero points subtracted, im2col by slicing, then one
        float64 matmul (torch's CUDA matmul takes no integer operands;
        every product and partial sum here is an integer below 2^53, so
        float64 is exact in any summation order; on the CPU it is also
        30x faster than an int64 matmul, which has no BLAS);
      - "mxu": int8 operands, im2col, `torch._int_mm` (cuBLASLt int8 x
        int8 -> int32) on the card, the float64 matmul on the CPU, plus
        the static zero-point offset map and, for legacy files, the
        weight zero point's row sums;
      - "xconv": the same decomposition as "mxu" through a direct float64
        convolution (exact for the same reason; cuDNN off, so no
        Winograd or FFT algorithm reorders it);
      - "auto": "mxu" on the card, "portable" on the CPU.
    float32 and bf16 are never used for an integer contraction: a 3x3 x
    1024-channel patch already passes float32's 24-bit mantissa;
  * DEPTHWISE_CONV_2D accumulates its taps in int32 elementwise products.

Supported ops: CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED, ADD, SUB, MUL,
QUANTIZE (from float or requantize), DEQUANTIZE, RESHAPE, CONCATENATION,
LOGISTIC (LUT), MAX_POOL_2D, AVERAGE_POOL_2D, PAD, TILE, STRIDED_SLICE
(stride 1), RESIZE_NEAREST_NEIGHBOR, SOFTMAX (float), ELU (float or int8
LUT), L2_NORMALIZATION (float or int8), and the TFLite_Detection_PostProcess
custom op as a STOP point (its inputs become the executor's outputs; the
decode and NMS of models/ssd_mobilenet.py consume them). Anything else
raises with the op name; 16x8-quantized files are refused at parse.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device, span
from ..ops import intmath
from ..utils import flops
from . import tflite_meta
from .convert import DETECTION_POSTPROCESS
from .preprocess import default_compute_dtype

# builtin opcodes (lite/schema/schema.fbs)
ADD, AVG_POOL, CONCAT, CONV, DW_CONV = 0, 1, 2, 3, 4
DEQUANTIZE, FC, LOGISTIC, MAX_POOL, MUL = 6, 9, 14, 17, 18
RESHAPE, SOFTMAX, CUSTOM, PAD_OP, SUB, QUANTIZE = 22, 25, 32, 34, 41, 114
STRIDED_SLICE, TILE, RESIZE_NN = 45, 69, 97
L2_NORM, ELU = 11, 111

_OP_NAMES = {0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION",
             3: "CONV_2D", 4: "DEPTHWISE_CONV_2D", 6: "DEQUANTIZE",
             9: "FULLY_CONNECTED", 11: "L2_NORMALIZATION", 14: "LOGISTIC",
             17: "MAX_POOL_2D",
             18: "MUL", 22: "RESHAPE", 25: "SOFTMAX", 34: "PAD",
             41: "SUB", 45: "STRIDED_SLICE", 69: "TILE",
             97: "RESIZE_NEAREST_NEIGHBOR", 111: "ELU", 114: "QUANTIZE"}

# builtin options union types the ops read (tflite_meta.OPTION_TABLES)
_OPTIONS = {CONV: 1, DW_CONV: 2, AVG_POOL: 5, MAX_POOL: 5, FC: 8,
            SOFTMAX: 9, CONCAT: 10, ADD: 11, MUL: 21, SUB: 28,
            STRIDED_SLICE: 32, RESIZE_NN: 74}

# tensor types with constant data the executor reads (no float16: a
# full-integer file has none, and the JAX executor skips it too)
_NP_DT = {0: np.float32, 2: np.int32, 3: np.uint8, 4: np.int64,
          7: np.int16, 9: np.int8}
_TORCH_DT = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8}


def _round_half_away(x):
    return np.floor(np.abs(x) + 0.5) * np.sign(x)


@dataclass
class _TMeta:
    name: str
    dtype: Any
    shape: Tuple[int, ...]
    scale: Optional[np.ndarray]     # per-tensor (1,) or per-channel (C,)
    zp: Optional[np.ndarray]
    qdim: int


@dataclass
class _QOp:
    code: int
    name: str                       # output tensor name (diagnostics)
    inputs: List[int]
    outputs: List[int]
    attrs: Dict[str, Any] = field(default_factory=dict)


def _act_range(fused: int, scale: float, zp: int, dtype) -> Tuple[int, int]:
    """CalculateActivationRangeQuantized: clamp bounds in the quantized
    domain for the fused activation (kernel_util.cc)."""
    qmin = int(np.iinfo(dtype).min)
    qmax = int(np.iinfo(dtype).max)

    def q(f):
        return int(zp + _round_half_away(np.float64(f) / scale))

    if fused == 1:                                     # RELU
        return max(qmin, q(0.0)), qmax
    if fused == 2:                                     # RELU_N1_TO_1
        return max(qmin, q(-1.0)), min(qmax, q(1.0))
    if fused == 3:                                     # RELU6
        return max(qmin, q(0.0)), min(qmax, q(6.0))
    if fused == 0:
        return qmin, qmax
    raise NotImplementedError(f"fused activation {fused}")


def _padding_amounts(in_size, k_eff, stride, padding):
    """TFLite ComputePaddingWithOffset: SAME puts the extra pixel after."""
    if padding == 1:                                   # VALID
        out = (in_size - k_eff) // stride + 1
        return out, 0, 0
    out = -(-in_size // stride)                        # SAME: ceil
    total = max(0, (out - 1) * stride + k_eff - in_size)
    before = total // 2
    return out, before, total - before


def _per_channel_requant(in_scale: float, w_scales: np.ndarray,
                         out_scale: float):
    m0, sh = [], []
    for ws in np.atleast_1d(w_scales).astype(np.float64):
        a, b = intmath.quantize_multiplier(float(in_scale) * float(ws)
                                           / float(out_scale))
        m0.append(a)
        sh.append(b)
    return np.asarray(m0, np.int32), np.asarray(sh, np.int32)


def _f32(v: float) -> float:
    """A scale as the float32 value the reference kernels multiply by."""
    return float(np.float32(v))


# ------------------------------------------------ exact integer contractions

def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def wide_weight(w: np.ndarray, device: torch.device) -> torch.Tensor:
    """An integer (K, N) matrix for `wide_matmul`, as float64."""
    return torch.from_numpy(np.asarray(w, np.float64)).to(device)


def wide_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer (M, K) @ (K, N) -> int64 through one float64 matmul
    (cuBLAS / the CPU's BLAS): every product and partial sum is an integer
    below 2^53 (|a|, |w| <= 255, K < 2^36), so any summation order gives
    the exact sum."""
    return (a.double() @ w).long()


def int8_weight(w: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int8 (K, N) right-hand matrix for `int8_matmul` on `device`: on
    the card int8, zero-padded to K and N multiples of 8 (torch._int_mm's
    cuBLASLt rule; zero rows and columns change no sum) and column-major
    (cuBLASLt's int8 GEMM takes only the transposed-A layout, which a
    row-major right-hand matrix does not give); on the CPU the
    `wide_weight`."""
    if device.type != "cuda":
        return wide_weight(w, device)
    w = np.ascontiguousarray(w, np.int8)
    k, n = w.shape
    out = np.zeros((_pad_to(n, 8), _pad_to(k, 8)), np.int8)
    out[:n, :k] = w.T
    return torch.from_numpy(out).to(device).t()


def int8_matmul(a8: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """Exact (M, K) int8 @ (K, n) int8 -> int64 (M, n), `w` from
    `int8_weight`: on the card one torch._int_mm (cuBLASLt, int32
    accumulators) with the rows padded past 16 and K padded to w's rows,
    which reports its unpadded M x K x n product to `utils.flops` (the
    CPU's matmul is counted as it runs); on the CPU `wide_matmul`."""
    if not a8.is_cuda:
        return wide_matmul(a8, w)
    m, k = a8.shape
    flops.report(2 * m * k * n)
    kp = w.shape[0]
    mp = max(m, 17)
    if mp != m or kp != k:
        a8 = F.pad(a8, (0, kp - k, 0, mp - m))
    return torch._int_mm(a8.contiguous(), w)[:m, :n].long()


class QGraphExecutor:
    """Parse a full-integer .tflite and execute it exactly on `device`
    (default CUDA).

    apply(x) -> list of output tensors (graph output order, or the custom
    postprocess op's inputs when the graph ends in one); x is (N, ...) in
    the input tensor's dtype, N any batch. `run_op(qop, get)` runs one
    parsed op on a resolver of its input tensors (the seam the per-op
    tests drive)."""

    def __init__(self, model_path: str, conv_impl: str = "auto",
                 stop_at_custom: bool = True, device=None):
        self.device = resolve_device(device)
        if conv_impl not in ("auto", "portable", "mxu", "xconv"):
            raise ValueError(f"conv_impl {conv_impl!r}")
        self.conv_impl = conv_impl
        self.impl = (("mxu" if self.device.type == "cuda" else "portable")
                     if conv_impl == "auto" else conv_impl)
        model = tflite_meta.read_model(model_path)
        self.consts: Dict[str, torch.Tensor] = {}
        self.meta: List[_TMeta] = []
        self._const_idx: Dict[int, np.ndarray] = {}
        self._const_t: Dict[int, torch.Tensor] = {}

        for ti, t in enumerate(model.tensors):
            q = t.quantization
            scale = zp = None
            qdim = 0
            if q is not None and q.scale is not None and q.scale.size:
                scale = q.scale.astype(np.float64)
                zp = (q.zero_point.astype(np.int64)
                      if q.zero_point is not None and q.zero_point.size
                      else np.zeros(scale.shape, np.int64))
                qdim = q.quantized_dimension
            shape = tuple(int(s) for s in (t.shape if t.shape is not None
                                           else ()))
            self.meta.append(_TMeta(t.name, _NP_DT.get(t.type), shape,
                                    scale, zp, qdim))
            data = model.data(ti)
            dt = _NP_DT.get(t.type)
            if data is not None and dt is not None:
                arr = np.frombuffer(data, np.dtype(dt).newbyteorder("<"))
                arr = arr.astype(dt)
                if shape:
                    arr = arr.reshape(shape)
                self._const_idx[ti] = arr

        self.input_idx = int(model.inputs[0])
        self.output_idxs = [int(t) for t in model.outputs]
        self.ops: List[_QOp] = []
        self.stopped_at_custom = False
        for op in model.operators:
            oc = model.opcodes[op.opcode_index]
            code = oc.code
            ins, outs = list(op.inputs), list(op.outputs)
            if code == CUSTOM:
                cname = oc.custom_code.decode() if oc.custom_code else "?"
                if stop_at_custom and cname == DETECTION_POSTPROCESS:
                    # detections come from the decode on the op's inputs,
                    # which it declares in a fixed order: box encodings,
                    # class predictions, anchors (const)
                    self.output_idxs = [t for t in ins
                                        if t not in self._const_idx]
                    self.stopped_at_custom = True
                    break
                raise NotImplementedError(
                    f"custom op {cname!r}"
                    + (" - an edgetpu-compiled artifact wraps the whole "
                       "network in one opaque op; use the uncompiled "
                       "CPU .tflite export of the same model"
                       if "edgetpu" in cname.lower() else ""))
            qop = _QOp(code, self.meta[outs[0]].name, ins, outs)
            self._prepare(qop, op)
            self.ops.append(qop)
        self._batch: Optional[int] = None     # apply's batch while it runs

    # ---- per-op host-side preparation (requant tables, layouts) ----

    def _q(self, ti):
        m = self.meta[ti]
        if m.scale is None:
            raise ValueError(f"tensor {m.name} has no quantization")
        return float(m.scale[0]), int(m.zp[0])

    def _const(self, name: str, arr, dtype=torch.int64) -> None:
        self.consts[name] = torch.as_tensor(np.asarray(arr)).to(
            self.device, dtype)

    @staticmethod
    def _options(qop: _QOp, op) -> Dict[str, Any]:
        """The op's builtin options; the schema's defaults when the file
        carries no options table of the expected type."""
        kind = _OPTIONS[qop.code]
        if op.builtin_options_type == kind:
            return op.builtin_options
        return tflite_meta.read_options(kind, None)

    def _prepare(self, qop: _QOp, op):
        code = qop.code
        key = f"op{len(self.ops)}"
        meta_out = self.meta[qop.outputs[0]]
        if meta_out.dtype in (np.int8, np.uint8):
            qop.attrs["out_dtype"] = _TORCH_DT[np.dtype(meta_out.dtype)]
        elif meta_out.dtype == np.int16:
            raise NotImplementedError(
                f"16x8 quantization (int16 activations) in op "
                f"{_OP_NAMES.get(code, code)} ({meta_out.name})")

        if code in (CONV, DW_CONV, FC):
            kt = qop.inputs[1]
            kern = self._const_idx[kt]
            km = self.meta[kt]
            if kern.dtype not in (np.int8, np.uint8):
                raise NotImplementedError(
                    f"{_OP_NAMES[code]} with {kern.dtype} weights (only "
                    "int8/uint8 full-integer graphs are supported)")
            # legacy full-uint8 files carry per-TENSOR uint8 weights with a
            # weight zero point; both schemes are normalized into the int8
            # domain (uint8 codes and their zero points minus 128)
            w_zp = int(km.zp[0]) if km.zp is not None else 0
            if kern.dtype == np.uint8:
                kern = (kern.astype(np.int16) - 128).astype(np.int8)
                w_zp -= 128
            in_u8 = self.meta[qop.inputs[0]].dtype == np.uint8
            in_scale, in_zp = self._q(qop.inputs[0])
            if in_u8:
                in_zp -= 128
            out_scale, out_zp = self._q(qop.outputs[0])
            bias = None
            if len(qop.inputs) >= 3 and qop.inputs[2] >= 0:
                bias = self._const_idx[qop.inputs[2]].astype(np.int64)
            o = self._options(qop, op)
            if code == CONV:
                stride = (o["stride_h"], o["stride_w"])
                dil = (o["dilation_h_factor"], o["dilation_w_factor"])
                fused, padding = o["fused_activation_function"], o["padding"]
                k = np.transpose(kern, (1, 2, 3, 0))    # OHWI -> HWIO
            elif code == DW_CONV:
                if o["depth_multiplier"] != 1:
                    raise NotImplementedError("depth_multiplier != 1")
                stride = (o["stride_h"], o["stride_w"])
                dil = (o["dilation_h_factor"], o["dilation_w_factor"])
                fused, padding = o["fused_activation_function"], o["padding"]
                k = np.transpose(kern, (1, 2, 0, 3))    # 1HWC -> HW1C
            else:
                stride = dil = (1, 1)
                fused, padding = o["fused_activation_function"], 1
                k = np.transpose(kern, (1, 0))          # OI -> IO
            if min(stride) < 1 or min(dil) < 1:
                raise ValueError(f"{_OP_NAMES[code]} {qop.name} with stride "
                                 f"{stride} and dilation {dil}")
            w_scales = np.asarray(km.scale, np.float64)
            m0, sh = _per_channel_requant(in_scale, w_scales, out_scale)
            act_min, act_max = _act_range(fused, out_scale, out_zp,
                                          meta_out.dtype)
            qop.attrs.update(stride=stride, dilation=dil, padding=padding,
                             in_zp=in_zp, out_zp=out_zp, w_zp=w_zp,
                             in_u8=in_u8, act=(act_min, act_max), kkey=key,
                             kshape=k.shape)
            self._const(f"{key}/m0", m0)
            self._const(f"{key}/shift", sh)
            if bias is not None:
                self._const(f"{key}/bias", bias)
            if code == DW_CONV:
                kh, kw, _, c = k.shape
                self._const(f"{key}/kernel",
                            k.reshape(kh * kw, c).astype(np.int32) - w_zp,
                            torch.int32)
                return
            mat = k.reshape(-1, k.shape[-1])                # (K, Cout)
            if self.impl == "portable":
                self.consts[f"{key}/kernel"] = wide_weight(
                    mat.astype(np.int64) - w_zp, self.device)
            elif self.impl == "mxu" or code == FC:
                self.consts[f"{key}/kernel"] = int8_weight(mat, self.device)
            else:                                           # xconv: OIHW
                self._const(f"{key}/kernel", np.transpose(k, (3, 2, 0, 1)),
                            torch.float64)
            self._prep_offset_map(qop, k)

        elif code in (ADD, SUB):
            s1, z1 = self._q(qop.inputs[0])
            s2, z2 = self._q(qop.inputs[1])
            so, zo = self._q(qop.outputs[0])
            fused = self._options(qop, op)["fused_activation_function"]
            left_shift = 20
            twice_max = 2.0 * max(s1, s2)
            m1 = intmath.quantize_multiplier(s1 / twice_max)
            m2 = intmath.quantize_multiplier(s2 / twice_max)
            mo = intmath.quantize_multiplier(
                twice_max / ((1 << left_shift) * so))
            qop.attrs.update(z1=z1, z2=z2, zo=zo, m1=m1, m2=m2, mo=mo,
                             left_shift=left_shift,
                             act=_act_range(fused, so, zo, meta_out.dtype))

        elif code == MUL:
            s1, z1 = self._q(qop.inputs[0])
            s2, z2 = self._q(qop.inputs[1])
            so, zo = self._q(qop.outputs[0])
            fused = self._options(qop, op)["fused_activation_function"]
            qop.attrs.update(z1=z1, z2=z2, zo=zo,
                             mo=intmath.quantize_multiplier(s1 * s2 / so),
                             act=_act_range(fused, so, zo, meta_out.dtype))

        elif code == QUANTIZE:
            si, zi = self._q(qop.inputs[0]) \
                if self.meta[qop.inputs[0]].scale is not None else (None, 0)
            so, zo = self._q(qop.outputs[0])
            qop.attrs.update(zo=zo,
                             qmin=int(np.iinfo(meta_out.dtype).min),
                             qmax=int(np.iinfo(meta_out.dtype).max))
            if si is None:
                # float -> int: AffineQuantize, TfLiteRound(v / scale) + zp,
                # clamped (the converter emits it around float islands)
                qop.attrs.update(from_float=True, scale=so)
            else:
                qop.attrs.update(from_float=False, zi=zi,
                                 mo=intmath.quantize_multiplier(si / so))

        elif code == DEQUANTIZE:
            si, zi = self._q(qop.inputs[0])
            qop.attrs.update(scale=si, zp=zi)

        elif code == LOGISTIC:
            si, zi = self._q(qop.inputs[0])
            so, zo = self._q(qop.outputs[0])
            dt = self.meta[qop.inputs[0]].dtype
            if dt not in (np.int8, np.uint8):
                raise NotImplementedError(f"LOGISTIC on {dt}")
            # LUTPopulate: sigmoid sampled at each of the 256 input codes,
            # rounded half-away, clamped (the JAX package's table)
            qmin = int(np.iinfo(dt).min)
            q = np.arange(qmin, qmin + 256, dtype=np.float64)
            x = np.clip(si * (q - zi), -500.0, 500.0)
            y = 1.0 / (1.0 + np.exp(-x))
            omin = int(np.iinfo(self.meta[qop.outputs[0]].dtype).min)
            lut = np.clip(_round_half_away(y / so) + zo, omin, omin + 255)
            self._const(f"{key}/lut", lut, qop.attrs["out_dtype"])
            qop.attrs.update(kkey=key, in_min=qmin)

        elif code in (MAX_POOL, AVG_POOL):
            o = self._options(qop, op)
            so, zo = self._q(qop.outputs[0])
            if min(o["stride_h"], o["stride_w"], o["filter_height"],
                   o["filter_width"]) < 1:
                raise ValueError(f"{_OP_NAMES[code]} {qop.name} with "
                                 f"options {o}")
            qop.attrs.update(stride=(o["stride_h"], o["stride_w"]),
                             ksize=(o["filter_height"], o["filter_width"]),
                             padding=o["padding"],
                             act=_act_range(o["fused_activation_function"],
                                            so, zo, meta_out.dtype))

        elif code == CONCAT:
            so, zo = self._q(qop.outputs[0])
            for ti in qop.inputs:
                si, zi = self._q(ti)
                if abs(si - so) > 1e-12 * so or zi != zo:
                    raise NotImplementedError(
                        "CONCATENATION with per-input requantization "
                        f"(input {self.meta[ti].name} scale {si} vs output "
                        f"{so}) - the int8 converter unifies these")
            axis = self._options(qop, op)["axis"]
            qop.attrs.update(axis=axis % len(meta_out.shape))

        elif code == RESHAPE:
            qop.attrs.update(shape=meta_out.shape)

        elif code == TILE:
            # pure data movement: quant params pass through unchanged
            qop.attrs.update(
                multiples=tuple(int(v) for v in
                                self._const_idx[qop.inputs[1]].ravel()))

        elif code == STRIDED_SLICE:
            o = self._options(qop, op)
            if o["ellipsis_mask"] or o["new_axis_mask"] or \
                    o["shrink_axis_mask"]:
                raise NotImplementedError(
                    "STRIDED_SLICE with ellipsis/new-axis/shrink masks")
            begin = self._const_idx[qop.inputs[1]].astype(int).ravel()
            end = self._const_idx[qop.inputs[2]].astype(int).ravel()
            strides = self._const_idx[qop.inputs[3]].astype(int).ravel()
            if not np.all(strides == 1):
                raise NotImplementedError("STRIDED_SLICE with stride != 1")
            in_shape = self.meta[qop.inputs[0]].shape
            slices = []
            for d in range(len(begin)):
                b = 0 if (o["begin_mask"] >> d) & 1 else int(begin[d])
                e = in_shape[d] if (o["end_mask"] >> d) & 1 else int(end[d])
                if b < 0:
                    b += in_shape[d]
                if e < 0:
                    e += in_shape[d]
                slices.append(slice(b, e))
            qop.attrs.update(slices=tuple(slices))

        elif code == RESIZE_NN:
            o = self._options(qop, op)
            size = self._const_idx[qop.inputs[1]].astype(int).ravel()
            in_shape = self.meta[qop.inputs[0]].shape

            # TFLite reference nearest-neighbor index math
            # (reference_ops::ResizeNearestNeighbor)
            def idx(n_in, n_out):
                i = np.arange(n_out, dtype=np.float64)
                if o["half_pixel_centers"]:
                    src = (i + 0.5) * (n_in / n_out)
                    return np.clip(np.floor(src).astype(int), 0, n_in - 1)
                if o["align_corners"] and n_out > 1:
                    src = np.round(i * (n_in - 1) / (n_out - 1))
                    return np.clip(src.astype(int), 0, n_in - 1)
                src = np.floor(i * (n_in / n_out))
                return np.clip(src.astype(int), 0, n_in - 1)
            self._const(f"{key}/rows", idx(in_shape[1], int(size[0])))
            self._const(f"{key}/cols", idx(in_shape[2], int(size[1])))
            qop.attrs.update(kkey=key)

        elif code == PAD_OP:
            pads = self._const_idx[qop.inputs[1]].astype(int)
            _, zi = self._q(qop.inputs[0])
            qop.attrs.update(pads=pads, value=zi)

        elif code == SOFTMAX:
            if self.meta[qop.inputs[0]].dtype != np.float32:
                raise NotImplementedError("quantized SOFTMAX")

        elif code == ELU:
            dt = self.meta[qop.inputs[0]].dtype
            if dt == np.float32:
                # the int8 converter keeps ELU in float behind a
                # DEQUANTIZE/QUANTIZE pair (elu.cc: x < 0 ? expm1(x) : x)
                qop.attrs.update(is_float=True)
            elif dt == np.int8:
                # LUT path (elu.cc int8: LUTPopulate over the 256 codes)
                si, zi = self._q(qop.inputs[0])
                so, zo = self._q(qop.outputs[0])
                q = np.arange(-128, 128, dtype=np.float64)
                v = si * (q - zi)
                y = np.where(v < 0.0, np.expm1(np.clip(v, -500.0, 0.0)), v)
                lut = np.clip(_round_half_away(y / so) + zo, -128, 127)
                self._const(f"{key}/lut", lut, torch.int8)
                qop.attrs.update(is_float=False, kkey=key, in_min=-128)
            else:
                raise NotImplementedError(f"ELU on {dt}")

        elif code == L2_NORM:
            dt = self.meta[qop.inputs[0]].dtype
            if dt == np.float32:
                qop.attrs.update(is_float=True)
            elif dt == np.int8:
                # reference_integer_ops::L2Normalization: int32 sum of
                # squared zp-less codes per row, GetInvSqrtQuantized-
                # MultiplierExp, MBQM with kOutputScale=7; the output is the
                # fixed 1/128 scale, zp 0
                _, zi = self._q(qop.inputs[0])
                qop.attrs.update(is_float=False, zi=zi)
            else:
                raise NotImplementedError(f"L2_NORMALIZATION on {dt}")

        else:
            raise NotImplementedError(
                f"TFLite op {code} ({_OP_NAMES.get(code, '?')}) in an "
                "integer graph")

    def _prep_offset_map(self, qop: _QOp, k_hwio: np.ndarray):
        """The "mxu"/"xconv" static correction. With activations and
        weights normalized to the int8 domain and patches zero-padded, the
        exact accumulator decomposes as

            acc = dot(x', w') - w_zp * rowsum(x')
                  - [ in_zp * W_inb - in_zp * w_zp * CNT ]

        where W_inb[y, x, co] sums the kernel taps whose input sample is
        in-bounds and CNT[y, x] counts those taps (times C_in), both
        constant because padding geometry is static. The bracket is
        precomputed here; the rowsum is needed only for legacy files
        (w_zp != 0)."""
        in_zp = qop.attrs["in_zp"]
        w_zp = qop.attrs["w_zp"]
        qop.attrs["offkey"] = None
        if in_zp == 0 or self.impl == "portable":
            return
        key = qop.attrs["kkey"]
        in_shape = self.meta[qop.inputs[0]].shape
        if len(k_hwio.shape) == 2:                     # FC: no padding
            wsum = k_hwio.sum(axis=0, dtype=np.int64)
            cnt = k_hwio.shape[0]
            self._const(f"{key}/off", in_zp * wsum - in_zp * w_zp * cnt)
            qop.attrs["offkey"] = key
            return
        kh, kw, ci, co = k_hwio.shape
        sh, sw = qop.attrs["stride"]
        dh, dw = qop.attrs["dilation"]
        h, w = in_shape[1], in_shape[2]
        ho, pt, pb = _padding_amounts(h, (kh - 1) * dh + 1, sh,
                                      qop.attrs["padding"])
        wo, pl, pr = _padding_amounts(w, (kw - 1) * dw + 1, sw,
                                      qop.attrs["padding"])
        mask = np.zeros((h + pt + pb, w + pl + pr), np.int64)
        mask[pt:pt + h, pl:pl + w] = 1
        ksum = k_hwio.sum(axis=2, dtype=np.int64)      # (kh, kw, co)
        w_inb = np.zeros((ho, wo, co), np.int64)
        cnt = np.zeros((ho, wo, 1), np.int64)
        for dy in range(kh):
            for dx in range(kw):
                sub = mask[dy * dh: dy * dh + (ho - 1) * sh + 1: sh,
                           dx * dw: dx * dw + (wo - 1) * sw + 1: sw]
                w_inb += sub[:, :, None] * ksum[dy, dx][None, None, :]
                cnt += sub[:, :, None] * ci
        self._const(f"{key}/off", in_zp * w_inb - in_zp * w_zp * cnt)
        qop.attrs["offkey"] = key

    # ---- execution ----

    def _xs(self, qop, x):
        """Activation codes in the int8 domain as int32 (uint8 tensors are
        shifted by -128, matching the prepare-time zp/kernel shift)."""
        v = x.to(torch.int32)
        return v - 128 if qop.attrs["in_u8"] else v

    def _geometry(self, qop, x):
        kh, kw = qop.attrs["kshape"][:2]
        sh, sw = qop.attrs["stride"]
        dh, dw = qop.attrs["dilation"]
        ho, pt, pb = _padding_amounts(x.shape[1], (kh - 1) * dh + 1, sh,
                                      qop.attrs["padding"])
        wo, pl, pr = _padding_amounts(x.shape[2], (kw - 1) * dw + 1, sw,
                                      qop.attrs["padding"])
        return kh, kw, sh, sw, dh, dw, ho, wo, (pl, pr, pt, pb)

    def _taps(self, qop, x, pad_value=0):
        """The kh*kw shifted (N, Ho, Wo, C) views of x, zero-padded."""
        kh, kw, sh, sw, dh, dw, ho, wo, pads = self._geometry(qop, x)
        xp = F.pad(x, (0, 0) + pads, value=pad_value)
        return [xp[:, dy * dh: dy * dh + (ho - 1) * sh + 1: sh,
                   dx * dw: dx * dw + (wo - 1) * sw + 1: sw, :]
                for dy in range(kh) for dx in range(kw)], ho, wo

    def _patches(self, qop, x):
        """im2col: x (N, H, W, C) -> (N * Ho * Wo, kh * kw * C)."""
        taps, ho, wo = self._taps(qop, x)
        p = taps[0] if len(taps) == 1 else torch.stack(taps, dim=3)
        return p.reshape(x.shape[0] * ho * wo, -1), ho, wo

    def _conv(self, qop, x):
        key = qop.attrs["kkey"]
        k = self.consts[f"{key}/kernel"]
        co = qop.attrs["kshape"][3]
        n = x.shape[0]
        if self.impl == "xconv":
            kh, kw, sh, sw, dh, dw, ho, wo, pads = self._geometry(qop, x)
            x8 = self._xs(qop, x).double().permute(0, 3, 1, 2)
            x8 = F.pad(x8, pads)
            with torch.backends.cudnn.flags(enabled=False):
                acc = F.conv2d(x8, k, stride=(sh, sw), dilation=(dh, dw))
                if qop.attrs["w_zp"]:
                    ones = torch.ones((1,) + tuple(k.shape[1:]),
                                      dtype=torch.float64, device=x.device)
                    acc = acc - qop.attrs["w_zp"] * F.conv2d(
                        x8, ones, stride=(sh, sw), dilation=(dh, dw))
            acc = acc.permute(0, 2, 3, 1).long()
        elif self.impl == "mxu":
            x8 = self._xs(qop, x).to(torch.int8)
            p, ho, wo = self._patches(qop, x8)
            acc = int8_matmul(p, k, co)
            if qop.attrs["w_zp"]:
                acc = acc - qop.attrs["w_zp"] * p.long().sum(1, keepdim=True)
            acc = acc.reshape(n, ho, wo, co)
        else:
            xs = self._xs(qop, x) - qop.attrs["in_zp"]
            p, ho, wo = self._patches(qop, xs)
            acc = wide_matmul(p, k).reshape(n, ho, wo, co)
        if qop.attrs["offkey"] is not None:
            acc = acc - self.consts[f"{key}/off"]
        return self._epilogue(qop, acc)

    def _dw_conv(self, qop, x):
        key = qop.attrs["kkey"]
        ks = self.consts[f"{key}/kernel"]                # (kh*kw, C) int32
        xs = self._xs(qop, x) - qop.attrs["in_zp"]
        with span("qgraph.depthwise"):
            taps, _, _ = self._taps(qop, xs)
            flops.report(flops.conv(taps[0].numel(), len(taps), 1))
            acc = taps[0] * ks[0]
            for t, kt in zip(taps[1:], ks[1:]):
                acc = acc + t * kt
        return self._epilogue(qop, acc)

    def _fc(self, qop, x):
        key = qop.attrs["kkey"]
        k = self.consts[f"{key}/kernel"]
        ci, co = qop.attrs["kshape"]
        x2 = x.reshape(-1, ci)
        if self.impl in ("mxu", "xconv"):
            x8 = self._xs(qop, x2).to(torch.int8)
            acc = int8_matmul(x8, k, co)
            if qop.attrs["w_zp"]:
                acc = acc - qop.attrs["w_zp"] * x8.long().sum(1,
                                                             keepdim=True)
            if qop.attrs["offkey"] is not None:
                acc = acc - self.consts[f"{key}/off"]
        else:
            acc = wide_matmul(self._xs(qop, x2) - qop.attrs["in_zp"], k)
        return self._epilogue(qop, acc)

    def _epilogue(self, qop, acc):
        key = qop.attrs["kkey"]
        bias = self.consts.get(f"{key}/bias")
        if bias is not None:
            acc = acc + bias
        out = intmath.multiply_by_quantized_multiplier(
            acc, self.consts[f"{key}/m0"], self.consts[f"{key}/shift"])
        lo, hi = qop.attrs["act"]
        return torch.clamp(out + qop.attrs["out_zp"], lo, hi).to(
            qop.attrs["out_dtype"])

    def _add_sub(self, qop, a, b):
        at = qop.attrs
        sh = at["left_shift"]
        v1 = (a.long() - at["z1"]) << sh
        v2 = (b.long() - at["z2"]) << sh
        s1 = intmath.multiply_by_quantized_multiplier(v1, *at["m1"])
        s2 = intmath.multiply_by_quantized_multiplier(v2, *at["m2"])
        raw = s1 + s2 if qop.code == ADD else s1 - s2
        out = intmath.multiply_by_quantized_multiplier(raw, *at["mo"]) \
            + at["zo"]
        lo, hi = at["act"]
        return torch.clamp(out, lo, hi).to(at["out_dtype"])

    def _get_const(self, ti: int) -> torch.Tensor:
        t = self._const_t.get(ti)
        if t is None:
            t = torch.from_numpy(np.array(self._const_idx[ti])).to(
                self.device)
            self._const_t[ti] = t
        return t

    @torch.inference_mode()
    def apply(self, x: torch.Tensor, return_env: bool = False):
        env: Dict[int, torch.Tensor] = {self.input_idx: x}

        def get(ti):
            if ti in env:
                return env[ti]
            return self._get_const(ti)

        self._batch = x.shape[0]
        try:
            for qop in self.ops:
                env[qop.outputs[0]] = self.run_op(qop, get)
        finally:
            self._batch = None
        if return_env:
            return env
        return [env[t] for t in self.output_idxs]

    def _batch_free(self, qop, x, what: str, ok: bool):
        # the batch is apply's input's axis 0, not x's: a tensor reshaped
        # to (-1, 4) at batch 1 may concatenate along axis 0
        n = self._batch if self._batch is not None else x.shape[0]
        if n != 1 and not ok:
            raise NotImplementedError(
                f"{_OP_NAMES[qop.code]} {qop.name} {what} the batch axis; "
                "this graph runs one frame at a time")

    def run_op(self, qop, get):
        """Execute one parsed op given a resolver for its input tensors
        (also the seam the per-op exactness tests drive)."""
        i = qop.inputs
        at = qop.attrs
        if qop.code == CONV:
            return self._conv(qop, get(i[0]))
        if qop.code == DW_CONV:
            return self._dw_conv(qop, get(i[0]))
        if qop.code == FC:
            return self._fc(qop, get(i[0]))
        if qop.code in (ADD, SUB):
            return self._add_sub(qop, get(i[0]), get(i[1]))
        if qop.code == MUL:
            prod = (get(i[0]).long() - at["z1"]) * (get(i[1]).long()
                                                    - at["z2"])
            out = intmath.multiply_by_quantized_multiplier(
                prod, *at["mo"]) + at["zo"]
            lo, hi = at["act"]
            return torch.clamp(out, lo, hi).to(at["out_dtype"])
        if qop.code == QUANTIZE:
            if at["from_float"]:
                v = get(i[0]).float() / _f32(at["scale"])
                out = torch.sign(v) * torch.floor(torch.abs(v) + 0.5) \
                    + at["zo"]
            else:
                v = get(i[0]).long() - at["zi"]
                out = intmath.multiply_by_quantized_multiplier(
                    v, *at["mo"]) + at["zo"]
            return torch.clamp(out, at["qmin"], at["qmax"]).to(
                at["out_dtype"])
        if qop.code == DEQUANTIZE:
            return (get(i[0]).float() - at["zp"]) * _f32(at["scale"])
        if qop.code in (LOGISTIC, ELU) and not at.get("is_float"):
            lut = self.consts[f"{at['kkey']}/lut"]
            return lut[get(i[0]).long() - at["in_min"]]
        if qop.code == MAX_POOL:
            return self._pool(qop, get(i[0]), reduce_max=True)
        if qop.code == AVG_POOL:
            return self._pool(qop, get(i[0]), reduce_max=False)
        if qop.code == CONCAT:
            xs = [get(t) for t in i]
            self._batch_free(qop, xs[0], "concatenates along",
                             at["axis"] != 0)
            return torch.cat(xs, dim=at["axis"])
        if qop.code == RESHAPE:
            x = get(i[0])
            shape = at["shape"]
            self._batch_free(qop, x, "reshapes",
                             len(shape) > 0 and shape[0] == 1)
            return x.reshape((x.shape[0],) + tuple(shape[1:])
                             if shape and shape[0] == 1 else shape)
        if qop.code == TILE:
            x = get(i[0])
            self._batch_free(qop, x, "tiles", at["multiples"][0] == 1)
            return x.repeat(*at["multiples"])
        if qop.code == STRIDED_SLICE:
            x = get(i[0])
            s0 = at["slices"][0]
            whole = s0.start == 0 and s0.stop == self.meta[i[0]].shape[0]
            self._batch_free(qop, x, "slices", whole)
            return x[(slice(None),) + at["slices"][1:] if whole
                     else at["slices"]]
        if qop.code == RESIZE_NN:
            x = get(i[0])
            rows = self.consts[f"{at['kkey']}/rows"]
            cols = self.consts[f"{at['kkey']}/cols"]
            return x[:, rows][:, :, cols]
        if qop.code == PAD_OP:
            x = get(i[0])
            pads = at["pads"]
            self._batch_free(qop, x, "pads", not pads[0].any())
            flat = [int(v) for pair in pads[::-1] for v in pair]
            return F.pad(x, flat, value=at["value"])
        if qop.code == SOFTMAX:
            v = get(i[0])
            e = torch.exp(v - v.amax(-1, keepdim=True))
            return e / e.sum(-1, keepdim=True)
        if qop.code == ELU:
            v = get(i[0])
            return torch.where(v < 0.0, torch.expm1(v), v)
        if qop.code == L2_NORM:
            v = get(i[0])
            if at["is_float"]:
                return v / torch.sqrt(torch.sum(v * v, -1, keepdim=True))
            diff = v.long() - at["zi"]
            acc = torch.sum(diff * diff, -1, keepdim=True)
            mult, shift = intmath.get_inv_sqrt_quantized_multiplier_exp(acc)
            out24 = intmath.multiply_by_quantized_multiplier(
                diff, mult, shift + 7)             # kOutputScale = 7
            return torch.clamp(out24, -128, 127).to(torch.int8)
        raise NotImplementedError(qop.code)        # pragma: no cover

    def _pool(self, qop, x, reduce_max: bool):
        kh, kw = qop.attrs["ksize"]
        sh, sw = qop.attrs["stride"]
        h, w = x.shape[1], x.shape[2]
        ho, pt, pb = _padding_amounts(h, kh, sh, qop.attrs["padding"])
        wo, pl, pr = _padding_amounts(w, kw, sw, qop.attrs["padding"])
        lo, hi = qop.attrs["act"]

        def taps(t):
            return [t[:, dy: dy + (ho - 1) * sh + 1: sh,
                      dx: dx + (wo - 1) * sw + 1: sw, :]
                    for dy in range(kh) for dx in range(kw)]
        if reduce_max:
            qmin = int(torch.iinfo(x.dtype).min)
            xp = F.pad(x.to(torch.int32), (0, 0, pl, pr, pt, pb), value=qmin)
            acc = None
            for tap in taps(xp):
                acc = tap if acc is None else torch.maximum(acc, tap)
            return torch.clamp(acc, lo, hi).to(qop.attrs["out_dtype"])
        # AVERAGE_POOL int8: sum over the IN-BOUNDS window, rounded divide
        # by the in-bounds count (reference pooling.h)
        xp = F.pad(x.to(torch.int32), (0, 0, pl, pr, pt, pb))
        mask = F.pad(torch.ones((1, h, w, 1), dtype=torch.int32,
                                device=x.device), (0, 0, pl, pr, pt, pb))
        acc = sum(taps(xp))
        cnt = sum(taps(mask))
        half = torch.div(cnt, 2, rounding_mode="floor")
        out = torch.where(
            acc >= 0, torch.div(acc + half, cnt, rounding_mode="floor"),
            -torch.div(-acc + half, cnt, rounding_mode="floor"))
        return torch.clamp(out, lo, hi).to(qop.attrs["out_dtype"])

    # ---- convenience ----

    def output_meta(self):
        return [self.meta[t] for t in self.output_idxs]

    def dequantize_outputs(self, outs):
        """Exact dequantization of integer outputs (float outputs pass
        through): what the interpreter's output_details scale/zp do."""
        res = []
        for arr, m in zip(outs, self.output_meta()):
            if m.scale is not None and arr.dtype != torch.float32:
                res.append((arr.float() - float(m.zp[0]))
                           * _f32(m.scale[0]))
            else:
                res.append(arr)
        return res


def _full_integer_input(model_path: str, what: str):
    """The input dtype of a full-integer file; ValueError otherwise."""
    from .convert import read_tflite_io_quant
    io = read_tflite_io_quant(model_path)
    in_dt = next(iter(io.values()))[0] if io else None
    if in_dt not in (np.uint8, np.int8):
        raise ValueError(
            f"{model_path} is not a full-integer artifact (input tensor "
            f"is {in_dt}); the quantized path needs a full-integer "
            f"export - use the float converter for {what}")
    return in_dt


def _affine_quantize(x: torch.Tensor, scale: float, zp: int, dtype):
    """AffineQuantize of raw values (TfLiteRound half away from zero of
    value / scale FIRST, zero point added AFTER: the order flips tie
    directions), clamped to `dtype`."""
    xf = x.float() / _f32(scale)
    q = torch.sign(xf) * torch.floor(torch.abs(xf) + 0.5) + zp
    info = torch.iinfo(dtype)
    return torch.clamp(q, info.min, info.max).to(dtype)


class QuantizedSSDDetector:
    """SSD (and EfficientDet-Lite) detector on the INTEGER datapath: the
    serving mode that runs the reference's full-integer artifacts with
    the interpreter's own arithmetic (tools/ssd_mobilenet.py:100-127), on
    `device` (default CUDA): uint8 frames in, the byte-exact integer graph,
    then the float decode and NMS of models/ssd_mobilenet.py. Detector
    contract of the registry: width, height, compute_dtype (the frame
    resize's), labels, detect(images (N, H, W, 3), orig_w, orig_h) ->
    fixed-capacity detections."""

    def __init__(self, model_path: str, max_outputs: int = 32,
                 top_k: int = 100, score_threshold: float = 0.5,
                 iou_threshold: float = 0.5, conv_impl: str = "auto",
                 anchors=None, box_scale=None, detections_cap=None,
                 family: str = "ssd", pp_num_classes=None,
                 label_allow=None, label_deny=None, max_results: int = -1,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        from .ssd_mobilenet import BOX_SCALE, generate_anchors
        _full_integer_input(model_path, "fp16/fp32 exports")
        ex = QGraphExecutor(model_path, conv_impl=conv_impl, device=device)
        self.device = ex.device
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else default_compute_dtype(self.device))
        in_meta = ex.meta[ex.input_idx]
        self.executor = ex
        self.height, self.width = int(in_meta.shape[1]), int(in_meta.shape[2])
        if anchors is None:
            # both families share the box-coder decode; the anchor grid and
            # decode scales are family defaults (a fused postprocess op's
            # embedded table overrides both upstream)
            if family == "efficientdet":
                from .efficientdet import generate_anchors as eff_anchors
                anchors = eff_anchors(self.width) / float(self.width)
                box_scale = box_scale or (1.0, 1.0, 1.0, 1.0)
            else:
                anchors = generate_anchors()
        self.anchors = torch.from_numpy(np.asarray(anchors, np.float32)).to(
            self.device)
        self.box_scale = tuple(box_scale) if box_scale else BOX_SCALE
        self.max_outputs = max_outputs
        self.top_k = top_k
        self.score_threshold = score_threshold
        self.iou_threshold = iou_threshold
        self.detections_cap = detections_cap
        # zoo-layout exports run sigmoid in-graph before the fused
        # postprocess op; raw-heads exports end at the (dequantized) logits
        self._heads_are_probs = ex.stopped_at_custom
        self._in_int8 = in_meta.dtype == np.int8
        self._in_scale = float(in_meta.scale[0]) \
            if in_meta.scale is not None else 1.0
        self._in_zp = int(in_meta.zp[0]) if in_meta.zp is not None else 0
        # background column: the fused op's rule when present (a score
        # width of num_classes + 1 has one); raw-heads files follow the
        # family (TF-OD SSD: column 0; EfficientDet: none)
        self._pp_num_classes = pp_num_classes
        self._strip_background = family != "efficientdet"
        self.label_allow = list(label_allow) if label_allow else None
        self.label_deny = list(label_deny) if label_deny else None
        self.max_results = max_results
        self.labels = {}
        self._filter_lut = None

    def finalize_label_filter(self):
        from .efficientdet import build_label_filter_lut
        lut = build_label_filter_lut(self.labels, self.label_allow,
                                     self.label_deny)
        self._filter_lut = (None if lut is None
                            else torch.from_numpy(lut).to(self.device))

    def quantize_input(self, images: torch.Tensor) -> torch.Tensor:
        """Resized frames (N, H, W, 3) -> the graph's integer input."""
        if self._in_int8:
            return _affine_quantize(images, self._in_scale, self._in_zp,
                                    torch.int8)
        if images.dtype != torch.uint8:
            # uint8-input graphs consume the raw pixel lattice, so
            # nearest-uint8 (half away from zero) is the quantization step
            return torch.clamp(torch.floor(images.float() + 0.5), 0,
                               255).to(torch.uint8)
        return images

    def heads(self, images: torch.Tensor):
        """(box encodings (N, A, 4), class scores (N, A, C)) float32: the
        integer graph's head tensors, exactly dequantized."""
        with span("qssd.net"):
            outs = self.executor.dequantize_outputs(
                self.executor.apply(self.quantize_input(images)))
        n = images.shape[0]
        if self.executor.stopped_at_custom:
            # the fused op declares (box encodings, class predictions) in
            # fixed input order
            box_enc, scores = outs[0], outs[1]
        else:
            four = [o for o in outs if o.shape[-1] == 4]
            rest = [o for o in outs if o.shape[-1] != 4]
            if len(four) != 1 or len(rest) != 1:
                raise ValueError(
                    "could not identify box/score head tensors in "
                    f"{[tuple(o.shape) for o in outs]} - a score head with "
                    "exactly 4 class columns needs the fused postprocess "
                    "op's explicit ordering")
            box_enc, scores = four[0], rest[0]
        return (box_enc.reshape(n, -1, 4),
                scores.reshape(n, -1, scores.shape[-1]))

    @torch.inference_mode()
    def detect(self, images_resized: torch.Tensor, orig_w: float,
               orig_h: float):
        """(N, H, W, 3) float/uint8 -> fixed-capacity (boxes_xyxy (N, K, 4)
        in original pixels, classes (N, K) int32, scores (N, K), valid
        (N, K) bool), K = max_outputs."""
        from .efficientdet import apply_result_filter
        from .ssd_mobilenet import decode_boxes, postprocess_detections
        box_enc, scores = self.heads(images_resized)
        with span("qssd.decode_nms"):
            probs = scores if self._heads_are_probs else torch.sigmoid(scores)
            strip = (scores.shape[-1] == self._pp_num_classes + 1
                     if self._pp_num_classes is not None
                     else self._strip_background)
            if strip:
                probs = probs[..., 1:]
            boxes = decode_boxes(box_enc, self.anchors, self.box_scale)
            xyxy, classes, out_scores, valid = postprocess_detections(
                boxes, probs, orig_w, orig_h, top_k=self.top_k,
                score_threshold=self.score_threshold,
                iou_threshold=self.iou_threshold,
                max_outputs=self.max_outputs,
                detections_cap=self.detections_cap)
            valid = apply_result_filter(classes, valid, self._filter_lut,
                                        self.max_results)
        return xyxy, classes, out_scores, valid


class QuantizedYOLOv5Detector:
    """YOLOv5 on the integer datapath, on `device` (default CUDA). The
    reference's int8 yolov5 TFLite contract (tools/yolov5.py:102-118):
    normalize the frame to [0, 1], quantize with the input tensor's scale
    and zero point (`(img / scale + zero_point).astype(np.int8)`, a
    TRUNCATING cast, mirrored here), run the integer graph, dequantize the
    outputs, then the standard decode (yolov5.postprocess_heads)."""

    def __init__(self, model_path: str, max_outputs: int = 64,
                 score_threshold: float = 0.25, conv_impl: str = "auto",
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        in_dt = _full_integer_input(model_path, "fp16/fp32 yolov5 exports")
        ex = QGraphExecutor(model_path, conv_impl=conv_impl, device=device)
        self.device = ex.device
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else default_compute_dtype(self.device))
        in_meta = ex.meta[ex.input_idx]
        self.executor = ex
        self.height, self.width = int(in_meta.shape[1]), int(in_meta.shape[2])
        self.max_outputs = max_outputs
        self.score_threshold = score_threshold
        self._in_dtype = torch.int8 if in_dt == np.int8 else torch.uint8
        self._in_scale = float(in_meta.scale[0])
        self._in_zp = int(in_meta.zp[0])
        self.labels = {}

    def quantize_input(self, images: torch.Tensor) -> torch.Tensor:
        x01 = images.float() / 255.0
        q = x01 / _f32(self._in_scale) + self._in_zp
        info = torch.iinfo(self._in_dtype)
        # truncating cast, exactly the reference's .astype(np.int8)
        return torch.clamp(q, info.min, info.max).to(self._in_dtype)

    @torch.inference_mode()
    def detect(self, images_resized: torch.Tensor, orig_w: float,
               orig_h: float):
        from .yolov5 import postprocess_heads
        with span("qyolov5.net"):
            outs = self.executor.dequantize_outputs(
                self.executor.apply(self.quantize_input(images_resized)))
        with span("qyolov5.decode_nms"):
            # per-level heads ordered largest-spatial (stride 8) first
            heads = sorted(outs, key=lambda h: -int(h.shape[1]))
            return postprocess_heads(heads, self.width, orig_w, orig_h,
                                     score_threshold=self.score_threshold,
                                     max_outputs=self.max_outputs)


def make_quantized_mars_encoder(model_path: str, conv_impl: str = "auto",
                                device=None,
                                compute_dtype: Optional[torch.dtype] = None):
    """Appearance encoder on the INTEGER datapath: runs a full-integer MARS
    TFLite artifact (the reference's encoder format,
    tools/generate_detections.py:151-177 wraps `mars-little*.tflite`) with
    the interpreter's own arithmetic over the whole crop batch, on `device`
    (default CUDA). Float-in/float-out files run the converter's op stream
    (QUANTIZE from float, int8 convs and dense, float or int8 ELU, int8
    L2_NORMALIZATION, DEQUANTIZE); integer-in files get the AffineQuantize
    input step. `compute_dtype` is the crops' (default: bf16 on the card).

    Returns an EncoderSpec (drop-in for FrameStep). Features are the
    artifact's outputs re-normalized in float32 (the int8 L2 norm is
    1/128-scale with +-1 LSB rounding; the tracker's cosine math expects
    unit vectors like the float MARS path)."""
    from .encoders import EncoderSpec
    ex = QGraphExecutor(model_path, conv_impl=conv_impl, device=device)
    in_meta = ex.meta[ex.input_idx]
    h, w = int(in_meta.shape[1]), int(in_meta.shape[2])
    out_dim = int(np.prod(ex.meta[ex.output_idxs[0]].shape[1:]))
    in_dtype = in_meta.dtype
    in_scale = float(in_meta.scale[0]) if in_meta.scale is not None else 1.0
    in_zp = int(in_meta.zp[0]) if in_meta.zp is not None else 0

    @torch.inference_mode()
    def apply_fn(patches: torch.Tensor) -> torch.Tensor:
        if in_dtype == np.float32:
            x = patches.float()
        else:
            x = _affine_quantize(patches, in_scale, in_zp,
                                 _TORCH_DT[np.dtype(in_dtype)])
        feats = ex.dequantize_outputs(ex.apply(x))[0]
        feats = feats.reshape(patches.shape[0], out_dim).float()
        norm = torch.sqrt(1e-8 + torch.sum(feats * feats, 1, keepdim=True))
        return feats / norm

    dev = ex.device
    spec = EncoderSpec((h, w, 3), out_dim, apply_fn, dev,
                       compute_dtype if compute_dtype is not None
                       else default_compute_dtype(dev))
    spec.executor = ex
    return spec
