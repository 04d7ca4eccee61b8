"""Real-weight ingestion by variable name: frozen GraphDefs, TF checkpoints
and SavedModel directories.

Port of the name-map half of deepdish_tpu/models/convert.py: the readers
(`import_frozen_pb` :958, `import_tf_checkpoint` :1336,
`read_saved_model_variables` :1347), the MARS frozen-graph map
(`_mars_name_map` / `convert_mars_pb` :979-1060), the TF-OD SSD map
(`_ssd_name_patterns` / `convert_ssd_tfod` :1063-1157) and the TF-OD
faster_rcnn_resnet_v1 map (`convert_faster_rcnn_tfod` :1369-1509, which
infers the resnet depth, widths, RPN width and class count from the
names), with the loaders of :1361-1366 and :1512-1534. The structural half
(TFLite flatbuffers, Keras .h5) is not ported yet: `load_mars` refuses a
.tflite.

The readers import tensorflow inside the function: where it is not
installed they raise ImportError, and the numpy-only converters still run
on named tensors built some other way.

No trace: the JAX package runs `net.init` under `nn.intercept_methods`
only to learn each conv's or dense layer's path, flax-layout kernel shape,
bias and owning batch norm. Here these come from the port module's flax
template (models/weights.py `*_to_flax_template`: flax-named zeros in flax
layout, the keys and shapes of the JAX package's `_flatten(variables)`),
with a batch norm owning the conv `<conv>` when it is `<conv>_bn` (ds<i>/dw
+ ds<i>/dw_bn, the Faster R-CNN convs) or when the conv is
`<parent>/Conv_0` and the batch norm `<parent>/BatchNorm_0`. The
converters fill that flat dict as the JAX ones fill their tree, so a
conversion here equals `_flatten` of the JAX one key by key, and the
`*_from_flax` bridges turn it into a state_dict. Every converter fails
loudly: missing parameters raise with a report.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import weights as w

Flat = Dict[str, np.ndarray]


@dataclass
class Slot:
    """A conv or dense layer of a template: its flax path, kernel shape in
    flax layout (HWIO / (in, out)), bias, and owning batch norm."""
    kind: str                      # 'conv' | 'dw' | 'dense'
    path: Tuple[str, ...]
    kernel_shape: Tuple[int, ...]
    has_bias: bool
    bn_path: Optional[Tuple[str, ...]] = None
    bn_eps: float = 1e-3

    def __repr__(self):
        bn = f" bn={'/'.join(self.bn_path)}" if self.bn_path else ""
        return (f"<{self.kind} {'/'.join(self.path)} "
                f"{self.kernel_shape}{' +bias' if self.has_bias else ''}{bn}>")


def template_slots(flat: Flat, bn_eps: float = 1e-3) -> Dict[str, Slot]:
    """'/'-joined path -> Slot for every kernel of a flax template."""
    slots = {}
    for key, arr in flat.items():
        coll, *path, leaf = key.split("/")
        if coll != "params" or leaf != "kernel":
            continue
        kind = ("dense" if arr.ndim == 2 else
                "dw" if arr.shape[2] == 1 and arr.shape[3] > 1 else "conv")
        owners = [path[:-1] + [path[-1] + "_bn"]]
        if path[-1] == "Conv_0":
            owners.append(path[:-1] + ["BatchNorm_0"])
        bn = next((tuple(o) for o in owners
                   if f"batch_stats/{'/'.join(o)}/mean" in flat), None)
        name = "/".join(path)
        slots[name] = Slot(kind, tuple(path), tuple(arr.shape),
                           f"params/{name}/bias" in flat, bn, bn_eps)
    return slots


def _set_leaf(flat: Flat, coll: str, path, value) -> None:
    """flat['<coll>/<path>'] = value (the flat form of the JAX package's
    tree `_set_leaf`)."""
    flat["/".join([coll] + list(path))] = value


def _kernel_to_shape(arr: np.ndarray, target_shape) -> Optional[np.ndarray]:
    """Try the known kernel layouts (flax HWIO, TFLite OHWI, TF depthwise
    HWCM, TFLite depthwise 1HWC, dense IO/OI) and return the array in flax
    layout if one matches `target_shape`, else None."""
    target_shape = tuple(target_shape)
    cands = [arr]
    if arr.ndim == 4:
        cands += [np.transpose(arr, (1, 2, 3, 0)),    # OHWI -> HWIO
                  np.transpose(arr, (1, 2, 0, 3)),    # 1HWC -> HW1C
                  np.transpose(arr, (0, 1, 3, 2))]    # HWCM -> HWMC (dw)
    elif arr.ndim == 2:
        cands += [np.transpose(arr, (1, 0))]
    for c in cands:
        if tuple(c.shape) == target_shape:
            return c
    return None


def _write_identity_bn(flat: Flat, slot: Slot,
                       beta: Optional[np.ndarray]) -> None:
    """A folded export's batch norm as an identity carrying the folded
    bias: (x - 0) * 1 / sqrt((1 - eps) + eps) + beta = x + beta."""
    c = slot.kernel_shape[-1]
    bn = slot.bn_path
    _set_leaf(flat, "params", bn + ("scale",), np.ones(c, np.float32))
    b = beta if beta is not None else np.zeros(c, np.float32)
    _set_leaf(flat, "params", bn + ("bias",), b.astype(np.float32))
    _set_leaf(flat, "batch_stats", bn + ("mean",), np.zeros(c, np.float32))
    _set_leaf(flat, "batch_stats", bn + ("var",),
              np.full(c, 1.0 - slot.bn_eps, np.float32))


# ------------------------------------------------------------ TF readers

def import_frozen_pb(path: str) -> Dict[str, np.ndarray]:
    """Every Const tensor of a frozen GraphDef as {name: ndarray} (the
    product of convert_variables_to_constants keeps variable names,
    tools/freeze_model.py:212-215). Needs tensorflow."""
    import tensorflow as tf
    from tensorflow.python.framework import tensor_util

    gd = tf.compat.v1.GraphDef()
    with open(path, "rb") as f:
        gd.ParseFromString(f.read())
    out = {}
    for node in gd.node:
        if node.op == "Const" and "value" in node.attr:
            try:
                out[node.name] = tensor_util.MakeNdarray(
                    node.attr["value"].tensor)
            except Exception:
                continue
    return out


def import_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a TF checkpoint as {variable_name: ndarray} (the
    MARS training artifact mars-small128.ckpt-68577, whose names match the
    frozen graph's). Needs tensorflow."""
    import tensorflow as tf
    reader = tf.train.load_checkpoint(path)
    return {name: reader.get_tensor(name)
            for name in reader.get_variable_to_shape_map()}


def read_saved_model_variables(path: str) -> Dict[str, np.ndarray]:
    """Every variable of a SavedModel directory as {name: ndarray}, from
    its variables/variables checkpoint (TF1-style TF-OD exports keep the
    graph's variable names). Needs tensorflow."""
    vpath = os.path.join(path, "variables", "variables")
    if not os.path.exists(vpath + ".index"):
        raise FileNotFoundError(
            f"{path} has no variables/variables checkpoint")
    return import_tf_checkpoint(vpath)


# ------------------------------------------------------------ MARS

def _mars_name_map():
    """(substring, target leaf path, collection) for every MARS parameter.
    Slim nests the BN scope inside the layer scope (`conv1_1/conv1_1/bn/
    beta`); the trailing `<scope>/bn/<var>` substring matches either way.
    Slim's batch norms are center-only: beta, no gamma."""
    m = []

    def bn(frag, path):
        m.append((f"{frag}/bn/beta", path + ["BatchNorm_0", "bias"], "p"))
        m.append((f"{frag}/bn/moving_mean",
                  path + ["BatchNorm_0", "mean"], "s"))
        m.append((f"{frag}/bn/moving_variance",
                  path + ["BatchNorm_0", "var"], "s"))

    for c in ("conv1_1", "conv1_2"):
        m.append((f"{c}/weights", [c, "kernel"], "p"))
        bn(c, [f"{c}_bn"])
    blocks = [("conv2_1", False, True), ("conv2_3", False, False),
              ("conv3_1", True, False), ("conv3_3", False, False),
              ("conv4_1", True, False), ("conv4_3", False, False)]
    for blk, inc, first in blocks:
        if not first:
            bn(blk, [blk, "pre_bn"])
        m.append((f"{blk}/1/weights", [blk, "inner", "conv1", "kernel"], "p"))
        bn(f"{blk}/1", [blk, "inner", "bn1"])
        m.append((f"{blk}/2/weights", [blk, "inner", "conv2", "kernel"], "p"))
        m.append((f"{blk}/2/biases", [blk, "inner", "conv2", "bias"], "p"))
        if inc:
            m.append((f"{blk}/projection/weights",
                      [blk, "projection", "kernel"], "p"))
    m.append(("fc1/weights", ["fc1", "kernel"], "p"))
    bn("fc1", ["fc1_bn"])
    m.append(("ball/beta", ["ball", "BatchNorm_0", "bias"], "p"))
    m.append(("ball/moving_mean", ["ball", "BatchNorm_0", "mean"], "s"))
    m.append(("ball/moving_variance", ["ball", "BatchNorm_0", "var"], "s"))
    return m


def mars_template() -> Flat:
    from .mars import MarsNet
    with torch.device("meta"):
        return w.mars_to_flax_template(MarsNet())


def convert_mars_pb(tensors: Dict[str, np.ndarray],
                    template: Optional[Flat] = None, strict: bool = True):
    """Frozen-graph MARS constants (tools/freeze_model.py names) onto a
    MarsNet flax template (default: `mars_template()`). Returns (flat
    variables, report); raises when strict and a parameter is missing."""
    flat = dict(template if template is not None else mars_template())
    consumed = set()
    missing = []
    for frag, path, coll in _mars_name_map():
        key = "/".join(["params" if coll == "p" else "batch_stats"] + path)
        expect = flat.get(key)
        if expect is None:
            raise KeyError(f"target leaf {'/'.join(path)} not in MarsNet "
                           "variables — name map out of date")
        hits = [n for n in tensors
                if frag in n and n not in consumed
                and tuple(tensors[n].shape) == tuple(expect.shape)]
        if not hits:
            missing.append(f"{frag} -> {'/'.join(path)}")
            continue
        consumed.add(hits[0])
        flat[key] = tensors[hits[0]].astype(np.float32)
    report = {"assigned": len(consumed), "total": len(flat),
              "missing": missing}
    if strict and missing:
        raise ValueError(f"MARS pb conversion missing {len(missing)} "
                         f"parameters: {missing[:10]}")
    return flat, report


def load_mars(model_path: str):
    """MARS weights from a frozen .pb or a TF checkpoint (name map).
    Returns (flat flax variables, report)."""
    if model_path.endswith(".tflite"):
        raise NotImplementedError(
            f"{model_path}: converting a .tflite MARS encoder (structural, "
            "BN folded) waits for the port's TFLite/Keras conversion slice "
            "(ROADMAP.md §1 item 2); convert it to .npz with the JAX "
            "package")
    if ".ckpt" in model_path or model_path.endswith(".index"):
        tensors = import_tf_checkpoint(model_path.replace(".index", ""))
    else:
        tensors = import_frozen_pb(model_path)
    return convert_mars_pb(tensors)


# ------------------------------------------------------------ TF-OD SSD

def _ssd_name_patterns():
    """slot path -> regex over TF-OD tensor names (ssd_mobilenet_v1 feature
    extractor, the BoxPredictor heads and the four extra layers
    Conv2d_13_pointwise_{1,2}_Conv2d_{2..5})."""
    pats = [("conv0/Conv_0", r"Conv2d_0/(?:weights|Conv2D)")]
    for i in range(1, 14):
        pats.append((f"ds{i}/dw", rf"Conv2d_{i}_depthwise/depthwise"))
        pats.append((f"ds{i}/pw", rf"Conv2d_{i}_pointwise/(?:weights|Conv2D)"))
    for i in range(4):
        pats.append((f"extra{i}_1x1/Conv_0",
                     rf"Conv2d_13_pointwise_1_Conv2d_{i + 2}_1x1"))
        pats.append((f"extra{i}_3x3/Conv_0",
                     rf"Conv2d_13_pointwise_2_Conv2d_{i + 2}_3x3"))
    for i in range(6):
        pats.append((f"box_head{i}",
                     rf"BoxPredictor_{i}/BoxEncodingPredictor"))
        pats.append((f"cls_head{i}", rf"BoxPredictor_{i}/ClassPredictor"))
    return pats


def convert_ssd_tfod(tensors: Dict[str, np.ndarray], net=None,
                     strict: bool = True):
    """Name-map conversion of TF-OD SSD-MobileNetV1 exports whose tensor
    names survive (frozen graphs, SavedModel variables): kernel by name
    pattern and rank-4 shape, bias by rank 1; a BN-folded export lands its
    bias in an identity batch norm. `net` is a port SSDMobileNetV1 (default:
    a new one on the meta device). Returns (flat variables, report)."""
    if net is None:
        from .ssd_mobilenet import SSDMobileNetV1
        with torch.device("meta"):
            net = SSDMobileNetV1()
    flat = w.ssd_to_flax_template(net)
    by_path = template_slots(flat)

    consumed = set()
    missing = []
    for frag, pat in _ssd_name_patterns():
        slot = by_path.get(frag) or by_path.get(frag + "/Conv_0")
        if slot is None:
            raise KeyError(f"slot {frag} not found in SSDMobileNetV1 tree")
        rx = re.compile(pat)
        names = [n for n in tensors if rx.search(n) and n not in consumed]
        kern = bias = None
        kshape = slot.kernel_shape
        for n in names:
            a = tensors[n]
            if a.ndim == 4 and kern is None:
                flaxk = _kernel_to_shape(a, kshape)
                if flaxk is not None:
                    kern = flaxk
                    consumed.add(n)
            elif a.ndim == 1 and a.shape[0] == kshape[-1] and bias is None \
                    and "BatchNorm" not in n:
                bias = a
                consumed.add(n)
        if kern is None:
            missing.append(frag)
            continue
        _set_leaf(flat, "params", slot.path + ("kernel",),
                  kern.astype(np.float32))
        if slot.has_bias:
            b = bias if bias is not None else np.zeros(kshape[-1], np.float32)
            _set_leaf(flat, "params", slot.path + ("bias",),
                      b.astype(np.float32))
        elif slot.bn_path is not None:
            # unfolded exports keep BatchNorm variables next to the conv
            bn_vars = {}
            for v in ("gamma", "beta", "moving_mean", "moving_variance"):
                rx2 = re.compile(pat.split("/")[0] + rf".*BatchNorm.*{v}")
                cand = [n for n in tensors if rx2.search(n)
                        and n not in consumed
                        and tensors[n].shape == (kshape[-1],)]
                if cand:
                    bn_vars[v] = tensors[cand[0]]
                    consumed.add(cand[0])
            if len(bn_vars) == 4:
                bn = slot.bn_path
                _set_leaf(flat, "params", bn + ("scale",), bn_vars["gamma"])
                _set_leaf(flat, "params", bn + ("bias",), bn_vars["beta"])
                _set_leaf(flat, "batch_stats", bn + ("mean",),
                          bn_vars["moving_mean"])
                _set_leaf(flat, "batch_stats", bn + ("var",),
                          bn_vars["moving_variance"])
            else:
                _write_identity_bn(flat, slot, bias)
    report = {"assigned": len(_ssd_name_patterns()) - len(missing),
              "total": len(_ssd_name_patterns()), "missing": missing}
    if strict and missing:
        raise ValueError(f"SSD TF-OD conversion missing {len(missing)} "
                         f"layers: {missing}")
    return flat, report


def load_ssd_saved_model(path: str):
    """TF-OD SSD-MobileNetV1 SavedModel directory -> (flat variables,
    report); raises when its variables are not the SSD family's."""
    return convert_ssd_tfod(read_saved_model_variables(path))


# ------------------------------------------------------------ TF-OD Faster R-CNN

def convert_faster_rcnn_tfod(tensors: Dict[str, np.ndarray],
                             input_size: int = 640, strict: bool = True):
    """Name-map conversion of TF-OD faster_rcnn_resnet_v1 exports (the TF1
    export_inference_graph names: FirstStageFeatureExtractor/resnet_v1_N/
    ..., Conv (the RPN 3x3), FirstStageBoxPredictor/..., SecondStage
    FeatureExtractor/resnet_v1_N/block4/..., SecondStageBoxPredictor/...).
    The architecture comes from the checkpoint: units per block, stem and
    block widths, RPN width and class count, so resnet_v1_50/101/152 bind
    without configuration. Returns (flat variables, report); report
    ["config"] is the inferred FasterRCNNConfig."""
    from .faster_rcnn import FasterRCNNConfig, FasterRCNNNet

    rv = None
    for n in tensors:
        m = re.match(r"FirstStageFeatureExtractor/(resnet_v1_\d+)/"
                     r"conv1/weights$", n)
        if m:
            rv = m.group(1)
            break
    if rv is None:
        raise ValueError(
            "not a TF-OD faster_rcnn_resnet_v1 export: no "
            "FirstStageFeatureExtractor/resnet_v1_N/conv1/weights variable")

    def block_prefix(b):
        stage = ("FirstStageFeatureExtractor" if b <= 3
                 else "SecondStageFeatureExtractor")
        return f"{stage}/{rv}/block{b}"

    units, feats = [], []
    for b in range(1, 5):
        pre = block_prefix(b)
        us = {int(m.group(1)) for n in tensors
              for m in [re.match(rf"{pre}/unit_(\d+)/", n)] if m}
        if not us:
            raise ValueError(f"missing {pre} in checkpoint")
        units.append(max(us))
        feats.append(int(
            tensors[f"{pre}/unit_1/bottleneck_v1/conv3/weights"].shape[-1]))

    stem = int(tensors[
        f"FirstStageFeatureExtractor/{rv}/conv1/weights"].shape[-1])
    rpn_feats = int(tensors["Conv/weights"].shape[-1])
    a_cells = int(tensors[
        "FirstStageBoxPredictor/BoxEncodingPredictor/weights"]
        .shape[-1]) // 4
    num_classes = int(tensors[
        "SecondStageBoxPredictor/ClassPredictor/biases"].shape[0]) - 1
    cfg = FasterRCNNConfig(input_size=input_size, stem_features=stem,
                           block_units=tuple(units),
                           block_features=tuple(feats),
                           num_classes=num_classes,
                           rpn_features=rpn_feats)
    if cfg.anchors_per_cell != a_cells:
        raise ValueError(
            f"RPN predicts {a_cells} anchors/cell; only the TF-OD default "
            f"grid ({cfg.anchors_per_cell}: scales {cfg.anchor_scales} x "
            f"aspects {cfg.anchor_aspects}) is supported")

    with torch.device("meta"):
        flat = w.faster_rcnn_to_flax_template(FasterRCNNNet(cfg))
    by_path = template_slots(flat, bn_eps=1e-5)
    consumed = set()
    missing = []

    def bind(slot_path, tf_name, has_bias):
        slot = by_path.get(slot_path)
        if slot is None:
            raise KeyError(f"slot {slot_path} not in FasterRCNNNet tree")
        kname = f"{tf_name}/weights"
        if kname not in tensors:
            missing.append(kname)
            return
        kern = _kernel_to_shape(tensors[kname], slot.kernel_shape)
        if kern is None:
            missing.append(f"{kname} (shape {tensors[kname].shape} does "
                           f"not fit {slot.kernel_shape})")
            return
        consumed.add(kname)
        _set_leaf(flat, "params", slot.path + ("kernel",),
                  kern.astype(np.float32))
        if has_bias:
            bname = f"{tf_name}/biases"
            if bname in tensors:
                _set_leaf(flat, "params", slot.path + ("bias",),
                          tensors[bname].astype(np.float32))
                consumed.add(bname)
            else:
                missing.append(bname)
        elif slot.bn_path is not None:
            for tfv, coll, leaf in (("gamma", "params", "scale"),
                                    ("beta", "params", "bias"),
                                    ("moving_mean", "batch_stats", "mean"),
                                    ("moving_variance", "batch_stats",
                                     "var")):
                n = f"{tf_name}/BatchNorm/{tfv}"
                if n in tensors:
                    _set_leaf(flat, coll, slot.bn_path + (leaf,),
                              tensors[n].astype(np.float32))
                    consumed.add(n)
                else:
                    missing.append(n)

    bind("conv1", f"FirstStageFeatureExtractor/{rv}/conv1", False)
    for b in range(1, 5):
        pre = block_prefix(b)
        for u in range(1, units[b - 1] + 1):
            flax_u = f"block{b}/unit_{u}"
            tf_u = f"{pre}/unit_{u}/bottleneck_v1"
            for c in ("conv1", "conv2", "conv3"):
                bind(f"{flax_u}/{c}", f"{tf_u}/{c}", False)
            if f"{tf_u}/shortcut/weights" in tensors:
                bind(f"{flax_u}/shortcut", f"{tf_u}/shortcut", False)
    bind("rpn_conv", "Conv", True)
    bind("rpn_box", "FirstStageBoxPredictor/BoxEncodingPredictor", True)
    bind("rpn_cls", "FirstStageBoxPredictor/ClassPredictor", True)
    bind("box_head", "SecondStageBoxPredictor/BoxEncodingPredictor", True)
    bind("cls_head", "SecondStageBoxPredictor/ClassPredictor", True)

    unused = [n for n in tensors if n not in consumed
              and not n.endswith(("/ExponentialMovingAverage",
                                  "global_step"))]
    report = {"missing": missing, "unused": unused,
              "assigned": len(consumed), "config": cfg}
    if strict and missing:
        raise ValueError(f"faster_rcnn conversion incomplete: {missing}")
    return flat, report


def load_faster_rcnn_saved_model(path: str, input_size: int = 640):
    """TF-OD faster_rcnn_resnet_v1 SavedModel directory -> (flat variables,
    report with the inferred config); raises when its variables are not
    the family's."""
    return convert_faster_rcnn_tfod(read_saved_model_variables(path),
                                    input_size=input_size)
