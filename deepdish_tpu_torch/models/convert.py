"""Real-weight ingestion: TFLite flatbuffers, Keras HDF5, frozen GraphDefs,
TF checkpoints and SavedModel directories.

Port of deepdish_tpu/models/convert.py, both halves:

  * **Structural conversion** (`convert_tflite` :897, `convert_keras_h5`
    :1189): a TFLite flatbuffer lists its CONV_2D / DEPTHWISE_CONV_2D /
    FULLY_CONNECTED operators with the batch norms folded in, and the
    port's networks call their convs in the JAX package's order.
    `trace_slots` records each conv's, dense layer's and batch norm's flax
    path, kernel shape, bias and owning batch norm in call order, with a
    structural signature from the forward pass's dataflow (`_struct_sigs`
    :331, the same values as the jaxpr walk of `_annotate_slot_sigs`
    :154); `read_tflite` (:376) reads the ops with their dequantized
    kernels and the same signatures from the flatbuffer's dataflow;
    `assign_slots` (:748) binds ops to slots by kernel shape and signature
    rank (`_bind_by_structure` :700), writing a folded batch norm as an
    identity carrying the folded bias and a standalone one (TFLite's
    constant MUL + ADD) as an affine. `read_tflite_postprocess` (:592)
    reads the TFLite_Detection_PostProcess op's anchors and options, and
    the loaders (:1306-1333, :1521-1545) attach them to the report.
  * **Name-map conversion** for artifacts that keep variable names: the
    readers `import_frozen_pb` (:958), `import_tf_checkpoint` (:1336) and
    `read_saved_model_variables` (:1347), the MARS frozen-graph map
    (`convert_mars_pb` :979-1060), the TF-OD SSD map (`convert_ssd_tfod`
    :1063-1157) and the TF-OD faster_rcnn_resnet_v1 map
    (`convert_faster_rcnn_tfod` :1369-1509, which infers the resnet depth,
    widths, RPN width and class count from the names).

The flatbuffer readers parse the file with numpy alone
(models/tflite_meta.py), where the JAX package uses TF's generated schema
and flatbuffers.flexbuffers, so .tflite files convert on a machine without
tensorflow; `.pb`, checkpoints, SavedModel directories and `.h5` need
tensorflow or h5py, imported inside the functions that read them.

Every conversion fills a flat dict of flax variables keyed
"params/<path>/<leaf>" and "batch_stats/<path>/<leaf>", as the JAX
converters fill their tree, so a conversion here equals `_flatten` of the
JAX one key by key; the `*_from_flax` bridges of models/weights.py turn it
into a state_dict. The name-map converters read the flax-named templates of
models/weights.py (`*_to_flax_template`) and need no trace; a batch norm
owns the conv `<conv>` there when it is `<conv>_bn` (ds<i>/dw + ds<i>/dw_bn,
the Faster R-CNN convs) or when the conv is `<parent>/Conv_0` and the batch
norm `<parent>/BatchNorm_0`. Leaves that a conversion does not fill are
zeros (the JAX package's are its random init). Every converter fails
loudly: missing parameters raise with a report.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import tflite_meta
from . import weights as w

Flat = Dict[str, np.ndarray]


@dataclass
class Slot:
    """A conv or dense layer (or a standalone batch norm, kind 'bn') of a
    network: its flax path, kernel shape in flax layout (HWIO / (in, out);
    (C,) for a batch norm), bias, owning batch norm, and the structural
    signature that `_bind_by_structure` pairs with a flatbuffer op's."""
    kind: str                      # 'conv' | 'dw' | 'dense' | 'bn'
    path: Tuple[str, ...]
    kernel_shape: Tuple[int, ...]
    has_bias: bool
    bn_path: Optional[Tuple[str, ...]] = None
    bn_eps: float = 1e-3
    bn_has_scale: bool = True
    bn_has_bias: bool = True
    # bounded upstream/downstream kernel-shape distance profiles
    # (`_struct_sigs`); empty when the dataflow was not traced
    sig: Tuple = ()

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
    if slot.bn_has_scale:
        _set_leaf(flat, "params", bn + ("scale",), np.ones(c, np.float32))
    if slot.bn_has_bias:
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
    """MARS weights from a frozen .pb or a TF checkpoint (name map), or a
    .tflite (structural, batch norms folded). Returns (flat flax
    variables, report)."""
    if model_path.endswith(".tflite"):
        from .mars import INPUT_SHAPE, MarsNet
        return convert_tflite(_meta_net(MarsNet), (1,) + INPUT_SHAPE,
                              model_path)
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


# ------------------------------------------------------------ slot tracing

def _owns(conv_path, bn_path) -> bool:
    """A batch norm belongs to the conv called just before it when both
    were created in the same flax body: it shares the conv's parent chain
    and sits at most two levels below it (bn module [+ 'BatchNorm_0']).
    The depth bound keeps the empty top-level parent from vacuously
    claiming another module's pre-activation batch norm (MARS's
    conv3_1/projection followed by conv3_3/pre_bn)."""
    parent = conv_path[:-1]
    return (bn_path[:len(parent)] == parent
            and len(bn_path) <= len(parent) + 2)


def _materialize(net: torch.nn.Module) -> torch.nn.Module:
    """`net` on the CPU in float32 for the trace: a net on the meta device
    gets zero weights there (values do not matter to the structure)."""
    if any(p.is_meta for p in net.parameters()):
        net = net.to_empty(device="cpu")
        with torch.no_grad():
            for t in list(net.parameters()) + list(net.buffers()):
                t.zero_()
    for p in net.parameters():
        if p.device.type != "cpu" or p.dtype != torch.float32:
            raise ValueError("trace_slots runs a float32 net on the CPU "
                             f"(or the meta device); got {p.dtype} on "
                             f"{p.device}")
    return net


def trace_slots(net: torch.nn.Module, example_shape, naming=None):
    """(flat flax template of zeros, slots) of `net`: `trace_graph`
    without the graph."""
    flat, slots, _ = trace_graph(net, example_shape, naming)
    return flat, slots


def trace_graph(net: torch.nn.Module, example_shape, naming=None):
    """Run `net` once on zeros of `example_shape`, recording every
    nn.Conv2d / nn.Linear / BatchNorm call in execution order, and return
    (flat flax template of zeros, slots, graph): graph is (indices of the
    conv / dense slots, their immediate weight-bearing ancestors and
    consumers as positions in that list), None when the dataflow could
    not be matched.

    The trace is structure, not inference: it runs on the CPU in float32
    whatever device the detector later takes (a net on the meta device is
    given zero weights there). Each slot's path is the flax path of the
    called module under `naming` (models/weights.py FlaxNaming; default
    the net class's entry of NAMINGS), its kernel shape the template's,
    and whether its batch norm learns a scale or a bias the template's
    too. A batch norm is attached to the conv or dense layer called just
    before it when `_owns` says so; others become standalone 'bn' slots,
    which TFLite lowers to constant MUL + ADD pairs. The slots' structural
    signatures come from the same forward pass (`_annotate_slot_sigs`)."""
    from .layers import BatchNorm
    net = _materialize(net)
    if naming is None:
        naming = w.NAMINGS[type(net).__name__]
    flat = w._to_flax(net, naming, zeros=True)
    paths = naming.paths(net)
    calls: List[Tuple[str, str]] = []

    def record(name):
        def hook(module, args):
            calls.append((name, type(module).__name__))
        return hook

    hooks = [m.register_forward_pre_hook(record(name))
             for name, m in net.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, BatchNorm))]
    try:
        dataflow = _dataflow(net, example_shape)
    finally:
        for h in hooks:
            h.remove()

    slots: List[Slot] = []
    slot_module: List[str] = []
    i = 0
    while i < len(calls):
        name, _ = calls[i]
        mod = net.get_submodule(name)
        path = paths[name]
        key = "/".join(path)
        if isinstance(mod, BatchNorm):
            c = flat[f"batch_stats/{key}/mean"].shape[0]
            slots.append(Slot("bn", path, (c,), False, bn_path=path,
                              bn_eps=float(mod.eps),
                              bn_has_scale=f"params/{key}/scale" in flat,
                              bn_has_bias=f"params/{key}/bias" in flat))
            slot_module.append(name)
            i += 1
            continue
        if isinstance(mod, torch.nn.Linear):
            kind = "dense"
        elif mod.groups > 1:
            kind = "dw"
        else:
            kind = "conv"
        slot = Slot(kind, path, tuple(flat[f"params/{key}/kernel"].shape),
                    mod.bias is not None)
        if i + 1 < len(calls) and \
                isinstance(net.get_submodule(calls[i + 1][0]), BatchNorm):
            bn_name = calls[i + 1][0]
            bn_path = paths[bn_name]
            bn_key = "/".join(bn_path)
            if _owns(path, bn_path):
                slot.bn_path = bn_path
                slot.bn_eps = float(net.get_submodule(bn_name).eps)
                slot.bn_has_scale = f"params/{bn_key}/scale" in flat
                slot.bn_has_bias = f"params/{bn_key}/bias" in flat
                i += 1
        slots.append(slot)
        slot_module.append(name)
        i += 1
    graph = None
    try:
        graph = _annotate_slot_sigs(dataflow, slots, slot_module)
    except Exception as e:       # pragma: no cover - diagnostics only
        print(f"slot connectivity analysis unavailable ({e}); "
              "falling back to order-based binding")
    return flat, slots, graph


def _dataflow(net: torch.nn.Module, example_shape):
    """One forward pass of zeros under a TorchFunctionMode: for every torch
    function call with a tensor output, the calls that produced its tensor
    inputs (-1: a parameter, buffer or the input), and, for conv2d and
    linear calls, the name of the parameter that is the kernel operand
    (walked back through pass-through calls, as the JAX side's `_origin`
    walks to a parameter leaf). An in-place op's output is a new node.
    Every recorded tensor is kept until the walk ends, so that no id() is
    reused. Returns (inputs per call, {call: kernel parameter name})."""
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_leaves

    param_name = {id(p): n for n, p in net.named_parameters()}
    producer: Dict[int, int] = {}       # id(tensor) -> latest call
    inputs: List[List[int]] = []
    first_input: List[Optional[object]] = []
    kernels: Dict[int, object] = {}
    keep: List[object] = []

    class Recorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            if not outs:
                return out
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            idx = len(inputs)
            inputs.append([producer.get(id(t), -1) for t in ins])
            first_input.append(ins[0] if ins else None)
            if getattr(func, "__name__", "") in ("conv2d", "linear") \
                    and len(args) >= 2 and isinstance(args[1], torch.Tensor):
                kernels[idx] = args[1]
            for t in outs:
                producer[id(t)] = idx
            keep.append((ins, outs))
            return out

    def origin(t):
        for _ in range(64):
            if id(t) in param_name:
                return param_name[id(t)]
            c = producer.get(id(t))
            if c is None or first_input[c] is None:
                return None
            t = first_input[c]
        return None

    with torch.device("cpu"), torch.no_grad():
        x = torch.zeros(tuple(example_shape), dtype=torch.float32)
        with Recorder():
            net(x)
    # kernel origins resolve after the pass: a cast kernel's producer is
    # recorded by then; parameters are never produced by a call
    kernel_of = {c: origin(k) for c, k in kernels.items()}
    del keep
    return inputs, kernel_of


def _annotate_slot_sigs(dataflow, slots, slot_module):
    """Fill Slot.sig from the recorded dataflow: each conv / dense slot's
    call is found by its kernel parameter; its immediate weight-bearing
    neighbours up (through every tensor input of non-weight calls) and
    down (through every consumer) give the same bounded shape-distance
    signatures as `read_tflite` computes on the flatbuffer side and the
    JAX package on the jaxpr. Tensors that descend only from parameters (a
    batch norm's rsqrt(var + eps) * weight) have no activation ancestors
    and add no edge. Returns (conv slot indices, ups, downs)."""
    inputs, kernel_of = dataflow
    conv_slots = [i for i, s in enumerate(slots) if s.kind != "bn"]
    name_to_node = {slot_module[si] + ".weight": n
                    for n, si in enumerate(conv_slots)}
    call_node: Dict[int, int] = {}
    node_call: Dict[int, int] = {}
    for c, pname in kernel_of.items():
        n = name_to_node.get(pname)
        if n is not None:
            call_node[c] = n
            node_call[n] = c
    if len(call_node) != len(conv_slots):
        raise ValueError(
            f"matched {len(call_node)} of {len(conv_slots)} conv calls")

    consumers: Dict[int, List[int]] = {}
    for c, ins in enumerate(inputs):
        for p in ins:
            if p >= 0:
                consumers.setdefault(p, []).append(c)

    up_memo: Dict[int, frozenset] = {}
    down_memo: Dict[int, frozenset] = {}

    def _up(c):
        if c < 0:
            return frozenset()
        if c in call_node:
            return frozenset((call_node[c],))
        if c in up_memo:
            return up_memo[c]
        up_memo[c] = frozenset()
        acc = set()
        for p in inputs[c]:
            acc |= _up(p)
        up_memo[c] = frozenset(acc)
        return up_memo[c]

    def _down(c):
        if c in down_memo:
            return down_memo[c]
        down_memo[c] = frozenset()
        acc = set()
        for cc in consumers.get(c, []):
            if cc in call_node:
                acc.add(call_node[cc])
            else:
                acc |= _down(cc)
        down_memo[c] = frozenset(acc)
        return down_memo[c]

    shapes, ups, downs = [], [], []
    for n, si in enumerate(conv_slots):
        c = node_call[n]
        shapes.append(slots[si].kernel_shape)
        acc = set()
        for p in inputs[c]:
            acc |= _up(p)
        acc.discard(n)
        ups.append(tuple(sorted(acc)))
        downs.append(tuple(sorted(_down(c) - {n})))
    for si, sig in zip(conv_slots, _struct_sigs(shapes, ups, downs)):
        slots[si].sig = sig
    return conv_slots, ups, downs


def _struct_sigs(shapes, ups, downs):
    """Per-node structural signature over a weight-op graph.

    shapes[i] is node i's flax-layout kernel shape; ups[i]/downs[i] are its
    immediate weight-bearing neighbor indices. The signature is the node's
    own shape plus its DISTANCE PROFILE: the minimum hop count to every
    kernel shape reachable upstream and downstream. Pure shapes and
    distances, so the traced side and the flatbuffer side of the same
    network produce identical values, and same-shape parallel branches the
    TFLite converter emits out of order can be re-paired structurally.
    The profile subsumes chain position (distance to the nearest
    distinctly-shaped anchor grows along a chain of identical blocks) and
    resolves deep symmetric towers (EfficientDet's box-vs-class towers
    differ only via their 36- vs 810-channel prediction conv many hops
    downstream — a bounded-depth tree would have to expand exponentially
    to see it; a distance profile reaches it for free)."""
    n = len(shapes)

    def profiles(neigh):
        out = []
        for i in range(n):
            dist: Dict[tuple, int] = {}
            frontier = list(neigh[i])
            hop = 1
            seen = set(frontier) | {i}
            while frontier:
                nxt = []
                for j in frontier:
                    s = shapes[j]
                    if s not in dist:
                        dist[s] = hop
                    for k in neigh[j]:
                        if k not in seen:
                            seen.add(k)
                            nxt.append(k)
                frontier = nxt
                hop += 1
            out.append(tuple(sorted(dist.items())))
        return out

    up_prof = profiles(ups)
    down_prof = profiles(downs)
    return [(shapes[i], up_prof[i], down_prof[i]) for i in range(n)]


# ------------------------------------------------------------ TFLite reading

@dataclass
class TFLiteConvOp:
    kind: str               # 'conv' | 'dw' | 'dense' | 'mul' | 'add'
    out_name: str           # output tensor name (for diagnostics)
    kernel: np.ndarray      # dequantized float32, TFLite layout
    bias: Optional[np.ndarray]
    # conv-stream index of the nearest upstream weight-bearing op (-1 =
    # fed by the graph input). Disambiguates parallel branches whose
    # kernels share a shape: the TFLite converter emits e.g. detection
    # heads in reverse level order, so op order alone mis-binds them.
    depth: int = -1
    # structural signature (see Slot.sig) computed from the flatbuffer's
    # dataflow graph; empty when unavailable
    sig: Tuple = ()


_TENSOR_NP = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8,
              4: np.int64, 7: np.int16, 9: np.int8}
CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED = 3, 4, 9
ADD, MUL = 0, 18
CUSTOM_OP_CODE = 32
DETECTION_POSTPROCESS = "TFLite_Detection_PostProcess"


def _dequant(t, data: np.ndarray) -> np.ndarray:
    """Tensor t's stored values as float32: (q - zero_point) * scale, per
    axis on `quantized_dimension` when there are several scales, zero
    points defaulting to 0 (the same float32 operations, in the same
    order, as the JAX package's `_dequant`)."""
    q = t.quantization
    if q is None or q.scale is None or q.scale.size == 0:
        return data.astype(np.float32)
    scales = q.scale.astype(np.float32)
    zps = (q.zero_point.astype(np.float32)
           if q.zero_point is not None and q.zero_point.size
           else np.zeros_like(scales))
    axis = q.quantized_dimension
    shape = [1] * data.ndim
    if scales.size > 1 and data.ndim:
        shape[axis] = scales.size
    return ((data.astype(np.float32) - zps.reshape(shape))
            * scales.reshape(shape))


def _tensor_data(model, ti: int):
    """(tensor, its constant data as stored, reshaped) or (tensor, None)."""
    if ti < 0:
        return None, None
    t = model.tensors[ti]
    raw = model.buffers[t.buffer]
    if raw is None:
        return t, None
    dt = _TENSOR_NP.get(t.type)
    if dt is None:
        return t, None
    arr = np.frombuffer(raw, dtype=dt)
    if t.shape is not None and len(t.shape):
        arr = arr.reshape(t.shape)
    return t, arr


def read_tflite(model_path: str):
    """Parse a .tflite flatbuffer. Returns (conv_ops, tensors): conv_ops is
    the ordered list of CONV_2D / DEPTHWISE_CONV_2D / FULLY_CONNECTED
    operators with dequantized constant kernel and bias, and the constant
    MUL / ADD operators (what a converter leaves of an unfolded batch
    norm, with the constant of either operand), each weight-bearing op
    with its producer depth and structural signature; tensors maps every
    constant tensor's name to its dequantized float32 array."""
    model = tflite_meta.read_model(model_path)

    kinds = {CONV_2D: "conv", DEPTHWISE_CONV_2D: "dw",
             FULLY_CONNECTED: "dense"}
    affine = {ADD: "add", MUL: "mul"}
    conv_ops: List[TFLiteConvOp] = []
    tensors: Dict[str, np.ndarray] = {}

    for ti in range(len(model.tensors)):
        t, arr = _tensor_data(model, ti)
        if arr is not None:
            tensors[t.name] = _dequant(t, arr)

    producer: Dict[int, int] = {}
    for oi, op in enumerate(model.operators):
        for o in op.outputs:
            producer[o] = oi

    def _is_const(ti):
        return ti < 0 or model.data(ti) is not None

    conv_stream_idx: Dict[int, int] = {}   # operator index -> conv_ops pos

    for oi, op in enumerate(model.operators):
        code = model.opcodes[op.opcode_index].code
        out_name = model.tensors[op.outputs[0]].name
        if code in affine and len(op.inputs) == 2:
            # elementwise op with one constant operand (either side)
            pairs = [_tensor_data(model, op.inputs[j]) for j in (0, 1)]
            tt, const = pairs[1] if pairs[1][1] is not None else pairs[0]
            if const is not None:
                conv_ops.append(TFLiteConvOp(
                    affine[code], out_name,
                    np.asarray(_dequant(tt, const),
                               np.float32).reshape(-1), None))
            continue
        kind = kinds.get(code)
        if kind is None or len(op.inputs) < 2:
            continue
        kt, kern = _tensor_data(model, op.inputs[1])
        if kern is None:   # non-constant weights; not a weight-bearing op
            continue
        bias = None
        if len(op.inputs) >= 3 and op.inputs[2] >= 0:
            bt, bias = _tensor_data(model, op.inputs[2])
            if bias is not None:
                bias = _dequant(bt, bias)
        conv_ops.append(TFLiteConvOp(kind, out_name,
                                     _dequant(kt, kern), bias))
        conv_stream_idx[oi] = len(conv_ops) - 1

    # the dataflow graph: for each weight-bearing op, (a) its IMMEDIATE
    # weight-bearing ancestors (every activation input walked through
    # non-weight ops: a residual shortcut must not shadow the branch's
    # convs), (b) its immediate weight-bearing consumers, (c) depth = the
    # deepest ancestor's stream position, (d) the structural signature
    up_memo: Dict[int, frozenset] = {}

    def _up_set(ti: int) -> frozenset:
        pi = producer.get(ti)
        if pi is None:
            return frozenset()
        if pi in conv_stream_idx:
            return frozenset((conv_stream_idx[pi],))
        if pi in up_memo:
            return up_memo[pi]
        up_memo[pi] = frozenset()    # cycle guard
        acc = set()
        for tj in model.operators[pi].inputs:
            if tj >= 0 and not _is_const(tj):
                acc |= _up_set(tj)
        up_memo[pi] = frozenset(acc)
        return up_memo[pi]

    consumers: Dict[int, List[int]] = {}
    for oi, op in enumerate(model.operators):
        for ti in op.inputs:
            if ti >= 0 and not _is_const(ti):
                consumers.setdefault(ti, []).append(oi)

    down_memo: Dict[int, frozenset] = {}

    def _down_set(oi: int) -> frozenset:
        if oi in down_memo:
            return down_memo[oi]
        down_memo[oi] = frozenset()  # cycle guard
        acc = set()
        for o in model.operators[oi].outputs:
            for ci in consumers.get(o, []):
                if ci in conv_stream_idx:
                    acc.add(conv_stream_idx[ci])
                else:
                    acc |= _down_set(ci)
        down_memo[oi] = frozenset(acc)
        return down_memo[oi]

    wb = sorted(conv_stream_idx.items())          # (op index, stream idx)
    stream_to_node = {si: n for n, (_, si) in enumerate(wb)}
    shapes, ups, downs = [], [], []
    for oi, si in wb:
        o = conv_ops[si]
        shapes.append(tuple(_tflite_kernel_to_flax(o.kind, o.kernel).shape))
        anc = set()
        for tj in model.operators[oi].inputs:
            if tj >= 0 and not _is_const(tj):
                anc |= _up_set(tj)
        o.depth = max(anc) if anc else -1
        ups.append(tuple(sorted(stream_to_node[a] for a in anc)))
        downs.append(tuple(sorted(stream_to_node[d]
                                  for d in _down_set(oi))))
    for (oi, si), sig in zip(wb, _struct_sigs(shapes, ups, downs)):
        conv_ops[si].sig = sig
    return conv_ops, tensors


def read_tflite_io_quant(model_path: str):
    """(input, output) tensor quantization for the runtime contract: dict
    name -> (dtype, scale, zero_point) of the subgraph's inputs and
    outputs, what the reference reads from the input / output details
    (tools/yolov5.py:95-118)."""
    model = tflite_meta.read_model(model_path)
    out = {}
    for ti in list(model.inputs) + list(model.outputs):
        t = model.tensors[ti]
        q = t.quantization
        scale = zp = None
        if q is not None and q.scale is not None and q.scale.size:
            scale = float(q.scale[0])
            zp = (int(q.zero_point[0])
                  if q.zero_point is not None and q.zero_point.size else 0)
        out[t.name] = (_TENSOR_NP.get(t.type), scale, zp)
    return out


# ------------------------------------------------------------ postprocess op

@dataclass
class DetectionPostProcess:
    """A TFLite_Detection_PostProcess custom op: the fused postprocess that
    real zoo detector flatbuffers end in (the reference consumes its
    outputs at tools/ssd_mobilenet.py:100-127 and
    tools/tflite_object_detector.py:154-172).

    Field semantics follow the kernel
    (tensorflow/lite/kernels/detection_postprocess.cc): anchors are
    (A, 4) [y_center, x_center, h, w] in normalized coordinates; box
    encodings are divided by (y_scale, x_scale, h_scale, w_scale) before
    the standard centroid/log-size decode; the score input includes a
    leading background column when it has num_classes + 1 columns."""
    anchors: np.ndarray
    scales: Tuple[float, float, float, float]    # (y, x, h, w)
    nms_score_threshold: float
    nms_iou_threshold: float
    max_detections: int
    max_classes_per_detection: int
    detections_per_class: int
    use_regular_nms: bool
    num_classes: int


def read_tflite_postprocess(model_path: str) -> Optional[DetectionPostProcess]:
    """The TFLite_Detection_PostProcess op of a flatbuffer (its constant
    anchor table and its flexbuffer options), or None when the model ends
    in raw head tensors instead."""
    model = tflite_meta.read_model(model_path)
    for op in model.operators:
        oc = model.opcodes[op.opcode_index]
        if oc.code != CUSTOM_OP_CODE or oc.custom_code is None \
                or oc.custom_code.decode() != DETECTION_POSTPROCESS:
            continue
        if len(op.inputs) < 3:
            raise ValueError(f"{DETECTION_POSTPROCESS} op has "
                             f"{len(op.inputs)} inputs; expected "
                             "(box_encodings, class_predictions, anchors)")
        at = model.tensors[op.inputs[2]]
        raw = model.buffers[at.buffer]
        if raw is None:
            raise ValueError(f"{DETECTION_POSTPROCESS} anchors tensor "
                             f"{at.name!r} is not constant")
        anchors = np.frombuffer(raw, dtype=_TENSOR_NP.get(at.type))
        anchors = _dequant(at, anchors.reshape(at.shape))
        anchors = np.asarray(anchors, np.float32)
        if anchors.ndim != 2 or anchors.shape[1] != 4:
            raise ValueError(f"anchor tensor has shape {anchors.shape}; "
                             "expected (A, 4)")
        if not op.custom_options:
            raise ValueError(f"{DETECTION_POSTPROCESS} op carries no "
                             "flexbuffer options")
        opts = tflite_meta.loads_flexbuffer_map(op.custom_options)
        missing = [k for k in ("num_classes", "y_scale", "x_scale",
                               "h_scale", "w_scale") if k not in opts]
        if missing:
            raise ValueError(f"{DETECTION_POSTPROCESS} options missing "
                             f"required keys {missing}: {sorted(opts)}")
        return DetectionPostProcess(
            anchors=anchors,
            scales=(float(opts["y_scale"]), float(opts["x_scale"]),
                    float(opts["h_scale"]), float(opts["w_scale"])),
            nms_score_threshold=float(opts.get("nms_score_threshold", 0.0)),
            nms_iou_threshold=float(opts.get("nms_iou_threshold", 0.6)),
            max_detections=int(opts.get("max_detections", 10)),
            max_classes_per_detection=int(
                opts.get("max_classes_per_detection", 1)),
            detections_per_class=int(opts.get("detections_per_class", 100)),
            use_regular_nms=bool(opts.get("use_regular_nms", False)),
            num_classes=int(opts["num_classes"]))
    return None


# ------------------------------------------------------------ binding

def _tflite_kernel_to_flax(kind: str, kern: np.ndarray) -> np.ndarray:
    if kind == "conv":          # (O, kh, kw, I) -> (kh, kw, I, O)
        return np.transpose(kern, (1, 2, 3, 0))
    if kind == "dw":            # (1, kh, kw, C) -> (kh, kw, 1, C)
        return np.transpose(kern, (1, 2, 0, 3))
    if kind == "dense":         # (O, I) -> (I, O)
        return np.transpose(kern, (1, 0))
    raise ValueError(kind)


def _bind_by_structure(slots: Sequence[Slot],
                       ops: Sequence[TFLiteConvOp]) -> Dict[int, int]:
    """op stream index -> slot index for every weight-bearing op.

    Ops and slots are grouped by (kind, flax kernel shape). Within a
    group the TFLite converter's emission order is NOT reliable: it emits
    parallel branches in its own order (SSD heads come out in reverse
    level order; C3's cv1/cv2 swap inconsistently), so both sides of each
    group are sorted by their structural signatures (identical values on
    both sides of a correct correspondence) and paired by rank. Members
    with equal signatures (identical-block chains, truly symmetric
    branches) keep their own side's order: chains are data-dependent so
    the converter cannot reorder them, and symmetric branches are
    structurally indistinguishable by definition. When signatures are
    unavailable on either side, falls back to producer-depth order."""
    slot_groups: Dict[tuple, List[int]] = {}
    for si, slot in enumerate(slots):
        if slot.kind in ("conv", "dw", "dense"):
            slot_groups.setdefault((slot.kind, slot.kernel_shape),
                                   []).append(si)
    op_groups: Dict[tuple, List[int]] = {}
    for i, op in enumerate(ops):
        if op.kind in ("conv", "dw", "dense"):
            key = (op.kind,
                   tuple(_tflite_kernel_to_flax(op.kind, op.kernel).shape))
            op_groups.setdefault(key, []).append(i)

    bind: Dict[int, int] = {}
    for key, oidxs in op_groups.items():
        sidxs = slot_groups.get(key, [])
        if not sidxs:
            continue
        if all(ops[i].sig for i in oidxs) and \
                all(slots[si].sig for si in sidxs):
            o_sorted = sorted(range(len(oidxs)),
                              key=lambda r: (ops[oidxs[r]].sig, r))
            s_sorted = sorted(range(len(sidxs)),
                              key=lambda r: (slots[sidxs[r]].sig, r))
        else:
            o_sorted = sorted(range(len(oidxs)),
                              key=lambda r: (ops[oidxs[r]].depth, r))
            s_sorted = list(range(len(sidxs)))
        for k in range(min(len(oidxs), len(sidxs))):
            bind[oidxs[o_sorted[k]]] = sidxs[s_sorted[k]]
    return bind


def _write_bn_affine(flat: Flat, slot: Slot, mul: np.ndarray,
                     add: np.ndarray) -> None:
    """Store the affine y = x * mul + add in batch-norm form. With a scale:
    scale = mul, mean = 0, var = 1 - eps. Without one (slim's center-only
    batch norm) mul is encoded in the variance, var = mul^-2 - eps, so
    that 1 / sqrt(var + eps) = mul."""
    bn = slot.bn_path
    c = slot.kernel_shape[0]
    mul = np.broadcast_to(mul, (c,)).astype(np.float32)
    add = np.broadcast_to(add, (c,)).astype(np.float32)
    if slot.bn_has_scale:
        _set_leaf(flat, "params", bn + ("scale",), mul)
        var = np.full(c, 1.0 - slot.bn_eps, np.float32)
    else:
        if np.any(mul <= 0):
            raise ValueError(f"BN slot {slot}: non-positive MUL const "
                             "cannot be encoded without a scale param")
        var = (1.0 / np.square(mul)) - slot.bn_eps
    if slot.bn_has_bias:
        _set_leaf(flat, "params", bn + ("bias",), add)
    _set_leaf(flat, "batch_stats", bn + ("mean",), np.zeros(c, np.float32))
    _set_leaf(flat, "batch_stats", bn + ("var",), var.astype(np.float32))


def _bn_slot_of(slot: Slot, c: int) -> Slot:
    return Slot("bn", slot.bn_path, (c,), False, bn_path=slot.bn_path,
                bn_eps=slot.bn_eps, bn_has_scale=slot.bn_has_scale,
                bn_has_bias=slot.bn_has_bias)


def assign_slots(slots: Sequence[Slot], ops: Sequence[TFLiteConvOp],
                 flat: Flat, strict: bool = True):
    """Bind TFLite ops (graph order) onto slots (execution order), filling
    a copy of the flat variables `flat`. Returns (flat, report).

    Weight-bearing ops bind through `_bind_by_structure`. Standalone batch
    norm slots (kind 'bn', MARS's pre-activation batch norms) consume a
    constant MUL followed by a constant ADD of their channel width, what
    the TFLite converter lowers an unfoldable batch norm to. A conv's
    own batch norm left unfolded as MUL + ADD right after it is consumed
    into that batch norm. Raises on unfilled slots or unmatched ops when
    strict."""
    flat = dict(flat)
    taken = [False] * len(slots)

    def _find(kind, shape):
        for si, slot in enumerate(slots):
            if not taken[si] and slot.kind == kind \
                    and slot.kernel_shape == shape:
                return si
        return None

    unused: List[str] = []
    ignored_affine: List[str] = []
    pending_mul: Optional[TFLiteConvOp] = None
    bind = _bind_by_structure(slots, ops)
    i = 0
    while i < len(ops):
        op = ops[i]
        i += 1
        if op.kind == "mul":
            if pending_mul is not None:
                ignored_affine.append(f"mul {pending_mul.out_name}")
            pending_mul = op
            continue
        if op.kind == "add":
            if pending_mul is None:
                continue   # residual/other add — not a BN remnant
            c = max(pending_mul.kernel.shape[0], op.kernel.shape[0])
            hit = _find("bn", (c,))
            if hit is None:
                # const MUL/ADD pairs also occur in decode heads (anchor
                # grids); only unfilled 'bn' slots are an error, not these
                ignored_affine.append(f"affine {op.out_name} ({c},)")
            else:
                taken[hit] = True
                _write_bn_affine(flat, slots[hit], pending_mul.kernel,
                                 op.kernel)
            pending_mul = None
            continue
        if pending_mul is not None:
            # a weight-bearing op between MUL and ADD means that MUL was
            # not half of a BN remnant — never pair it across this op
            ignored_affine.append(f"mul {pending_mul.out_name}")
            pending_mul = None
        kern = _tflite_kernel_to_flax(op.kind, op.kernel)
        hit = bind.get(i - 1)
        if hit is None or taken[hit]:
            unused.append(f"{op.kind} {op.out_name} kernel{kern.shape}")
            continue
        slot = slots[hit]
        taken[hit] = True
        _set_leaf(flat, "params", slot.path + ("kernel",),
                  kern.astype(np.float32))
        bias = op.bias
        out_c = slot.kernel_shape[-1]

        # Some converters leave an attached BN unfolded as const MUL+ADD
        # right after the conv; consume the pair into the slot's BN (with
        # or without a conv bias). A non-empty bias usually means the BN
        # was already folded into it; then a following pair belongs to a
        # STANDALONE BN slot (MARS's fc1_bn folded + the 'ball' BN right
        # after), so only claim it when no standalone slot of this width
        # is still waiting.
        unfolded = None
        if (slot.bn_path is not None
                and i + 1 < len(ops)
                and ops[i].kind == "mul" and ops[i + 1].kind == "add"
                and max(ops[i].kernel.shape[0],
                        ops[i + 1].kernel.shape[0]) == out_c
                and (bias is None or not np.any(bias)
                     or _find("bn", (out_c,)) is None)):
            unfolded = (ops[i].kernel, ops[i + 1].kernel)
            i += 2

        if slot.has_bias:
            b = bias if bias is not None else np.zeros(out_c, np.float32)
            _set_leaf(flat, "params", slot.path + ("bias",),
                      b.astype(np.float32))
            if slot.bn_path is not None:
                if unfolded is not None:
                    _write_bn_affine(flat, _bn_slot_of(slot, out_c),
                                     unfolded[0], unfolded[1])
                else:   # bias took the fold; identity BN
                    _write_identity_bn(flat, slot, None)
        elif slot.bn_path is not None:
            if unfolded is not None:
                _write_bn_affine(flat, _bn_slot_of(slot, out_c),
                                 unfolded[0],
                                 unfolded[1] + (bias * unfolded[0]
                                                if bias is not None
                                                else 0.0))
            else:
                _write_identity_bn(flat, slot, bias)
        elif bias is not None and np.any(bias):
            raise ValueError(
                f"TFLite op {op.out_name} carries a non-zero bias but slot "
                f"{slot} has neither bias nor BN to receive it")

    missing = [repr(s) for s, t in zip(slots, taken) if not t]
    report = {"assigned": int(sum(taken)), "total": len(slots),
              "missing": missing, "unused_ops": unused,
              "ignored_affine": ignored_affine}
    if strict and (missing or unused):
        raise ValueError(
            f"structural conversion incomplete: {len(missing)} unfilled "
            f"slots {missing[:8]}..., {len(unused)} unmatched ops "
            f"{unused[:8]}...")
    return flat, report


def convert_tflite(net, example_shape, model_path: str, strict: bool = True,
                   naming=None):
    """Trace `net` (`trace_slots`), read the flatbuffer, assign. Returns
    (flat flax variables, report)."""
    flat, slots = trace_slots(net, example_shape, naming)
    ops, _ = read_tflite(model_path)
    return assign_slots(slots, ops, flat, strict=strict)


def fold_slots_to_ops(flat: Flat, slots: Sequence[Slot]):
    """Inverse of assign_slots: the TFLite-style op stream (batch norms
    folded into conv kernels and biases, standalone ones as constant MUL +
    ADD) a converter would produce from the flat variables `flat`. Used
    by round-trip tests and as a reference for the folding arithmetic."""
    def bn_affine(slot):
        bn = "/".join(slot.bn_path)
        mean = flat[f"batch_stats/{bn}/mean"]
        var = flat[f"batch_stats/{bn}/var"]
        scale = flat.get(f"params/{bn}/scale",
                         np.ones_like(mean)) if slot.bn_has_scale \
            else np.ones_like(mean)
        beta = flat.get(f"params/{bn}/bias",
                        np.zeros_like(mean)) if slot.bn_has_bias \
            else np.zeros_like(mean)
        mul = scale / np.sqrt(var + slot.bn_eps)
        return mul.astype(np.float32), (beta - mean * mul).astype(np.float32)

    ops: List[TFLiteConvOp] = []
    for slot in slots:
        if slot.kind == "bn":
            mul, add = bn_affine(slot)
            ops.append(TFLiteConvOp("mul", "/".join(slot.path) + ":mul",
                                    mul, None))
            ops.append(TFLiteConvOp("add", "/".join(slot.path) + ":add",
                                    add, None))
            continue
        p = "/".join(slot.path)
        kern = flat[f"params/{p}/kernel"].astype(np.float32)
        bias = (flat[f"params/{p}/bias"].astype(np.float32)
                if slot.has_bias else None)
        if slot.bn_path is not None:
            mul, add = bn_affine(slot)
            kern = kern * mul          # flax layouts put out-channels last
            bias = (bias * mul + add) if bias is not None else add
        # flax -> TFLite layout
        if slot.kind == "conv":
            kern = np.transpose(kern, (3, 0, 1, 2))
        elif slot.kind == "dw":
            kern = np.transpose(kern, (2, 0, 1, 3))
        else:
            kern = np.transpose(kern, (1, 0))
        ops.append(TFLiteConvOp(slot.kind, p, kern, bias))
    return ops


# ------------------------------------------------------------ Keras HDF5

def read_keras_h5(path: str):
    """Ordered (layer name, {weight name: array}) list from a Keras HDF5
    weights file (the format of the reference's yolo.h5,
    tools/yolo.py:186). Needs h5py."""
    import h5py

    def decode(x):
        return x.decode() if isinstance(x, bytes) else str(x)

    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        layer_names = [decode(n) for n in g.attrs["layer_names"]]
        out = []
        for ln in layer_names:
            lg = g[ln]
            wnames = [decode(n) for n in lg.attrs.get("weight_names", [])]
            if not wnames:
                continue
            weights = {}
            for wn in wnames:
                node = lg
                for part in wn.split("/"):
                    node = node[part]
                leaf = wn.split("/")[-1].split(":")[0]
                weights[leaf] = np.asarray(node)
            out.append((ln, weights))
    return out


def convert_keras_h5(net, example_shape, path: str, strict: bool = True,
                     naming=None):
    """Structural conversion of a Keras HDF5 file (conv and batch-norm
    layers in creation order, which keras-yolo3 builds in network order)
    onto a port network. Batch norms are not folded in .h5 files, so
    gamma, beta and the moving statistics map directly. Returns (flat
    flax variables, report)."""
    layers = read_keras_h5(path)
    flat, slots = trace_slots(net, example_shape, naming)
    flat = dict(flat)

    # the h5 layers as an op stream: conv -> optional bn
    ops = []
    for name, wts in layers:
        if "kernel" in wts:
            kern = wts["kernel"]
            kind = ("dw" if "depthwise" in name.lower() else
                    ("dense" if kern.ndim == 2 else "conv"))
            ops.append(("convlike", kind, name, kern, wts.get("bias")))
        elif "depthwise_kernel" in wts:
            ops.append(("convlike", "dw", name, wts["depthwise_kernel"],
                        wts.get("bias")))
        elif "moving_mean" in wts:
            ops.append(("bn", None, name,
                        (wts.get("gamma"), wts.get("beta"),
                         wts["moving_mean"], wts["moving_variance"]), None))

    taken = [False] * len(slots)
    missing_bn = []
    i = 0
    while i < len(ops):
        tag, kind, name, payload, bias = ops[i]
        if tag != "convlike":
            i += 1
            continue
        kern = np.asarray(payload, np.float32)   # keras HWIO == flax HWIO
        hit = None
        for si, slot in enumerate(slots):
            if taken[si] or slot.kind != kind:
                continue
            if tuple(kern.shape) == slot.kernel_shape:
                hit = si
                break
        if hit is None:
            if strict:
                raise ValueError(f"h5 layer {name} kernel{kern.shape} has "
                                 "no matching slot")
            i += 1
            continue
        slot = slots[hit]
        taken[hit] = True
        _set_leaf(flat, "params", slot.path + ("kernel",), kern)
        if slot.has_bias:
            b = (np.asarray(bias, np.float32) if bias is not None
                 else np.zeros(slot.kernel_shape[-1], np.float32))
            _set_leaf(flat, "params", slot.path + ("bias",), b)
        if slot.bn_path is not None:
            if i + 1 < len(ops) and ops[i + 1][0] == "bn":
                gamma, beta, mean, var = ops[i + 1][3]
                c = slot.kernel_shape[-1]
                if slot.bn_has_scale:
                    g = (gamma if gamma is not None
                         else np.ones(c, np.float32))
                    _set_leaf(flat, "params", slot.bn_path + ("scale",),
                              np.asarray(g, np.float32))
                if slot.bn_has_bias:
                    b = beta if beta is not None else np.zeros(c, np.float32)
                    _set_leaf(flat, "params", slot.bn_path + ("bias",),
                              np.asarray(b, np.float32))
                _set_leaf(flat, "batch_stats", slot.bn_path + ("mean",),
                          np.asarray(mean, np.float32))
                _set_leaf(flat, "batch_stats", slot.bn_path + ("var",),
                          np.asarray(var, np.float32))
                i += 1
            else:
                missing_bn.append("/".join(slot.bn_path))
        i += 1

    missing = [repr(s) for s, t in zip(slots, taken) if not t]
    report = {"assigned": int(sum(taken)), "total": len(slots),
              "missing": missing, "missing_bn": missing_bn}
    if strict and (missing or missing_bn):
        raise ValueError(f"h5 conversion incomplete: missing={missing[:8]} "
                         f"missing_bn={missing_bn[:8]}")
    return flat, report


# ------------------------------------------------------------ family loaders

def _attach_postprocess(model_path: str, report: dict,
                        our_anchors: Optional[np.ndarray]) -> dict:
    """Record the flatbuffer's fused-postprocess parameters in the report
    and cross-check our generated anchor table against the embedded one.
    The embedded anchors are authoritative (the kernel decodes against
    them); detectors configured from this report use them directly, so a
    mismatch is diagnostic, not fatal."""
    pp = read_tflite_postprocess(model_path)
    if pp is None:
        return report
    report["postprocess"] = pp
    if our_anchors is not None:
        ours = np.asarray(our_anchors, np.float32)
        if ours.shape == pp.anchors.shape:
            report["anchors_max_abs_diff"] = float(
                np.abs(ours - pp.anchors).max())
            report["anchors_verified"] = bool(
                report["anchors_max_abs_diff"] < 1e-3)
        else:
            report["anchors_verified"] = False
            report["anchors_shape_ours"] = tuple(ours.shape)
            report["anchors_shape_embedded"] = tuple(pp.anchors.shape)
    return report


def _meta_net(cls, *args):
    with torch.device("meta"):
        return cls(*args)


def load_ssd_mobilenet_tflite(model_path: str):
    """An SSD-MobileNetV1 .tflite -> (flat variables, report with the
    postprocess op and its anchor check when the file ends in one)."""
    from .ssd_mobilenet import INPUT_SIZE, SSDMobileNetV1, generate_anchors
    flat, report = convert_tflite(_meta_net(SSDMobileNetV1),
                                  (1, INPUT_SIZE, INPUT_SIZE, 3), model_path)
    return flat, _attach_postprocess(model_path, report, generate_anchors())


def load_yolov5_tflite(model_path: str, input_size: int = None):
    from .yolov5 import INPUT_SIZE, YOLOv5s
    size = input_size or INPUT_SIZE
    return convert_tflite(_meta_net(YOLOv5s), (1, size, size, 3), model_path)


def load_efficientdet_tflite(model_path: str):
    """An EfficientDet-Lite0 .tflite -> (flat variables, report). Its
    postprocess op's anchors are in normalized units, compared with the
    generated pixel anchors divided by the input size."""
    from .efficientdet import INPUT_SIZE, EfficientDetLite0, generate_anchors
    flat, report = convert_tflite(_meta_net(EfficientDetLite0),
                                  (1, INPUT_SIZE, INPUT_SIZE, 3), model_path)
    return flat, _attach_postprocess(
        model_path, report, generate_anchors() / float(INPUT_SIZE))


def load_yolov3_h5(model_path: str, input_size: int = None):
    from .yolov3 import INPUT_SIZE, YOLOv3
    size = input_size or INPUT_SIZE
    return convert_keras_h5(_meta_net(YOLOv3), (1, size, size, 3),
                            model_path)


# ------------------------------------------------------------ converter CLI

def main(argv=None):
    """`python -m deepdish_tpu_torch.models.convert ARTIFACT [-o OUT.npz]`

    Converts a pre-trained artifact (.tflite / .h5 / .pb / TF checkpoint)
    into the flat flax variables of the JAX package's parameter tree and
    saves them as .npz (what `--model X.npz` and `--encoder-model X.npz`
    load), printing the structural-assignment report. The family is
    inferred from the filename the same way the runtime does (--family
    overrides). The trace runs on the CPU."""
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("artifact", help=".tflite/.h5/.pb/.ckpt weight file")
    ap.add_argument("-o", "--out", default=None, help="output .npz path")
    ap.add_argument("--family", default=None,
                    choices=["ssd", "yolov5", "yolov3", "efficientdet",
                             "mars"],
                    help="model family (default: infer from filename)")
    args = ap.parse_args(argv)

    name = os.path.basename(args.artifact).lower()
    family = args.family or (
        "yolov5" if "yolov5" in name else
        "yolov3" if "yolo" in name else
        "mars" if "mars" in name or name.endswith(".pb")
        or ".ckpt" in name else
        "efficientdet" if "efficientdet" in name else "ssd")

    loaders = {
        "ssd": load_ssd_mobilenet_tflite,
        "yolov5": load_yolov5_tflite,
        "efficientdet": load_efficientdet_tflite,
        "yolov3": load_yolov3_h5,
        "mars": load_mars,
    }
    flat, report = loaders[family](args.artifact)
    print(_json.dumps({"family": family,
                       "assigned": report.get("assigned"),
                       "total": report.get("total"),
                       "missing": report.get("missing", [])[:5],
                       "unused_ops": report.get("unused_ops", [])[:5]},
                      indent=2))
    out = args.out or os.path.splitext(args.artifact)[0] + ".npz"
    w.save_npz(flat, out)
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
