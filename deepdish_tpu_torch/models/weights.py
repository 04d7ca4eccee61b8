"""Weight persistence (.npz flat trees) and the flax -> PyTorch bridge.

`_flatten`, `_unflatten` and `load_npz` are copies of
deepdish_tpu/models/weights.py: the common format is a flat dict of numpy
arrays keyed "params/<module>/.../<leaf>" and "batch_stats/...", which is
what `deepdish_tpu.models.weights.save_npz` writes (for instance after
converting real weights with deepdish_tpu/models/convert.py).

`ssd_from_flax`, `mars_from_flax`, `yolov5_from_flax`, `yolov3_from_flax`,
`efficientdet_from_flax` and `faster_rcnn_from_flax` turn such a flat dict
of the JAX package's variables into the port module's `state_dict`:
  * conv kernels HWIO (kh, kw, in/groups, out) -> OIHW (out, in/groups,
    kh, kw); the depthwise (3, 3, 1, C) becomes (C, 1, 3, 3);
  * dense kernels (in, out) -> Linear weights (out, in);
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
    MARS's slim batch norms learn no scale, so their weight is ones;
  * flax's auto-named children (Conv_0, BatchNorm_0, ConvBlock_<k>, ...)
    become the port modules' attribute names, one rename per family.

The other way, `FlaxNaming` (one per network class, `NAMINGS`) maps each
port module's convs, dense layers and batch norms to the JAX package's
flax paths: `*_to_flax_template` gives the zeros of the JAX package's
`_flatten(net.init(...))` (its keys and shapes), `to_flax` a network's
weights in that form, and models/convert.py's `trace_slots` the flax path
of each module that a forward pass calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .layers import BatchNorm

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict = {}
    for path, arr in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def load_npz(path: str):
    """Load a variable tree saved as a flat .npz."""
    with np.load(path) as f:
        return _unflatten({k: f[k] for k in f.files})


def save_npz(flat: Dict[str, np.ndarray], path: str) -> None:
    """Write flat flax variables as the .npz that the JAX package's
    `save_npz` writes (compressed, one array per "<collection>/<path>"
    key)."""
    np.savez_compressed(path, **flat)


def _from_flax(flat: Dict[str, np.ndarray], rename: Dict[str, str]
               ) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        _collection, *path = key.split("/")
        *mods, leaf = path
        mods = [rename.get(m, m) for m in mods]
        name = ".".join([m for m in mods if m] + [_LEAF[leaf]])
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "kernel":
            t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
        sd[name] = t.contiguous()
    for name in [n for n in sd if n.endswith(".running_mean")]:
        weight = name[:-len("running_mean")] + "weight"
        if weight not in sd:
            sd[weight] = torch.ones_like(sd[name])
    return sd


def _renamer(table: Dict[str, str], only_in: Tuple[str, ...] = ()):
    """A flax-naming rule for `flax_names`: a port child named `k` is the
    flax child `table[k]` (inside modules of the classes `only_in` when
    given); a ModuleList adds no level and its i-th child is flax's
    auto-named `<Class>_<i>` (YOLOv5's `m.<i>` -> Bottleneck_<i>, YOLOv3's
    `convs.<k>` -> ConvBN_<k>)."""
    def rename(parent: nn.Module, child: str, module: nn.Module) -> str:
        if isinstance(module, nn.ModuleList):
            return ""
        if isinstance(parent, nn.ModuleList):
            return f"{type(module).__name__}_{child}"
        if only_in and type(parent).__name__ not in only_in:
            return child
        return table.get(child, child)
    return rename


@dataclass(frozen=True)
class FlaxNaming:
    """How a port module's names map to the JAX package's flax paths:
    `rename(parent, child_name, child)` gives each child's flax name ("":
    no level), `bn_child` is the flax child that holds each batch norm's
    variables (MARS's "BatchNorm_0"), and `bn_scale=False` marks batch
    norms that learn no scale (MARS's slim batch norms)."""
    rename: Callable[[nn.Module, str, nn.Module], str]
    bn_child: str = ""
    bn_scale: bool = True

    def paths(self, module: nn.Module) -> Dict[str, Tuple[str, ...]]:
        """Port dotted name -> flax module path of every nn.Conv2d,
        nn.Linear and BatchNorm in `module` (a batch norm's with
        `bn_child` appended)."""
        flax = {"": ()}
        out: Dict[str, Tuple[str, ...]] = {}
        for name, m in module.named_modules():
            if not name:
                continue
            parent, _, child = name.rpartition(".")
            seg = self.rename(module.get_submodule(parent), child, m)
            flax[name] = flax[parent] + ((seg,) if seg else ())
            if isinstance(m, BatchNorm):
                out[name] = flax[name] + ((self.bn_child,) if self.bn_child
                                          else ())
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                out[name] = flax[name]
        return out


def _to_flax(module: nn.Module, naming: FlaxNaming, zeros: bool
             ) -> Dict[str, np.ndarray]:
    """The inverse of `_from_flax`: `module`'s convs, dense layers and batch
    norms as a flat dict of flax variables ("params/<path>/kernel", ...,
    "batch_stats/<path>/mean"), in flax layout, the paths given by
    `naming`; zeros of the right shapes when `zeros` (the module may then
    live on the meta device)."""
    def arr(t, perm=None):
        shape = tuple(t.shape[i] for i in perm) if perm else tuple(t.shape)
        if zeros:
            return np.zeros(shape, np.float32)
        t = t.detach().float().cpu()
        return (t.permute(*perm) if perm else t).contiguous().numpy()

    out: Dict[str, np.ndarray] = {}
    for name, path in naming.paths(module).items():
        m = module.get_submodule(name)
        path = "/".join(path)
        if isinstance(m, nn.Conv2d):
            out[f"params/{path}/kernel"] = arr(m.weight, (2, 3, 1, 0))
        elif isinstance(m, nn.Linear):
            out[f"params/{path}/kernel"] = arr(m.weight, (1, 0))
        else:
            if naming.bn_scale:
                out[f"params/{path}/scale"] = arr(m.weight)
            out[f"params/{path}/bias"] = arr(m.bias)
            out[f"batch_stats/{path}/mean"] = arr(m.running_mean)
            out[f"batch_stats/{path}/var"] = arr(m.running_var)
            continue
        if m.bias is not None:
            out[f"params/{path}/bias"] = arr(m.bias)
    return out


_CONV_BN = {"Conv_0": "conv", "BatchNorm_0": "bn"}
_CONV_BN_INV = {v: k for k, v in _CONV_BN.items()}


def ssd_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables of deepdish_tpu's SSDMobileNetV1 -> the
    state_dict of models.ssd_mobilenet.SSDMobileNetV1."""
    return _from_flax(flat, _CONV_BN)


def mars_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables of deepdish_tpu's MarsNet -> the state_dict of
    models.mars.MarsNet."""
    return _from_flax(flat, {"BatchNorm_0": ""})


def yolov5_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables of deepdish_tpu's YOLOv5s -> the state_dict of
    models.yolov5.YOLOv5s (ConvBlock_0/1/2 -> cv1/cv2/cv3, Bottleneck_<i>
    -> m.<i>)."""
    rename = dict(_CONV_BN, ConvBlock_0="cv1", ConvBlock_1="cv2",
                  ConvBlock_2="cv3")
    rename.update({f"Bottleneck_{i}": f"m.{i}" for i in range(8)})
    return _from_flax(flat, rename)


def yolov3_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables of deepdish_tpu's YOLOv3 -> the state_dict of
    models.yolov3.YOLOv3 (ConvBN_<k> -> convs.<k>)."""
    rename = dict(_CONV_BN)
    rename.update({f"ConvBN_{k}": f"convs.{k}" for k in range(6)})
    return _from_flax(flat, rename)


def efficientdet_from_flax(flat: Dict[str, np.ndarray]
                           ) -> Dict[str, torch.Tensor]:
    """Flat flax variables of deepdish_tpu's EfficientDetLite0 -> the
    state_dict of models.efficientdet.EfficientDetLite0."""
    return _from_flax(flat, _CONV_BN)


def faster_rcnn_from_flax(flat: Dict[str, np.ndarray]
                          ) -> Dict[str, torch.Tensor]:
    """Flat flax variables of deepdish_tpu's FasterRCNNNet -> the
    state_dict of models.faster_rcnn.FasterRCNNNet (same module names)."""
    return _from_flax(flat, {})


SSD_NAMING = FlaxNaming(_renamer(_CONV_BN_INV))
MARS_NAMING = FlaxNaming(_renamer({}), bn_child="BatchNorm_0",
                         bn_scale=False)
YOLOV5_NAMING = FlaxNaming(_renamer(dict(
    _CONV_BN_INV, cv1="ConvBlock_0", cv2="ConvBlock_1", cv3="ConvBlock_2")))
YOLOV3_NAMING = FlaxNaming(_renamer(_CONV_BN_INV))
# only _ConvBN's children are flax's auto-named Conv_0 / BatchNorm_0; the
# BiFPN's and heads' separable convs name their batch norm "bn"
EFFICIENTDET_NAMING = FlaxNaming(_renamer(_CONV_BN_INV, only_in=("_ConvBN",)))
FASTER_RCNN_NAMING = FlaxNaming(_renamer({}))

#: port network class name -> its FlaxNaming
NAMINGS = {"SSDMobileNetV1": SSD_NAMING, "MarsNet": MARS_NAMING,
           "YOLOv5s": YOLOV5_NAMING, "YOLOv3": YOLOV3_NAMING,
           "EfficientDetLite0": EFFICIENTDET_NAMING,
           "FasterRCNNNet": FASTER_RCNN_NAMING}


def ssd_to_flax_template(module: nn.Module) -> Dict[str, np.ndarray]:
    """Zeros in the flax layout of an SSDMobileNetV1."""
    return _to_flax(module, SSD_NAMING, zeros=True)


def mars_to_flax_template(module: nn.Module) -> Dict[str, np.ndarray]:
    """Zeros in the flax layout of a MarsNet (slim batch norms: a
    BatchNorm_0 child, no scale)."""
    return _to_flax(module, MARS_NAMING, zeros=True)


def yolov5_to_flax_template(module: nn.Module) -> Dict[str, np.ndarray]:
    """Zeros in the flax layout of a YOLOv5s."""
    return _to_flax(module, YOLOV5_NAMING, zeros=True)


def yolov3_to_flax_template(module: nn.Module) -> Dict[str, np.ndarray]:
    """Zeros in the flax layout of a YOLOv3."""
    return _to_flax(module, YOLOV3_NAMING, zeros=True)


def efficientdet_to_flax_template(module: nn.Module
                                  ) -> Dict[str, np.ndarray]:
    """Zeros in the flax layout of an EfficientDetLite0."""
    return _to_flax(module, EFFICIENTDET_NAMING, zeros=True)


def faster_rcnn_to_flax_template(module: nn.Module
                                 ) -> Dict[str, np.ndarray]:
    """Zeros in the flax layout of a FasterRCNNNet."""
    return _to_flax(module, FASTER_RCNN_NAMING, zeros=True)


def to_flax(module: nn.Module) -> Dict[str, np.ndarray]:
    """A port network's weights as flat flax variables (float32), named by
    its class's entry in NAMINGS: the inverse of the `*_from_flax`
    bridges."""
    return _to_flax(module, NAMINGS[type(module).__name__], zeros=False)


def faster_rcnn_to_flax(module: nn.Module) -> Dict[str, np.ndarray]:
    """A FasterRCNNNet's weights as flat flax variables (float32)."""
    return _to_flax(module, FASTER_RCNN_NAMING, zeros=False)


def _q_from_jax(qparams, base_from_flax) -> Dict:
    """The JAX package's quantize_mars / quantize_ssd qparams -> the port's
    (models/mars_q.py, models/ssd_q.py): the pruned float tree as a
    state_dict (pruned kernels stay empty), and the int8 kernels (HWIO /
    (in, out)), scales, activation scales and the 1x1 corrections as
    numpy, keyed by the same flax paths."""
    out = {"base": base_from_flax(_flatten(qparams["base"]))}
    for k in ("wq", "wscale", "corr"):
        if k in qparams:
            out[k] = {p: np.asarray(v) for p, v in qparams[k].items()}
    out["ascale"] = {p: np.float32(v) for p, v in qparams["ascale"].items()}
    if "layers" in qparams:
        out["layers"] = {p: tuple(v) for p, v in qparams["layers"].items()}
    return out


def mars_q_from_jax(qparams) -> Dict:
    """deepdish_tpu.models.mars_q.quantize_mars output -> the port's
    mars_q qparams (for `make_mars_int8_encoder(qparams=...)`)."""
    return _q_from_jax(qparams, mars_from_flax)


def ssd_q_from_jax(qparams) -> Dict:
    """deepdish_tpu.models.ssd_q.quantize_ssd output -> the port's ssd_q
    qparams (for `SSDMobileNetInt8Detector(qparams=...)`)."""
    return _q_from_jax(qparams, ssd_from_flax)
