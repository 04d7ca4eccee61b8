"""Weight persistence (.npz flat trees) and the flax -> PyTorch bridge.

`_flatten`, `_unflatten` and `load_npz` are copies of
deepdish_tpu/models/weights.py: the common format is a flat dict of numpy
arrays keyed "params/<module>/.../<leaf>" and "batch_stats/...", which is
what `deepdish_tpu.models.weights.save_npz` writes (for instance after
converting real weights with deepdish_tpu/models/convert.py).

`ssd_from_flax`, `mars_from_flax`, `yolov5_from_flax`, `yolov3_from_flax`
and `efficientdet_from_flax` turn such a flat dict of the JAX package's
variables into the port module's `state_dict`:
  * conv kernels HWIO (kh, kw, in/groups, out) -> OIHW (out, in/groups,
    kh, kw); the depthwise (3, 3, 1, C) becomes (C, 1, 3, 3);
  * dense kernels (in, out) -> Linear weights (out, in);
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
    MARS's slim batch norms learn no scale, so their weight is ones;
  * flax's auto-named children (Conv_0, BatchNorm_0, ConvBlock_<k>, ...)
    become the port modules' attribute names, one rename per family.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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


_CONV_BN = {"Conv_0": "conv", "BatchNorm_0": "bn"}


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
