"""Appearance encoders: MARS, plus the weightless dummy and constant fakes.

Port of deepdish_tpu/models/encoders.py. The reference picks its encoder by
filename substring (tools/generate_detections.py:180-189); 'dummy' and
'constant' are its weightless fakes (:86-116), which let the whole pipeline
run without model files.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from ..device import resolve_device
from .layers import flax_default_init_
from .mars import FEATURE_DIM, INPUT_SHAPE, MarsNet
from .preprocess import crop_resize_patches_mxu, default_compute_dtype


class EncoderSpec:
    """Uniform encoder interface: image_shape (H, W, C), feature_dim,
    `apply(patches) -> (N, feature_dim)` and `encode_boxes(image,
    boxes_tlwh, valid)` (crop-resize + forward). The crops are computed in
    `compute_dtype`, the network's own."""

    def __init__(self, image_shape, feature_dim,
                 apply_fn: Callable[[torch.Tensor], torch.Tensor], device,
                 compute_dtype: torch.dtype = torch.float32):
        self.image_shape = image_shape
        self.height, self.width = image_shape[0], image_shape[1]
        self.feature_dim = feature_dim
        self.device = device
        self.compute_dtype = compute_dtype
        self._apply_fn = apply_fn

    def apply(self, patches: torch.Tensor) -> torch.Tensor:
        return self._apply_fn(patches)

    def encode_boxes(self, image, boxes_tlwh, valid):
        patches, ok = crop_resize_patches_mxu(image, boxes_tlwh, valid,
                                              self.height, self.width,
                                              self.compute_dtype)
        feats = self.apply(patches)
        return torch.where(ok[..., None], feats, torch.zeros_like(feats)), ok


def _dummy_apply(patches):
    """generate_detections.py:86-105: mean over channels, centre at 128,
    L2 normalize; zero-norm rows become e0."""
    mat = patches.float().mean(dim=3)
    mat = mat.reshape(mat.shape[0], -1) - 128.0
    norm = torch.linalg.vector_norm(mat, dim=1, keepdim=True)
    e0 = torch.zeros_like(mat)
    e0[:, 0] = 1.0
    return torch.where(norm == 0.0, e0,
                       mat / torch.where(norm == 0.0,
                                         torch.ones_like(norm), norm))


def _constant_apply(patches):
    """generate_detections.py:107-116: the constant e0 feature."""
    out = torch.zeros((patches.shape[0], FEATURE_DIM), dtype=torch.float32,
                      device=patches.device)
    out[:, 0] = 1.0
    return out


def make_dummy_encoder(device=None) -> EncoderSpec:
    return EncoderSpec((16, 8, 3), FEATURE_DIM, _dummy_apply,
                       resolve_device(device))


def make_constant_encoder(device=None) -> EncoderSpec:
    return EncoderSpec((16, 8, 3), FEATURE_DIM, _constant_apply,
                       resolve_device(device))


def make_mars_encoder(state_dict=None,
                      compute_dtype: Optional[torch.dtype] = None,
                      device=None,
                      generator: Optional[torch.Generator] = None
                      ) -> EncoderSpec:
    """MARS CNN encoder on `device` (default CUDA). Without `state_dict`
    (e.g. from `models.weights.mars_from_flax`) the weights are random,
    drawn like flax's defaults from `generator` (a CPU generator; default
    seeded with 0)."""
    dev = resolve_device(device)
    net = MarsNet()
    if state_dict is not None:
        net.load_state_dict(state_dict)
    else:
        flax_default_init_(net, generator if generator is not None
                           else torch.Generator().manual_seed(0))
    dtype = (compute_dtype if compute_dtype is not None
             else default_compute_dtype(dev))
    net = net.to(dev, dtype).eval()
    net.requires_grad_(False)
    return EncoderSpec(INPUT_SHAPE, FEATURE_DIM, net, dev, dtype)


def create_box_encoder(model_name: str, state_dict=None, device=None,
                       **kw) -> EncoderSpec:
    """Filename-substring dispatch (generate_detections.py:180-189):
    'dummy', 'constant', else MARS. MARS weights load from a flat .npz of
    the JAX package's variables (models/weights.py), a .tflite
    (structural conversion), a frozen .pb or a TF checkpoint (name map;
    these two need tensorflow), all through models/convert.py `load_mars`.
    A full-integer .tflite, which the JAX package runs on its integer
    datapath (models/qgraph.py), raises NotImplementedError until that is
    ported (ROADMAP.md §1 item 8): it never runs on dequantized float
    weights. A name that is no file gives random weights, as in the JAX
    package."""
    name = model_name or ""
    if "dummy" in name:
        return make_dummy_encoder(device)
    if "constant" in name:
        return make_constant_encoder(device)
    if state_dict is None and name:
        from . import weights as w
        is_ckpt = ".ckpt" in name and (os.path.exists(name + ".index")
                                       or name.endswith(".index"))
        if name.endswith(".npz") and os.path.exists(name):
            state_dict = w.mars_from_flax(w._flatten(w.load_npz(name)))
        elif is_ckpt or (os.path.exists(name)
                         and name.endswith((".pb", ".tflite"))):
            from .convert import is_full_integer, load_mars
            if name.endswith(".tflite") and is_full_integer(name):
                raise NotImplementedError(
                    f"{name} is a full-integer TFLite encoder, which the "
                    "JAX package runs on its integer datapath "
                    "(models/qgraph.py); that waits for a later slice of "
                    "the port (ROADMAP.md §1 item 8). A float or "
                    "dynamic-range .tflite converts.")
            state_dict = w.mars_from_flax(load_mars(name)[0])
        elif os.path.exists(name):
            raise ValueError(f"{name}: the port loads MARS weights from a "
                             ".npz of the JAX package's variables, a "
                             ".tflite, a frozen .pb or a TF checkpoint")
    return make_mars_encoder(state_dict=state_dict, device=device, **kw)
