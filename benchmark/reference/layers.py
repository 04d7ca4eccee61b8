"""Layers shared by the port's models: TF "SAME" convolutions, inference
batch norm as flax computes it, and flax-default random initialisation.

Flax pads "SAME" asymmetrically at stride 2 (300 -> 150 pads (0, 1),
75 -> 38 pads (1, 1)), which `nn.Conv2d(padding=...)` cannot express, so
`SameConv2d` pads explicitly per call (`same_pad`, the helper of
deepdish_tpu/ops/dsconv_pallas.py:47), and `max_pool_same` pads with -inf
(flax's `nn.max_pool(padding="SAME")`, the EfficientDet BiFPN's and the
Faster R-CNN stem's pool).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_pad(size: int, stride: int, k: int) -> Tuple[int, int]:
    """TF SAME padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """NCHW convolution with TF SAME padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__(cin, cout, kernel, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_pad(x.shape[-2], self.stride[0], self.kernel_size[0])
        pw = same_pad(x.shape[-1], self.stride[1], self.kernel_size[1])
        if any(ph) or any(pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return super().forward(x)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NCHW max pool with flax's SAME padding (-inf, asymmetric)."""
    ph = same_pad(x.shape[-2], stride, kernel)
    pw = same_pad(x.shape[-1], stride, kernel)
    if any(ph) or any(pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class BatchNorm(nn.Module):
    """Inference batch norm over dim 1, computed as flax does:
    (x - mean) * (rsqrt(var + eps) * weight) + bias, eps = 1e-3."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape))


def flax_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights with flax's defaults: lecun_normal kernels (a normal
    of std sqrt(1 / fan_in) / 0.8796, truncated at two stds), zero biases,
    and identity batch norms. Draws from `generator` (a CPU generator), in
    module order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
