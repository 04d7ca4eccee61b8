"""MARS appearance-descriptor network (cosine-metric-learning CNN).

Port of deepdish_tpu/models/mars.py `MarsNet` (:83), the reference's
TF1-slim network (tools/freeze_model.py:88-157): two 3x3 convs (BN + ELU),
a 3x3/2 VALID max-pool, six residual blocks (32 -> 64 -> 128 channels,
stride-2 projections where the width grows), a 128-unit dense layer with
BN + ELU, a final BN ("ball") and L2 normalization. Input (N, 128, 64, 3)
NHWC float RGB in [0, 255].

Slim's batch norms learn no scale (center only) and use eps 1e-3; convs
followed by a BN have no bias. The network runs NCHW and permutes back to
NHWC before the flatten, so `fc1` takes the JAX package's feature order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, SameConv2d

FEATURE_DIM = 128
INPUT_SHAPE = (128, 64, 3)  # (H, W, C)


class _InnerBlock(nn.Module):
    def __init__(self, cin: int, n: int, stride: int):
        super().__init__()
        self.conv1 = SameConv2d(cin, n, 3, stride)
        self.bn1 = BatchNorm(n)
        # dropout (keep 0.6) is the identity at inference
        self.conv2 = SameConv2d(n, n, 3, 1, bias=True)

    def forward(self, x):
        return self.conv2(F.elu(self.bn1(self.conv1(x))))


class _ResidualBlock(nn.Module):
    """create_link + create_inner_block (freeze_model.py:13-85)."""

    def __init__(self, features: int, increase_dim: bool = False,
                 is_first: bool = False):
        super().__init__()
        n = features * (2 if increase_dim else 1)
        self.is_first = is_first
        self.increase_dim = increase_dim
        if not is_first:
            self.pre_bn = BatchNorm(features)
        self.inner = _InnerBlock(features, n, 2 if increase_dim else 1)
        if increase_dim:
            self.projection = SameConv2d(features, n, 1, 2)

    def forward(self, x):
        pre = x if self.is_first else F.elu(self.pre_bn(x))
        block = self.inner(pre)
        if self.increase_dim:
            return self.projection(x) + block
        return x + block


class MarsNet(nn.Module):
    """(N, 128, 64, 3) -> (N, 128) L2-normalized float32 features."""

    def __init__(self):
        super().__init__()
        self.conv1_1 = SameConv2d(3, 32, 3)
        self.conv1_1_bn = BatchNorm(32)
        self.conv1_2 = SameConv2d(32, 32, 3)
        self.conv1_2_bn = BatchNorm(32)
        self.conv2_1 = _ResidualBlock(32, is_first=True)
        self.conv2_3 = _ResidualBlock(32)
        self.conv3_1 = _ResidualBlock(32, increase_dim=True)
        self.conv3_3 = _ResidualBlock(64)
        self.conv4_1 = _ResidualBlock(64, increase_dim=True)
        self.conv4_3 = _ResidualBlock(128)
        self.fc1 = nn.Linear(16 * 8 * 128, FEATURE_DIM, bias=False)
        self.fc1_bn = BatchNorm(FEATURE_DIM)
        self.ball = BatchNorm(FEATURE_DIM)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.conv1_1.weight.dtype).permute(0, 3, 1, 2)
        x = F.elu(self.conv1_1_bn(self.conv1_1(x)))
        x = F.elu(self.conv1_2_bn(self.conv1_2(x)))
        x = F.max_pool2d(x, 3, 2)          # slim's default VALID padding
        for name in ("conv2_1", "conv2_3", "conv3_1", "conv3_3", "conv4_1",
                     "conv4_3"):
            x = getattr(self, name)(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.elu(self.fc1_bn(self.fc1(x)))
        x = self.ball(x).float()
        norm = torch.sqrt(1e-8 + torch.sum(x * x, dim=1, keepdim=True))
        return x / norm
