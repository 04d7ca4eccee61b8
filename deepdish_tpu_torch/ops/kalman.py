"""Constant-velocity Kalman filter over a fixed-capacity track table.

Port of the batched forms in deepdish_tpu/ops/kalman.py (`initiate_v`,
`predict_v`, `update_v`, `gating_distance_v`): every function works on a
(T, 8) mean / (T, 8, 8) covariance table at once, and on a stack of such
tables with leading axes, (S, T, 8) / (S, T, 8, 8) for a tracker batched
over streams. The 8-dim state is (x, y, a, h, vx, vy, va, vh) with
dt = 1.

deep_sort's state pairs never couple across dimensions, so the innovation
covariance S is diagonal (`_projected_var`, kalman.py:91) and the update
and gating solves are elementwise divisions.
"""
from __future__ import annotations

import torch

CHI2INV95 = {1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877,
             5: 11.070, 6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919}

_STD_WEIGHT_POSITION = 1.0 / 20
_STD_WEIGHT_VELOCITY = 1.0 / 160


def _motion_mat(like: torch.Tensor) -> torch.Tensor:
    f = torch.eye(8, dtype=like.dtype, device=like.device)
    f[torch.arange(4), torch.arange(4) + 4] = 1.0
    return f


def _const(h: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(h, value)


def initiate_v(measurement_xyah: torch.Tensor):
    """(..., N, 4) measurements -> (..., N, 8) means, (..., N, 8, 8)
    covariances."""
    m = measurement_xyah
    mean = torch.cat([m, torch.zeros_like(m)], dim=-1)
    h = m[..., 3]
    std = torch.stack([
        2 * _STD_WEIGHT_POSITION * h,
        2 * _STD_WEIGHT_POSITION * h,
        _const(h, 1e-2),
        2 * _STD_WEIGHT_POSITION * h,
        10 * _STD_WEIGHT_VELOCITY * h,
        10 * _STD_WEIGHT_VELOCITY * h,
        _const(h, 1e-5),
        10 * _STD_WEIGHT_VELOCITY * h,
    ], dim=-1)
    return mean, torch.diag_embed(std * std)


def predict_v(mean: torch.Tensor, covariance: torch.Tensor):
    h = mean[..., 3]
    std = torch.stack([
        _STD_WEIGHT_POSITION * h, _STD_WEIGHT_POSITION * h,
        _const(h, 1e-2), _STD_WEIGHT_POSITION * h,
        _STD_WEIGHT_VELOCITY * h, _STD_WEIGHT_VELOCITY * h,
        _const(h, 1e-5), _STD_WEIGHT_VELOCITY * h,
    ], dim=-1)
    motion_cov = torch.diag_embed(std * std)
    f = _motion_mat(mean)
    new_mean = mean @ f.T
    new_cov = f @ covariance @ f.T + motion_cov
    return new_mean, new_cov


def _projected_var(mean: torch.Tensor, covariance: torch.Tensor):
    """Diagonal of S = H P H^T + R, (..., T, 4)."""
    h = mean[..., 3]
    std = torch.stack([
        _STD_WEIGHT_POSITION * h, _STD_WEIGHT_POSITION * h,
        _const(h, 1e-1), _STD_WEIGHT_POSITION * h,
    ], dim=-1)
    return torch.diagonal(covariance, dim1=-2, dim2=-1)[..., :4] + std * std


def update_v(mean: torch.Tensor, covariance: torch.Tensor,
             measurement_xyah: torch.Tensor):
    """Measurement correction for every slot with its own (..., T, 4)
    row."""
    s = _projected_var(mean, covariance)
    gain = covariance[..., :4] / s[..., None, :]           # (..., T, 8, 4)
    innovation = measurement_xyah - mean[..., :4]
    new_mean = mean + (gain @ innovation[..., None])[..., 0]
    new_cov = covariance - (gain * s[..., None, :]) @ gain.transpose(-1, -2)
    return new_mean, new_cov


def gating_distance_v(mean: torch.Tensor, covariance: torch.Tensor,
                      measurements_xyah: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis distance, (..., T, 8), (..., T, 8, 8),
    (..., N, 4) -> (..., T, N)."""
    s = _projected_var(mean, covariance)
    d = measurements_xyah[..., None, :, :] - mean[..., :, None, :4]
    return torch.sum(d * d / s[..., :, None, :], dim=-1)
