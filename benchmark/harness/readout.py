"""A detector's read-out fitted to the walker scene, so that seeded random
weights detect the walkers as a trained detector would.

A random backbone with calibrated batch norms (`weights.py`) carries the
scene in its features, but its heads read nothing sensible out of them.
So each family fits its heads' person rows by ridge regression on the
features of one wave of the unrolled scene: a score that rises with an
anchor's (or a proposal's) overlap with a walker, and the box encoding
that moves it onto the walker. Every other class gets no weight and a
bias far below any threshold, so the detector reports a person at each
walker and nothing else. The fit is made once, on the device, from the
features of the seed's own network; only the ridge's inputs depend on the
seed, so every seed detects about the same walkers.
"""
from __future__ import annotations

import torch

from .scene import block_xy

NEVER = -10.0         # the bias of a class that is never reported
SCORE = 4.0           # the fitted logit's target scale


def walker_boxes(tr: dict, frames, scale_x: float, scale_y: float,
                 device) -> list:
    """For each unrolled wave frame index in `frames`, the walkers' boxes
    as a (k, 4) yxyx tensor in the frame's pixels times the scales."""
    nb = int(tr["background_frames"])
    bh, bw = int(tr["block_h"]), int(tr["block_w"])
    out = []
    for i in frames:
        rows = []
        if i >= nb:
            for k in range(int(tr["walkers"])):
                x, y = block_xy(tr, k, i - nb)
                rows.append((y * scale_y, x * scale_x, (y + bh) * scale_y,
                             (x + bw) * scale_x))
        out.append(torch.tensor(rows, dtype=torch.float32,
                                device=device).reshape(-1, 4))
    return out


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (k, 4) yxyx -> (N, k) intersection over union."""
    y0 = torch.maximum(a[:, None, 0], b[None, :, 0])
    x0 = torch.maximum(a[:, None, 1], b[None, :, 1])
    y1 = torch.minimum(a[:, None, 2], b[None, :, 2])
    x1 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (y1 - y0).clamp(min=0) * (x1 - x0).clamp(min=0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def ychw_to_yxyx(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2,
                        a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2],
                       dim=-1)


def targets(anchors_ychw: torch.Tensor, walkers: torch.Tensor,
            low: float, box_scale):
    """Per anchor (or proposal) (N, 4) ychw against one frame's walkers:
    (score target (N,), box encoding target (N, 4), best IoU (N,)). The
    score goes from -SCORE below an IoU of `low` - 0.2 to +SCORE above
    `low` + 0.2; the encoding is the box coder's for the best walker."""
    n = anchors_ychw.shape[0]
    if walkers.shape[0] == 0:
        z = torch.zeros(n, device=anchors_ychw.device)
        return z - SCORE, torch.zeros((n, 4), device=z.device), z
    ov = iou(ychw_to_yxyx(anchors_ychw), walkers)
    best, who = ov.max(dim=1)
    score = ((best - low) / 0.2).clamp(-1.0, 1.0) * SCORE
    w = walkers[who]
    wy, wx = (w[:, 0] + w[:, 2]) / 2, (w[:, 1] + w[:, 3]) / 2
    wh, ww = w[:, 2] - w[:, 0], w[:, 3] - w[:, 1]
    ya, xa, ha, wa = anchors_ychw.unbind(-1)
    enc = torch.stack([(wy - ya) / ha * box_scale[0],
                       (wx - xa) / wa * box_scale[1],
                       torch.log(wh / ha) * box_scale[2],
                       torch.log(ww / wa) * box_scale[3]], dim=-1)
    return score, enc, best


def ridge(x: torch.Tensor, y: torch.Tensor, lam: float = 1e-2):
    """Least squares of y (N, m) on x (N, C) with an intercept and a ridge
    of `lam` per sample: (weights (m, C), bias (m,)), float32."""
    x = x.double()
    x1 = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    a = x1.T @ x1
    a += lam * x.shape[0] * torch.eye(a.shape[0], dtype=a.dtype,
                                      device=a.device)
    sol = torch.linalg.solve(a, x1.T @ y.double())
    return sol[:-1].T.float(), sol[-1].float()
