"""The traffic generator: the walker scene, rolled per camera, as host
I420 frames.

One traffic file (`traffic/<name>.json`) sets every size. A wave is
`background_frames` frames of a flat background, then `walkers` textured
blocks in separate rows walking `step_px` a frame for `walk_frames`
frames, alternately right (from `start_x_right`) and left (from
`start_x_left`), so that each crosses x = `line_x`; the waves repeat for
the whole window. Camera s shows the scene rolled along x by
s * `shift_px` + a phase drawn from the seed, and starts its waves at a
frame offset drawn from the seed (a permutation of evenly spaced
offsets, so every seed gives every camera the same frames in another
order). The textures (values `texture_low`..255) are drawn from the seed.

A frozen rewrite in PyTorch of the port's `chip_smoke._cli_scene`,
`_cli_block` and `PAR_SHIFT` rolling, and of `tools/bench.py` `to_i420`
(BT.601 video range).

A call's frames repeat with the wave's period P, so the generator makes
the P distinct calls' frames once, on the device in a few large calls,
and hands them to the host: `Traffic.calls[c % P]` is call c's
(S, F, H * 3 / 2, W) uint8 array.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Traffic(NamedTuple):
    calls: np.ndarray      # (P, S, F, H * 3 / 2, W) uint8 I420, host
    period: int
    offsets: np.ndarray    # (S,) wave offset of each camera
    rolls: np.ndarray      # (S,) px each camera is rolled by


def seed_int(seed: int, salt: int) -> int:
    """A generator seed from the run's seed and a salt."""
    return (int(seed) * 1000003 + salt) % (2 ** 63)


def period(tr: dict) -> int:
    return int(tr["background_frames"]) + int(tr["walk_frames"])


def _textures(tr: dict, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed_int(seed, 11))
    lo = int(tr["texture_low"])
    return torch.randint(lo, 256, (int(tr["walkers"]), int(tr["block_h"]),
                                   int(tr["block_w"]), 3),
                         generator=g, device=device, dtype=torch.int32
                         ).to(torch.uint8)


def block_xy(tr: dict, k: int, t: int):
    """Top-left corner of walker k after t frames of walking."""
    right = k % 2 == 0
    x0 = int(tr["start_x_right"] if right else tr["start_x_left"])
    step = int(tr["step_px"]) * (1 if right else -1)
    return x0 + step * t, int(tr["row_top"]) + int(tr["row_pitch"]) * k


def scene(tr: dict, seed: int, device) -> torch.Tensor:
    """(P, H, W, 3) uint8 RGB: one wave of the unrolled scene."""
    H, W = int(tr["height"]), int(tr["width"])
    bh, bw = int(tr["block_h"]), int(tr["block_w"])
    nb = int(tr["background_frames"])
    tex = _textures(tr, seed, device)
    out = torch.full((period(tr), H, W, 3), int(tr["background_level"]),
                     dtype=torch.uint8, device=device)
    for i in range(nb, period(tr)):
        for k in range(int(tr["walkers"])):
            x, y = block_xy(tr, k, i - nb)
            out[i, y:y + bh, x:x + bw] = tex[k]
    return out


def to_i420(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB -> (..., H * 3 / 2, W) uint8 I420, BT.601
    video range."""
    f = rgb.float()
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128 + 0.439 * r - 0.368 * g - 0.071 * b
    lead, (H, W) = y.shape[:-2], y.shape[-2:]

    def sub(c):
        c = c.reshape(lead + (H // 2, 2, W // 2, 2)).mean((-3, -1))
        return c.reshape(lead + (H // 4, W))
    out = torch.cat([y, sub(u), sub(v)], dim=-2)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def camera_layout(tr: dict, seed: int):
    """(offsets, rolls) of the S cameras, drawn from the seed."""
    S, P = int(tr["streams"]), period(tr)
    rng = np.random.default_rng(seed_int(seed, 12))
    offsets = (rng.permutation(S) * P) // S
    rolls = (np.arange(S) * int(tr["shift_px"])
             + int(rng.integers(0, int(tr["shift_px"])))) % int(tr["width"])
    return offsets.astype(np.int64), rolls.astype(np.int64)


def camera_frames(tr: dict, waves: torch.Tensor, s: int, offsets, rolls,
                  calls) -> torch.Tensor:
    """Camera s's RGB frames at the given call indices: (n, F, H, W, 3)."""
    F, P = int(tr["frames_per_call"]), period(tr)
    idx = [((c * F + f) + int(offsets[s])) % P for c in calls
           for f in range(F)]
    x = torch.roll(waves[idx], int(rolls[s]), dims=2)
    return x.reshape((len(calls), F) + x.shape[1:])


def make(tr: dict, seed: int, device, waves: torch.Tensor) -> Traffic:
    """Every distinct call's frames of the traffic, on the host, from
    `waves` (`scene(tr, seed, device)`)."""
    S, F, P = int(tr["streams"]), int(tr["frames_per_call"]), period(tr)
    H, W = int(tr["height"]), int(tr["width"])
    # with F frames a call, the calls repeat after P / gcd(P, F) of them
    n_calls = P // np.gcd(P, F)
    offsets, rolls = camera_layout(tr, seed)
    calls = torch.empty((n_calls, S, F, H * 3 // 2, W), dtype=torch.uint8,
                        device=device)
    for s in range(S):
        calls[:, s] = to_i420(camera_frames(tr, waves, s, offsets, rolls,
                                            range(n_calls)))
    return Traffic(calls.cpu().numpy(), n_calls, offsets, rolls)
