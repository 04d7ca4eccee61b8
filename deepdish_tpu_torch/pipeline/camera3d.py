"""Pinhole camera ground-plane unprojection for the 3-D top-down mode.

Native replacement for the `cameratransform` package used by the reference
(deepdish.py:50,592-611,1088-1097): a rectilinear pinhole camera at
elevation `e` with tilt (0 deg = straight down) and roll, projecting image
points onto the z=0 ground plane. Only `space_from_image` is needed by the
pipeline (the reference calls cam.spaceFromImage on bottom-centre points).

A copy of deepdish_tpu/pipeline/camera3d.py (host code; the port keeps its
own).
"""
from __future__ import annotations

import numpy as np


class GroundCamera:
    def __init__(self, focallength_mm: float, sensor_wh_mm, image_wh,
                 elevation_m: float, tilt_deg: float, roll_deg: float = 0.0):
        sw, sh = sensor_wh_mm
        iw, ih = image_wh
        self.fx = focallength_mm / sw * iw
        self.fy = focallength_mm / sh * ih
        self.cx = iw / 2.0
        self.cy = ih / 2.0
        self.elevation = elevation_m
        t = np.deg2rad(tilt_deg)
        r = np.deg2rad(roll_deg)
        # camera basis in world coords (x east, y north, z up);
        # tilt 0 = straight down, tilt 90 = horizon, rotating view toward +Y.
        view = np.array([0.0, np.sin(t), -np.cos(t)])
        right = np.array([np.cos(r), -np.sin(r) * np.cos(t),
                          -np.sin(r) * np.sin(t)])
        # image-down direction in world coords
        down = np.cross(view, right)
        self.right, self.down, self.view = right, down, view

    def space_from_image(self, pts) -> np.ndarray:
        """pts: (N, 2) or (2,) pixel coords -> (N, 3) ground points (z=0)."""
        p = np.atleast_2d(np.asarray(pts, float))
        dx = (p[:, 0] - self.cx) / self.fx
        dy = (p[:, 1] - self.cy) / self.fy
        rays = (dx[:, None] * self.right + dy[:, None] * self.down +
                self.view[None, :])
        rz = rays[:, 2]
        # rays parallel to ground never hit; clamp to avoid div-by-zero
        rz = np.where(np.abs(rz) < 1e-9, -1e-9, rz)
        t = -self.elevation / rz
        t = np.where(t < 0, np.inf, t)  # behind the horizon
        out = np.stack([rays[:, 0] * t, rays[:, 1] * t,
                        self.elevation + rays[:, 2] * t], axis=1)
        if np.asarray(pts).ndim == 1:
            return out[0]
        return out
