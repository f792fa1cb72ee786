"""Camera models and 2D <-> 3D joint projection.

The port's copy of ``lsps_tpu/data/camera.py`` (presets, projections and
the numpy intrinsic / projection matrices and point cloud).
Functions work over leading axes: input shape ``(..., 3)``.  A torch
tensor is projected in torch ops; anything else in numpy, with the JAX
package's numpy expressions, so that the host data pipeline (importers,
detector, pose sampling, augment labels) rounds as the JAX package's
does: float32 inputs stay float32, float64 stay float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _where(cond, a, b):
    """``where`` in the namespace of ``cond``."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def _stack(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with optional y-axis flip (NYU/MSRA convention)."""

    fx: float
    fy: float
    ux: float
    uy: float
    flip_y: bool = False
    depth_map_size: tuple = (320, 240)  # (width, height)

    # -- presets ----------------------------------------------------------
    @staticmethod
    def icvl() -> "Camera":
        return Camera(241.42, 241.42, 160.0, 120.0, flip_y=False,
                      depth_map_size=(320, 240))

    @staticmethod
    def msra() -> "Camera":
        return Camera(241.42, 241.42, 160.0, 120.0, flip_y=True,
                      depth_map_size=(320, 240))

    @staticmethod
    def post() -> "Camera":
        return Camera(568.2585063980484, 568.6191815994941,
                      317.5252035537242, 248.5884501249385, flip_y=False,
                      depth_map_size=(640, 480))

    @staticmethod
    def nyu() -> "Camera":
        return Camera(588.03, 587.07, 320.0, 240.0, flip_y=True,
                      depth_map_size=(640, 480))

    # -- projections -------------------------------------------------------
    def img_to_3d(self, uvd):
        """(u, v, d[mm]) image coords -> metric 3D (x, y, z) in mm."""
        u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
        x = (u - self.ux) * d / self.fx
        if self.flip_y:
            y = (self.uy - v) * d / self.fy
        else:
            y = (v - self.uy) * d / self.fy
        return _stack([x, y, d])

    def to_img(self, xyz):
        """Metric 3D (mm) -> image coords (u, v, d); z == 0 maps to the
        principal point with d = 0."""
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        at_zero = z == 0.0
        if isinstance(z, torch.Tensor):
            safe_z = torch.where(at_zero, torch.ones_like(z), z)
        else:
            safe_z = np.where(at_zero, 1.0, z)
        u = _where(at_zero, self.ux, x / safe_z * self.fx + self.ux)
        if self.flip_y:
            v = _where(at_zero, self.uy, self.uy - y / safe_z * self.fy)
        else:
            v = _where(at_zero, self.uy, y / safe_z * self.fy + self.uy)
        d = _where(at_zero, 0.0, z)
        return _stack([u, v, d])

    # reference-parity aliases
    def joint_img_to_3d(self, uvd):
        return self.img_to_3d(uvd)

    def joint_3d_to_img(self, xyz):
        return self.to_img(xyz)

    # -- matrices (numpy) --------------------------------------------------
    def intrinsics(self) -> np.ndarray:
        """3x3 intrinsic matrix (reference importers.py:139-150,865-876)."""
        k = np.zeros((3, 3), np.float32)
        k[0, 0] = self.fx
        k[1, 1] = -self.fy if self.flip_y else self.fy
        k[2, 2] = 1.0
        k[0, 2] = self.ux
        k[1, 2] = self.uy
        return k

    def projection(self) -> np.ndarray:
        """4x4 homogeneous projection (reference importers.py:125-137)."""
        p = np.zeros((4, 4), np.float32)
        p[0, 0] = self.fx
        p[1, 1] = -self.fy if self.flip_y else self.fy
        p[2, 2] = 1.0
        p[0, 2] = self.ux
        p[1, 2] = self.uy
        p[3, 2] = 1.0
        return p

    def depth_to_pcl(self, dpt, T, background_val=0.0) -> np.ndarray:
        """Back-project a cropped depth map to a metric point cloud through
        ``inv(T)`` of the 3x3 crop transform (reference
        importers.py:160-177, 929-946, 1366-1383)."""
        dpt = np.asarray(dpt)
        ys, xs = np.where(~np.isclose(dpt, background_val))
        pts = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs, np.float32)], 1)
        pts = (np.linalg.inv(np.asarray(T)) @ pts.T).T
        uv = pts[:, :2] / pts[:, 2:3]
        depth = dpt[ys, xs]
        row = (uv[:, 0] - self.ux) / self.fx * depth
        if self.flip_y:
            col = (self.uy - uv[:, 1]) / self.fy * depth
        else:
            col = (uv[:, 1] - self.uy) / self.fy * depth
        return np.column_stack((row, col, depth))
