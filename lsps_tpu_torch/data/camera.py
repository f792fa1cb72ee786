"""Camera models and 2D <-> 3D joint projection on torch tensors.

The port's copy of ``lsps_tpu/data/camera.py`` (presets and projections).
Functions work over leading axes: input shape ``(..., 3)``.
"""

from __future__ import annotations

import dataclasses

import torch


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
    def img_to_3d(self, uvd: torch.Tensor) -> torch.Tensor:
        """(u, v, d[mm]) image coords -> metric 3D (x, y, z) in mm."""
        u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
        x = (u - self.ux) * d / self.fx
        if self.flip_y:
            y = (self.uy - v) * d / self.fy
        else:
            y = (v - self.uy) * d / self.fy
        return torch.stack([x, y, d], dim=-1)

    def to_img(self, xyz: torch.Tensor) -> torch.Tensor:
        """Metric 3D (mm) -> image coords (u, v, d); z == 0 maps to the
        principal point with d = 0."""
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        at_zero = z == 0.0
        safe_z = torch.where(at_zero, torch.ones_like(z), z)
        u = torch.where(at_zero, self.ux, x / safe_z * self.fx + self.ux)
        if self.flip_y:
            v = torch.where(at_zero, self.uy, self.uy - y / safe_z * self.fy)
        else:
            v = torch.where(at_zero, self.uy, y / safe_z * self.fy + self.uy)
        d = torch.where(at_zero, 0.0, z)
        return torch.stack([u, v, d], dim=-1)
