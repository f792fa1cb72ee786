"""Live-frame utilities: the camera presets and ``Frame`` (host numpy).

The port's copy of ``lsps_tpu/utils/realtime.py`` (reference:
src/utils/util.py:40-302): a captured depth map is cropped around the
hand by the port's :class:`HandDetector` (the depth-weighted CoM refined
five times unless the caller gives one), the crop normalized to
[-0.5, 0.5] around the CoM's depth, the skeleton normalized by the fixed
ratio 50, and predictions reprojected to crop and full-image
coordinates.  Every field equals the JAX package's ``Frame`` on the same
frame; ``render`` draws with ``utils.viz.vis_pair`` (numpy shapes where
the JAX package draws with cv2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.data.detector import HandDetector
from lsps_tpu_torch.data.transformations import transform_points_2d
from lsps_tpu_torch.utils import viz

# (camera, far_point) presets (util.py:41-42); the far point blanks
# invalid pixels
CAMERAS = {
    "intel": (Camera.icvl(), 32001.0),
    "kinect": (Camera(588.235, 587.084, 320.0, 240.0, flip_y=True,
                      depth_map_size=(640, 480)), 2001.0),
}

SKEL_NORM_RATIO = 50.0  # util.py:98


@dataclasses.dataclass
class Frame:
    """One live depth frame with its crop and (optional) skeleton.

    dm:        (H, W) raw depth (mm), far-point pixels zeroed
    crop_dm:   (128, 128) normalized crop in [-0.5, 0.5]
    skel:      flat 3D joints in mm (camera space), if known
    norm_skel: skeleton centered at com3d and / 50 (util.py:197-207)
    """

    dm: Optional[np.ndarray] = None
    skel: Optional[np.ndarray] = None
    com2d: Optional[np.ndarray] = None
    com3d: Optional[np.ndarray] = None
    crop_dm: Optional[np.ndarray] = None
    trans: Optional[np.ndarray] = None
    norm_skel: Optional[np.ndarray] = None
    camera: Camera = dataclasses.field(default_factory=Camera.nyu)
    far_point: float = 2001.0
    cube: tuple = (250, 250, 250)

    @staticmethod
    def from_depth(dm, camera: Camera, far_point: float,
                   com2d=None, skel=None, cube=(250, 250, 250)) -> "Frame":
        """Build a frame: blank far-point pixels, find the hand (the
        depth-weighted CoM refined five times, unless ``com2d`` is
        given), crop it and normalize the crop to [-0.5, 0.5]
        (util.py:120-180)."""
        dm = np.asarray(dm, np.float32).copy()
        dm[dm >= far_point] = 0.0
        hd = HandDetector(dm, camera.fx, camera.fy)
        if com2d is None:
            com2d = hd.calculate_com(hd.dpt)
            com2d = hd.refine_com_iterative(com2d, 5, cube)
        crop, M, com2d = hd.crop_area_3d(com=np.asarray(com2d, np.float64),
                                         size=cube)
        com3d = camera.img_to_3d(np.asarray(com2d, np.float32))
        crop = crop.copy()
        crop[crop == 0] = com3d[2] + cube[2] / 2.0
        crop = (crop - com3d[2]) / cube[2]
        f = Frame(dm=dm, com2d=np.asarray(com2d, np.float32), com3d=com3d,
                  crop_dm=crop, trans=M, camera=camera,
                  far_point=far_point, cube=tuple(cube))
        if skel is not None:
            f.skel = np.asarray(skel, np.float32).reshape(-1)
            f.norm_skel = f.normalize_skel(f.skel)
        return f

    # -- skeleton normalization (util.py:197-221) -----------------------
    def normalize_skel(self, skel) -> np.ndarray:
        s = np.asarray(skel, np.float32).reshape(-1, 3) - self.com3d
        return (s / SKEL_NORM_RATIO).reshape(-1)

    def denormalize_skel(self, norm_skel) -> np.ndarray:
        s = np.asarray(norm_skel, np.float32).reshape(-1, 3)
        return (s * SKEL_NORM_RATIO + self.com3d).reshape(-1)

    # -- reprojection (util.py:231-265) ----------------------------------
    def skel_to_full2d(self, skel=None) -> np.ndarray:
        """Metric skeleton -> full-image (u, v) coords."""
        s = np.asarray(skel if skel is not None else self.skel,
                       np.float32).reshape(-1, 3)
        return self.camera.to_img(s)[:, :2]

    def skel_to_crop2d(self, skel=None) -> np.ndarray:
        """Metric skeleton -> crop (u, v) coords through the crop M."""
        uv = self.camera.to_img(np.asarray(
            skel if skel is not None else self.skel,
            np.float32).reshape(-1, 3))
        return transform_points_2d(uv, self.trans)[:, :2]

    # -- viz (util.py:267-302) --------------------------------------------
    def render(self, pred_norm_skel=None, color_idx=None, bones=None):
        """The crop as a (128, 128, 3) BGR uint8 image, with the
        prediction drawn over it if given."""
        pose = None
        if pred_norm_skel is not None:
            pose = (np.asarray(pred_norm_skel).reshape(-1, 3)
                    * SKEL_NORM_RATIO / (self.cube[2] / 2.0)).reshape(-1)
        return viz.vis_pair(self.camera, self.crop_dm[None] * 2.0, pose,
                            self.trans, self.com3d, np.asarray(self.cube),
                            color_idx, bones)
