"""Dataset importer base (host numpy).

The port's copy of ``DepthImporter`` from ``lsps_tpu/data/importers.py``:
the camera passthroughs, the per-frame crop step and the sequence API that
the synthetic importer (``data/synthetic.py``) implements.  Joints are
projected in numpy, as the JAX package's importers project them.

Not ported here (``ROADMAP.md``): the NYU, ICVL, MSRA15 and POST importers
and the ``.npz`` sequence cache with its uint16 crops; a run on real data
waits for the datasets to be in the repository.
"""

from __future__ import annotations

import numpy as np

from lsps_tpu_torch.data.basetypes import (DepthFrame, FrameArrays,
                                           NamedImgSequence)
from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.data.detector import HandDetector
from lsps_tpu_torch.data.transformations import transform_points_2d


class DepthImporter:
    """Base: camera projection + sequence loading skeleton
    (reference importers.py:50-188)."""

    num_joints = 0
    crop_joint_idx = 0

    def __init__(self, camera: Camera, basepath: str = "", use_cache=True,
                 cache_dir="./cache/", hand=None):
        self.camera = camera
        self.basepath = basepath
        self.use_cache = use_cache
        self.cache_dir = cache_dir
        self.hand = hand
        self.default_cubes = {}
        self.sides = {}

    # camera passthroughs (reference importers.py:73-150)
    @property
    def fx(self):
        return self.camera.fx

    @property
    def fy(self):
        return self.camera.fy

    @property
    def ux(self):
        return self.camera.ux

    @property
    def uy(self):
        return self.camera.uy

    @property
    def depth_map_size(self):
        return self.camera.depth_map_size

    def joint_img_to_3d(self, uvd):
        return self.camera.img_to_3d(np.asarray(uvd, np.float32))

    def joint_3d_to_img(self, xyz):
        return self.camera.to_img(np.asarray(xyz, np.float32))

    # reference-name aliases
    jointImgTo3D = joint_img_to_3d
    jointsImgTo3D = joint_img_to_3d
    joint3DToImg = joint_3d_to_img
    joints3DToImg = joint_3d_to_img

    def get_camera_intrinsics(self):
        return self.camera.intrinsics()

    def get_camera_projection(self):
        return self.camera.projection()

    def depth_to_pcl(self, dpt, T, background_val=0.0):
        return self.camera.depth_to_pcl(dpt, T, background_val)

    # ------------------------------------------------------------------
    def _crop_frame(self, dpt, gtorig, gt3Dorig, cube, docom, fname):
        """Shared per-frame crop step (reference importers.py:391-411)."""
        hd = HandDetector(dpt, self.fx, self.fy, importer=self)
        if not hd.check_image(1):
            return None
        try:
            dpt_c, M, com = hd.crop_area_3d(
                com=gtorig[self.crop_joint_idx], size=cube, docom=docom)
        except UserWarning:
            return None
        com3d = self.joint_img_to_3d(com)
        gt3Dcrop = gt3Dorig - com3d
        gtcrop = transform_points_2d(gtorig, M)
        return DepthFrame(dpt_c.astype(np.float32), gtorig, gtcrop,
                          M.astype(np.float32), gt3Dorig, gt3Dcrop,
                          com3d, fname, "", "right", {})

    def load_sequence(self, seq_name, **kw) -> FrameArrays:
        raise NotImplementedError

    # reference-compatible wrapper returning NamedImgSequence of DepthFrames
    def loadSequence(self, seq_name, *a, **kw) -> NamedImgSequence:
        arrays = self.load_sequence(seq_name, **kw)
        frames = [arrays.frame(i) for i in range(len(arrays))]
        return NamedImgSequence(arrays.name, frames, arrays.config)
