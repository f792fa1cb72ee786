"""Synthetic hand-like depth data (host numpy).

The port's copy of ``lsps_tpu/data/synthetic.py``: depth maps with a
hand-shaped blob (palm disc + joint spheres) at a controlled CoM, with
consistent 3D joint annotations, run through the import pipeline (detector
crop, normalization), so that every downstream stage is exercised without
dataset downloads.  The same seeds give the same frames, crops and poses
as the JAX package, bit for bit.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

from lsps_tpu_torch.data.basetypes import FrameArrays
from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.data.datasets import NYUContractDataset
from lsps_tpu_torch.data.importers import DepthImporter
from lsps_tpu_torch.registry import register


def make_pose_basis(n_joints: int, rng, n_modes: int = 5,
                    spread_mm: float = 70.0):
    """A synthetic pose manifold: mean offsets + low-rank deformation
    basis, so pose distributions have the low-dimensional structure real
    hand poses do (and VAEs can learn them)."""
    mean = rng.randn(n_joints, 3).astype(np.float32)
    mean /= np.maximum(np.linalg.norm(mean, axis=1, keepdims=True), 1)
    mean *= rng.uniform(0.2, 1.0, (n_joints, 1)).astype(np.float32)
    mean *= spread_mm
    mean[:, 2] *= 0.3  # mostly fronto-parallel
    basis = rng.randn(n_modes, n_joints, 3).astype(np.float32)
    basis *= spread_mm * 0.25 / np.sqrt(n_modes)
    basis[..., 2] *= 0.3
    return mean, basis


def sample_pose_offsets(mean, basis, rng):
    c = rng.randn(basis.shape[0]).astype(np.float32)
    off = mean + np.tensordot(c, basis, axes=1)
    off[0] = 0.0  # anchor the crop joint at the CoM
    return off


def render_hand_depth(cam: Camera, com3d, n_joints: int, rng,
                      spread_mm: float = 80.0,
                      finger_radius_px: int = 3,
                      pose_basis=None) -> Tuple[np.ndarray, np.ndarray]:
    """Render a crude hand: a palm disc at com3d plus joint spheres.

    Returns (depth map HxW float32 mm, joints3d (J, 3) mm).  With
    ``pose_basis`` (mean, basis), joints are drawn from the low-rank
    manifold; otherwise independent random offsets.
    """
    w, h = cam.depth_map_size
    dpt = np.zeros((h, w), np.float32)
    com3d = np.asarray(com3d, np.float32)

    if pose_basis is not None:
        offsets = sample_pose_offsets(*pose_basis, rng)
    else:
        offsets = rng.randn(n_joints, 3).astype(np.float32)
        offsets /= np.maximum(np.linalg.norm(offsets, axis=1,
                                             keepdims=True), 1)
        offsets *= rng.uniform(0.15, 1.0, (n_joints, 1)).astype(np.float32)
        offsets *= spread_mm
        offsets[:, 2] *= 0.3  # mostly fronto-parallel
    joints3d = com3d[None] + offsets
    joints3d[0] = com3d  # anchor the crop joint at the CoM

    uv = cam.to_img(joints3d)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def draw_ball(cx, cy, z, r_px):
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r_px ** 2
        cur = dpt[mask]
        dpt[mask] = np.where((cur == 0) | (cur > z), z, cur)

    # palm
    palm_uv = cam.to_img(com3d)
    palm_r = max(6, int(35.0 * cam.fx / com3d[2]))
    draw_ball(palm_uv[0], palm_uv[1], com3d[2], palm_r)
    # finger joints
    for j in range(n_joints):
        r = max(2, int(finger_radius_px * 300.0 / joints3d[j, 2] * 3))
        draw_ball(uv[j, 0], uv[j, 1], joints3d[j, 2], r)
    return dpt, joints3d


class SyntheticImporter(DepthImporter):
    """Importer-compatible synthetic dataset (NYU camera by default)."""

    def __init__(self, n_frames: int = 16, n_joints: int = 36, seed: int = 1,
                 camera: Optional[Camera] = None, cube=(300, 300, 300),
                 pose_seed: int = 77, **kw):
        super().__init__(camera or Camera.nyu(), basepath="synthetic",
                         use_cache=False)
        self.n_frames = n_frames
        self.num_joints = n_joints
        self.crop_joint_idx = 0
        self.seed = seed
        # the pose manifold is shared across subsets (same "hand" in
        # train/test, different samples), keyed by pose_seed only
        self.pose_basis = make_pose_basis(
            n_joints, np.random.RandomState(pose_seed))
        self.default_cubes = {"train": tuple(cube), "test": tuple(cube),
                              "train_synth": tuple(cube),
                              "test_synth": tuple(cube)}
        self.sides = {k: "right" for k in self.default_cubes}

    def load_sequence(self, seq_name, nmax=float("inf"), shuffle=False,
                      rng=None, docom=False, cube=None) -> FrameArrays:
        config = {"cube": tuple(cube) if cube is not None
                  else self.default_cubes.get(seq_name, (300, 300, 300))}
        # a stable hash: builtin hash() is salted per process
        gen = np.random.RandomState(
            self.seed + (zlib.crc32(seq_name.encode()) % 1000))
        frames = []
        n = int(min(self.n_frames, nmax))
        while len(frames) < n:
            com3d = np.array([
                gen.uniform(-120, 120), gen.uniform(-120, 120),
                gen.uniform(600, 900)], np.float32)
            dpt, joints3d = render_hand_depth(self.camera, com3d,
                                              self.num_joints, gen,
                                              pose_basis=self.pose_basis)
            gtorig = self.joint_3d_to_img(joints3d)
            f = self._crop_frame(dpt, gtorig, joints3d, config["cube"],
                                 docom, f"synth_{len(frames)}")
            if f is not None:
                frames.append(f)
        arrays = FrameArrays.from_frames(seq_name, frames, config)
        if shuffle and rng is not None:
            arrays = arrays.shuffled(rng)
        return arrays


@register("dataset", "dataset_hand_synth")
@register("dataset", "dataset_hand_synth_test")
class DatasetHandSynth(NYUContractDataset):
    """Dataset over SyntheticImporter with the NYU 6-tuple contract;
    supports pose_only / sample_poses / set_nmax / augment."""

    def __init__(self, specs):
        super().__init__(specs)
        self.joint_subset = np.arange(specs.get("n_joints", 36))
        self.di = SyntheticImporter(
            n_frames=specs.get("n_frames", 16),
            n_joints=specs.get("n_joints", 36),
            seed=specs["seed"],
            cube=specs.get("cube", (300, 300, 300)))
        self.seq = self.di.load_sequence(
            specs["subset"], rng=self.rng, shuffle=True,
            docom=specs.get("docom", False))
        self._init_detector()
