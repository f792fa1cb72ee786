"""Depth -> pose inference on the card.

Counterpart of ``lsps_tpu/serve/inference.py:PoseEstimator``: crop ->
normalize -> ``dis.regress_b`` -> ``vae.decode`` -> denormalize.  The crop
and normalize run in one launch of the ``crop_normalize`` CUDA kernel,
index math included; the conv trunk and the MLP decode are PyTorch convs
and matmuls, as they were XLA convs and dots in the JAX package.  Outputs
are torch tensors on the estimator's device.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from lsps_tpu_torch import resolve_device
from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.models import build_model
from lsps_tpu_torch.serve.detect import device_detect_batch
from lsps_tpu_torch.serve.preprocess import crop_normalize_batch

DEFAULT_CUBE_MM = 300.0


class PoseEstimator:
    """Raw depth frames (or normalized crops) -> metric 3D joints.

    ``state_dict`` holds the ``dis.*`` and ``vae.*`` parameters, as
    ``weights.from_jax_params({"dis": ..., "vae": ...})`` returns them; it
    is loaded with ``strict=True``.  ``dtype=torch.bfloat16`` casts the
    conv trunk's weights and activations to bf16 once, at construction;
    the pose decode stays float32.  ``device`` defaults to ``cuda`` and
    construction raises when there is none (pass ``device="cpu"`` for the
    plain path).
    """

    def __init__(self, hyp: dict, state_dict: Mapping[str, torch.Tensor],
                 camera: Optional[Camera] = None, domain: str = "b",
                 dtype: torch.dtype = torch.float32, device=None):
        self.device = resolve_device(device)
        if domain not in ("a", "b"):
            raise ValueError(f"domain must be 'a' or 'b', not {domain!r}")
        nets = nn.ModuleDict({"dis": build_model(hyp["dis"]),
                              "vae": build_model(hyp["vae"])})
        nets.load_state_dict(state_dict, strict=True)
        nets.eval().to(self.device)
        nets["dis"].to(dtype)
        self.dis, self.vae = nets["dis"], nets["vae"]
        self.camera = camera or Camera.nyu()
        self.domain = domain
        self.dtype = dtype
        self._regress = (self.dis.regress_b if domain == "b"
                         else self.dis.regress_a)

    # ------------------------------------------------------------------
    def _crops_to_pose(self, crops: torch.Tensor) -> torch.Tensor:
        """(B, 128, 128, 1) normalized crops -> (B, reg_dim) pose."""
        _, post, _ = self._regress(crops.to(self.dtype))
        return self.vae.decode(post.to(torch.float32))

    def _frames_to_pose(self, frames, coms, cubes) -> torch.Tensor:
        """Raw frames + CoMs -> metric joints.  uint16 frames go to the
        kernel as they are and are read there as uint16."""
        crops, _ = crop_normalize_batch(frames, coms, cubes, self.camera.fx,
                                        self.camera.fy)
        pose = self._crops_to_pose(crops[..., None])
        j = pose.reshape(pose.shape[0], -1, 3)
        com3d = self.camera.img_to_3d(coms)
        return j * (cubes[:, 2:3, None] / 2.0) + com3d[:, None, :]

    def _frames(self, frames) -> torch.Tensor:
        """uint16 millimetre frames pass through as uint16; everything else
        becomes float32.  On the estimator's device."""
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        if frames.dtype != torch.uint16:
            frames = frames.to(torch.float32)
        return frames.to(self.device).contiguous()

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict_crops(self, crops) -> torch.Tensor:
        """Normalized (B, 128, 128, 1) crops -> (B, J*3) normalized pose."""
        return self._crops_to_pose(self._f32(crops))

    @torch.inference_mode()
    def predict_frames(self, frames, coms, cubes) -> torch.Tensor:
        """Raw (B, H, W) frames + (B, 3) CoMs + (B, 3) cubes -> (B, J, 3)
        metric joints (mm).  ``frames`` may be uint16 millimetre depth."""
        return self._frames_to_pose(self._frames(frames), self._f32(coms),
                                    self._f32(cubes))

    def predict_frame(self, frame, com, cube) -> torch.Tensor:
        return self.predict_frames(torch.as_tensor(frame)[None],
                                   self._f32(com)[None],
                                   self._f32(cube)[None])[0]

    @torch.inference_mode()
    def predict_raw(self, frames, cubes=None, return_coms: bool = False):
        """Raw (B, H, W) frames -> (B, J, 3) metric joints with the CoM
        detected on the device.  ``cubes`` defaults to a 300 mm cube per
        frame.  A frame where detection fails gets a zero CoM and so
        degenerate joints; ``return_coms=True`` lets callers screen them.
        ``frames`` may be uint16 millimetre depth."""
        frames = self._frames(frames)
        if cubes is None:
            cubes = torch.full((frames.shape[0], 3), DEFAULT_CUBE_MM,
                               dtype=torch.float32, device=self.device)
        cubes = self._f32(cubes)
        coms = device_detect_batch(frames, cubes, self.camera.fx,
                                   self.camera.fy)
        joints = self._frames_to_pose(frames, coms, cubes)
        return (joints, coms) if return_coms else joints
