"""Depth -> pose inference on the card, and the latent walk.

Counterpart of ``lsps_tpu/serve/inference.py``: crop -> normalize ->
``dis.regress_b`` -> ``vae.decode`` -> denormalize.  The crop and
normalize run in one launch of the ``crop_normalize`` CUDA kernel, index
math included; the conv trunk and the MLP decode are PyTorch convs and
matmuls, as they were XLA convs and dots in the JAX package.  Outputs are
torch tensors on the estimator's device.

The two serving programs are ``nn.Module``s over the estimator's own nets
and camera, which ``torch.export`` traces (``serve/export.py``):
``FramesProgram`` ``(frames, coms, cubes) -> joints`` and ``RawProgram``
``(frames, cubes) -> (joints, coms)`` with the CoM detected on the device.
``PoseEstimator.predict_frames`` and ``predict_raw`` call the same
modules, so that live and exported serving compute one function.  Under a
recording profiler a call opens the spans ``lsps.predict``, ``lsps.h2d``,
``lsps.detect``, ``lsps.crop``, ``lsps.regress`` and ``lsps.decode``
(``utils/logging.py``); an exported program holds none of them.

``PoseEstimator(devices=(...))`` is the counterpart of the JAX package's
``mesh=``: one replica of the nets per device, each call's batch split into
contiguous blocks, one per replica, and the results concatenated on the
first device.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from lsps_tpu_torch import resolve_device
from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.models import build_model
from lsps_tpu_torch.serve.detect import device_detect_batch
from lsps_tpu_torch.serve.preprocess import crop_normalize_batch
from lsps_tpu_torch.utils.logging import span

DEFAULT_CUBE_MM = 300.0


class FramesProgram(nn.Module):
    """Raw (B, H, W) frames (float32 or uint16 mm) + (B, 3) CoMs + (B, 3)
    cubes -> (B, J, 3) metric joints: the crop kernel, ``regress`` of
    ``domain`` on ``dtype`` crops, ``vae.decode`` in float32."""

    def __init__(self, dis: nn.Module, vae: nn.Module, camera: Camera,
                 domain: str = "b", dtype: torch.dtype = torch.float32):
        super().__init__()
        if domain not in ("a", "b"):
            raise ValueError(f"domain must be 'a' or 'b', not {domain!r}")
        self.dis, self.vae = dis, vae
        self.camera, self.domain, self.dtype = camera, domain, dtype

    def _regress(self, crops: torch.Tensor) -> torch.Tensor:
        """(B, 128, 128, 1) normalized crops -> the regressor's float32
        posterior code."""
        regress = (self.dis.regress_b if self.domain == "b"
                   else self.dis.regress_a)
        with span("regress"):
            _, post, _ = regress(crops.to(self.dtype))
        return post.to(torch.float32)

    def crops_to_pose(self, crops: torch.Tensor) -> torch.Tensor:
        """(B, 128, 128, 1) normalized crops -> (B, reg_dim) pose."""
        post = self._regress(crops)
        with span("decode"):
            return self.vae.decode(post)

    def forward(self, frames: torch.Tensor, coms: torch.Tensor,
                cubes: torch.Tensor) -> torch.Tensor:
        with span("crop"):
            crops, _ = crop_normalize_batch(frames, coms, cubes,
                                            self.camera.fx, self.camera.fy)
        post = self._regress(crops[..., None])
        with span("decode"):
            pose = self.vae.decode(post)
            j = pose.reshape(pose.shape[0], -1, 3)
            com3d = self.camera.img_to_3d(coms)
            return j * (cubes[:, 2:3, None] / 2.0) + com3d[:, None, :]


class RawProgram(nn.Module):
    """Raw (B, H, W) frames + (B, 3) cubes -> ((B, J, 3) joints, (B, 3)
    CoMs), the CoM detected on the device (a zero CoM where no depth
    slice qualifies, and then degenerate joints)."""

    def __init__(self, frames_program: FramesProgram):
        super().__init__()
        self.frames_program = frames_program

    def forward(self, frames: torch.Tensor, cubes: torch.Tensor):
        cam = self.frames_program.camera
        with span("detect"):
            coms = device_detect_batch(frames, cubes, cam.fx, cam.fy)
        return self.frames_program(frames, coms, cubes), coms


class Replica(NamedTuple):
    """One device's copy of the nets, as its two serving programs."""
    device: torch.device
    frames: FramesProgram
    raw: RawProgram


class PoseEstimator:
    """Raw depth frames (or normalized crops) -> metric 3D joints.

    ``state_dict`` holds the ``dis.*`` and ``vae.*`` parameters, as
    ``weights.from_jax_params({"dis": ..., "vae": ...})`` returns them; it
    is loaded with ``strict=True``.  ``dtype=torch.bfloat16`` casts the
    conv trunk's weights and activations to bf16 once, at construction;
    the pose decode stays float32.  ``device`` defaults to ``cuda`` and
    construction raises when there is none (pass ``device="cpu"`` for the
    plain path).

    ``devices`` (instead of ``device``), two or more: one replica per
    device (a device may repeat); every call splits its batch into
    contiguous blocks, one per replica, which must divide it evenly, and
    returns the results concatenated on the first device.  ``device``,
    ``dis``, ``vae`` and the two programs are the first replica's.
    """

    def __init__(self, hyp: dict, state_dict: Mapping[str, torch.Tensor],
                 camera: Optional[Camera] = None, domain: str = "b",
                 dtype: torch.dtype = torch.float32, device=None,
                 devices: Optional[Sequence] = None):
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        self.devices = (tuple(torch.device(d) for d in devices) if devices
                        else (resolve_device(device),))
        self.device = self.devices[0]
        self.camera = camera or Camera.nyu()
        self.domain = domain
        self.dtype = dtype
        self.replicas = []
        for dev in self.devices:
            nets = nn.ModuleDict({"dis": build_model(hyp["dis"]),
                                  "vae": build_model(hyp["vae"])})
            nets.load_state_dict(state_dict, strict=True)
            nets.eval().to(dev)
            nets["dis"].to(dtype)
            fp = FramesProgram(nets["dis"], nets["vae"], self.camera,
                               domain, dtype)
            self.replicas.append(Replica(dev, fp, RawProgram(fp)))
        _, self.frames_program, self.raw_program = self.replicas[0]
        self.dis, self.vae = self.frames_program.dis, self.frames_program.vae

    @property
    def n_joints(self) -> int:
        return self.vae.input_dim // 3

    def _frames(self, frames) -> torch.Tensor:
        """uint16 millimetre frames pass through as uint16; everything else
        becomes float32.  On the estimator's device."""
        with span("h2d"):
            if not isinstance(frames, torch.Tensor):
                frames = torch.from_numpy(np.ascontiguousarray(frames))
            if frames.dtype != torch.uint16:
                frames = frames.to(torch.float32)
            return frames.to(self.device).contiguous()

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _check_batch(self, n: int):
        """A multi-device estimator needs batch % devices == 0; fail with
        a clear message rather than in a split."""
        nd = len(self.replicas)
        if nd > 1 and n % nd != 0:
            raise ValueError(
                f"batch {n} not divisible by the mesh data axis ({nd}); "
                "pad the batch or use an unsharded PoseEstimator for small "
                "requests")

    def _sharded(self, call, *xs):
        """``call(replica, *blocks)`` on each replica's contiguous block of
        the batch ``xs``; the results concatenated on the first device."""
        self._check_batch(xs[0].shape[0])
        if len(self.replicas) == 1:
            return call(self.replicas[0], *xs)
        blocks = [x.tensor_split(len(self.replicas)) for x in xs]
        outs = [call(rep, *(b[i].to(rep.device) for b in blocks))
                for i, rep in enumerate(self.replicas)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[k].to(self.device) for o in outs])
                         for k in range(len(outs[0])))
        return torch.cat([o.to(self.device) for o in outs])

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict_crops(self, crops) -> torch.Tensor:
        """Normalized (B, 128, 128, 1) crops -> (B, J*3) normalized pose."""
        return self._sharded(lambda r, c: r.frames.crops_to_pose(c),
                             self._f32(crops))

    @torch.inference_mode()
    def predict_frames(self, frames, coms, cubes) -> torch.Tensor:
        """Raw (B, H, W) frames + (B, 3) CoMs + (B, 3) cubes -> (B, J, 3)
        metric joints (mm).  ``frames`` may be uint16 millimetre depth."""
        with span("predict"):
            return self._sharded(lambda r, *a: r.frames(*a),
                                 self._frames(frames), self._f32(coms),
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
        with span("predict"):
            frames = self._frames(frames)
            if cubes is None:
                cubes = torch.full((frames.shape[0], 3), DEFAULT_CUBE_MM,
                                   dtype=torch.float32, device=self.device)
            joints, coms = self._sharded(lambda r, *a: r.raw(*a), frames,
                                         self._f32(cubes))
        return (joints, coms) if return_coms else joints


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """``module`` in eval mode inside the block, its own mode after.  The
    JAX package's ``encode`` and ``decode`` default to ``train=False``;
    the port's modules follow their mode (noise and dropout only in
    training), and a trainer keeps its nets in training mode."""
    was = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(was)


def latent_walk(gen: nn.Module, z_start: torch.Tensor, z_end: torch.Tensor,
                steps: int = 16):
    """Decode an interpolation path through the generator's shared latent
    (the reference's generative result, README.md:25-26): ``steps`` codes
    ``(1 - t) z_start + t z_end`` for t evenly over [0, 1], decoded in eval
    mode without gradients (the caller's mode is restored after).

    z_*: (H, W, C) shared-latent maps (from ``gen.encode``).  Returns
    ``(out_a, out_b)``, tensors of shape (steps, H', W', 1) on the codes'
    device, one per domain.
    """
    ts = torch.linspace(0.0, 1.0, steps, dtype=z_start.dtype,
                        device=z_start.device)[:, None, None, None]
    zs = (1 - ts) * z_start[None] + ts * z_end[None]
    with eval_mode(gen), torch.no_grad():
        return gen.decode(zs)
