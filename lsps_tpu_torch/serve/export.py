"""Ahead-of-time export of the serving programs through ``torch.export``.

The port's counterpart of ``lsps_tpu/serve/export.py``.  The whole
depth -> pose program (the crop kernel, ``dis.regress_b``, ``vae.decode``,
the metric denormalization; with ``raw=True`` the CoM detection too) is
traced from the estimator's ``FramesProgram`` / ``RawProgram`` into an
``ExportedProgram`` with the weights in it, and saved as a PyTorch
``.pt2`` file.  Two export shapes: a static batch (the daemon pads each
request to it) or a symbolic one (``batch=None``: any batch size).  Frames
are float32 or whole-millimetre uint16.

Deviations from the JAX package:

* the artifact is a PyTorch ``.pt2`` (``torch.export.save``), not
  serialized StableHLO.  The crop kernel and the detection kernel are the
  registered ops ``lsps::crop_normalize`` (``ops/kernels/warp.py``) and
  ``lsps::detect_coms`` (``serve/detect.py``), so the artifact loads only
  where ``lsps_tpu_torch`` is importable and, on the card, their kernel
  libraries build; ``load_pose_program`` imports the ops first;
* ``--platforms`` has no counterpart: the program runs on the device it
  was exported on, and ``load_pose_program(path, device=)`` moves it to
  another one explicitly;
* a multi-device estimator (``PoseEstimator(devices=...)``, the
  counterpart of the JAX package's mesh-sharded one) is refused, for the
  JAX package's reason.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

FORMAT = "lsps-torch-export/1"   # the format tag in the file's extra_files
_META = "lsps_meta.json"
FRAME_DTYPES = {"float32": torch.float32, "uint16": torch.uint16}


def export_pose_program(est, batch: Optional[int] = 1,
                        frame_shape: Tuple[int, int] = (480, 640),
                        raw: bool = False, frame_dtype=torch.float32):
    """Export ``est`` (a ``serve.inference.PoseEstimator``) as one program
    ``(frames, coms, cubes) -> joints``, or with ``raw=True`` ``(frames,
    cubes) -> (joints, coms)`` with the CoM detection in it.

    batch: a static batch size, or None for a symbolic batch
        (``torch.export.Dim``), traced on an example batch of 2, since an
        example of 1 specializes the dimension to the constant 1.
    frame_dtype: ``torch.float32`` or ``torch.uint16`` (sensor
        millimetres, half the host-to-device bytes; the math is unchanged).
    Returns ``(ExportedProgram, metadata dict)`` for ``save_pose_program``.
    """
    if frame_dtype not in FRAME_DTYPES.values():
        raise TypeError(f"frame_dtype must be float32 or uint16, not "
                        f"{frame_dtype}")
    if len(getattr(est, "devices", ())) > 1:
        raise ValueError(
            "export a mesh-free PoseEstimator: a multi-device (sharded) "
            "estimator would bake multi-device placement into the "
            "artifact, which then cannot load on a single-device serving "
            "host")
    n = 2 if batch is None else int(batch)
    h, w = frame_shape
    dev = est.device
    frames = torch.zeros((n, h, w), dtype=frame_dtype, device=dev)
    cubes = torch.full((n, 3), 300.0, device=dev)
    coms = torch.tensor([[w / 2.0, h / 2.0, 700.0]] * n, device=dev)
    if raw:
        program, args = est.raw_program, (frames, cubes)
    else:
        program, args = est.frames_program, (frames, coms, cubes)
    dynamic = None
    if batch is None:
        b = torch.export.Dim("b", min=1)
        dynamic = tuple({0: b} for _ in args)
    with torch.no_grad():
        ep = torch.export.export(program, args, dynamic_shapes=dynamic,
                                 strict=False)
    ep.example_inputs = None  # the zero frames are not worth saving
    meta = {"format": FORMAT, "raw": bool(raw), "batch": batch,
            "frame_shape": [int(h), int(w)],
            "frame_dtype": str(frame_dtype).replace("torch.", ""),
            "n_joints": int(est.n_joints), "device": str(dev)}
    return ep, meta


def save_pose_program(path: str, exported) -> None:
    """Write ``export_pose_program``'s result to ``path`` (``.pt2``), the
    format tag and the metadata in its ``extra_files``."""
    ep, meta = exported
    torch.export.save(ep, path, extra_files={_META: json.dumps(meta)})


def load_pose_program(path: str, device=None):
    """Load a saved program: ``(ExportedProgram, metadata)``.  A file
    without the format tag is refused.  ``device`` moves the program to
    another device than the one it was exported on."""
    import lsps_tpu_torch.ops.kernels.warp  # noqa: F401  (the ops)
    import lsps_tpu_torch.serve.detect  # noqa: F401

    extra = {_META: ""}
    try:
        ep = torch.export.load(path, extra_files=extra)
        meta = json.loads(extra[_META] or "{}")
    except Exception as e:
        raise ValueError(f"{path}: not an LSPS export ({e})") from e
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not an LSPS export (format "
                         f"{meta.get('format')!r}, want {FORMAT!r})")
    if device is not None:
        device, saved = torch.device(device), torch.device(meta["device"])
        if (device.type, device.index or 0) != (saved.type,
                                                saved.index or 0):
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, device)
            meta["device"] = str(device)
    return ep, meta


def _as_frame_dtype(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A client's frames as a tensor of the program's frame dtype on
    ``device``, refusing lossy float -> integer casts: a uint16 program
    fed float frames with fractional millimetres (or non-finite or
    out-of-range values) would otherwise truncate and wrap into wrong
    depths, and wrong joints with a 200 response."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    if a.dtype == dtype:
        return a.to(device).contiguous()
    if not dtype.is_floating_point and a.dtype.is_floating_point:
        info = torch.iinfo(dtype)
        af = a.double()
        bad = (~torch.isfinite(af) | (af < info.min) | (af > info.max)
               | (af != torch.trunc(af)))
        if bool(bad.any()):
            raise ValueError(
                f"this artifact takes {str(dtype).replace('torch.', '')} "
                f"frames (sensor millimetres) but the request's "
                f"{str(a.dtype).replace('torch.', '')} values are not "
                f"representable as such (fractional, non-finite, or "
                f"outside [{info.min}, {info.max}]): send whole mm frames "
                f"or use a float32 artifact")
    return a.to(dtype).to(device).contiguous()


class ArtifactPoseEstimator:
    """``predict_frames`` (and, on a raw artifact, ``predict_raw``) from a
    saved program alone: no config and no checkpoint.  A symbolic-batch
    program runs any batch in one call; a static one runs each request as
    chunks of its batch, the last padded with copies of its last frame
    ("pad to bucket").  Outputs are tensors on the program's device."""

    def __init__(self, path: str, device=None):
        ep, meta = load_pose_program(path, device)
        self.program = ep.module()
        self.device = torch.device(meta["device"])
        self.bucket: Optional[int] = meta["batch"]
        self.frame_shape = tuple(meta["frame_shape"])
        self.frame_dtype = FRAME_DTYPES[meta["frame_dtype"]]
        self.n_joints = int(meta["n_joints"])
        self.raw = bool(meta["raw"])
        # predict_raw only on a raw artifact, so that capability checks
        # through getattr (the daemon's) stay true
        if self.raw:
            self.predict_raw = self._predict_raw

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32,
                               device=self.device).contiguous()

    @torch.no_grad()
    def _run(self, *arrays):
        n = arrays[0].shape[0]
        if self.bucket is None:
            return self.program(*arrays)
        outs = []
        for i in range(0, n, self.bucket):
            chunk = [a[i:i + self.bucket] for a in arrays]
            k = chunk[0].shape[0]
            if k < self.bucket:
                pad = self.bucket - k
                chunk = [torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
                         for a in chunk]
            out = self.program(*chunk)
            outs.append(tuple(o[:k] for o in out) if isinstance(out, tuple)
                        else out[:k])
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    def _frames(self, frames) -> torch.Tensor:
        frames = _as_frame_dtype(frames, self.frame_dtype, self.device)
        if tuple(frames.shape[1:]) != self.frame_shape:
            raise ValueError(f"frame shape {tuple(frames.shape[1:])} != "
                             f"the artifact's {self.frame_shape}")
        return frames

    def predict_frames(self, frames, coms, cubes) -> torch.Tensor:
        if self.raw:
            raise ValueError("this artifact holds the raw-detection "
                             "program (frames, cubes); use predict_raw / "
                             "omit 'coms'")
        frames = self._frames(frames)
        if frames.shape[0] == 0:
            return torch.empty((0, self.n_joints, 3), device=self.device)
        return self._run(frames, self._f32(coms), self._f32(cubes))

    def _predict_raw(self, frames, cubes=None, return_coms: bool = False):
        frames = self._frames(frames)
        n = frames.shape[0]
        cubes = (torch.full((n, 3), 300.0, device=self.device)
                 if cubes is None else self._f32(cubes))
        if n == 0:
            joints = torch.empty((0, self.n_joints, 3), device=self.device)
            coms = torch.empty((0, 3), device=self.device)
        else:
            joints, coms = self._run(frames, cubes)
        return (joints, coms) if return_coms else joints

    def predict_frame(self, frame, com, cube) -> torch.Tensor:
        return self.predict_frames(np.asarray(frame)[None],
                                   np.asarray(com)[None],
                                   np.asarray(cube)[None])[0]
