"""Core data containers (host numpy).

The port's copy of ``lsps_tpu/data/basetypes.py``.  ``DepthFrame`` mirrors
the reference namedtuple field-for-field (reference:
src/data/basetypes.py:34-37).  ``FrameArrays`` is the
TPU-native struct-of-arrays form: one contiguous array per field, ready
to be sliced into device batches without per-sample Python work.
"""

from __future__ import annotations

import dataclasses
from collections import namedtuple
from typing import Any, Dict, List, Optional

import numpy as np

DepthFrame = namedtuple(
    "DepthFrame",
    ["dpt", "gtorig", "gtcrop", "T", "gt3Dorig", "gt3Dcrop", "com",
     "fileName", "subSeqName", "side", "extraData"],
)

NamedImgSequence = namedtuple("NamedImgSequence", ["name", "data", "config"])


@dataclasses.dataclass
class FrameArrays:
    """Struct-of-arrays storage for a loaded sequence.

    dpt:      (N, H, W) float32 cropped depth (mm, 0 = background), OR
              uint16 codes when the sequence is held in the half-size
              raw-mm form (see ``encode_dpt_u16``): code 0 = background,
              code 1 = the frame's single non-integral clamp value
              (``dpt_vstar[i]``), any other code = that depth in mm.
              Bit-exact round trip, verified at encode time.  Consumers
              that need mm call :meth:`dpt_mm`; the fused device augment
              decodes codes in-program so the host RSS, the npz cache,
              and the H2D stream all carry half the bytes
              (reference importers.py:987-1004 — depth is integral mm at
              the sensor; the only non-integral crop pixels are the
              single per-frame zstart clamp from handdetector.py:293-297).
    gtorig:   (N, J, 3) joints in original image coords (u, v, d)
    gtcrop:   (N, J, 3) joints in crop coords
    M:        (N, 3, 3) crop transforms
    gt3Dorig: (N, J, 3) metric joints (mm)
    gt3Dcrop: (N, J, 3) metric joints centered at CoM
    com:      (N, 3)    CoM in metric 3D (mm)
    dpt_vstar:(N,) float32 per-frame decode value for code 1 (only when
              ``dpt`` is uint16)
    """

    name: str
    dpt: np.ndarray
    gtorig: np.ndarray
    gtcrop: np.ndarray
    M: np.ndarray
    gt3Dorig: np.ndarray
    gt3Dcrop: np.ndarray
    com: np.ndarray
    config: Dict[str, Any]
    file_names: Optional[List[str]] = None
    dpt_vstar: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.dpt.shape[0]

    def dpt_mm(self, idx=None) -> np.ndarray:
        """float32 mm crops (decoding the uint16 form if present).

        ``idx``: optional frame index / index array — decode only that
        slice (the batch paths decode per batch, keeping the resident
        sequence at half size).  Always a FRESH writable array (several
        consumers, e.g. augment.normalize, mutate in place)."""
        dpt = self.dpt if idx is None else self.dpt[idx]
        if dpt.dtype != np.uint16:
            return np.array(dpt, np.float32)
        vstar = (self.dpt_vstar if idx is None
                 else self.dpt_vstar[idx])
        return decode_dpt_u16(dpt, vstar)

    @property
    def cube(self):
        return np.asarray(self.config["cube"], np.float32)

    def frame(self, i: int, side: str = "right") -> DepthFrame:
        """Materialize one frame in the reference's DepthFrame layout."""
        return DepthFrame(
            self.dpt_mm(i), self.gtorig[i], self.gtcrop[i], self.M[i],
            self.gt3Dorig[i], self.gt3Dcrop[i], self.com[i],
            self.file_names[i] if self.file_names else "", "", side, {})

    def shuffled(self, rng: np.random.RandomState) -> "FrameArrays":
        perm = rng.permutation(len(self))
        return self.take(perm)

    def take(self, idx) -> "FrameArrays":
        return FrameArrays(
            name=self.name,
            dpt=self.dpt[idx], gtorig=self.gtorig[idx],
            gtcrop=self.gtcrop[idx], M=self.M[idx],
            gt3Dorig=self.gt3Dorig[idx], gt3Dcrop=self.gt3Dcrop[idx],
            com=self.com[idx], config=self.config,
            file_names=[self.file_names[i] for i in np.atleast_1d(idx)]
            if self.file_names else None,
            dpt_vstar=(None if self.dpt_vstar is None
                       else self.dpt_vstar[idx]),
        )

    @staticmethod
    def from_frames(name: str, frames: List[DepthFrame],
                    config: Dict[str, Any]) -> "FrameArrays":
        return FrameArrays(
            name=name,
            dpt=np.stack([f.dpt for f in frames]).astype(np.float32),
            gtorig=np.stack([f.gtorig for f in frames]).astype(np.float32),
            gtcrop=np.stack([f.gtcrop for f in frames]).astype(np.float32),
            M=np.stack([np.asarray(f.T) for f in frames]).astype(np.float32),
            gt3Dorig=np.stack([f.gt3Dorig for f in frames]).astype(np.float32),
            gt3Dcrop=np.stack([f.gt3Dcrop for f in frames]).astype(np.float32),
            com=np.stack([f.com for f in frames]).astype(np.float32),
            config=dict(config),
            file_names=[f.fileName for f in frames],
        )


def encode_dpt_u16(dpt: np.ndarray):
    """Lossless uint16 coding of float32 mm crops, or None.

    With the nearest-neighbour resize of the crops (HandDetector.resize_crop,
    reference handdetector.py:338-350) every crop pixel is either an
    integral sensor depth (whole mm, reference importers.py:987-1004), the
    background 0, the pad/nd sentinel (integral), or the frame's single
    non-integral value: the zstart clamp (handdetector.py:293-297 sets
    ``v < zstart`` pixels to the f64-derived zstart, narrowed to f32 in
    the crop array).  Coding: code 1 marks the non-integral pixels and
    ``vstar[i]`` carries their value; every other pixel stores its mm
    value directly.  Returns ``(codes uint16, vstar float32)`` only if
    the decode is verified BIT-EXACT against the input (so bilinear
    crops, out-of-range depths, >1 distinct fractional value, or a
    colliding genuine 1-mm pixel all fall back to float32); else None.
    """
    dpt = np.asarray(dpt)
    if dpt.dtype != np.float32 or dpt.ndim != 3:
        return None
    frac = dpt != np.trunc(dpt)
    # one candidate non-integral value per frame (max over frac pixels)
    vstar = np.max(np.where(frac, dpt, -np.inf), axis=(1, 2))
    vstar = np.where(np.isfinite(vstar), vstar, 0.0).astype(np.float32)
    with np.errstate(invalid="ignore"):
        codes_f = np.where(frac, 1.0, dpt)
    if (not np.isfinite(codes_f).all() or (codes_f < 0).any()
            or (codes_f > np.iinfo(np.uint16).max).any()):
        return None
    codes = codes_f.astype(np.uint16)
    if not np.array_equal(decode_dpt_u16(codes, vstar), dpt):
        return None
    return codes, vstar


def decode_dpt_u16(codes: np.ndarray, vstar) -> np.ndarray:
    """Inverse of :func:`encode_dpt_u16` (also for single frames /
    batch slices: ``vstar`` broadcasts over the trailing (H, W))."""
    vstar = np.asarray(vstar, np.float32)[..., None, None]
    return np.where(codes == 1, vstar,
                    codes.astype(np.float32)).astype(np.float32)
