"""The training augment's image half on the device: warp + sentinel/clamp/
normalize of a raw batch, in PyTorch ops.

Counterpart of ``lsps_tpu/data/augment_jax.py:device_recrop_normalize_
batch``, which the JAX trainer's fused-augment steps run inside the step.
It takes the raw tuple that ``FastAugmenter.raw_batch`` builds,
``(src, minv, com_z, cube_z, premax, zstart, zend[, vstar])``, and returns
the normalized (B, H, W) float32 crops.

Results are bit-equal to the JAX function on the CPU.  That holds because
the operations are the same and in the same order:

* a uint16 ``src`` is decoded here, a code of 1 to the frame's ``vstar``
  (so the host-to-device copy moves half the bytes);
* the pointwise chain (NV sentinel, near clamp, far cut, premax/zero to
  the far plane, clip, normalize) runs on the source crop first and the
  nearest-neighbour warp after it, as the JAX function orders them;
* source coordinates are ``(m[r, 0] * x + m[r, 1] * y + m[r, 2]) / w``
  in float32, each product and sum rounded on its own, and rounded to a
  pixel with ``floor(x + 0.5)``.  XLA's CPU backend does not contract
  these products into fused multiply-adds (over random rotations each
  FMA spelling moves some pixels, the plain one none), so unlike the
  crop math of ``ops/kernels/warp.py`` no ``fma`` is spelled out here;
* an out-of-range pixel takes ``chain(pad_value)``.  The range test is
  taken on the float coordinates, before any float -> int conversion.

The JAX function's one-hot einsums were a TPU workaround; here the warp
is a gather.  Each sample's warp is a full 3x3 transform (rotations by up
to +-180 degrees), so a source index depends on both output row and
column: the serving kernel's separable ``frame[iy[r], ix[c]]`` gather
does not fit it.  This module is plain PyTorch on whatever device its
inputs are on; it replaces an XLA function, not a Pallas kernel.

Beside it is the host half of ``lsps_tpu/data/augment.py``: ``normalize``
/ ``denormalize`` of a crop, the default augment modes and ``augment_crop``,
the per-sample augment of the ``host`` backend (numpy, the warps of
``data/detector.py``), bit-equal to the JAX package's on the same
``RandomState``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

# the float32 rounding of a Python number: a weakly typed constant of the
# JAX function
from lsps_tpu_torch.ops.kernels.warp import _f32

PAD_VALUE = 0.0
NV_VAL = 32000.0

AUG_MODES_DEFAULT = ["none", "com", "rot"]  # dataset_hand2.py:139,271


def normalize(img: np.ndarray, com, cube) -> np.ndarray:
    """In-place host depth normalization to [-1, 1] around the CoM depth
    (dataset_hand2.py:27-31): background (0) -> far plane, subtract com_z,
    divide by half cube depth."""
    img[img == 0] = com[2] + cube[2] / 2.0
    img -= com[2]
    img /= cube[2] / 2.0
    return img


def denormalize(img: np.ndarray, com, cube) -> np.ndarray:
    """Inverse of :func:`normalize` (up to the background collapse)."""
    return img * (cube[2] / 2.0) + com[2]


def augment_crop(img, gt3d_crop, com_img, cube, M, aug_modes, hd,
                 norm_zero_one=False, sigma_com=None, sigma_sc=None,
                 rot_range=None, rng=None):
    """Randomly augment one normalized crop (dataset_hand2.py:34-119).

    ``img`` is the normalized crop, ``com_img`` the CoM in image coords
    (u, v, z), ``hd`` the dataset's ``HandDetector``.  The draws keep the
    reference order (mode, offset, rotation, scale), all four whatever the
    mode, so a shared RandomState gives the same stream.

    Returns (img, None, label, cube, com_img, M, rot); the label is
    gt3Dcrop / (cube_z / 2) after the augment.
    """
    assert img.ndim == 2
    assert isinstance(aug_modes, list)
    sigma_com = 10.0 if sigma_com is None else sigma_com
    sigma_sc = 0.05 if sigma_sc is None else sigma_sc
    rot_range = 180.0 if rot_range is None else rot_range

    img = np.array(img, np.float32, copy=True)
    com_img = np.asarray(com_img, np.float32)
    cube = np.asarray(cube, np.float32)

    # denormalize to mm (dataset_hand2.py:64-67)
    if norm_zero_one:
        img = img * cube[2] + (com_img[2] - cube[2] / 2.0)
    else:
        img = img * (cube[2] / 2.0) + com_img[2]
    premax = img.max()

    # the reference draw order (dataset_hand2.py:70-73)
    mode = rng.randint(0, len(aug_modes))
    off = rng.randn(3) * sigma_com
    rot = rng.uniform(-rot_range, rot_range)
    sc = abs(1.0 + rng.randn() * sigma_sc)

    mode_name = aug_modes[mode]
    # the branches other than rot return rot = 0.0, as the reference
    # zeroes the unused draws (dataset_hand2.py:75-99)
    if mode_name == "com":
        rot = 0.0
        img_d, new_joints, com_img, M = hd.move_com(
            img.astype("float32"), cube, com_img, off, gt3d_crop, M,
            pad_value=0)
        label = new_joints / (cube[2] / 2.0)
    elif mode_name == "rot":
        img_d, new_joints, rot = hd.rotate_hand(
            img.astype("float32"), cube, com_img, rot, gt3d_crop,
            pad_value=0)
        label = new_joints / (cube[2] / 2.0)
    elif mode_name == "sc":
        rot = 0.0
        img_d, new_joints, cube, M = hd.scale_hand(
            img.astype("float32"), cube, com_img, sc, gt3d_crop, M,
            pad_value=0)
        label = new_joints / (cube[2] / 2.0)
    elif mode_name == "none":
        rot = 0.0
        img_d = img
        label = gt3d_crop / (cube[2] / 2.0)
    else:
        raise NotImplementedError(mode_name)

    img_d = np.asarray(img_d, np.float32)
    # re-clamp and renormalize with the premax sentinel
    # (dataset_hand2.py:103-116)
    far = com_img[2] + cube[2] / 2.0
    near = com_img[2] - cube[2] / 2.0
    img_d[img_d == premax] = far
    img_d[img_d == 0] = far
    img_d[img_d >= far] = far
    img_d[img_d <= near] = near
    if norm_zero_one:
        img_d -= near
        img_d /= cube[2]
    else:
        img_d -= com_img[2]
        img_d /= cube[2] / 2.0

    return (img_d, None, label, np.asarray(cube), com_img,
            np.array(M, dtype="float32"), rot)


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` on ``device``, in its own dtype (a uint16 source crosses at
    half width) or in ``dtype``."""
    t = torch.as_tensor(x).to(device)
    return t if dtype is None else t.to(dtype)


def decode_src(src: torch.Tensor, vstar: Optional[torch.Tensor]):
    """(B, H, W) float32 mm from float32 mm or uint16 codes (code 1 ->
    the frame's ``vstar``, every other code its own value)."""
    if src.dtype == torch.uint16:
        if vstar is None:
            raise ValueError("uint16 src needs vstar")
        f = src.to(torch.float32)
        return torch.where(f == 1.0, vstar.to(torch.float32)[:, None, None],
                           f)
    return src.to(torch.float32)


def normalize_chain(v: torch.Tensor, com_z, cube_z, premax, zstart, zend,
                    nv_val: float = NV_VAL,
                    pad_value: float = PAD_VALUE) -> torch.Tensor:
    """The pointwise chain of ``augmentCrop`` on (B, ...) values with
    per-sample (B, 1, ...) parameters: NV sentinel -> pad, near clamp,
    beyond ``zend`` -> 0, premax or 0 -> far plane, clip, normalize to the
    cube."""
    far = com_z + cube_z * 0.5
    near = com_z - cube_z * 0.5
    v = torch.where((v - nv_val).abs() <= _f32(1e-5 * abs(nv_val)),
                    _f32(pad_value), v)
    v = torch.where((v != 0.0) & (v < zstart), zstart, v)
    v = torch.where((v != 0.0) & (v > zend), 0.0, v)
    v = torch.where((v == premax) | (v == 0.0), far, v)
    v = torch.clamp(v, near, far)
    return (v - com_z) / (cube_z * 0.5)


def source_coords(minv: torch.Tensor, h: int, w: int):
    """Per output pixel, the float32 source (x, y) of a (B, 3, 3)
    dst -> src transform: each product and sum rounded on its own."""
    out_x = torch.arange(w, dtype=torch.float32, device=minv.device)[None,
                                                                     None]
    out_y = torch.arange(h, dtype=torch.float32,
                         device=minv.device)[None, :, None]
    m = minv[:, :, :, None, None]

    def row(r):
        return m[:, r, 0] * out_x + m[:, r, 1] * out_y + m[:, r, 2]

    ww = row(2)
    return row(0) / ww, row(1) / ww


def recrop_normalize_batch(src, minv, com_z, cube_z, premax, zstart, zend,
                           vstar=None, pad_value: float = PAD_VALUE,
                           nv_val: float = NV_VAL,
                           device=None) -> torch.Tensor:
    """The raw tuple -> (B, H, W) float32 normalized crops, on ``device``
    (the device of ``src`` if it is a tensor and none is named, else the
    CPU).  Inputs may be numpy arrays or tensors; ``minv`` may be float64
    and is taken in float32."""
    if device is None:
        device = src.device if isinstance(src, torch.Tensor) else "cpu"
    src = _as_tensor(src, device)
    vstar = None if vstar is None else _as_tensor(vstar, device,
                                                  torch.float32)
    s = decode_src(src, vstar)
    b, h, w = s.shape
    minv = _as_tensor(minv, device, torch.float32)
    cz, qz, pm, zs, ze = (_as_tensor(p, device, torch.float32)[:, None, None]
                          for p in (com_z, cube_z, premax, zstart, zend))

    sn = normalize_chain(s, cz, qz, pm, zs, ze, nv_val, pad_value)
    pad_n = normalize_chain(torch.full_like(cz, _f32(pad_value)), cz, qz, pm,
                            zs, ze, nv_val, pad_value)

    sx, sy = source_coords(minv, h, w)
    fx, fy = torch.floor(sx + 0.5), torch.floor(sy + 0.5)
    inside = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    iy = torch.where(inside, fy, 0.0).to(torch.int64)
    ix = torch.where(inside, fx, 0.0).to(torch.int64)
    v = torch.gather(sn.reshape(b, h * w), 1, (iy * w + ix).reshape(b, -1))
    return torch.where(inside, v.reshape(b, h, w), pad_n)


def stack_raw(raws: Sequence[tuple]) -> tuple:
    """K raw tuples -> one tuple with each leaf stacked on a leading K
    axis (as the CLIs stack a chunk of steps)."""
    return tuple(np.stack([np.asarray(r[i]) for r in raws])
                 for i in range(len(raws[0])))
