"""Batched training augment: host warp parameters, image work in one call.

The port's copy of ``lsps_tpu/data/fast_augment.py`` (semantics of the
reference ``augmentCrop``, dataset_hand2.py:34-119).  ``raw_batch`` draws
each sample's mode, CoM offset, rotation and scale in the reference order
on the dataset's ``RandomState`` and computes the labels and the warp
parameters in numpy, bit for bit as the JAX package does.  The image work
of a whole batch is then one call:

* ``'step'``: inside the training step (the trainer's ``*_raw`` updates,
  :func:`lsps_tpu_torch.data.augment.recrop_normalize_batch`);
* ``'jax'``: the same function here in ``batch``, on the trainer's device,
  copied back to the host;
* ``'native'``: the port's build of the C++ host library
  (``lsps_tpu_torch/native``), bit-equal to the JAX package's ``native``
  backend.  It rounds coordinates in double, half away from zero, so it
  may pick another source pixel than the device augment at exact ties.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lsps_tpu_torch import resolve_device
from lsps_tpu_torch.data.augment import (NV_VAL, PAD_VALUE,
                                         recrop_normalize_batch)
from lsps_tpu_torch.data.basetypes import decode_dpt_u16
from lsps_tpu_torch.data.detector import HandDetector


def _batched_inv3(Ms):
    """Stacked 3x3 inverses (same LAPACK path as per-sample inv)."""
    return np.linalg.inv(Ms)


def _batched_rotation_dst_to_src(center, rot_deg):
    """Inverse of ``cv2.getRotationMatrix2D(center, -rot, 1)`` over (m,)
    angles: the forward warp rotates the image by ``rot``, sampling goes
    the other way."""
    a = np.deg2rad(-np.asarray(rot_deg, np.float64))
    ca, sa = np.cos(a), np.sin(a)
    cx, cy = center
    m = a.shape[0]
    fwd = np.zeros((m, 3, 3))
    fwd[:, 0, 0] = ca
    fwd[:, 0, 1] = sa
    fwd[:, 0, 2] = (1 - ca) * cx - sa * cy
    fwd[:, 1, 0] = -sa
    fwd[:, 1, 1] = ca
    fwd[:, 1, 2] = sa * cx + (1 - ca) * cy
    fwd[:, 2, 2] = 1.0
    return np.linalg.inv(fwd)


def _batched_com_to_transform(coms, cube, dsize, fx, fy, cubes_arr=None):
    """Vectorized ``HandDetector.com_to_transform`` (handdetector.py:
    230-260) in the scalar path's dtypes: bounds math in f32 (weak
    promotion of the python-float intrinsics), scale in f64, size math in
    ints with py2 ``//``, and the reference's swapped-sz centering."""
    coms = np.asarray(coms, np.float32)
    m = coms.shape[0]
    if cubes_arr is None:
        chx = np.full(m, np.float32(cube[0] / 2.0), np.float32)
        chy = np.full(m, np.float32(cube[1] / 2.0), np.float32)
    else:
        chx = (cubes_arr[:, 0].astype(np.float32)
               / np.float32(2.0))
        chy = (cubes_arr[:, 1].astype(np.float32)
               / np.float32(2.0))
    u, v, z = coms[:, 0], coms[:, 1], coms[:, 2]
    fx32, fy32 = np.float32(fx), np.float32(fy)
    with np.errstate(divide="ignore", invalid="ignore"):
        xs = np.floor((u * z / fx32 - chx) / z * fx32 + np.float32(0.5))
        xe = np.floor((u * z / fx32 + chx) / z * fx32 + np.float32(0.5))
        ys = np.floor((v * z / fy32 - chy) / z * fy32 + np.float32(0.5))
        ye = np.floor((v * z / fy32 + chy) / z * fy32 + np.float32(0.5))

    def _i(a):
        return np.where(np.isfinite(a), a, 0.0).astype(np.int64)

    xs, xe, ys, ye = _i(xs), _i(xe), _i(ys), _i(ye)
    wb, hb = xe - xs, ye - ys
    wbs, hbs = np.maximum(wb, 1), np.maximum(hb, 1)
    d0, d1 = dsize
    wide = wb > hb
    s = np.where(wide, float(d0) / wbs, float(d1) / hbs)
    sz0 = np.where(wide, d0, wb * d1 // hbs)
    sz1 = np.where(wide, hb * d0 // wbs, d1)
    # sz components swapped in the centering, as in the reference
    # (handdetector.py:254-255)
    xoff = np.floor(d0 / 2.0 - sz1 / 2.0)
    yoff = np.floor(d1 / 2.0 - sz0 / 2.0)
    M = np.zeros((m, 3, 3))
    M[:, 0, 0] = s
    M[:, 1, 1] = s
    M[:, 2, 2] = 1.0
    M[:, 0, 2] = s * (-xs) + xoff
    M[:, 1, 2] = s * (-ys) + yoff
    return M


class FastAugmenter:
    """Batched augment of a hand dataset.

    Usage::

        fa = FastAugmenter(dataset, "jax", device=torch.device("cuda"))
        imgs, labels, coms, Ms, cubes = fa.batch(indices)
    """

    def __init__(self, dataset, backend: str = "step", device=None):
        """backend: ``'step'`` (``raw_batch`` only), ``'jax'`` (``batch``:
        the image work on ``device``, the card unless one is named; without
        a card and a named device this raises) or ``'native'`` (``batch``:
        the C++ host library, built here if it is not built yet)."""
        self.ds = dataset
        self.di = dataset.di
        self.hd: HandDetector = dataset.hd
        self.rng = dataset.rng
        self.aug_modes = dataset.aug_modes
        self.backend = backend
        self.device = (resolve_device(device) if backend == "jax"
                       else device)
        if backend == "native":
            from lsps_tpu_torch import native

            native.get_lib()

    def raw_batch(self, idxs):
        """Per-sample augment parameters without the image work:
        ``(raw, labels, com3d, Ms, cubes)`` where ``raw`` is the 7-tuple
        ``(src, minv, com_z, cube_z, premax, zstart, zend)`` (8 with the
        uint16 ``vstar``).  The draws keep the reference order
        (dataset_hand2.py:70-73)."""
        ds, di = self.ds, self.di
        seq = ds.seq
        n = len(idxs)
        h, w = seq.dpt.shape[1:]
        cube0 = seq.cube

        if seq.dpt.dtype == np.uint16:
            # the half-size raw-mm form (basetypes.encode_dpt_u16): the
            # codes go to the device, which decodes them
            src = np.ascontiguousarray(seq.dpt[idxs])
            vstar = np.ascontiguousarray(seq.dpt_vstar[idxs], np.float32)
        else:
            src = np.ascontiguousarray(seq.dpt[idxs], np.float32)
            vstar = None
        gt3d = seq.gt3Dcrop[idxs].astype(np.float32)
        com3d = seq.com[idxs].astype(np.float32)
        M0 = seq.M[idxs].astype(np.float64)

        minv = np.tile(np.eye(3)[None], (n, 1, 1))
        Ms = M0.astype(np.float32).copy()
        cubes = np.tile(np.asarray(cube0, np.float32)[None], (n, 1))
        coms2d = di.joint_3d_to_img(com3d).astype(np.float32)
        labels = np.empty_like(gt3d)
        # f64: holds the f64-projected new_com of 'com' samples exactly
        # (the host path keeps new_com at f64 through the clamp bounds)
        out_com2d = coms2d.astype(np.float64)

        # draws stay sequential, all four per sample whatever the mode
        # (dataset_hand2.py:70-73); the math is vectorized per mode group
        modes = np.empty(n, np.int64)
        offs = np.empty((n, 3))
        rots = np.empty(n)
        scs = np.empty(n)
        for k in range(n):
            modes[k] = self.rng.randint(0, len(self.aug_modes))
            offs[k] = self.rng.randn(3) * 10.0
            rots[k] = self.rng.uniform(-180.0, 180.0)
            scs[k] = abs(1.0 + self.rng.randn() * 0.05)
        names = np.asarray([self.aug_modes[m] for m in modes])
        half = cube0[2] / 2

        is_com = names == "com"
        if is_com.any():
            c2 = coms2d[is_com]
            c3 = di.joint_img_to_3d(c2)
            # float64 through the projection: com_to_transform's
            # int(floor(x + 0.5)) bounds can flip a whole pixel if new_com
            # is narrowed to f32
            new_com = di.joint_3d_to_img(c3 + offs[is_com])
            valid = ~(np.isclose(c2[:, 2], 0, atol=1e-8)
                      | np.isclose(new_com[:, 2], 0, atol=1e-8))
            Mnew = _batched_com_to_transform(new_com, cube0, (h, w),
                                             di.fx, di.fy)
            mi = np.matmul(M0[is_com], _batched_inv3(Mnew))
            rows = np.nonzero(is_com)[0]
            vrows = rows[valid]
            minv[vrows] = mi[valid]
            Ms[vrows] = Mnew[valid]
            out_com2d[rows] = new_com
            nc3 = di.joint_img_to_3d(new_com)
            labels[rows] = (gt3d[is_com] + c3[:, None, :]
                            - nc3[:, None, :]) / half

        is_rot = names == "rot"
        if is_rot.any():
            rotm = np.mod(rots[is_rot], 360)
            minv[is_rot] = _batched_rotation_dst_to_src(
                (w // 2, h // 2), rotm)
            m = int(is_rot.sum())
            c2 = coms2d[is_rot]
            c3 = di.joint_img_to_3d(c2)
            j2 = di.joint_3d_to_img(
                (gt3d[is_rot] + c3[:, None, :]).reshape(-1, 3)
            ).reshape(m, -1, 3)
            # rotate_points_2d, batched per-sample angle
            a = np.deg2rad(rotm)
            R = np.empty((m, 2, 2), np.float32)
            R[:, 0, 0] = np.cos(a)
            R[:, 0, 1] = -np.sin(a)
            R[:, 1, 0] = np.sin(a)
            R[:, 1, 1] = np.cos(a)
            uv = j2[:, :, :2] - c2[:, None, :2]
            uvr = np.einsum("mjk,mik->mji", uv, R) + c2[:, None, :2]
            j2r = np.concatenate([uvr, j2[:, :, 2:]], axis=-1)
            labels[is_rot] = (di.joint_img_to_3d(
                j2r.reshape(-1, 3)).reshape(m, -1, 3)
                - c3[:, None, :]) / half

        is_sc = names == "sc"
        if is_sc.any():
            # per-sample f32 * python-float product (the original rounding)
            new_cubes = np.stack([np.asarray(cube0, np.float32) * s
                                  for s in scs[is_sc]])
            c2 = coms2d[is_sc]
            valid = ~np.isclose(c2[:, 2], 0, atol=1e-8)
            Mnew = _batched_com_to_transform(c2, None, (h, w), di.fx,
                                             di.fy, cubes_arr=new_cubes)
            mi = np.matmul(M0[is_sc], _batched_inv3(Mnew))
            rows = np.nonzero(is_sc)[0]
            vrows = rows[valid]
            minv[vrows] = mi[valid]
            Ms[vrows] = Mnew[valid]
            cubes[rows] = new_cubes
            labels[rows] = gt3d[is_sc] / (new_cubes[:, 2, None, None]
                                          / 2)

        is_none = ~(is_com | is_rot | is_sc)
        if is_none.any():
            labels[is_none] = gt3d[is_none] / half

        com_z = out_com2d[:, 2].astype(np.float32)
        cube_z = cubes[:, 2].astype(np.float32)
        # premax is the pre-augmentation far plane (from the original
        # com/cube, dataset_hand2.py:68); the clamp bounds use the updated
        # com/cube (dataset_hand2.py:111-116)
        premax = (coms2d[:, 2] + np.float32(cube0[2]) / 2.0).astype(
            np.float32)
        zstart = com_z - cube_z / 2.0
        zend = com_z + cube_z / 2.0

        com3d_out = di.joint_img_to_3d(out_com2d).astype(np.float32)
        # minv stays float64; the device augment takes it in float32
        raw = (src, minv, com_z, cube_z, premax, zstart, zend)
        if vstar is not None:
            raw = raw + (vstar,)
        return raw, labels.reshape(n, -1), com3d_out, Ms, cubes

    def batch(self, idxs) -> Tuple[np.ndarray, ...]:
        """One augmented batch: ``(imgs (B, 1, H, W), labels, com3d, Ms,
        cubes)`` on the host, the images made on ``self.device`` (``jax``)
        or by the host library (``native``)."""
        if self.backend not in ("jax", "native"):
            raise ValueError(f"backend {self.backend!r} yields raw batches "
                             "only; batch() needs 'jax' or 'native'")
        raw, labels, com3d_out, Ms, cubes = self.raw_batch(idxs)
        n = labels.shape[0]
        if self.backend == "native":
            from lsps_tpu_torch import native

            if len(raw) == 8:  # uint16 codes: the library takes mm
                raw = (decode_dpt_u16(raw[0], raw[7]),) + raw[1:7]
            imgs = native.fused_recrop_normalize_batch(
                *raw, pad_value=PAD_VALUE, nv_val=NV_VAL)
        else:
            imgs = recrop_normalize_batch(*raw, pad_value=PAD_VALUE,
                                          nv_val=NV_VAL,
                                          device=self.device).cpu().numpy()
        return (imgs[:, None], labels.reshape(n, -1), com3d_out, Ms, cubes)


def available(backend: str = "native") -> bool:
    """Whether the given batched backend can run here: ``'native'`` needs
    the C++ library to build and load; ``'jax'`` and ``'step'`` always
    can (``'jax'`` on a named device, or on a card)."""
    if backend in ("jax", "step"):
        return True
    from lsps_tpu_torch import native

    return native.available()
