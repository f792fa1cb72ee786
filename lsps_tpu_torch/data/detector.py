"""CoM-based 3D hand cropping, augment warps and pose sampling, in numpy
(no cv2).

The port's copy of ``lsps_tpu/data/detector.py``'s ``HandDetector``: CoM,
bounds, crop, resize, ``crop_area_3d``, ``apply_crop_3d``, the augment
warps of the per-sample host augment (``recrop_hand``, ``move_com``,
``rotate_hand``, ``scale_hand``) and the vectorized
``sample_random_poses``.  Every result is bit-equal to the JAX package's
on the same inputs.

The cv2 calls of that path are numpy here and pick the pixels cv2 picks:

* ``cv2.resize(..., INTER_NEAREST)`` is an index gather: OpenCV's
  ``resizeNN`` scales by ``inv = dst_size / src_size`` (a double) and reads
  source index ``min(floor(dst_index * (1 / inv)), src_size - 1)``.  The
  ratio ``src_size / dst_size`` rounds differently for some sizes and
  moves whole rows and columns.
* ``cv2.warpAffine`` and ``cv2.warpPerspective`` with ``INTER_NEAREST``
  and ``BORDER_CONSTANT`` (OpenCV 5) invert the matrix in double (the
  affine inverse of ``invertAffineTransform``, the 3 x 3 cofactor inverse
  of ``cv::invert``), cast it to float32, and per destination pixel
  compute ``X = fma(m0, x, m1 * y + m2)`` in float32 (the row term
  rounded per operation, the x term fused; numpy emulates the fused
  multiply-add with the exact float64 product rounded once), for the
  perspective warp ``X / W`` as a float32 division, and round half to
  even.  A source pixel outside the frame takes the border value.  This
  holds bit for bit at widths that are a multiple of cv2's vector block,
  which every 128 x 128 augment crop is; at other widths cv2's remainder
  columns may round another way (1 to 4 pixels over 1200 random warps at
  widths 127, 131 and 45).
* ``cv2.getRotationMatrix2D`` scales the angle by ``CV_PI / 180`` in
  double, as :func:`rotation_matrix_2d` does.

The linear resizes and warps (``resize_method`` other than
``RESIZE_CV2_NN``) are bit-equal too, found by probing cv2 5:

* ``cv2.resize(..., INTER_LINEAR)`` on float32 maps destination index
  ``d`` to ``(d + 0.5) * (src / dst) - 0.5`` in double, floors it, clamps
  at both edges (weight 0 on the far tap), casts the fraction to float32,
  and interpolates columns then rows, each as ``fma(b - a, t, a)`` in
  float32 (:func:`resize_linear`).
* ``cv2.warpAffine`` / ``cv2.warpPerspective`` with ``INTER_LINEAR``
  compute the source coordinate as the nearest warps do in their vector
  blocks of 16 columns, and as ``fma(m0, x, m1 * y) + m2`` in the columns
  past the last whole block; then ``floor``, the fraction in float32, the
  same two-level ``fma`` interpolation, and each corner outside the
  source taking the border value (:func:`warp_affine_linear`,
  :func:`warp_perspective_linear`).  Held bit for bit at widths 128, 127,
  131 and 45.
* ``bilinear_resize`` (``RESIZE_BILINEAR``) is the JAX package's
  vectorized copy of the reference's ND-aware loop: the same float64 grid,
  the same cascade of weights, the same float32 products and sums.

The closest-object detector and the tracker (``detect``,
``refine_com_iterative``, ``track`` with its ``refine_net`` hook,
``estimate_hand_size``) find contours with
:mod:`lsps_tpu_torch.data.contours`, which returns cv2's contours in cv2's
order, so the first contour over 200 pixels of area, and every CoM that
follows from it, is the JAX package's to the bit.

"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from lsps_tpu_torch.data.contours import (bounding_rect, contour_area,
                                         contour_moments, find_contours)
from lsps_tpu_torch.data.transformations import (rotate_points_2d,
                                                 rotate_points_3d)


def nearest_indices(src_size: int, dst_size: int) -> np.ndarray:
    """Source index of each destination index of OpenCV's
    nearest-neighbour resize along one axis."""
    inv_scale = float(dst_size) / float(src_size)
    idx = np.floor(np.arange(dst_size, dtype=np.float64) * (1.0 / inv_scale))
    return np.minimum(idx.astype(np.int64), src_size - 1)


def resize_nearest(src, dsize) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=cv2.INTER_NEAREST)`` with
    ``dsize = (width, height)``, as a numpy gather."""
    src = np.asarray(src)
    w, h = int(dsize[0]), int(dsize[1])
    if w <= 0 or h <= 0 or src.shape[0] == 0 or src.shape[1] == 0:
        raise ValueError(f"cannot resize {src.shape[:2]} to {(w, h)}")
    iy = nearest_indices(src.shape[0], h)
    ix = nearest_indices(src.shape[1], w)
    return src[iy[:, None], ix[None, :]]


def rotation_matrix_2d(center, angle, scale) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the (2, 3) float64 matrix that rotates
    by ``angle`` degrees (counter-clockwise) about ``center``, a float32
    point as OpenCV takes it."""
    a = float(angle) * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = float(np.float32(center[0])), float(np.float32(center[1]))
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(M) -> np.ndarray:
    """``cv2.invertAffineTransform`` of a (2, 3) matrix, in double."""
    m = [float(v) for v in np.asarray(M, np.float64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, -m[1] * d, -m[3] * d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def invert_3x3(M) -> np.ndarray:
    """``cv::invert`` of a 3 x 3 double matrix (its cofactor formulas);
    raises for a singular matrix, as ``warpPerspective`` would warp
    through the zero matrix OpenCV returns for it."""
    m = [[float(v) for v in row] for row in np.asarray(M, np.float64)]
    d = (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
         - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
         + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))
    if d == 0:
        raise ValueError("singular perspective matrix")
    d = 1.0 / d
    return np.array([
        [(m[1][1] * m[2][2] - m[1][2] * m[2][1]) * d,
         (m[0][2] * m[2][1] - m[0][1] * m[2][2]) * d,
         (m[0][1] * m[1][2] - m[0][2] * m[1][1]) * d],
        [(m[1][2] * m[2][0] - m[1][0] * m[2][2]) * d,
         (m[0][0] * m[2][2] - m[0][2] * m[2][0]) * d,
         (m[0][2] * m[1][0] - m[0][0] * m[1][2]) * d],
        [(m[1][0] * m[2][1] - m[1][1] * m[2][0]) * d,
         (m[0][1] * m[2][0] - m[0][0] * m[2][1]) * d,
         (m[0][0] * m[1][1] - m[0][1] * m[1][0]) * d]])


def _row_coords(inv, dsize):
    """Each row of the float32 inverse ``inv`` applied to every
    destination pixel: ``fma(m0, x, m1 * y + m2)`` in float32."""
    w, h = int(dsize[0]), int(dsize[1])
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    coords = []
    for m0, m1, m2 in inv:
        row = m1 * ys + m2                          # float32, rounded twice
        coords.append((np.float64(m0) * xs + row).astype(np.float32))
    return coords


def _gather_nearest(src, sx, sy, border):
    src = np.asarray(src)
    sh, sw = src.shape[:2]
    with np.errstate(invalid="ignore"):
        ix, iy = np.rint(sx), np.rint(sy)           # half to even
        ok = (ix >= 0) & (ix < sw) & (iy >= 0) & (iy < sh)
    out = np.full(sx.shape, border, src.dtype)
    out[ok] = src[iy[ok].astype(np.int64), ix[ok].astype(np.int64)]
    return out


def warp_affine_nearest(src, M, dsize, border=0.0) -> np.ndarray:
    """``cv2.warpAffine(src, M, dsize, flags=INTER_NEAREST,
    borderMode=BORDER_CONSTANT, borderValue=border)``; ``M`` maps source
    to destination, ``dsize`` is (width, height)."""
    inv = invert_affine(M).astype(np.float32)
    sx, sy = _row_coords(inv, dsize)
    return _gather_nearest(src, sx, sy, border)


def warp_perspective_nearest(src, M, dsize, border=0.0) -> np.ndarray:
    """``cv2.warpPerspective(src, M, dsize, flags=INTER_NEAREST,
    borderMode=BORDER_CONSTANT, borderValue=border)``; ``M`` maps source
    to destination, ``dsize`` is (width, height)."""
    inv = invert_3x3(M).astype(np.float32)
    x, y, w = _row_coords(inv, dsize)
    with np.errstate(divide="ignore", invalid="ignore"):
        return _gather_nearest(src, x / w, y / w, border)


# cv2 5's warp kernels compute this many columns per vector block; the
# columns past the last whole block take the scalar formula
_WARP_BLOCK = 16


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``fma(a, b, c)``: the exact float64 product and sum of
    float32 operands, rounded once."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _lerp32(a, b, t) -> np.ndarray:
    """``fma(b - a, t, a)`` in float32."""
    return _fma32(b - a, t, a)


def _linear_taps(src_size: int, dst_size: int):
    """cv2's INTER_LINEAR taps along one axis: the first source index, the
    second (clamped), and the float32 weight of the second."""
    fd = (np.arange(dst_size, dtype=np.float64) + 0.5) * (
        float(src_size) / float(dst_size)) - 0.5
    s = np.floor(fd)
    t = (fd - s).astype(np.float32)
    s = s.astype(np.int64)
    edge = (s < 0) | (s >= src_size - 1)
    t[edge] = 0.0
    s = np.clip(s, 0, src_size - 1)
    return s, np.minimum(s + 1, src_size - 1), t


def resize_linear(src, dsize) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=cv2.INTER_LINEAR)`` of a
    float32 image with ``dsize = (width, height)``, both sides at least 2
    on either end (cv2 takes another path for a single row or column)."""
    src = np.asarray(src)
    w, h = int(dsize[0]), int(dsize[1])
    if src.dtype != np.float32:
        raise ValueError(f"linear resize takes float32, not {src.dtype}")
    if min(w, h, src.shape[0], src.shape[1]) < 2:
        raise ValueError(f"cannot resize {src.shape[:2]} to {(w, h)} "
                         "linearly: a side below 2")
    x0, x1, tx = _linear_taps(src.shape[1], w)
    y0, y1, ty = _linear_taps(src.shape[0], h)
    rows = _lerp32(src[:, x0], src[:, x1], tx)
    return _lerp32(rows[y0], rows[y1], ty[:, None])


def _linear_coords(inv, dsize):
    """Each row of the float32 inverse ``inv`` applied to every
    destination pixel as cv2's linear warps do: the nearest warps' formula
    in whole vector blocks, ``fma(m0, x, m1 * y) + m2`` past them."""
    coords = _row_coords(inv, dsize)
    w, h = int(dsize[0]), int(dsize[1])
    tail = w // _WARP_BLOCK * _WARP_BLOCK
    if tail < w:
        ys, xs = np.mgrid[0:h, tail:w].astype(np.float32)
        for c, (m0, m1, m2) in zip(coords, inv):
            c[:, tail:] = _fma32(m0, xs, m1 * ys) + m2
    return coords


def _gather_linear(src, sx, sy, border):
    src = np.asarray(src, np.float32)
    with np.errstate(invalid="ignore"):
        fx, fy = np.floor(sx), np.floor(sy)
        tx = (sx - fx).astype(np.float32)
        ty = (sy - fy).astype(np.float32)
        # a non-finite or far coordinate reads the border at all corners
        far = ~(np.abs(fx) < 2 ** 24) | ~(np.abs(fy) < 2 ** 24)
    ix = np.where(far, -2, fx).astype(np.int64)
    iy = np.where(far, -2, fy).astype(np.int64)
    sh, sw = src.shape[:2]

    def corner(dy, dx):
        x, y = ix + dx, iy + dy
        ok = (x >= 0) & (x < sw) & (y >= 0) & (y < sh)
        out = np.full(sx.shape, border, np.float32)
        out[ok] = src[y[ok], x[ok]]
        return out

    top = _lerp32(corner(0, 0), corner(0, 1), tx)
    bottom = _lerp32(corner(1, 0), corner(1, 1), tx)
    return _lerp32(top, bottom, ty)


def warp_affine_linear(src, M, dsize, border=0.0) -> np.ndarray:
    """``cv2.warpAffine(src, M, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border)`` of a float32 image."""
    inv = invert_affine(M).astype(np.float32)
    sx, sy = _linear_coords(inv, dsize)
    return _gather_linear(src, sx, sy, border)


def warp_perspective_linear(src, M, dsize, border=0.0) -> np.ndarray:
    """``cv2.warpPerspective(src, M, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border)`` of a float32 image."""
    inv = invert_3x3(M).astype(np.float32)
    x, y, w = _linear_coords(inv, dsize)
    with np.errstate(divide="ignore", invalid="ignore"):
        return _gather_linear(src, x / w, y / w, border)


class HandDetector:
    """Crop a hand around its center of mass."""

    RESIZE_BILINEAR = 0
    RESIZE_CV2_NN = 1
    RESIZE_CV2_LINEAR = 2

    def __init__(self, dpt, fx, fy, importer=None, refine_net=None):
        dpt = np.asarray(dpt)
        # clamp usable depth range (handdetector.py:59-63)
        self.max_depth = min(6500, dpt.max())
        self.min_depth = max(10, dpt.min())
        self.dpt = dpt.copy()
        self.dpt[self.dpt > self.max_depth] = 0.0
        self.dpt[self.dpt < self.min_depth] = 0.0
        self.fx = fx
        self.fy = fy
        self.importer = importer      # provides joint projection
        self.refine_net = refine_net  # optional CoM refinement hook
        self.resize_method = self.RESIZE_CV2_NN

    @staticmethod
    def detection_mode_to_string(com, refine_net) -> str:
        """Cache-key string for the detection mode
        (handdetector.py:73-91)."""
        if com is False and refine_net is False:
            return "gt"
        if com is True and refine_net is False:
            return "com"
        if com is True and refine_net is True:
            return "comref"
        raise NotImplementedError(f"com {com}, refineNet {refine_net}")

    # ------------------------------------------------------------------
    def calculate_com(self, dpt) -> np.ndarray:
        """Depth-weighted center of mass in (u, v, z[mm]): the z sum in
        the frame's dtype, then the f64 divide (handdetector.py:93-110)."""
        dc = np.asarray(dpt).copy()
        dc[dc < self.min_depth] = 0
        dc[dc > self.max_depth] = 0
        num = np.count_nonzero(dc)
        if num == 0:
            return np.zeros(3)
        ys, xs = np.nonzero(dc > 0)
        com = np.array([xs.mean() * num, ys.mean() * num,
                        float(dc.sum())])
        return com / num

    def check_image(self, tol) -> bool:
        """Image has content iff std > tol (handdetector.py:112-122)."""
        return float(np.std(self.dpt)) >= tol

    def get_nd_value(self) -> float:
        """Mode of the out-of-range depth values, the background fill
        (handdetector.py:124-132)."""
        below = self.dpt[self.dpt < self.min_depth]
        above = self.dpt[self.dpt > self.max_depth]
        vals = below if below.shape[0] > above.shape[0] else above
        if vals.size == 0:
            return 0.0
        uniq, counts = np.unique(vals, return_counts=True)
        return float(uniq[np.argmax(counts)])

    # ------------------------------------------------------------------
    def com_to_bounds(self, com, size) -> Tuple[int, int, int, int, float,
                                                float]:
        """3D cube around CoM -> 2D bbox + z range
        (handdetector.py:206-228); ``floor(x + 0.5)`` rounding."""
        if np.isclose(com[2], 0.0):
            xstart = self.dpt.shape[0] // 4
            xend = xstart + self.dpt.shape[0] // 2
            ystart = self.dpt.shape[1] // 4
            yend = ystart + self.dpt.shape[1] // 2
            return xstart, xend, ystart, yend, self.min_depth, self.max_depth
        zstart = com[2] - size[2] / 2.0
        zend = com[2] + size[2] / 2.0
        xstart = int(np.floor((com[0] * com[2] / self.fx - size[0] / 2.0)
                              / com[2] * self.fx + 0.5))
        xend = int(np.floor((com[0] * com[2] / self.fx + size[0] / 2.0)
                            / com[2] * self.fx + 0.5))
        ystart = int(np.floor((com[1] * com[2] / self.fy - size[1] / 2.0)
                              / com[2] * self.fy + 0.5))
        yend = int(np.floor((com[1] * com[2] / self.fy + size[1] / 2.0)
                            / com[2] * self.fy + 0.5))
        return xstart, xend, ystart, yend, zstart, zend

    def com_to_transform(self, com, size, dsize=(128, 128)) -> np.ndarray:
        """Affine crop transform from CoM (handdetector.py:230-260)."""
        xstart, xend, ystart, yend, _, _ = self.com_to_bounds(com, size)
        trans = np.eye(3)
        trans[0, 2] = -xstart
        trans[1, 2] = -ystart
        wb, hb = xend - xstart, yend - ystart
        if wb > hb:
            scale = np.eye(3) * dsize[0] / float(wb)
            sz = (dsize[0], hb * dsize[0] // wb)
        else:
            scale = np.eye(3) * dsize[1] / float(hb)
            sz = (wb * dsize[1] // hb, dsize[1])
        scale[2, 2] = 1
        # the reference centers with sz components swapped
        # (handdetector.py:254-255); reproduced as-is
        xstart = int(np.floor(dsize[0] / 2.0 - sz[1] / 2.0))
        ystart = int(np.floor(dsize[1] / 2.0 - sz[0] / 2.0))
        off = np.eye(3)
        off[0, 2] = xstart
        off[1, 2] = ystart
        return off @ scale @ trans

    def get_crop(self, dpt, xstart, xend, ystart, yend, zstart, zend,
                 thresh_z=True, background=0) -> np.ndarray:
        """Crop bbox with out-of-image padding and z thresholding
        (handdetector.py:262-298): nearer-than-cube pixels clamp to zstart,
        farther-than-cube pixels go to 0."""
        cropped = dpt[max(ystart, 0):min(yend, dpt.shape[0]),
                      max(xstart, 0):min(xend, dpt.shape[1])].copy()
        pad_y = (abs(ystart) - max(ystart, 0),
                 abs(yend) - min(yend, dpt.shape[0]))
        pad_x = (abs(xstart) - max(xstart, 0),
                 abs(xend) - min(xend, dpt.shape[1]))
        pads = ((pad_y, pad_x) if cropped.ndim == 2
                else (pad_y, pad_x, (0, 0)))
        cropped = np.pad(cropped, pads, mode="constant",
                         constant_values=background)
        if thresh_z:
            msk1 = np.logical_and(cropped < zstart, cropped != 0)
            msk2 = np.logical_and(cropped > zend, cropped != 0)
            cropped[msk1] = zstart
            cropped[msk2] = 0.0
        return cropped

    def resize_crop(self, crop, sz) -> np.ndarray:
        """Resize with the configured method (handdetector.py:338-353)."""
        if self.resize_method == self.RESIZE_CV2_NN:
            return resize_nearest(crop, sz)
        if self.resize_method == self.RESIZE_CV2_LINEAR:
            return resize_linear(crop, sz)
        if self.resize_method == self.RESIZE_BILINEAR:
            return self.bilinear_resize(crop, sz, self.get_nd_value())
        raise NotImplementedError("Unknown resize method")

    @staticmethod
    def bilinear_resize(src, dsize, nd_value) -> np.ndarray:
        """Bilinear resize that treats ``nd_value`` pixels as missing
        (handdetector.py:134-204): per-corner weights zeroed for missing
        corners and the rest renormalized; more than two missing corners
        give ``nd_value``.  Offsets and weights in float64 (the reference's
        Python floats), each weighted corner and the running sum in
        float32, as the reference's scalar products round."""
        src = np.asarray(src, np.float32)
        out_h, out_w = dsize[1], dsize[0]
        x_ratio = float(src.shape[1] - 1) / out_w
        y_ratio = float(src.shape[0] - 1) / out_h
        rows = np.arange(out_h, dtype=np.float64)[:, None]
        cols = np.arange(out_w, dtype=np.float64)[None, :]
        y = (rows * y_ratio).astype(np.int64)
        x = (cols * x_ratio).astype(np.int64)
        y_diff = rows * y_ratio - y
        x_diff = cols * x_ratio - x
        c00 = src[y, x]
        c01 = src[y, x + 1]
        c10 = src[y + 1, x]
        c11 = src[y + 1, x + 1]
        zero = np.zeros(c00.shape)
        w00 = (1 - y_diff) * (1 - x_diff) + zero
        w01 = (1 - y_diff) * x_diff + zero
        w10 = y_diff * (1 - x_diff) + zero
        w11 = y_diff * x_diff + zero
        nd00, nd01 = c00 == nd_value, c01 == nd_value
        nd10, nd11 = c10 == nd_value, c11 == nd_value
        n_nd = (nd00.astype(int) + nd01.astype(int) + nd10.astype(int)
                + nd11.astype(int))
        # the reference's cascade of weight redistribution
        # (handdetector.py:173-186)
        w00 = np.where(nd00, 0.0, w00)
        w01 = np.where(nd00, 1.0 - w11 - w10, w01)
        w01 = np.where(nd01, 0.0, w01)
        w00 = np.where(nd01 & (w00 != 0.0), 1.0 - w11 - w10, w00)
        w10 = np.where(nd10, 0.0, w10)
        w11 = np.where(nd10, 1.0 - w01 - w00, w11)
        w11 = np.where(nd11, 0.0, w11)
        w10 = np.where(nd11 & (w10 != 0.0), 1.0 - w01 - w00, w10)
        # the normalizer summed as the reference sums it, and each weight
        # scaled before the products (handdetector.py:190-203)
        total = w11 + w10 + w01 + w00
        all_zero = total == 0.0
        scale = np.where(all_zero, 1.0, 1.0 / np.where(all_zero, 1.0, total))
        val = (w00 * scale).astype(np.float32) * c00
        val = val + (w01 * scale).astype(np.float32) * c01
        val = val + (w10 * scale).astype(np.float32) * c10
        val = val + (w11 * scale).astype(np.float32) * c11
        out = np.where(all_zero | (n_nd > 2), nd_value, val)
        return out.astype(np.float32)

    # ------------------------------------------------------------------
    def crop_area_3d(self, com=None, size=(250, 250, 250), dsize=(128, 128),
                     docom=False):
        """Crop the hand in a metric 3D cube, scale-normalized to distance
        (handdetector.py:384-492).

        Returns (128x128 float32 crop, 3x3 transform M, com (u,v,z)).
        """
        if len(size) != 3 or len(dsize) != 2:
            raise ValueError("size must be 3D and dsize 2D")
        if com is None:
            com = self.calculate_com(self.dpt)
        com = np.asarray(com, np.float64).copy()

        xstart, xend, ystart, yend, zstart, zend = self.com_to_bounds(com,
                                                                      size)
        cropped = self.get_crop(self.dpt, xstart, xend, ystart, yend, zstart,
                                zend)

        if docom:  # re-center on the crop's own CoM (handdetector.py:415-428)
            com = self.calculate_com(cropped)
            if np.allclose(com, 0.0):
                com[2] = cropped[cropped.shape[0] // 2,
                                 cropped.shape[1] // 2]
                if np.isclose(com[2], 0):
                    com[2] = 300.0
            com[0] += xstart
            com[1] += ystart
            xstart, xend, ystart, yend, zstart, zend = self.com_to_bounds(
                com, size)
            cropped = self.get_crop(self.dpt, xstart, xend, ystart, yend,
                                    zstart, zend)

        if docom and self.refine_net is not None and self.importer is not None:
            # move the CoM by the refinement hook's offset
            # (handdetector.py:430-447)
            rz = self.resize_crop(cropped, dsize)
            new_com3d = (self.refine_com(rz, size, com)
                         + self.importer.joint_img_to_3d(com))
            com = self.importer.joint_3d_to_img(new_com3d)
            if np.allclose(com, 0.0):
                com[2] = cropped[cropped.shape[0] // 2,
                                 cropped.shape[1] // 2]
            xstart, xend, ystart, yend, zstart, zend = self.com_to_bounds(
                com, size)
            cropped = self.get_crop(self.dpt, xstart, xend, ystart, yend,
                                    zstart, zend)

        wb, hb = xend - xstart, yend - ystart
        # aspect-preserving destination size; py2 floor division
        # (handdetector.py:449-454)
        if wb > hb:
            sz = (dsize[0], hb * dsize[0] // wb)
        else:
            sz = (wb * dsize[1] // hb, dsize[1])

        trans = np.eye(3)
        trans[0, 2] = -xstart
        trans[1, 2] = -ystart
        if cropped.shape[0] > cropped.shape[1]:
            scale = np.eye(3) * sz[1] / float(cropped.shape[0])
        else:
            scale = np.eye(3) * sz[0] / float(cropped.shape[1])
        scale[2, 2] = 1

        rz = self.resize_crop(cropped, sz)

        ret = np.ones(dsize, np.float32) * self.get_nd_value()
        xs = int(np.floor(dsize[0] / 2.0 - rz.shape[1] / 2.0))
        ys = int(np.floor(dsize[1] / 2.0 - rz.shape[0] / 2.0))
        ret[ys:ys + rz.shape[0], xs:xs + rz.shape[1]] = rz
        off = np.eye(3)
        off[0, 2] = xs
        off[1, 2] = ys
        return ret, off @ scale @ trans, com

    def apply_crop_3d(self, dpt, com, size, dsize, thresh_z=True,
                      background=None):
        """Crop an arbitrary image with the CoM cube
        (handdetector.py:355-382)."""
        xstart, xend, ystart, yend, zstart, zend = self.com_to_bounds(com,
                                                                      size)
        cropped = self.get_crop(dpt, xstart, xend, ystart, yend, zstart,
                                zend, thresh_z, background or 0)
        wb, hb = xend - xstart, yend - ystart
        if wb > hb:
            sz = (dsize[0], hb * dsize[0] // wb)
        else:
            sz = (wb * dsize[1] // hb, dsize[1])
        rz = self.resize_crop(cropped, sz)
        if background is None:
            background = self.get_nd_value()
        ret = np.ones(dsize, np.float32) * background
        xs = int(np.floor(dsize[0] / 2.0 - rz.shape[1] / 2.0))
        ys = int(np.floor(dsize[1] / 2.0 - rz.shape[0] / 2.0))
        ret[ys:ys + rz.shape[0], xs:xs + rz.shape[1]] = rz
        return ret

    # ------------------------------------------------------------------
    # detection / tracking (handdetector.py:506-636)
    # ------------------------------------------------------------------
    def refine_com_iterative(self, com, num_iter, size=(250, 250, 250)):
        """Iterative CoM refinement (handdetector.py:548-569): the CoM of
        the cube's crop, ``num_iter`` times; an empty crop keeps its
        centre pixel's depth."""
        com = np.asarray(com, np.float64).copy()
        for _ in range(num_iter):
            xstart, xend, ystart, yend, zstart, zend = self.com_to_bounds(
                com, size)
            cropped = self.get_crop(self.dpt, xstart, xend, ystart, yend,
                                    zstart, zend)
            com = self.calculate_com(cropped)
            if np.allclose(com, 0.0):
                com[2] = cropped[cropped.shape[0] // 2,
                                 cropped.shape[1] // 2]
            com[0] += max(xstart, 0)
            com[1] += max(ystart, 0)
        return com

    def detect(self, size=(250, 250, 250), do_hand_size=True):
        """Closest-object depth-sweep detector (handdetector.py:571-636):
        the depth range in 65 slices from the sixth on; in the first
        slice with a contour over 200 pixels of area, the CoM of that
        slice around the contour's centroid, refined 5 times.  Returns
        (com, cube); (zeros, size) when no slice holds one."""
        steps = 65
        dz = (self.max_depth - self.min_depth) / float(steps)
        for i in range(5, steps):
            lo = i * dz + self.min_depth
            hi = (i + 1) * dz + self.min_depth
            part = np.logical_and(self.dpt >= lo, self.dpt <= hi)
            if not part.any():
                # most slices are empty, and this test is ~30x cheaper
                # than find_contours' own check of the mask
                continue
            contours, _ = find_contours(part)
            for c in contours:
                if contour_area(c) <= 200:
                    continue
                m = contour_moments(c)
                cx = int(np.rint(m["m10"] / m["m00"]))
                cy = int(np.rint(m["m01"] / m["m00"]))
                xstart = int(max(cx - 100, 0))
                xend = int(min(cx + 100, self.dpt.shape[1] - 1))
                ystart = int(max(cy - 100, 0))
                yend = int(min(cy + 100, self.dpt.shape[0] - 1))
                cropped = self.dpt[ystart:yend, xstart:xend].copy()
                cropped[cropped < lo] = 0.0
                cropped[cropped > hi] = 0.0
                com = self.calculate_com(cropped)
                if np.allclose(com, 0.0):
                    com[2] = cropped[cropped.shape[0] // 2,
                                     cropped.shape[1] // 2]
                com[0] += xstart
                com[1] += ystart
                com = self.refine_com_iterative(com, 5, size)
                if do_hand_size:
                    return com, self._hand_size_from_depth(com, size)
                return com, size
        return np.zeros(3), size

    def track(self, com, size=(250, 250, 250), dsize=(128, 128),
              do_hand_size=True):
        """Track the CoM with the refinement net (handdetector.py:506-546):
        the net's metric offset added to the CoM's 3D point."""
        xstart, xend, ystart, yend, zstart, zend = self.com_to_bounds(com,
                                                                      size)
        cropped = self.get_crop(self.dpt, xstart, xend, ystart, yend, zstart,
                                zend)
        if self.refine_net is None or self.importer is None:
            raise RuntimeError("Need refine_net for tracking")
        rz = self.resize_crop(cropped, dsize)
        new_com3d = (self.refine_com(rz, size, com)
                     + self.importer.joint_img_to_3d(np.asarray(com)))
        com = self.importer.joint_3d_to_img(new_com3d)
        if np.allclose(com, 0.0):
            com[2] = cropped[cropped.shape[0] // 2, cropped.shape[1] // 2]
        if do_hand_size:
            return com, self._hand_size_from_depth(com, size)
        return com, size

    def refine_com(self, cropped, size, com):
        """Run the CoM refinement hook on the crop normalized to [-1, 1]
        around the CoM's depth (handdetector.py:638-680).  ``refine_net``
        is any callable from the crop to a (3,) offset in normalized
        units."""
        img = np.asarray(cropped, np.float32).copy()
        img[img == 0] = com[2] + size[2] / 2.0
        img[img >= com[2] + size[2] / 2.0] = com[2] + size[2] / 2.0
        img[img <= com[2] - size[2] / 2.0] = com[2] - size[2] / 2.0
        img -= com[2]
        img /= size[2] / 2.0
        return np.asarray(self.refine_net(img)) * (size[2] / 2.0)

    def _hand_size_from_depth(self, com, size):
        """The cube from the largest contour of the CoM's depth range."""
        zstart = com[2] - size[2] / 2.0
        zend = com[2] + size[2] / 2.0
        part = np.logical_and(self.dpt >= zstart, self.dpt <= zend)
        contours, _ = find_contours(part)
        if not contours:
            return size
        areas = [contour_area(cc) for cc in contours]
        return self.estimate_hand_size(contours[int(np.argmax(areas))], com,
                                       size)

    def estimate_hand_size(self, contour, com, cube=(250, 250, 250),
                           tol=0.0):
        """Metric cube estimate from the hand contour's bounding box
        (handdetector.py:920-946)."""
        x, y, w, h = bounding_rect(contour)
        xstart = (com[0] - w / 2.0) * com[2] / self.fx
        xend = (com[0] + w / 2.0) * com[2] / self.fx
        ystart = (com[1] - h / 2.0) * com[2] / self.fy
        yend = (com[1] + h / 2.0) * com[2] / self.fy
        sz = ((xend - xstart) + (yend - ystart)) / 2.0
        return (sz + tol, sz + tol, sz + tol)

    # ------------------------------------------------------------------
    # augment warps (handdetector.py:682-807)
    # ------------------------------------------------------------------
    def recrop_hand(self, crop, M, Mnew, target_size, background_value=0.0,
                    nv_val=0.0, thresh_z=True, com=None,
                    size=(250, 250, 250)) -> np.ndarray:
        """Re-crop by warping through M @ Mnew (handdetector.py:786-807)."""
        warp = (warp_perspective_nearest
                if self.resize_method == self.RESIZE_CV2_NN
                else warp_perspective_linear)
        warped = warp(crop, np.dot(M, Mnew), target_size,
                      border=float(background_value))
        warped[np.isclose(warped, nv_val)] = background_value
        if thresh_z:
            assert com is not None
            _, _, _, _, zstart, zend = self.com_to_bounds(com, size)
            msk1 = np.logical_and(warped < zstart, warped != 0)
            msk2 = np.logical_and(warped > zend, warped != 0)
            warped[msk1] = zstart
            warped[msk2] = 0.0
        return warped

    def move_com(self, dpt, cube, com, off, joints_3d, M, pad_value=0):
        """Simulate a CoM shift on an already-cropped image
        (handdetector.py:682-714)."""
        if np.allclose(off, 0.0):
            return dpt, joints_3d, com, M
        new_com = self.importer.joint_3d_to_img(
            self.importer.joint_img_to_3d(np.asarray(com)) + off)
        if not (np.allclose(com[2], 0.0) or np.allclose(new_com[2], 0.0)):
            Mnew = self.com_to_transform(new_com, cube, dpt.shape)
            new_dpt = self.recrop_hand(dpt, Mnew, np.linalg.inv(M),
                                       dpt.shape, background_value=pad_value,
                                       nv_val=32000.0, thresh_z=True,
                                       com=new_com, size=cube)
        else:
            Mnew, new_dpt = M, dpt
        new_joints = (joints_3d + self.importer.joint_img_to_3d(np.asarray(com))
                      - self.importer.joint_img_to_3d(new_com))
        return new_dpt, new_joints, new_com, Mnew

    def rotate_hand(self, dpt, cube, com, rot, joints_3d, pad_value=0):
        """In-plane rotation of crop + joints (handdetector.py:716-751)."""
        if np.allclose(rot, 0.0):
            return dpt, joints_3d, rot
        rot = np.mod(rot, 360)
        M = rotation_matrix_2d((dpt.shape[1] // 2, dpt.shape[0] // 2), -rot,
                               1)
        warp = (warp_affine_nearest
                if self.resize_method == self.RESIZE_CV2_NN
                else warp_affine_linear)
        new_dpt = warp(dpt, M, (dpt.shape[1], dpt.shape[0]), border=pad_value)
        com3d = self.importer.joint_img_to_3d(np.asarray(com))
        joint_2d = self.importer.joint_3d_to_img(joints_3d + com3d)
        data_2d = rotate_points_2d(joint_2d, np.asarray(com[:2], np.float32),
                                   rot)
        new_joints = self.importer.joint_img_to_3d(data_2d) - com3d
        return new_dpt, new_joints, rot

    def scale_hand(self, dpt, cube, com, sc, joints_3d, M, pad_value=0):
        """Virtual scale change via a different cube
        (handdetector.py:754-784)."""
        if np.allclose(sc, 1.0):
            return dpt, joints_3d, cube, M
        new_cube = [s * sc for s in cube]
        if not np.allclose(com[2], 0.0):
            Mnew = self.com_to_transform(com, new_cube, dpt.shape)
            new_dpt = self.recrop_hand(dpt, Mnew, np.linalg.inv(M),
                                       dpt.shape, background_value=pad_value,
                                       nv_val=32000.0, thresh_z=True,
                                       com=com, size=cube)
        else:
            Mnew, new_dpt = M, dpt
        return new_dpt, joints_3d, new_cube, Mnew

    # ------------------------------------------------------------------
    @staticmethod
    def sample_random_poses(importer, rng, base_poses, base_com, base_cube,
                            num_poses, nmax, aug_modes, retall=False,
                            rot3d=False, sigma_com=None, sigma_sc=None,
                            rot_range=None):
        """Vectorized random pose-space augmentation
        (handdetector.py:809-918): the five random draws happen up front
        in the reference order on the same RandomState, then each mode's
        arithmetic runs on its index subset as one batched expression."""
        sigma_com = 10.0 if sigma_com is None else sigma_com
        sigma_sc = 0.05 if sigma_sc is None else sigma_sc
        rot_range = 180.0 if rot_range is None else rot_range

        all_modes = ["none", "rot", "sc", "com", "rot+com", "com+rot",
                     "rot+com+sc", "rot+sc+com", "sc+rot+com", "sc+com+rot",
                     "com+sc+rot", "com+rot+sc"]
        bad = [m for m in aug_modes if m not in all_modes]
        if bad:
            raise ValueError(f"unknown augmentation modes {bad}")

        base_poses = np.asarray(base_poses, np.float32)
        base_com = np.asarray(base_com, np.float32)
        base_cube = np.asarray(base_cube, np.float32)
        num_poses = int(num_poses)
        p2use = int(min(base_poses.shape[0], nmax))

        # the reference's draw order (handdetector.py:845-849)
        modes = rng.randint(0, len(aug_modes), num_poses)
        ridxs = rng.randint(0, p2use, num_poses)
        off = rng.randn(num_poses, 3) * sigma_com
        sc = np.fabs(rng.randn(num_poses) * sigma_sc + 1.0)
        rot = rng.uniform(-rot_range, rot_range, size=(num_poses, 3))

        if aug_modes == ["none"]:
            norm = base_poses / (base_cube[:, 2] / 2.0)[:, None, None]
            if retall:
                return norm, base_com, base_cube
            return norm

        cube = base_cube[ridxs]                       # (N, 3)
        com3d = base_com[ridxs]                       # (N, 3)
        pose = base_poses[ridxs].astype(np.float32)   # (N, J, 3)
        new_com = com3d.copy()
        new_cube = cube.copy()
        new_poses = np.zeros_like(pose)
        mode_names = np.asarray(aug_modes)[modes]

        def _rot2d_batch(poses_c, centers, angles):
            """Rotate each pose's 2D projection around its center."""
            j2 = importer.joint_3d_to_img(poses_c)      # (N, J, 3)
            a = np.deg2rad(angles)[:, None]
            ca, sa = np.cos(a), np.sin(a)
            du = j2[..., 0] - centers[:, None, 0]
            dv = j2[..., 1] - centers[:, None, 1]
            ru = du * ca - dv * sa + centers[:, None, 0]
            rv = du * sa + dv * ca + centers[:, None, 1]
            out = np.stack([ru, rv, j2[..., 2]], axis=-1)
            return importer.joint_img_to_3d(out)

        m = mode_names == "com"
        if m.any():  # handdetector.py:865-869
            new_com[m] = com3d[m] + off[m]
            new_poses[m] = ((pose[m] + com3d[m, None] - new_com[m, None])
                            / (new_cube[m, 2] / 2.0)[:, None, None])

        m = mode_names == "rot"
        if m.any():  # handdetector.py:870-879
            if not rot3d:
                centers = importer.joint_3d_to_img(com3d[m])[:, :2]
                r3 = _rot2d_batch(pose[m] + new_com[m, None], centers,
                                  rot[m, 0])
                new_poses[m] = ((r3 - new_com[m, None])
                                / (new_cube[m, 2] / 2.0)[:, None, None])
            else:
                for i in np.nonzero(m)[0]:
                    new_poses[i] = (rotate_points_3d(
                        pose[i] + new_com[i], new_com[i], rot[i, 0],
                        rot[i, 1], rot[i, 2]) - new_com[i]) / (
                            new_cube[i, 2] / 2.0)

        m = mode_names == "sc"
        if m.any():  # handdetector.py:880-884
            new_cube[m] = cube[m] * sc[m, None]
            new_poses[m] = pose[m] / (new_cube[m, 2] / 2.0)[:, None, None]

        m = mode_names == "none"
        if m.any():  # handdetector.py:885-889
            new_poses[m] = pose[m] / (new_cube[m, 2] / 2.0)[:, None, None]

        m = np.isin(mode_names, ["rot+com", "com+rot"])
        if m.any():  # handdetector.py:890-900
            new_com[m] = com3d[m] + off[m]
            pshift = pose[m] + com3d[m, None] - new_com[m, None]
            if not rot3d:
                centers = importer.joint_3d_to_img(new_com[m])[:, :2]
                r3 = _rot2d_batch(pshift + com3d[m, None], centers, rot[m, 0])
                new_poses[m] = ((r3 - com3d[m, None])
                                / (new_cube[m, 2] / 2.0)[:, None, None])
            else:
                idx = np.nonzero(m)[0]
                for k, i in enumerate(idx):
                    new_poses[i] = (rotate_points_3d(
                        pshift[k] + new_com[i], new_com[i], rot[i, 0],
                        rot[i, 1], rot[i, 2]) - new_com[i]) / (
                            new_cube[i, 2] / 2.0)

        m = np.isin(mode_names, ["rot+com+sc", "rot+sc+com", "sc+rot+com",
                                 "sc+com+rot", "com+sc+rot", "com+rot+sc"])
        if m.any():  # handdetector.py:901-912
            new_com[m] = com3d[m] + off[m]
            pshift = (pose[m] + com3d[m, None] - new_com[m, None]) \
                * sc[m, None, None]
            if not rot3d:
                centers = importer.joint_3d_to_img(new_com[m])[:, :2]
                r3 = _rot2d_batch(pshift + com3d[m, None], centers, rot[m, 0])
                new_poses[m] = ((r3 - com3d[m, None])
                                / (new_cube[m, 2] / 2.0)[:, None, None])

        if retall:
            return new_poses, new_com, new_cube, rot
        return new_poses
