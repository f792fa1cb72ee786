"""cv2's colour reading and 8-bit HSV conversion, in numpy.

The JAX package's POST importer reads a real frame's label image with
``cv2.imread(path, 1)``, converts it with ``cv2.cvtColor(img,
COLOR_BGR2HSV)`` and thresholds it with ``cv2.inRange``.  The card's
machine has no cv2, so the port reads PNGs with :mod:`.png` and does the
rest here, with cv2 5's results:

* :func:`imread_color` is ``cv2.imread(path, IMREAD_COLOR)``: 8-bit BGR,
  gray replicated to three channels, alpha dropped, 16-bit samples
  reduced to their high byte (libpng's ``strip_16``, not a rounding
  scale).
* :func:`bgr_to_hsv` is OpenCV's fixed-point ``RGB2HSV_b`` with
  ``hsv_shift = 12`` and its division tables, H in [0, 180); equal to
  cv2 over all 2^24 BGR triples.
* :func:`in_range` is ``cv2.inRange``: 255 where every channel lies in
  [lo, hi], else 0.
"""

from __future__ import annotations

import numpy as np

from lsps_tpu_torch.data.png import read_png

_HSV_SHIFT = 12


def imread_color(path) -> np.ndarray:
    """``cv2.imread(path, 1)`` of a PNG: an (H, W, 3) uint8 BGR image."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (2, 4):                  # drop alpha
        img = img[..., :-1]
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., ::-1])


def _division_tables():
    """``sdiv_table`` and ``hdiv_table180`` of ``RGB2HSV_b``:
    ``cvRound((255 << 12) / i)`` and ``cvRound((180 << 12) / (6 i))``,
    0 at i = 0."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.rint((255 << _HSV_SHIFT) / i)
        hdiv = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    sdiv[0] = hdiv[0] = 0
    return sdiv.astype(np.int32), hdiv.astype(np.int32)


def bgr_to_hsv(img) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` of a (..., 3) uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"bgr_to_hsv takes (..., 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    sdiv, hdiv = _division_tables()
    b, g, r = (img[..., k].astype(np.int32) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def in_range(img, lo, hi) -> np.ndarray:
    """``cv2.inRange(img, lo, hi)`` of an (H, W, C) image: (H, W) uint8,
    255 where every channel lies in [lo, hi]."""
    img = np.asarray(img)
    lo = np.asarray(lo).reshape(-1)
    hi = np.asarray(hi).reshape(-1)
    ok = np.all((img >= lo) & (img <= hi), axis=-1)
    return ok.astype(np.uint8) * 255
