"""The port's contour primitives (``lsps_tpu_torch/data/contours.py``)
against cv2, which the JAX package's host detector calls.

``find_contours`` must give ``cv2.findContours(mask, RETR_TREE,
CHAIN_APPROX_SIMPLE)``'s contours exactly: the same vertices, in the same
order, with the same hierarchy.  ``contour_area``, ``contour_moments``
(m00, m10, m01) and ``bounding_rect`` must equal ``cv2.contourArea``,
``cv2.moments`` and ``cv2.boundingRect`` to the bit on each contour.
Masks: seeded random shapes of each kind the detector meets (rectangles,
discs, rings, holes within holes, blobs touching the border, one-pixel
lines, isolated pixels, diagonal-only links, noise with hundreds of
borders), every slice mask of the detector's depth sweep over three
rendered hands, and a hand-built scene whose order and hierarchy are
pinned.
"""

import numpy as np
import pytest

from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.data.contours import (bounding_rect, contour_area,
                                          contour_moments, find_contours)
from lsps_tpu_torch.data.synthetic import render_hand_depth

cv2 = pytest.importorskip("cv2")


def assert_like_cv2(mask, what=""):
    """``find_contours`` and the three measures equal cv2's on ``mask``;
    returns the number of contours."""
    mask = np.ascontiguousarray(mask, np.uint8)
    want, want_h = cv2.findContours(mask, cv2.RETR_TREE,
                                    cv2.CHAIN_APPROX_SIMPLE)
    got, got_h = find_contours(mask)
    assert len(got) == len(want), what
    if not want:
        assert want_h is None and got_h.shape == (0, 4)
        return 0
    np.testing.assert_array_equal(got_h, want_h[0], err_msg=what)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int32 and g.shape == (len(w), 2), (what, k)
        np.testing.assert_array_equal(g, w.reshape(-1, 2),
                                      err_msg=f"{what} contour {k}")
        assert contour_area(g) == cv2.contourArea(w), (what, k)
        m, cm = contour_moments(g), cv2.moments(w)
        for key in ("m00", "m10", "m01"):
            assert m[key] == cm[key], (what, k, key)
        assert bounding_rect(g) == tuple(cv2.boundingRect(w)), (what, k)
    return len(want)


def _disc(mask, cy, cx, r, value=1):
    ys, xs = np.ogrid[:mask.shape[0], :mask.shape[1]]
    mask[(ys - cy) ** 2 + (xs - cx) ** 2 <= r * r] = value


def _rectangles(rs, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(rs.randint(1, 8)):
        y, x = rs.randint(0, h), rs.randint(0, w)
        m[y:y + rs.randint(1, h // 2), x:x + rs.randint(1, w // 2)] = 255
    return m


def _discs(rs, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(rs.randint(1, 6)):
        _disc(m, rs.randint(0, h), rs.randint(0, w), rs.randint(1, 12))
    return m


def _rings(rs, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(rs.randint(1, 4)):
        cy, cx, r = rs.randint(0, h), rs.randint(0, w), rs.randint(4, 16)
        _disc(m, cy, cx, r)
        _disc(m, cy, cx, r - rs.randint(1, 4), 0)
    return m


def _nested(rs, h, w):
    """Blobs in holes in blobs, several levels deep."""
    m = np.zeros((h, w), np.uint8)
    cy, cx = h // 2 + rs.randint(-3, 4), w // 2 + rs.randint(-3, 4)
    r, value = min(h, w) // 2 - 1, 1
    while r > 1:
        _disc(m, cy, cx, r, value)
        r -= rs.randint(2, 5)
        value = 1 - value
    return m


def _border(rs, h, w):
    """Blobs cut by the frame's edges and corners."""
    m = np.zeros((h, w), np.uint8)
    for cy, cx in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1),
                   (rs.randint(0, h), 0), (0, rs.randint(0, w))):
        if rs.rand() < 0.7:
            _disc(m, cy, cx, rs.randint(1, 9))
    m[:, -1] |= (rs.rand(h) < 0.3)
    return m


def _lines(rs, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(rs.randint(1, 6)):
        if rs.rand() < 0.5:
            m[rs.randint(0, h), rs.randint(0, w):rs.randint(0, w) + 1] = 1
        else:
            m[rs.randint(0, h):rs.randint(0, h) + 1, rs.randint(0, w)] = 1
    return m


def _pixels(rs, h, w):
    m = np.zeros((h, w), np.uint8)
    m.flat[rs.choice(h * w, rs.randint(1, 30), replace=False)] = 1
    return m


def _diagonals(rs, h, w):
    """Pixels linked only through their corners: staircases, a
    checkerboard patch, crossing diagonals."""
    m = np.zeros((h, w), np.uint8)
    for _ in range(rs.randint(1, 4)):
        y, x, n = rs.randint(0, h), rs.randint(0, w), rs.randint(2, 15)
        step = 1 if rs.rand() < 0.5 else -1
        for k in range(n):
            if 0 <= y + k < h and 0 <= x + step * k < w:
                m[y + k, x + step * k] = 1
    y, x = rs.randint(0, h - 4), rs.randint(0, w - 4)
    m[y:y + 4, x:x + 4] |= (np.indices((4, 4)).sum(0) % 2).astype(np.uint8)
    return m


def _noise(rs, h, w):
    return (rs.rand(h, w) < rs.uniform(0.2, 0.8)).astype(np.uint8)


KINDS = {"rectangles": _rectangles, "discs": _discs, "rings": _rings,
         "nested": _nested, "border": _border, "lines": _lines,
         "pixels": _pixels, "diagonals": _diagonals, "noise": _noise}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_seeded_masks_match_cv2(kind):
    """24 masks of each kind (216 in all), sizes 5-70 pixels a side."""
    rs = np.random.RandomState(sorted(KINDS).index(kind))
    total = 0
    for t in range(24):
        h, w = rs.randint(5, 70), rs.randint(5, 70)
        total += assert_like_cv2(KINDS[kind](rs, h, w), f"{kind} {t}")
    assert total > 24


def test_hundreds_of_borders_match_cv2():
    """Noise with over 127 borders: the parents stay cv2's where a border
    number of 7 bits would wrap."""
    rs = np.random.RandomState(11)
    for t in range(4):
        n = assert_like_cv2((rs.rand(120, 160) < 0.5).astype(np.uint8),
                            f"noise {t}")
        assert n > 1000


def test_hand_slice_masks_match_cv2():
    """Every slice of ``HandDetector.detect``'s sweep (the 6th to the 65th
    of 65 over the depth range) of three rendered NYU hands."""
    cam = Camera.nyu()
    rs = np.random.RandomState(3)
    nonempty = 0
    for i in range(3):
        com3d = np.array([40.0 * i - 20.0, 15.0 * i - 10.0,
                          720.0 + 40.0 * i], np.float32)
        dpt = render_hand_depth(cam, com3d, 36, rs)[0]
        lo_d, hi_d = max(10, dpt.min()), min(6500, dpt.max())
        dz = (hi_d - lo_d) / 65.0
        for k in range(5, 65):
            part = (dpt >= k * dz + lo_d) & (dpt <= (k + 1) * dz + lo_d)
            nonempty += assert_like_cv2(part * 255, f"hand {i} slice {k}") > 0
        # and the hand-size mask of a 300 mm cube around the CoM
        assert_like_cv2((dpt >= com3d[2] - 150) & (dpt <= com3d[2] + 150),
                        f"hand {i} cube")
    assert nonempty >= 6


def test_scene_order_and_hierarchy_are_pinned():
    """Blobs found in raster order A (row 2), B (row 5), C (row 20); C
    holds a hole and the hole a blob.  cv2 returns C, its hole, the blob
    inside, B, then A: depth first, siblings newest first."""
    m = np.zeros((40, 40), np.uint8)
    m[2:4, 30:34] = 255                 # A
    m[5:8, 3:7] = 255                   # B
    m[20:38, 5:30] = 255                # C
    m[23:35, 8:27] = 0                  # C's hole
    m[26:30, 12:16] = 255               # the blob in the hole
    assert assert_like_cv2(m, "scene") == 5
    contours, hierarchy = find_contours(m)
    assert hierarchy.tolist() == [[3, -1, 1, -1], [-1, -1, 2, 0],
                                  [-1, -1, -1, 1], [4, 0, -1, -1],
                                  [-1, 3, -1, -1]]
    assert contours[0].tolist() == [[5, 20], [5, 37], [29, 37], [29, 20]]
    assert contours[1].tolist() == [[7, 23], [8, 22], [26, 22], [27, 23],
                                    [27, 34], [26, 35], [8, 35], [7, 34]]
    assert contours[4].tolist() == [[30, 2], [30, 3], [33, 3], [33, 2]]
    assert contour_area(contours[0]) == 24.0 * 17.0
    assert bounding_rect(contours[0]) == (5, 20, 25, 18)


def test_empty_and_full_masks():
    assert assert_like_cv2(np.zeros((7, 9), np.uint8)) == 0
    assert assert_like_cv2(np.ones((7, 9), np.uint8)) == 1
    assert assert_like_cv2(np.ones((1, 1), np.uint8)) == 1
    got, _ = find_contours(np.ones((1, 1), bool))
    assert got[0].tolist() == [[0, 0]]
    with pytest.raises(ValueError, match="2-D"):
        find_contours(np.ones((2, 2, 2)))
