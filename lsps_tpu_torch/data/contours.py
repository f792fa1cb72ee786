"""The contour primitives of OpenCV's ``findContours`` family, in numpy.

The JAX package's host detector (``lsps_tpu/data/detector.py``: ``detect``,
``_hand_size_from_depth``, ``estimate_hand_size``) calls
``cv2.findContours(mask, RETR_TREE, CHAIN_APPROX_SIMPLE)``,
``cv2.contourArea``, ``cv2.moments`` and ``cv2.boundingRect``.  The port's
copies return what cv2 5 returns on the same masks, vertex for vertex:

* :func:`find_contours` is Suzuki and Abe's border following over the
  8-connected foreground, as OpenCV runs it: the mask framed by one pixel
  of background, scanned in raster order; an outer border starts at a
  foreground pixel whose left neighbour is background, a hole border at a
  foreground pixel whose right neighbour is background and which no
  border has marked as a right edge.  Each border is followed
  counter-clockwise from the neighbour found clockwise, its pixels marked
  with its number (negated where the pixel to the right is background),
  and a vertex is kept where the chain code changes direction
  (``CHAIN_APPROX_SIMPLE``).  The parent of a border comes from the last
  marked pixel to its left in the row (none: the frame): that pixel's
  border if it is of the other kind (outer or hole), else its parent.
  Borders are numbered 2, 3, ... without end: OpenCV 5 gives the same
  parents past 127 borders, where a 7-bit number would wrap.  Contours
  come out as a depth-first walk of the tree, each node's children
  newest first, with the hierarchy ``[next, previous, first_child,
  parent]``.
* :func:`contour_area` is the shoelace formula; :func:`contour_moments`
  the polygon moments of ``imgproc/src/moments.cpp`` (``m00``, ``m10``,
  ``m01``).  Integer vertices keep every partial sum exact in float64, so
  the centroid ``m10 / m00`` is cv2's to the bit.

Only the starts of candidate borders are found with numpy (a foreground
pixel after background, a background pixel after foreground); the
borders are followed in Python from those, in raster order, over the
bounding box of the foreground.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

class _Border:
    __slots__ = ("is_hole", "parent", "at", "children", "points")

    def __init__(self, is_hole, parent, at):
        self.is_hole = is_hole
        self.parent = parent
        self.at = at                      # its place among its siblings
        self.children: List[int] = []
        self.points: List[int] = []


def _follow(lab, i0, width, is_hole, nbd, points) -> None:
    """Follow one border from pixel ``i0`` of the flat label list ``lab``
    (rows of ``width``), marking its pixels ``nbd`` (``-nbd`` where the
    pixel to the right is background) and appending its vertices."""
    # chain code s: right, up-right, up, up-left, left, down-left, ...
    d = (1, 1 - width, -width, -1 - width, -1, width - 1, width, width + 1)
    deltas = d + d
    s = s_end = 0 if is_hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if lab[i1] != 0 or s == s_end:
            break
    if s == s_end:                       # a single pixel
        lab[i0] = -nbd
        points.append(i0)
        return
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if lab[i4] != 0:
                break
        s &= 7
        if 0 < s <= s_end:               # the right neighbour was examined
            lab[i3] = -nbd
        elif lab[i3] == 1:
            lab[i3] = nbd
        if s != prev_s:
            points.append(i3)
        prev_s = s
        if i4 == i0 and i3 == i1:
            return
        i3 = i4
        s = (s + 4) & 7


def find_contours(binary) -> Tuple[List[np.ndarray], np.ndarray]:
    """``cv2.findContours(binary, RETR_TREE, CHAIN_APPROX_SIMPLE)``.

    Returns the contours, each an (N, 2) int32 array of (x, y) vertices,
    and the (K, 4) int32 hierarchy ``[next, previous, first_child,
    parent]`` (-1 for none), in cv2's order.  Nonzero pixels of
    ``binary`` are foreground."""
    fg = np.asarray(binary) != 0
    if fg.ndim != 2:
        raise ValueError(f"find_contours takes a 2-D mask, got {fg.shape}")
    rows = np.flatnonzero(fg.any(axis=1))
    if rows.size == 0:
        return [], np.zeros((0, 4), np.int32)
    cols = np.flatnonzero(fg.any(axis=0))
    y0, x0 = int(rows[0]), int(cols[0])
    sub = fg[y0:rows[-1] + 1, x0:cols[-1] + 1]
    h, w = sub.shape
    width = w + 2
    pad = np.zeros((h + 2, width), np.int8)
    pad[1:-1, 1:-1] = sub

    # candidate starts in raster order over columns 1 .. width - 2
    here, left = pad[:, 1:-1], pad[:, :-2]
    outer = (here == 1) & (left == 0)
    ys, xs = np.nonzero(outer | ((here == 0) & (left == 1)))
    starts = (ys * width + xs + 1).tolist()
    kinds = outer[ys, xs].tolist()

    lab = pad.ravel().tolist()
    borders = [_Border(True, -1, 0)]       # 0: the frame, a hole
    for i, is_outer in zip(starts, kinds):
        if is_outer:
            if lab[i] != 1:
                continue
            start = i
        else:
            if lab[i - 1] < 1:
                continue
            start = i - 1
        is_hole = not is_outer
        # the last marked pixel to the left in this row
        parent = 0
        row0 = i - i % width
        for j in range(i - 1, row0, -1):
            v = lab[j]
            if v != 0 and v != 1:
                parent = abs(v) - 1        # border n is numbered n + 1
                if borders[parent].is_hole == is_hole:
                    parent = borders[parent].parent
                break
        b = _Border(is_hole, parent, len(borders[parent].children))
        _follow(lab, start, width, is_hole, len(borders) + 1, b.points)
        borders[parent].children.append(len(borders))
        borders.append(b)

    # depth first, newest child first
    order: List[int] = []
    stack = list(borders[0].children)
    while stack:
        k = stack.pop()
        order.append(k)
        stack.extend(borders[k].children)
    index = {k: n for n, k in enumerate(order)}
    index[0] = -1
    hierarchy = np.full((len(order), 4), -1, np.int32)
    contours = []
    for n, k in enumerate(order):
        b = borders[k]
        sibs = borders[b.parent].children
        if b.at > 0:
            hierarchy[n, 0] = index[sibs[b.at - 1]]
        if b.at + 1 < len(sibs):
            hierarchy[n, 1] = index[sibs[b.at + 1]]
        if b.children:
            hierarchy[n, 2] = index[b.children[-1]]
        hierarchy[n, 3] = index[b.parent]
        flat = np.asarray(b.points, np.int64)
        contours.append(np.stack([flat % width - 1 + x0,
                                  flat // width - 1 + y0],
                                 axis=1).astype(np.int32))
    return contours, hierarchy


def _xy(contour) -> np.ndarray:
    return np.asarray(contour, np.float64).reshape(-1, 2)


def contour_area(contour) -> float:
    """``cv2.contourArea(contour)``: the absolute shoelace area."""
    p = _xy(contour)
    if len(p) == 0:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return float(abs((q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]).sum() * 0.5))


def contour_moments(contour) -> dict:
    """``m00``, ``m10`` and ``m01`` of ``cv2.moments(contour)`` (the
    polygon's, by the formula of OpenCV's ``contourMoments``)."""
    p = _xy(contour)
    if len(p) == 0:
        return {"m00": 0.0, "m10": 0.0, "m01": 0.0}
    q = np.roll(p, 1, axis=0)
    dxy = q[:, 0] * p[:, 1] - p[:, 0] * q[:, 1]
    a00 = dxy.sum()
    a10 = (dxy * (q[:, 0] + p[:, 0])).sum()
    a01 = (dxy * (q[:, 1] + p[:, 1])).sum()
    if abs(a00) <= np.finfo(np.float32).eps:
        return {"m00": 0.0, "m10": 0.0, "m01": 0.0}
    half, sixth = (0.5, 1.0 / 6.0) if a00 > 0 else (-0.5, -1.0 / 6.0)
    return {"m00": float(a00 * half), "m10": float(a10 * sixth),
            "m01": float(a01 * sixth)}


def bounding_rect(contour) -> Tuple[int, int, int, int]:
    """``cv2.boundingRect(contour)``: (x, y, w, h) of the vertices."""
    p = np.asarray(contour, np.int64).reshape(-1, 2)
    if len(p) == 0:
        return 0, 0, 0, 0
    lo, hi = p.min(axis=0), p.max(axis=0)
    return (int(lo[0]), int(lo[1]), int(hi[0] - lo[0] + 1),
            int(hi[1] - lo[1] + 1))
