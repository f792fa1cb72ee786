"""A small numpy rasterizer: cv2's anti-aliased shapes, and the marks of the
3D scene of ``eval/handpose_evaluation.plotResult3D``.

The card's machine has neither cv2 nor matplotlib, so the plots draw here.
Every function draws in place on an (H, W, 3) uint8 image and clips to it.

cv2's shapes, pixel for pixel as cv2 5 draws them (held against cv2 by
``tests/test_torch_plots.py``):

* :func:`line_aa` is ``cv2.line(img, p0, p1, color, thickness, LINE_AA)``
  for a thickness of 2 or more: the segment clipped (``clipLine``) to the
  image grown by ``thickness`` on every side, a convex quadrilateral of
  half-width ``thickness / 2`` (plus half a pixel for an odd thickness)
  and a filled anti-aliased disc of radius ``thickness / 2`` at each end;
* :func:`circle_aa` is ``cv2.circle(img, center, radius, color, -1,
  LINE_AA)``: the polygon of ``ellipse2Poly`` (a vertex every 90, 30, 18
  or 5 degrees as the radius grows, from cv2's float sine table), filled;
* both fill as OpenCV's ``FillConvexPoly`` does with ``LINE_AA``: every
  edge drawn by ``LineAA`` (16.16 fixed point, three pixels a step
  weighted by ``FILTER_TABLE`` and ``SLOPE_CORR_TABLE`` with its end-point
  corrections, each pixel blended twice as ``v += ((c - v) * a + 127) >>
  8``), then the scan-line interior overwritten with the colour.

``disc`` and ``line1`` are ``vis_pair``'s aliased shapes (``utils/viz``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# OpenCV's LineAA tables (drawing.cpp), read back from cv2 5's pixels
FILTER_TABLE = (
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
    254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
    194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
    68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7,
    5, 5)
SLOPE_CORR_TABLE = (
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196,
    198, 201, 203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238,
    242, 246, 250, 254)
# cv2's sine table: float32 sines of whole degrees, 0 to 450
_SIN = np.sin(np.radians(np.arange(451, dtype=np.float64))).astype(
    np.float32)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, p1, p2):
    """``cv::clipLine`` of the segment to ``[0, w) x [0, h)``; None when
    it misses."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line_aa_steps(p1, p2, w: int, h: int):
    """OpenCV's ``LineAA`` from ``p1`` to ``p2`` (16.16 fixed point): the
    (x, y, alpha) it blends, in its order."""
    r = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if r is None:
        return []
    (x1, y1), (x2, y2) = r
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if not x_major:   # walk along y: swap the axes and swap back at the end
        x1, y1, x2, y2, dx, dy = y1, x1, y2, x2, dy, dx
    if dx < 0:
        x1, x2, y1, y2, dx, dy = x2, x1, y2, y1, -dx, -dy
    step = _cdiv(dy << XY_SHIFT, dx | 1)
    x2 += XY_ONE
    ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
    y1 += ((step * -(x1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
    slope = (step >> (XY_SHIFT - 5)) & 0x3f
    slope ^= 0x3f if step < 0 else 0
    i = (x1 >> (XY_SHIFT - 7)) & 0x78
    j = (x2 >> (XY_SHIFT - 7)) & 0x78
    slope = 0x100 if slope & 0x20 else SLOPE_CORR_TABLE[slope]
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    ep = [0, 0, (t1 >> 8) & 0x1ff, 0, ((((j - i) + 0x80) | 4) * slope >> 8)
          & 0x1ff, ((t1 + t0) >> 8) & 0x1ff, (t2 >> 8) & 0x1ff,
          ((t2 + t0) >> 8) & 0x1ff, slope]
    ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff
    out = []
    major_size = w if x_major else h
    x, scount = x1 >> XY_SHIFT, 0
    while ecount >= 0:
        if 0 <= x < major_size:
            y = (y1 >> XY_SHIFT) - 1
            corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3
                      + (((ecount >= 2) + 1) & (ecount | 2))]
            dist = (y1 >> (XY_SHIFT - 5)) & 31
            for k, f in ((0, dist + 32), (1, dist), (2, 63 - dist)):
                a = (corr * FILTER_TABLE[f] >> 8) & 0xff
                out.append((x, y + k, a) if x_major else (y + k, x, a))
        x += 1
        y1 += step
        scount += 1
        ecount -= 1
    return out


def _line_aa(img: np.ndarray, p1, p2, color) -> None:
    h, w = img.shape[:2]
    for x, y, a in _line_aa_steps(p1, p2, w, h):
        if 0 <= x < w and 0 <= y < h:
            px = img[y, x]
            for k in range(3):
                v, c = int(px[k]), color[k]
                v += ((c - v) * a + 127) >> 8
                v += ((c - v) * a + 127) >> 8
                px[k] = v


def fill_convex_poly_aa(img: np.ndarray, pts: Sequence[Tuple[int, int]],
                        color, shift: int = XY_SHIFT) -> None:
    """OpenCV's ``FillConvexPoly`` with ``LINE_AA``: the vertices ``pts``
    in ``shift`` fractional bits; the edges anti-aliased, then the
    interior's scan lines filled."""
    h, w = img.shape[:2]
    n = len(pts)
    color = tuple(int(c) for c in color)
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift
    p0 = (pts[-1][0] << up, pts[-1][1] << up)
    xmin = xmax = pts[0][0]
    ymin = ymax = pts[0][1]
    imin = 0
    for i, (px, py) in enumerate(pts):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << up, py << up)
        _line_aa(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # the left and right edges: [vertex index, index step, x, dx, end y]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    y, edges = ymin, n
    while True:
        if y < ymax or y == ymin:
            for e in edge:
                if y < e[4]:
                    continue
                idx0 = e[0]
                idx = (idx0 + e[1]) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (pts[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = pts[idx0][0] << up, pts[idx][0] << up
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + e[1]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] \
                else (edge[0], edge[1])
            x1 = (left[2] + XY_ONE - 1) >> XY_SHIFT
            x2 = right[2] >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                x1, x2 = max(x1, 0), min(x2, w - 1)
                if x2 >= x1:
                    img[y, x1:x2 + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _ellipse_fill_aa(img: np.ndarray, center, radius: int, color) -> None:
    """OpenCV's ``EllipseEx`` of a full filled circle with ``LINE_AA``
    (centre and radius in 16.16 fixed point)."""
    step = (radius + (XY_ONE >> 1)) >> XY_SHIFT
    step = 90 if step < 3 else 30 if step < 10 else 18 if step < 15 else 5
    cx, cy = float(center[0]), float(center[1])
    pts = []
    for deg in range(0, 360 + step, step):
        deg = min(deg, 360)
        x = radius * float(_SIN[450 - deg])
        y = radius * float(_SIN[deg])
        p = (int(np.rint(cx + x)), int(np.rint(cy + y)))
        if not pts or p != pts[-1]:
            pts.append(p)
    if len(pts) == 1:
        pts.append(pts[0])
    fill_convex_poly_aa(img, pts, color, XY_SHIFT)


def circle_aa(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1, cv2.LINE_AA)``."""
    _ellipse_fill_aa(img, (int(center[0]) << XY_SHIFT,
                           int(center[1]) << XY_SHIFT),
                     int(radius) << XY_SHIFT, color)


def line_aa(img: np.ndarray, p0, p1, color, thickness: int) -> None:
    """``cv2.line(img, p0, p1, color, thickness, cv2.LINE_AA)`` with
    integer end points and a thickness of at least 2."""
    if thickness < 2:
        raise ValueError("line_aa draws thickness 2 and over")
    h, w = img.shape[:2]
    t = int(thickness)
    r = clip_line(w + 2 * t, h + 2 * t, (int(p0[0]) + t, int(p0[1]) + t),
                  (int(p1[0]) + t, int(p1[1]) + t))
    if r is None:
        return
    a = ((r[0][0] - t) << XY_SHIFT, (r[0][1] - t) << XY_SHIFT)
    b = ((r[1][0] - t) << XY_SHIFT, (r[1][1] - t) << XY_SHIFT)
    dx, dy = (a[0] - b[0]) / XY_ONE, (b[1] - a[1]) / XY_ONE
    length2 = dx * dx + dy * dy
    half = t << (XY_SHIFT - 1)
    if abs(length2) > 2.220446049250313e-16:
        k = (half + (t & 1) * XY_ONE * 0.5) / math.sqrt(length2)
        ox, oy = int(np.rint(dy * k)), int(np.rint(dx * k))
        fill_convex_poly_aa(img, [(a[0] + ox, a[1] + oy),
                                  (a[0] - ox, a[1] - oy),
                                  (b[0] - ox, b[1] - oy),
                                  (b[0] + ox, b[1] + oy)], color)
    for p in (a, b):
        _ellipse_fill_aa(img, p, half, color)


# ---------------------------------------------------------------------------
# vis_pair's aliased shapes
# ---------------------------------------------------------------------------

def disc(img: np.ndarray, cx: int, cy: int, r: int, color) -> None:
    """cv2.circle(img, (cx, cy), r, color, -1): every pixel within
    distance r of the centre, clipped to the image."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[cy - r:cy + r + 1, cx - r:cx + r + 1]
    keep = (((xs - cx) ** 2 + (ys - cy) ** 2 <= r * r)
            & (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h))
    img[ys[keep], xs[keep]] = color


def line1(img: np.ndarray, p0, p1, color) -> None:
    """cv2.line(img, p0, p1, color, 1): one pixel per step along the
    longer axis, the other coordinate rounded half up, clipped."""
    h, w = img.shape[:2]
    (x0, y0), (x1, y1) = p0, p1
    n = max(abs(x1 - x0), abs(y1 - y0))
    t = np.arange(n + 1) / max(n, 1)
    xs = np.floor(x0 + (x1 - x0) * t + 0.5).astype(np.int64)
    ys = np.floor(y0 + (y1 - y0) * t + 0.5).astype(np.int64)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


# ---------------------------------------------------------------------------
# the 3D scene's marks (matplotlib's look, not its pixels)
# ---------------------------------------------------------------------------

def blend_points(img: np.ndarray, xs, ys, color, alpha: float) -> None:
    """One-pixel marks at the rounded (xs, ys), ``alpha`` over the image;
    a pixel hit twice is blended twice, as overlapping marks are."""
    h, w = img.shape[:2]
    xi = np.rint(np.asarray(xs, np.float64)).astype(np.int64)
    yi = np.rint(np.asarray(ys, np.float64)).astype(np.int64)
    keep = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    flat = yi[keep] * w + xi[keep]
    counts = np.bincount(flat, minlength=h * w).reshape(h, w)
    hit = counts > 0
    keepf = (1.0 - alpha) ** counts[hit]
    c = np.asarray(color, np.float64)
    px = img[hit].astype(np.float64)
    img[hit] = np.clip(np.rint(px * keepf[:, None]
                               + c * (1.0 - keepf[:, None])), 0, 255)


def squares(img: np.ndarray, xs, ys, size: int, colors) -> None:
    """Filled ``size`` x ``size`` squares centred on (xs, ys), one colour
    each, drawn in order."""
    h, w = img.shape[:2]
    lo = size // 2
    for x, y, c in zip(xs, ys, colors):
        x0, y0 = int(np.rint(x)) - lo, int(np.rint(y)) - lo
        xa, xb = max(x0, 0), min(x0 + size, w)
        ya, yb = max(y0, 0), min(y0 + size, h)
        if xa < xb and ya < yb:
            img[ya:yb, xa:xb] = c


def segment(img: np.ndarray, p0, p1, color, width: int) -> None:
    """A ``width``-pixel anti-aliased segment between rounded points."""
    a = (int(np.rint(p0[0])), int(np.rint(p0[1])))
    b = (int(np.rint(p1[0])), int(np.rint(p1[1])))
    line_aa(img, a, b, tuple(int(c) for c in color), max(int(width), 2))


# 5 x 7 glyphs of the axis labels, one row of five bits per line
_GLYPHS = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "/": (0b00001, 0b00010, 0b00010, 0b00100, 0b01000, 0b01000, 0b10000),
    "m": (0, 0, 0b11010, 0b10101, 0b10101, 0b10101, 0b10101),
    "x": (0, 0, 0b10001, 0b01010, 0b00100, 0b01010, 0b10001),
    "y": (0, 0, 0b10001, 0b10001, 0b01111, 0b00001, 0b01110),
    "z": (0, 0, 0b11111, 0b00010, 0b00100, 0b01000, 0b11111),
}


def font_table() -> np.ndarray:
    """The glyphs as a (n, 7, 5) bool table, in the order of
    ``FONT_CHARS``."""
    return np.asarray([[[(row >> (4 - c)) & 1 for c in range(5)]
                        for row in _GLYPHS[ch]] for ch in FONT_CHARS], bool)


FONT_CHARS = "".join(sorted(_GLYPHS))
_FONT = font_table()


def text(img: np.ndarray, x: float, y: float, s: str, color,
         scale: int = 2) -> None:
    """``s`` in the 5 x 7 bitmap font, each dot ``scale`` pixels, centred
    on (x, y); characters outside the font raise."""
    h, w = img.shape[:2]
    glyphs = [_FONT[FONT_CHARS.index(ch)] for ch in s]
    row = np.concatenate([np.pad(g, ((0, 0), (0, 1))) for g in glyphs], 1)
    big = np.kron(row, np.ones((scale, scale), bool))
    y0 = int(np.rint(y)) - big.shape[0] // 2
    x0 = int(np.rint(x)) - big.shape[1] // 2
    ys, xs = np.nonzero(big)
    ys, xs = ys + y0, xs + x0
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color
