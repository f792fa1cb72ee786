"""Hand-pose accuracy metrics (host numpy).

The port's copy of the metrics of ``lsps_tpu/eval/handpose_evaluation.py``
(reference: src/utils/handpose_evaluation.py:41-228 and the per-dataset
joint tables, :684-913): vectorized over (N, J, 3) arrays and NaN-tolerant
like the reference (nanmean/nanmax).  ``Evaluation`` holds the legacy mm
errors of src/utils/evaluation.py (x50-denormalized poses on the NYU
14-joint protocol) and its threshold curve as text.

The plots draw without matplotlib or cv2, which the card's machine lacks:

* ``plotJoints`` / ``plotResult`` draw cv2's anti-aliased thick lines and
  discs pixel for pixel (``utils/raster``) on a background bit-equal to
  the JAX package's; ``name`` saves a PNG (``utils/viz.write_png``) where
  JAX writes through ``cv2.imwrite``.
* ``plotEvaluation`` writes the same three PDFs as JAX with the same
  series, axis ranges, grid, tick labels and legend, through the vector
  writer ``utils/pdf`` (Helvetica, uncompressed): each curve and bar is a
  path in data units times a power-of-two scale, so its values read back
  exactly.
* ``plotResult3D`` / ``plotHand3D`` draw on a :class:`Scene3D`, the
  port's stand-in for matplotlib's 3D axes: the same view transform as
  ``view_init(elev, azim)`` with its default perspective projection and a
  (1, 1, 1) box, the limits autoscaled with matplotlib's margins, 600 x
  600 pixels as JAX's 6-inch figure at dpi 100.  It draws the cloud as
  1-pixel gray marks at alpha 0.5, joints as 5-pixel squares, bones as
  3-pixel segments, the axis box and its "x / mm", "y / mm", "z / mm"
  labels in a bitmap font; tick labels and matplotlib's shaded panes are
  left out.
"""

from __future__ import annotations

import colorsys
import math
import os
from typing import List, Optional, Sequence

import numpy as np

from lsps_tpu_torch.utils import raster
from lsps_tpu_torch.utils.pdf import PDFPage, num, text_width
from lsps_tpu_torch.utils.viz import write_png

# NYU 14-joint evaluation protocol (reference importers.py:984,
# depth_train.py:231-234)
NYU_RESTRICTED_EVAL = np.asarray([0, 3, 6, 9, 12, 15, 18, 21, 24, 25, 27,
                                  30, 31, 32])


class HandposeEvaluation:
    """mm-space joint error metrics over (gt, pred) arrays of (N, J, 3)."""

    def __init__(self, gtjoints, joints, dolegend=True, linewidth=1):
        gtjoints = np.asarray(gtjoints, np.float64)
        joints = np.asarray(joints, np.float64)
        if gtjoints.shape != joints.shape or gtjoints.size == 0:
            raise ValueError(
                f"shape mismatch or empty: {gtjoints.shape} vs "
                f"{joints.shape}")
        self.gtjoints = gtjoints
        self.joints = joints
        self.dolegend = dolegend
        self.linewidth = linewidth
        self.subfolder = "./eval/"
        self.jointNames: Optional[Sequence[str]] = None
        self.jointConnections: List = []
        self.jointConnectionColors: List = []
        self.jointColors: List = []
        # (elev, azim, roll) of plotResult3D's view
        self.viewport3D = (-75.0, -90.0, 0.0)
        self.plotMaxJointDist = 80
        self.plotMeanJointDist = 80

    # -- core distances ----------------------------------------------------
    def _dists(self) -> np.ndarray:
        """(N, J) Euclidean joint errors, computed once."""
        if not hasattr(self, "_dists_cache"):
            self._dists_cache = np.sqrt(
                np.square(self.gtjoints - self.joints).sum(axis=2))
        return self._dists_cache

    # -- scalar metrics (handpose_evaluation.py:92-228) ---------------------
    def getMeanError(self) -> float:
        return float(np.nanmean(np.nanmean(self._dists(), axis=1)))

    def getStdError(self) -> float:
        return float(np.nanmean(np.nanstd(self._dists(), axis=1)))

    def getMeanErrorOverSeq(self) -> np.ndarray:
        return np.nanmean(self._dists(), axis=1)

    def getMedianError(self) -> float:
        return float(np.nanmedian(self._dists()))

    def getMaxError(self) -> float:
        return float(np.nanmax(self._dists()))

    def getMaxErrorOverSeq(self) -> np.ndarray:
        return np.nanmax(self._dists(), axis=1)

    def getJointMeanError(self, joint_id) -> float:
        return float(np.nanmean(self._dists()[:, joint_id]))

    def getJointStdError(self, joint_id) -> float:
        return float(np.nanstd(self._dists()[:, joint_id]))

    def getJointErrorOverSeq(self, joint_id) -> np.ndarray:
        return self._dists()[:, joint_id]

    def getJointDiffOverSeq(self, joint_id) -> np.ndarray:
        return self.gtjoints[:, joint_id, :] - self.joints[:, joint_id, :]

    def getJointMaxError(self, joint_id) -> float:
        return float(np.nanmax(self._dists()[:, joint_id]))

    def getNumFramesWithinMaxDist(self, dist) -> int:
        return int((np.nanmax(self._dists(), axis=1) <= dist).sum())

    def getNumFramesWithinMeanDist(self, dist) -> int:
        return int((np.nanmean(self._dists(), axis=1) <= dist).sum())

    def getNumFramesWithinMedianDist(self, dist) -> int:
        return int((np.median(self._dists(), axis=1) <= dist).sum())

    def getJointNumFramesWithinMaxDist(self, dist, joint_id) -> int:
        return int((self._dists()[:, joint_id] <= dist).sum())

    # -- plots (handpose_evaluation.py:104-348 of the JAX package) -----------
    def plotEvaluation(self, basename, method_name="Our method",
                       baseline=None) -> None:
        """Save the frames-within-distance curve and the per-joint mean and
        max bars as ``{basename}_frameswithin.pdf``, ``_joint_mean.pdf``
        and ``_joint_max.pdf`` in ``self.subfolder``."""
        os.makedirs(self.subfolder, exist_ok=True)
        n = float(self.joints.shape[0])
        series = [(method_name, self)] + list(baseline or [])

        plot = _PDFPlot("Distance threshold / mm",
                        "Fraction of frames within distance / %", grid=True)
        for name, ev in series:
            ys = [ev.getNumFramesWithinMaxDist(j) / n * 100.0
                  for j in range(self.plotMaxJointDist)]
            plot.line(list(range(len(ys))), ys, name)
        plot.ylim = (0.0, 100.0)
        plot.save(f"{self.subfolder}/{basename}_frameswithin.pdf",
                  legend="lower right" if self.dolegend else None)

        nj = self.joints.shape[1]
        width = (1 - 0.33) / len(series)
        ind = np.arange(nj + 1)
        # the NYU 'all' table names 32 of 36 joints: pad the labels
        labels = list(self.jointNames or [])[:nj]
        labels += [str(j) for j in range(len(labels), nj)]
        plot = _PDFPlot(None, "Mean error of joint / mm")
        for i, (name, ev) in enumerate(series):
            mean = [ev.getJointMeanError(j) for j in range(nj)]
            mean.append(ev.getMeanError())
            plot.bars(ind + width * i, mean, width, name)
        plot.xticks(ind + width, labels + ["Avg"])
        plot.save(f"{self.subfolder}/{basename}_joint_mean.pdf",
                  legend="upper right" if self.dolegend else None)

        plot = _PDFPlot(None, "Maximum error of joint / mm")
        for i, (name, ev) in enumerate(series):
            plot.bars(np.arange(nj) + width * i,
                      [ev.getJointMaxError(j) for j in range(nj)], width,
                      name)
        plot.xticks(np.arange(nj) + width, labels)
        plot.ylim = (0.0, 200.0)
        plot.save(f"{self.subfolder}/{basename}_joint_max.pdf",
                  legend="upper right" if self.dolegend else None)

    def plotHand3D(self, ax, joint3D, colors=(1, 0, 0)):
        """Draw one skeleton onto a :class:`Scene3D`: square joint marks
        and width-3 bones; ``colors`` is an RGB triple or ``'nice'`` for
        the per-joint and per-bone tables."""
        joint3D = np.asarray(joint3D, np.float64).reshape(-1, 3)
        nice = isinstance(colors, str) and colors == "nice"
        if nice and not getattr(self, "jointColors", None):
            colors, nice = (1, 0, 0), False  # no tables: plain red
        jc = (list(self.jointColors) if nice
              else [colors] * joint3D.shape[0])
        ax.scatter(joint3D[:, 0], joint3D[:, 1], joint3D[:, 2],
                   c=jc[:joint3D.shape[0]], marker="s", s=25,
                   depthshade=False)
        conns = self.jointConnections or []
        if conns and joint3D.shape[0] > np.max(np.abs(
                np.asarray([c[:2] for c in conns]))):
            ccol = (self.jointConnectionColors
                    if nice and self.jointConnectionColors
                    else [colors] * len(conns))
            for c, col in zip(conns, ccol):
                seg = joint3D[list(c[:2])]
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=col,
                        linewidth=3)

    def plotResult3D(self, dpt, T, gt3Dorig, joint3D, filename=None,
                     showGT=True, showPC=True, niceColors=False,
                     camera=None, background_val=0.0, max_points=4000):
        """The hand's point cloud with the predicted (red) and ground-truth
        (blue) skeletons.  ``dpt`` is a metric-mm depth crop and ``T`` its
        3 x 3 crop transform; the cloud is ``camera.depth_to_pcl`` of it,
        every ``n // max_points + 1``-th point.  Saves
        ``<subfolder>/<filename>.png`` when ``filename`` is given, else
        returns the (600, 600, 3) uint8 RGB image."""
        ax = Scene3D()
        if showPC and camera is not None and dpt is not None:
            pcl = camera.depth_to_pcl(dpt, T, background_val=background_val)
            if pcl.shape[0] > max_points:
                pcl = pcl[:: pcl.shape[0] // max_points + 1]
            if pcl.shape[0]:
                ax.scatter(pcl[:, 0], pcl[:, 1], pcl[:, 2], c="0.6", s=1,
                           alpha=0.5, depthshade=False)
        self.plotHand3D(ax, joint3D, "nice" if niceColors else (1, 0, 0))
        if showGT and gt3Dorig is not None:
            self.plotHand3D(ax, gt3Dorig,
                            "nice" if niceColors else (0, 0, 1))
        elev, azim, roll = self.viewport3D
        ax.view_init(elev=elev, azim=azim)
        ax.set_xlabel("x / mm")
        ax.set_ylabel("y / mm")
        ax.set_zlabel("z / mm")
        ax.set_box_aspect((1, 1, 1))
        img = ax.render()
        if filename is not None:
            os.makedirs(self.subfolder, exist_ok=True)
            write_png(f"{self.subfolder}/{filename}.png", img[..., ::-1])
            return None
        return img

    def plotJoints(self, img, joint, color="nice", jcolor=None,
                   annoscale=1):
        """Draw one skeleton onto a BGR uint8 image as cv2 draws it
        (``cv2.line`` of thickness ``3 * annoscale`` and filled
        ``cv2.circle`` of radius ``6 * annoscale``, both ``LINE_AA``):
        per-connection then per-joint colours from the tables when
        ``'nice'``, their luma gray when ``'gray'``, or a fixed BGR
        triple."""
        joint = np.asarray(joint)
        conns = self.jointConnections or []

        def named(c, name):
            return isinstance(c, str) and c == name

        def _conn_color(i):
            if named(color, "nice") and self.jointConnectionColors:
                return _to_bgr255(self.jointConnectionColors[i])
            if named(color, "gray") and self.jointConnectionColors:
                return _to_bgr255(_rgb_to_gray(
                    self.jointConnectionColors[i]))
            if named(color, "nice") or named(color, "gray"):
                return (0, 0, 255)
            return color

        def _joint_color(i):
            jc = color if jcolor is None else jcolor
            if named(jc, "nice") and self.jointColors:
                return _to_bgr255(self.jointColors[i])
            if named(jc, "gray") and self.jointColors:
                return _to_bgr255(_rgb_to_gray(self.jointColors[i]))
            if named(jc, "nice") or named(jc, "gray"):
                return (0, 0, 255)
            return jc

        if conns and joint.shape[0] > np.max(np.asarray(
                [c[:2] for c in conns])):
            for i, c in enumerate(conns):
                p0 = (int(np.rint(joint[c[0], 0])),
                      int(np.rint(joint[c[0], 1])))
                p1 = (int(np.rint(joint[c[1], 0])),
                      int(np.rint(joint[c[1], 1])))
                raster.line_aa(img, p0, p1, _conn_color(i), 3 * annoscale)
        for i in range(joint.shape[0]):
            p = (int(np.rint(joint[i, 0])), int(np.rint(joint[i, 1])))
            raster.circle_aa(img, p, 6 * annoscale, _joint_color(i))

    def plotResult(self, dpt, gtcrop, joint, name=None, show_gt=True,
                   upsample=4.0, annoscale=1, niceColors=False,
                   showJoints=True, showDepth=True):
        """The depth crop normalized to gray, upsampled (nearest) and
        annotated with the predicted and ground-truth skeletons (reference
        handpose_evaluation.py:348-434): with ``niceColors`` the
        prediction takes the colour tables and the ground truth their
        gray, else the prediction is blue (0, 0, 255 BGR) and the ground
        truth red (255, 0, 0).  Returns the BGR image when ``name`` is
        None, else writes it as a PNG."""
        if showDepth:
            img = np.asarray(dpt, np.float32).copy()
            msk, msk2 = img > 0, img == 0
            if msk.any():
                lo, hi = img[msk].min(), img[msk].max()
                img = (img - lo) / max(hi - lo, 1e-6) * 255.0
            img[msk2] = 255.0  # display hack to hide ND depth
        else:
            img = np.ones_like(np.asarray(dpt, np.float32)) * 255.0
        img = np.clip(img, 0.0, 255.0).astype("uint8")
        img = np.repeat(img[..., None], 3, axis=2)   # GRAY2BGR
        if upsample != 1.0:
            img = _upsample_nearest(img, upsample)

        def _scale(pts):
            return np.asarray(pts, np.float64)[:, :2] * upsample

        if showJoints and joint is not None:
            self.plotJoints(img, _scale(joint), annoscale=annoscale,
                            color="nice" if niceColors else (0, 0, 255))
        if show_gt and gtcrop is not None:
            gt_color = ("gray" if (showJoints and niceColors)
                        else ("nice" if niceColors else (255, 0, 0)))
            self.plotJoints(img, _scale(gtcrop), annoscale=annoscale,
                            color=gt_color)
        if name is None:
            return img
        write_png(name, img)
        return None


def _rgb_to_gray(rgb):
    """Luma gray of an RGB [0, 1] triple (reference rgb_to_gray,
    src/utils/helpers.py:136-143)."""
    g = 0.21 * rgb[0] + 0.72 * rgb[1] + 0.07 * rgb[2]
    return (g, g, g)


def _to_bgr255(rgb):
    """RGB [0, 1] triple -> a BGR int triple, the intended colours (the
    reference swapped channels; the JAX package draws these)."""
    r, g, b = (int(float(c) * 255.0) for c in rgb[:3])
    return (b, g, r)


def _upsample_nearest(img, f):
    """``cv2.resize(img, None, fx=f, fy=f, interpolation=INTER_NEAREST)``:
    the size rounded from ``f`` times the source's, source index
    ``min(floor(d * (1 / f)), n - 1)``."""
    h, w = img.shape[:2]
    dh, dw = int(np.rint(h * f)), int(np.rint(w * f))
    iy = np.minimum(np.floor(np.arange(dh) * (1.0 / f)).astype(np.int64),
                    h - 1)
    ix = np.minimum(np.floor(np.arange(dw) * (1.0 / f)).astype(np.int64),
                    w - 1)
    return img[iy[:, None], ix[None, :]]


# ---------------------------------------------------------------------------
# the vector plots of plotEvaluation
# ---------------------------------------------------------------------------

# matplotlib's default colour cycle (tab10)
_CYCLE = ((0.12156862745098039, 0.4666666666666667, 0.7058823529411765),
          (1.0, 0.4980392156862745, 0.054901960784313725),
          (0.17254901960784313, 0.6274509803921569, 0.17254901960784313),
          (0.8392156862745098, 0.15294117647058825, 0.1568627450980392),
          (0.5803921568627451, 0.403921568627451, 0.7411764705882353),
          (0.5490196078431373, 0.33725490196078434, 0.29411764705882354),
          (0.8901960784313725, 0.4666666666666667, 0.7607843137254902),
          (0.4980392156862745, 0.4980392156862745, 0.4980392156862745),
          (0.7372549019607844, 0.7411764705882353, 0.13333333333333333),
          (0.09019607843137255, 0.7450980392156863, 0.8117647058823529))


def nice_ticks(lo: float, hi: float, most: int = 9) -> List[float]:
    """Round tick values in [lo, hi]: a step of 1, 2, 2.5 or 5 times a
    power of ten, the smallest that gives at most ``most`` ticks."""
    span = hi - lo
    if not span > 0:
        return [lo]
    base = 10.0 ** math.floor(math.log10(span / most))
    for m in (1, 2, 2.5, 5, 10, 20):
        step = m * base
        if span / step <= most:
            break
    first = math.ceil(lo / step - 1e-9)
    return [k * step for k in range(first, int(math.floor(hi / step + 1e-9))
                                    + 1)]


def _pow2_scale(span: float, target: float) -> float:
    """The power of two nearest ``target / span``: data times it is exact."""
    return 2.0 ** round(math.log2(target / span)) if span > 0 else 1.0


class _PDFPlot:
    """One axes of a vector plot: line series and bar series in data units,
    autoscaled with matplotlib's 5 % margins (bars keep 0 as their floor)
    unless ``xlim`` / ``ylim`` are set, drawn by ``save`` with a frame,
    ticks, tick labels, axis labels, an optional grid and legend."""

    FONT = 10.0

    def __init__(self, xlabel, ylabel, grid=False):
        self.xlabel, self.ylabel, self.grid = xlabel, ylabel, grid
        self.series = []           # (kind, xs, ys, width, label, colour)
        self.xlim = self.ylim = None
        self.xtick_labels = None   # (positions, labels): rotated 90

    def _color(self):
        return _CYCLE[len(self.series) % len(_CYCLE)]

    def line(self, xs, ys, label):
        self.series.append(("line", [float(x) for x in xs],
                            [float(y) for y in ys], None, label,
                            self._color()))

    def bars(self, xs, heights, width, label):
        self.series.append(("bar", [float(x) for x in xs],
                            [float(h) for h in heights], float(width),
                            label, self._color()))

    def xticks(self, positions, labels):
        self.xtick_labels = ([float(p) for p in positions], list(labels))

    def _limits(self):
        xs, ys, bars = [], [], False
        for kind, sx, sy, w, _, _ in self.series:
            if kind == "bar":
                bars = True
                xs += [x - w / 2 for x in sx] + [x + w / 2 for x in sx]
                ys += sy + [0.0]
            else:
                xs += sx
                ys += sy
        xlo, xhi = min(xs), max(xs)
        ylo, yhi = min(ys), max(ys)
        xm, ym = 0.05 * (xhi - xlo), 0.05 * (yhi - ylo)
        xlim = self.xlim or (xlo - xm, xhi + xm)
        ylim = self.ylim or ((ylo if bars and ylo >= 0 else ylo - ym),
                             yhi + ym)
        return xlim, ylim

    def save(self, path, legend=None):
        (x0, x1), (y0, y1) = self._limits()
        sx = _pow2_scale(x1 - x0, 360.0)
        sy = _pow2_scale(y1 - y0, 256.0)
        w, h = (x1 - x0) * sx, (y1 - y0) * sy
        labels_h = 0.0
        if self.xtick_labels is not None:
            labels_h = max(text_width(t, self.FONT)
                           for t in self.xtick_labels[1])
        left, bottom = 62.0, 40.0 + labels_h
        page = PDFPage(left + w + 16.0, bottom + h + 16.0)
        # page = left + (x - x0) * sx: a translation, then data * scale
        ox, oy = left - x0 * sx, bottom - y0 * sy
        if self.grid:
            for t in nice_ticks(x0, x1):
                page.polyline([(ox + t * sx, bottom), (ox + t * sx,
                                                       bottom + h)],
                              color=(0.69, 0.69, 0.69), width=0.8)
            for t in nice_ticks(y0, y1):
                page.polyline([(left, oy + t * sy), (left + w,
                                                     oy + t * sy)],
                              color=(0.69, 0.69, 0.69), width=0.8)
        page.save_state()
        page.clip_rect(left, bottom, w, h)
        page.translate(ox, oy)
        # the data block: coordinates are data times these scales
        page.ops.append(f"% data-scale {num(sx)} {num(sy)}")
        for kind, xs, ys, bw, _, color in self.series:
            if kind == "line":
                page.polyline([(x * sx, y * sy) for x, y in zip(xs, ys)],
                              color=color, width=1.5)
            else:
                for x, y in zip(xs, ys):
                    page.rect((x - bw / 2) * sx, 0.0, bw * sx, y * sy,
                              fill=color)
        page.restore_state()
        page.rect(left, bottom, w, h, stroke=(0, 0, 0), width=0.8)
        # ticks and their labels
        if self.xtick_labels is None:
            for t in nice_ticks(x0, x1):
                px = ox + t * sx
                page.polyline([(px, bottom), (px, bottom - 3.5)], width=0.8)
                page.text(px, bottom - 14.0, f"{t:g}", self.FONT,
                          anchor="center")
        else:
            for t, s in zip(*self.xtick_labels):
                px = ox + t * sx
                page.polyline([(px, bottom), (px, bottom - 3.5)], width=0.8)
                page.text(px + self.FONT * 0.35, bottom - 6.0, s, self.FONT,
                          anchor="right", rotate=90)
        for t in nice_ticks(y0, y1):
            py = oy + t * sy
            page.polyline([(left, py), (left - 3.5, py)], width=0.8)
            page.text(left - 6.0, py - self.FONT * 0.35, f"{t:g}",
                      self.FONT, anchor="right")
        if self.xlabel:
            page.text(left + w / 2, bottom - 30.0, self.xlabel, self.FONT,
                      anchor="center")
        if self.ylabel:
            page.text(left - 40.0, bottom + h / 2, self.ylabel, self.FONT,
                      anchor="center", rotate=90)
        if legend:
            self._legend(page, legend, left, bottom, w, h)
        page.save(path)

    def _legend(self, page, where, left, bottom, w, h):
        rows = [(kind, label, color)
                for kind, _, _, _, label, color in self.series]
        lw = 36.0 + max(text_width(r[1], self.FONT) for r in rows)
        lh = 6.0 + 14.0 * len(rows)
        x = left + w - lw - 6.0
        y = bottom + 6.0 if where == "lower right" else bottom + h - lh - 6.0
        page.rect(x, y, lw, lh, fill=(1, 1, 1), stroke=(0.8, 0.8, 0.8),
                  width=0.8)
        for k, (kind, label, color) in enumerate(rows):
            cy = y + lh - 10.0 - 14.0 * k
            if kind == "line":
                page.polyline([(x + 6.0, cy), (x + 26.0, cy)], color=color,
                              width=1.5)
            else:
                page.rect(x + 6.0, cy - 4.0, 20.0, 8.0, fill=color)
            page.text(x + 32.0, cy - 3.5, label, self.FONT)


# ---------------------------------------------------------------------------
# the 3D scene of plotResult3D
# ---------------------------------------------------------------------------

def _rgb01(c):
    """A matplotlib colour of the kinds the plots pass (an RGB triple in
    [0, 1], or a gray level as a string) as an RGB triple."""
    if isinstance(c, str):
        g = float(c)
        return (g, g, g)
    return tuple(float(v) for v in np.asarray(c, np.float64)[:3])


class Scene3D:
    """The part of matplotlib's ``Axes3D`` that ``plotResult3D`` uses,
    rendered into a 600 x 600 RGB image.

    The projection is matplotlib's: the limits scaled to a (1, 1, 1) box
    (times its ``1.8294640721620434 * 25 / 24 / sqrt(3)`` per axis), the
    eye at distance 10 from the box's centre along ``(cos e cos a, cos e
    sin a, sin e)``, the view axes from the vertical z, and the
    perspective projection of focal length 1; the projected plane maps to
    the pixels of matplotlib's axes (its 2D view limits -0.095 to 0.09 on
    a 462-pixel square at (76.5, 66) from the bottom left).  Limits are
    the data's widened by 5 % and then by 1/48 of the result on each side,
    as matplotlib 3.9 and later autoscale a 3D axes."""

    SIZE = 600
    _DIST = 10.0
    _BOX = (76.5, 66.0, 462.0)          # left, bottom, side in pixels
    _VIEW = (-0.095, 0.09)              # the projected plane's limits

    def __init__(self):
        self.points = []       # (xyz (n, 3), [rgb] * n, size, marker, alpha)
        self.lines = []        # (xyz (2, 3), rgb, width)
        self.elev, self.azim = 30.0, -60.0
        self.labels = ["", "", ""]
        self.box_aspect = np.ones(3)

    # -- matplotlib's calls ---------------------------------------------------
    def scatter(self, xs, ys, zs, c=None, marker="o", s=20, alpha=1.0,
                depthshade=True):
        xyz = np.stack([np.asarray(v, np.float64).ravel()
                        for v in (xs, ys, zs)], 1)
        if isinstance(c, str) or c is None or np.ndim(c) == 1:
            colors = [_rgb01(c if c is not None else _CYCLE[0])] * len(xyz)
        else:
            colors = [_rgb01(v) for v in c]
        self.points.append((xyz, colors, float(s), marker, float(alpha)))

    def plot(self, xs, ys, zs, color=None, linewidth=1.5):
        xyz = np.stack([np.asarray(v, np.float64).ravel()
                        for v in (xs, ys, zs)], 1)
        self.lines.append((xyz, _rgb01(color if color is not None
                                       else _CYCLE[0]), float(linewidth)))

    def view_init(self, elev=30.0, azim=-60.0):
        self.elev, self.azim = float(elev), float(azim)

    def set_xlabel(self, s):
        self.labels[0] = s

    def set_ylabel(self, s):
        self.labels[1] = s

    def set_zlabel(self, s):
        self.labels[2] = s

    def set_box_aspect(self, aspect):
        self.box_aspect = np.asarray(aspect, np.float64)

    # -- projection -----------------------------------------------------------
    def limits(self) -> np.ndarray:
        """(3, 2) axis limits, autoscaled as matplotlib does."""
        pts = [p[0] for p in self.points] + [ln[0] for ln in self.lines]
        xyz = np.concatenate(pts) if pts else np.zeros((1, 3))
        lo, hi = xyz.min(0), xyz.max(0)
        span = hi - lo
        span = np.where(span > 0, span, 1.0)
        lo, hi = lo - 0.05 * span, hi + 0.05 * span
        pad = (hi - lo) / 48.0
        return np.stack([lo - pad, hi + pad], 1)

    def projection(self) -> np.ndarray:
        """The 4 x 4 matrix of matplotlib's ``Axes3D.get_proj``."""
        lim = self.limits()
        aspect = self.box_aspect * (1.8294640721620434 * 25 / 24
                                    / np.linalg.norm(self.box_aspect))
        d = (lim[:, 1] - lim[:, 0]) / aspect
        world = np.eye(4)
        world[[0, 1, 2], [0, 1, 2]] = 1.0 / d
        world[:3, 3] = -lim[:, 0] / d
        r = 0.5 * aspect
        e, a = np.deg2rad(self.elev), np.deg2rad(self.azim)
        ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                       np.sin(e)])
        eye = r + self._DIST * ps
        vert = np.array([0.0, 0.0, -1.0 if abs(e) > np.pi / 2 else 1.0])
        w = (eye - r) / np.linalg.norm(eye - r)
        u = np.cross(vert, w)
        u /= np.linalg.norm(u)
        v = np.cross(w, u)
        rot, move = np.eye(4), np.eye(4)
        rot[:3, :3] = [u, v, w]
        move[:3, 3] = -eye
        near, far = -self._DIST, self._DIST
        persp = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0],
                          [0, 0, (near + far) / (near - far),
                           -2 * near * far / (near - far)],
                          [0, 0, -1.0, 0]])
        return persp @ rot @ move @ world

    def to_pixels(self, xyz, m=None) -> np.ndarray:
        """(n, 3) data points -> (n, 3): pixel column, row (from the top)
        and the depth the points are sorted by."""
        m = self.projection() if m is None else m
        h = np.concatenate([np.asarray(xyz, np.float64),
                            np.ones((len(xyz), 1))], 1) @ m.T
        px, py, pz = h[:, 0] / h[:, 3], h[:, 1] / h[:, 3], h[:, 2] / h[:, 3]
        left, bottom, side = self._BOX
        lo, hi = self._VIEW
        col = left + (px - lo) / (hi - lo) * side
        row = self.SIZE - (bottom + (py - lo) / (hi - lo) * side)
        return np.stack([col, row, pz], 1)

    # -- drawing --------------------------------------------------------------
    def render(self) -> np.ndarray:
        img = np.full((self.SIZE, self.SIZE, 3), 255, np.uint8)
        m = self.projection()
        lim = self.limits()
        self._draw_box(img, m, lim)
        # the artists back to front by their mean depth, as matplotlib
        # orders 3D artists
        items = []
        for xyz, colors, s, marker, alpha in self.points:
            p = self.to_pixels(xyz, m)
            items.append((float(np.mean(p[:, 2])), "points",
                          (p, colors, s, marker, alpha)))
        for xyz, color, width in self.lines:
            p = self.to_pixels(xyz, m)
            items.append((float(np.mean(p[:, 2])), "line",
                          (p, color, width)))
        for _, kind, data in sorted(items, key=lambda t: t[0]):
            if kind == "points":
                p, colors, s, marker, alpha = data
                rgb = np.rint(np.asarray(colors) * 255).astype(np.uint8)
                if marker == "s":
                    raster.squares(img, p[:, 0], p[:, 1], 5,
                                   [tuple(int(v) for v in c) for c in rgb])
                else:
                    raster.blend_points(img, p[:, 0], p[:, 1], rgb[0],
                                        alpha)
            else:
                p, color, width = data
                rgb = tuple(int(round(v * 255)) for v in color)
                raster.segment(img, p[0, :2], p[1, :2], rgb, int(width))
        return img

    def _draw_box(self, img, m, lim):
        """The 12 edges of the limits' box in gray, and each axis's label
        beside the middle of its edge nearest the bottom of the image."""
        corners = np.array([[lim[0, i], lim[1, j], lim[2, k]]
                            for i in (0, 1) for j in (0, 1)
                            for k in (0, 1)])
        p = self.to_pixels(corners, m)
        centre = p[:, :2].mean(0)
        for a in range(8):
            for b in range(a + 1, 8):
                if bin(a ^ b).count("1") == 1:
                    raster.segment(img, p[a, :2], p[b, :2], (190, 190, 190),
                                   2)
        for axis, label in enumerate(self.labels):
            if not label:
                continue
            bit = 4 >> axis
            best = None
            for a in range(8):
                if a & bit:
                    continue
                mid = (p[a, :2] + p[a | bit, :2]) / 2
                if best is None or mid[1] > best[1]:
                    best = mid
            out = best - centre
            out = out / max(np.linalg.norm(out), 1e-9)
            pos = best + out * 28.0
            raster.text(img, pos[0], pos[1], label, (0, 0, 0), scale=2)


def _hsv(h, s, v):
    """HSV triple -> RGB [0, 1] ndarray (matplotlib's ``hsv_to_rgb`` and
    ``colorsys`` use the same formula)."""
    return np.asarray(colorsys.hsv_to_rgb(h, s, v))


# one hue per finger: thumb/red, index/green, middle/cyan, ring/blue,
# pinky/magenta, shared by all three datasets' eval tables
_FINGER_HUES = (0.00, 0.33, 0.50, 0.66, 0.83)


class NYUHandposeEvaluation(HandposeEvaluation):
    """NYU joint names/skeleton: the eval classes' own tables (reference
    handpose_evaluation.py:740-850); the eval-14 skeleton is a tree rooted
    at the palm C joint."""

    def __init__(self, gtjoints, joints, joint_subset=None, **kw):
        super().__init__(gtjoints, joints, **kw)
        nj = np.asarray(gtjoints).shape[1]
        if joint_subset is None:
            joint_subset = "eval" if nj == 14 else "all"
        if joint_subset == "eval":
            # handpose_evaluation.py:823-850 (14-joint eval protocol)
            self.jointNames = ["P1", "P2", "R1", "R2", "M1", "M2", "I1",
                               "I2", "T1", "T2", "T3", "W1", "W2", "C"]
            self.jointColors = (
                [_hsv(h, 1, v) for h in _FINGER_HUES[:4]
                 for v in (0.7, 1.0)]
                + [_hsv(0.83, 1, v) for v in (0.6, 0.8, 1.0)]
                + [_hsv(0.16, 1, 0.7), _hsv(0.16, 1, 1.0),
                   _hsv(0.00, 0, 0.0)])
            self.jointConnections = [[13, 1], [1, 0], [13, 3], [3, 2],
                                     [13, 5], [5, 4], [13, 7], [7, 6],
                                     [13, 10], [10, 9], [9, 8], [13, 11],
                                     [13, 12]]
            self.jointConnectionColors = (
                [_hsv(h, 1, v) for h in _FINGER_HUES[:4]
                 for v in (0.7, 1)]
                + [_hsv(0.83, 1, v) for v in (0.6, 0.8, 1)]
                + [_hsv(0.16, 1, 0.7), _hsv(0.16, 1, 1)])
        elif joint_subset == "all":
            # handpose_evaluation.py:755-822 (full 36-joint layout)
            self.jointNames = (
                [f"{f}{i}" for f in "PRMIT" for i in range(1, 6)]
                + ["C1", "C2", "C3", "W1", "W2", "W3", "W4"])
            self.jointColors = (
                [_hsv(h, 1, v) for h in _FINGER_HUES
                 for v in (0.2, 0.3, 0.4, 0.6, 0.8, 1.0)]
                + [_hsv(0.00, 1, 0.0)] * 3
                + [_hsv(0.16, 1, 0.7)] * 2 + [_hsv(0.16, 1, 1.0)] * 2)
            self.jointConnections = [
                [33, 5], [5, 4], [4, 3], [3, 2], [2, 1], [1, 0],
                [32, 11], [11, 10], [10, 9], [9, 8], [8, 7], [7, 6],
                [32, 17], [17, 16], [16, 15], [15, 14], [14, 13], [13, 12],
                [32, 23], [23, 22], [22, 21], [21, 20], [20, 19], [19, 18],
                [34, 29], [29, 28], [28, 27], [27, 26], [26, 25], [25, 24],
                [34, 32], [34, 33], [33, 32],
                [34, 30], [34, 31], [35, 30], [35, 31]]
            self.jointConnectionColors = (
                [_hsv(h, 1, v) for h in _FINGER_HUES
                 for v in (0.2, 0.3, 0.4, 0.6, 0.8, 1)]
                + [_hsv(0.00, 1, 0.0)] * 3
                + [_hsv(0.16, 1, 0.7)] * 2 + [_hsv(0.16, 1, 1.0)] * 2)
        else:
            raise ValueError("Unknown joint parameter")
        self.plotMaxJointDist = 80


class ICVLHandposeEvaluation(HandposeEvaluation):
    """ICVL joint names/skeleton (handpose_evaluation.py:684-737): five
    3-segment finger chains rooted at the palm joint 0."""

    def __init__(self, gtjoints, joints, **kw):
        super().__init__(gtjoints, joints, **kw)
        self.jointNames = ["C", "T1", "T2", "T3", "I1", "I2", "I3",
                           "M1", "M2", "M3", "R1", "R2", "R3",
                           "P1", "P2", "P3"]
        self.jointColors = (
            [_hsv(0.00, 0, 0.0)]
            + [_hsv(h, 1, v) for h in _FINGER_HUES
               for v in (0.6, 0.8, 1.0)])
        self.jointConnections = [
            [0, 3 * f + 1] if s == 0 else [3 * f + s, 3 * f + s + 1]
            for f in range(5) for s in range(3)]
        self.jointConnectionColors = [_hsv(h, 1, v) for h in _FINGER_HUES
                                      for v in (0.6, 0.8, 1)]
        self.plotMaxJointDist = 80


class MSRAHandposeEvaluation(HandposeEvaluation):
    """MSRA joint names/skeleton (handpose_evaluation.py:853-913): five
    4-segment finger chains rooted at the palm joint 0."""

    def __init__(self, gtjoints, joints, **kw):
        super().__init__(gtjoints, joints, **kw)
        self.jointNames = ["C"] + [f"{f}{i}" for f in "TIMRP"
                                   for i in range(1, 5)]
        self.jointColors = (
            [_hsv(0.00, 0, 0.0)]
            + [_hsv(h, 1, v) for h in _FINGER_HUES
               for v in (0.4, 0.6, 0.8, 1.0)])
        self.jointConnections = [
            [0, 4 * f + 1] if s == 0 else [4 * f + s, 4 * f + s + 1]
            for f in range(5) for s in range(4)]
        self.jointConnectionColors = [_hsv(h, 1, v) for h in _FINGER_HUES
                                      for v in (0.4, 0.6, 0.8, 1)]
        self.plotMaxJointDist = 80


class Evaluation:
    """Legacy mm-error helpers on x50-denormalized poses restricted to the
    NYU 14-joint protocol (reference src/utils/evaluation.py:5-77)."""

    SCALE = 50.0

    @classmethod
    def maxJntError(cls, skel1, skel2) -> float:
        diff = np.linalg.norm(
            (np.asarray(skel1).reshape(-1, 3)
             - np.asarray(skel2).reshape(-1, 3)) * cls.SCALE, axis=1)
        return float(diff[NYU_RESTRICTED_EVAL].max())

    @classmethod
    def meanJntError(cls, skel1, skel2) -> float:
        diff = np.linalg.norm(
            (np.asarray(skel1).reshape(-1, 3)
             - np.asarray(skel2).reshape(-1, 3)) * cls.SCALE, axis=1)
        return float(diff[NYU_RESTRICTED_EVAL].mean())

    @classmethod
    def plotError(cls, score_list, fig_path) -> float:
        """Write the threshold curve as text, one ``threshold percent``
        line for each of 17 thresholds (0.5 to 80.5 mm); return the share
        of scores <= 40.5 mm (evaluation.py:29-77)."""
        scores = np.sort(np.asarray(score_list, np.float64))
        err40 = float((scores <= 40.5).mean()) if scores.size else 0.0
        thresholds = [t * 5.0 + 0.5 for t in range(17)]
        with open(fig_path, "w") as f:
            for th in thresholds:
                pct = float((scores < th).mean()) * 100.0 if scores.size \
                    else 0.0
                f.write(f"{th:f} {pct:f}\n")
        return err40
