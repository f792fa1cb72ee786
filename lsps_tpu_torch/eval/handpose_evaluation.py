"""Hand-pose accuracy metrics (host numpy).

The port's copy of the metrics of ``lsps_tpu/eval/handpose_evaluation.py``
(reference: src/utils/handpose_evaluation.py:41-228 and the per-dataset
joint tables, :684-913): vectorized over (N, J, 3) arrays and NaN-tolerant
like the reference (nanmean/nanmax).  ``Evaluation`` holds the legacy mm
errors of src/utils/evaluation.py (x50-denormalized poses on the NYU
14-joint protocol) and its threshold curve as text.

Not ported (``ROADMAP.md`` queue 1 #7, the next item): the plots
(``plotEvaluation``, ``plotHand3D``, ``plotResult3D``, ``plotJoints``,
``plotResult``), which need matplotlib or cv2's drawing; the card's
machine has neither, so they wait for a numpy rasterizer.
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence

import numpy as np

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
