"""2D/3D point transforms, fully vectorized (host numpy).

The port's copy of ``lsps_tpu/data/transformations.py``.  Semantics match
the reference's per-point loops
(reference: src/data/transformations.py:34-166) but operate on whole
(N, 3) arrays at once — the reference loops one point at a time in
Python; here a single matmul handles the batch.
"""

from __future__ import annotations

import numpy as np


def transform_points_2d(pts, M):
    """Apply a 3x3 homogeneous transform to the (u, v) columns of pts.

    The third column (depth) is preserved, matching the reference
    (transformations.py:58-68).
    """
    pts = np.asarray(pts, np.float32)
    M = np.asarray(M, np.float32).reshape(3, 3)
    homo = np.concatenate(
        [pts[..., :2], np.ones((*pts.shape[:-1], 1), np.float32)], axis=-1)
    out = homo @ M.T
    uv = out[..., :2] / out[..., 2:3]
    if pts.shape[-1] > 2:
        return np.concatenate([uv, pts[..., 2:]], axis=-1)
    return uv


def transform_point_2d(pt, M):
    """Single-point version; returns (u, v) (transformations.py:47-55)."""
    return transform_points_2d(np.asarray(pt, np.float32)[None, :2], M)[0]


def rotate_points_2d(pts, center, angle_deg):
    """Rotate (u, v) around a 2D center by angle in degrees, keep depth
    (transformations.py:71-102)."""
    pts = np.asarray(pts, np.float32)
    a = np.deg2rad(angle_deg)
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                 np.float32)
    uv = (pts[..., :2] - center[:2]) @ R.T + center[:2]
    if pts.shape[-1] > 2:
        return np.concatenate([uv, pts[..., 2:]], axis=-1)
    return uv


def rotate_point_2d(pt, center, angle_deg):
    return rotate_points_2d(np.asarray(pt, np.float32)[None], np.asarray(
        center, np.float32), angle_deg)[0]


def rotation_matrix_3d(ax_deg, ay_deg, az_deg):
    """Intrinsic xyz Euler rotation, 4x4 (transformations.py:105-119)."""
    ax, ay, az = np.deg2rad([ax_deg, ay_deg, az_deg])
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    R = np.eye(4)
    # transforms3d euler2mat(.., 'rxyz') == Rx @ Ry @ Rz
    R[:3, :3] = Rx @ Ry @ Rz
    return R


def rotate_points_3d(pts, center, ax_deg, ay_deg, az_deg):
    """Rotate 3D points around center (transformations.py:122-155)."""
    pts = np.asarray(pts, np.float32)
    R = rotation_matrix_3d(ax_deg, ay_deg, az_deg)[:3, :3].astype(np.float32)
    return (pts - center) @ R.T + center


def transform_point_3d(pt, M):
    """Homogeneous 4x4 transform of a 3D point (transformations.py:158-166)."""
    M = np.asarray(M, np.float32).reshape(4, 4)
    v = M @ np.array([pt[0], pt[1], pt[2], 1.0], np.float32)
    return v[:3] / v[3]
