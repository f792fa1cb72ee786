"""The yardstick: the card's published peaks, the bytes and operations a
kernel must move and compute, its roofline bound, and percentiles.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense,
no sparsity).  Bytes count each input read once and each output written
once, whatever the kernel reads again.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # TF32 tensor cores, dense

WARP_FLOPS_PER_PIXEL = 9      # 3 compare-selects, isfinite, sub, div
WARP_INDEX_FLOPS = 8          # per output row or column: sub, div, add,
                              # floor and four compares
NORM_FLOPS_PER_VALUE = {"in_act_forward": 8, "in_act_backward": 9,
                        "in_res_forward": 8, "in_res_backward": 10}
# kernel symbol in a trace -> the norm function whose bytes it moves
NORM_SYMBOLS = {"in_act_fwd_kernel": "in_act_forward",
                "in_act_bwd_kernel": "in_act_backward",
                "in_res_fwd_kernel": "in_res_forward",
                "in_res_bwd_kernel": "in_res_backward"}
CROP_SYMBOL = "crop_warp_kernel"


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def source_pixels(iy: np.ndarray, ix: np.ndarray) -> int:
    """Distinct valid source pixels of each frame's crop, summed."""
    src = 0
    for i in range(iy.shape[0]):
        rows = np.unique(iy[i][iy[i] >= 0]).size
        cols = np.unique(ix[i][ix[i] >= 0]).size
        src += rows * cols
    return src


def warp_bytes(esize: int, iy: np.ndarray, ix: np.ndarray) -> int:
    """Bytes the crop kernel must move for these crops: each distinct
    valid source pixel read once, the CoM and cube read (24 B) and the
    crop affine (36 B) and the float32 crop written once per frame."""
    b, dh, dw = iy.shape[0], iy.shape[1], ix.shape[1]
    return source_pixels(iy, ix) * esize + b * (24 + 36) + b * dh * dw * 4


def warp_flops(b: int, dh: int, dw: int) -> int:
    return WARP_FLOPS_PER_PIXEL * b * dh * dw + WARP_INDEX_FLOPS * b * (dh
                                                                        + dw)


def norm_bytes(name: str, planes: int, hw: int, esize: int) -> int:
    """Bytes a norm kernel must move over ``planes`` planes of ``hw``
    values: each input read once, each output written once."""
    n = planes * hw
    return {
        "in_act_forward": n * esize * 2 + n * 4 + planes * 4,
        "in_act_backward": n * esize * 2 + n * 4 + planes * 4,
        "in_res_forward": n * esize * 3 + planes * 8,
        "in_res_backward": n * esize * 3 + planes * 8,
    }[name]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by the nearest rank: a value that
    was measured."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[k - 1])
