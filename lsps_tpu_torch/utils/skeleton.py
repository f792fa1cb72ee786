"""Skeleton color/bone tables for visualization.

The port's copy of ``lsps_tpu/utils/skeleton.py``.  Reference:
src/utils/util.py:11-37 — joint color indices and bone connectivity per
dataset, consumed by ``visPair`` (src/pose_train.py:54-59).
"""

from __future__ import annotations

from typing import List, Tuple

FIG_COLOR = [(19, 69, 139), (51, 51, 255), (51, 151, 255), (51, 255, 151),
             (255, 255, 51), (255, 51, 153), (0, 255, 0)]

# per-joint color indices (util.py:19-24; POST from util2.py:26)
NYU_COLOR_IDX = [1] * 6 + [2] * 6 + [3] * 6 + [4] * 6 + [5] * 6 + [0] * 6
ICVL_COLOR_IDX = [0] + [1] * 3 + [2] * 3 + [3] * 3 + [4] * 3 + [5] * 3
MSRA_COLOR_IDX = [0] + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4
POST_COLOR_IDX = ([0] + [1] * 3 + [0] + [2] * 3 + [0] * 2 + [3] * 4
                  + [4] * 4)


def _finger_bones(start: int, n: int, color) -> List[Tuple[int, int, tuple]]:
    return [(s, s + 1, color) for s in range(start, start + n - 1)]


def _flatten(groups):
    return [b for g in groups for b in g]


# bone chains (util.py:34-37)
NYU_BONES = _flatten([_finger_bones(b * 6, 6, FIG_COLOR[b + 1])
                      for b in range(5)])
NYU_BONES_14 = (_flatten([_finger_bones(b * 2, 2, (255, 51, 153))
                          for b in range(5)])
                + [(-4, -5, (255, 51, 153))]
                + [(b * 2 + 1, -1, (255, 51, 153)) for b in range(4)])
ICVL_BONES = _flatten([_finger_bones(b * 3 + 1, 3, FIG_COLOR[b + 1])
                       for b in range(5)])
MSRA_BONES = _flatten([_finger_bones(b * 4 + 1, 4, FIG_COLOR[b + 1])
                       for b in range(5)])
# POST body chains (util2.py:41): two 3-joint limbs then two 4-joint limbs
POST_BONES = _flatten(
    [_finger_bones(b * 4 + 1, 3, FIG_COLOR[b + 1]) for b in range(2)]
    + [_finger_bones(b * 4 + 2, 4, FIG_COLOR[b + 1]) for b in range(2, 4)])


def tables_for(config_name: str):
    """(color_idx, bones) selected by config path substring
    (pose_train.py:68-75)."""
    if "icvl" in config_name:
        return ICVL_COLOR_IDX, ICVL_BONES
    if "msra" in config_name:
        return MSRA_COLOR_IDX, MSRA_BONES
    if "post" in config_name:
        return POST_COLOR_IDX, POST_BONES
    return NYU_COLOR_IDX, NYU_BONES
