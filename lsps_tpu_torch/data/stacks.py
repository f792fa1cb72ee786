"""In-memory image and label stacks (the legacy dataset surface).

The port's copy of ``lsps_tpu/data/stacks.py`` (reference:
src/data/dataset.py:60-158): a loaded sequence as a contiguous
(N, 1, 128, 128) depth stack normalized to [-1, 1] and (N, J, 3) labels
over half the cube's depth, bit-equal to the JAX package's.
:class:`FrameArrays` is already a struct of arrays, so these are thin
views.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lsps_tpu_torch.data.augment import normalize
from lsps_tpu_torch.data.basetypes import FrameArrays


def img_stack_depth_only(arrays: FrameArrays) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """(N, 1, H, W) normalized depth stack + (N, J, 3) normalized labels
    (reference dataset.py:72-111: depth to [-1, 1], labels by half the
    cube's depth)."""
    cube = arrays.cube
    n = len(arrays)
    imgs = np.empty((n, 1) + arrays.dpt.shape[1:], np.float32)
    for i in range(n):
        imgs[i, 0] = normalize(arrays.dpt_mm(i), arrays.com[i], cube)
    labels = arrays.gt3Dcrop / (cube[2] / 2.0)
    return imgs, labels.astype(np.float32)


class SequenceDataset:
    """A legacy-style dataset over one imported sequence (reference
    dataset.py:114-158)."""

    def __init__(self, arrays: FrameArrays):
        self.arrays = arrays

    def imgStackDepthOnly(self):
        return img_stack_depth_only(self.arrays)

    def __len__(self):
        return len(self.arrays)
