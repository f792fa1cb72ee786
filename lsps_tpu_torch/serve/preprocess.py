"""On-device preprocessing: depth frame -> normalized 128x128 crop.

Counterpart of ``lsps_tpu/serve/preprocess_jax.py`` and of
``lsps_tpu/ops/pallas/warp.py:crop_normalize_batch_pallas``.  On the card a
batch is one launch of the ``crop_normalize`` kernel, which computes the
crop bounds, the source rows and columns, the tail parameters and the crop
affine itself, gathers and normalizes.  The crop-index math lives beside
the kernel in ``lsps_tpu_torch/ops/kernels/warp.py``, whose notes say how
it stays bit-equal to the JAX package's (XLA's ``x / const -> x * (1 /
const)`` and FMA contraction spelled out in float32 there, and as
explicitly rounded intrinsics in the kernel); it is re-exported here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lsps_tpu_torch.ops.kernels.warp import (  # noqa: F401
    com_to_bounds, crop_indices, crop_normalize, crop_transform, fma)


def crop_normalize_batch(frames: torch.Tensor, coms: torch.Tensor,
                         cubes: torch.Tensor, fx: float, fy: float,
                         dsize: Tuple[int, int] = (128, 128)):
    """(B, H, W) float32 or uint16 frames + (B, 3) CoMs + (B, 3) cubes ->
    (crops (B, dh, dw) in [-1, 1], Ms (B, 3, 3)).  One kernel launch for
    CUDA tensors; the plain version for CPU tensors."""
    return crop_normalize(frames.contiguous(),
                          coms.to(torch.float32).contiguous(),
                          cubes.to(torch.float32).contiguous(), fx, fy, dsize)
