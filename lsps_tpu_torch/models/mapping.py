"""Pose-latent -> depth-latent feature-map mapping network.

Counterpart of ``lsps_tpu/models/mapping.py``: a pose code (B, input_dim)
is seen as a 1x1 map and upsampled by four transposed convs to the
generator's shared-latent shape (B, output_dim, output_dim, output_ch),
NHWC.  The module is the JAX package's ``sequential`` list itself, so
its state_dict keys (``0.0.weight`` ... ``3.weight``) follow the pytree.
"""

from __future__ import annotations

import torch
from torch import nn

from lsps_tpu_torch.ops import layers as L
from lsps_tpu_torch.registry import register


@register("model", "Mapping")
class Mapping(nn.Sequential):
    def __init__(self, cfg: dict):
        self.cfg = dict(cfg)
        self.input_dim = cfg["input_dim"]
        dim, ch = cfg["output_dim"], cfg["output_ch"]
        self.output_shape = (dim, dim, ch)
        super().__init__(
            L.LeakyReLUConvTranspose2d(self.input_dim, 4 * ch, 4, 1, 0),
            L.LeakyReLUConvTranspose2d(4 * ch, 4 * ch, 4, 2, 1),
            L.LeakyReLUConvTranspose2d(4 * ch, 2 * ch, 4, 2, 1),
            L.ConvTranspose2d(2 * ch, ch, 4, 2, 1))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, input_dim) -> (B, dim, dim, ch) NHWC."""
        return super().forward(z[:, :, None, None]).permute(0, 2, 3, 1)
