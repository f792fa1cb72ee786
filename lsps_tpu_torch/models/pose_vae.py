"""Pose VAE over flattened 3D joint vectors.

Counterpart of ``lsps_tpu/models/pose_vae.py``.  Encoder: Linear ->
LeakyReLU -> (mu Linear, sd = softplus(Linear)), the mu/sd heads drawn
from N(0, 0.002); the reparameterised sample uses noise of fixed scale
0.05.  Decoder: LeakyReLU(Linear) -> Linear.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lsps_tpu_torch.ops import layers as L
from lsps_tpu_torch.registry import register

NOISE_STD = 0.05


class _PresetLinear(L.Linear):
    """Linear whose weight and bias are drawn from N(0, 0.002)."""

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.weight, 0.0, 0.002, generator=generator)
        nn.init.normal_(self.bias, 0.0, 0.002, generator=generator)


@register("model", "poseVAE")
@register("model", "PoseVAE")
class PoseVAE(nn.Module):
    def __init__(self, params_cfg: dict):
        super().__init__()
        self.input_dim = params_cfg["input_dim"]
        self.z_dim = params_cfg["z_dim"]
        self.h_dim = params_cfg["h_dim"]
        self.en_fc1 = L.Linear(self.input_dim, self.h_dim)
        self.en_mu = _PresetLinear(self.h_dim, self.z_dim)
        self.en_sigma = _PresetLinear(self.h_dim, self.z_dim)
        self.de_fc1 = L.LeakyReLULinear(self.z_dim, self.h_dim)
        self.de_fc2 = L.Linear(self.h_dim, self.input_dim)

    def encode(self, y: torch.Tensor, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Return (z, mu, sd).  ``noise`` is a standard-normal draw of mu's
        shape, or is drawn from ``generator``; z = mu + sd * 0.05 * noise.
        With neither, z = mu."""
        h = L.leaky_relu(self.en_fc1(y))
        mu = self.en_mu(h)
        sd = L.softplus(self.en_sigma(h))
        if noise is None and generator is None:
            return mu, mu, sd
        if noise is None:
            noise = L.draw_normal(mu.shape, generator, mu.dtype, mu.device)
        return mu + sd * (NOISE_STD * noise), mu, sd

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.de_fc2(self.de_fc1(z))

    def forward(self, y: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Full pass: returns (recons, z, mu, sd)."""
        z, mu, sd = self.encode(y, noise, generator)
        return self.decode(z), z, mu, sd
