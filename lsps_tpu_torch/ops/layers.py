"""NN building blocks of the port (NCHW inside, as PyTorch wants).

Counterparts of ``lsps_tpu/ops/layers.py``.  Each block nests like the
JAX package's ``sequential`` lists, so a JAX pytree path names the same
parameter here (``weights.from_jax_params``).  Initialisation matches the
reference's distributions: N(0, 0.02) conv kernels, PyTorch's uniform
bound 1/sqrt(fan_in) for linear weights and for every bias.  Each
``reset_parameters`` takes an optional ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.01


def _uniform_(t: torch.Tensor, fan_in: int, generator=None) -> None:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    nn.init.uniform_(t, -bound, bound, generator=generator)


class Conv2d(nn.Conv2d):
    """PyTorch-parity conv: cross-correlation, symmetric padding, bias."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__(n_in, n_out, kernel_size, stride, padding)

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        _uniform_(self.bias, fan_in, generator)


class Linear(nn.Linear):
    """PyTorch Linear; weight (out, in), the JAX package's (in, out)^T."""

    def reset_parameters(self, generator=None) -> None:
        _uniform_(self.weight, self.in_features, generator)
        _uniform_(self.bias, self.in_features, generator)


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)``.  ``F.leaky_relu`` selects on
    ``x > 0`` instead; the two differ only at x = -0.0, where both give
    -0.0, so they agree bit for bit."""
    return F.leaky_relu(x, slope)


class LeakyReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x)


class LeakyReLUConv2d(nn.Sequential):
    """``leaky_relu_conv2d``: [conv, LeakyReLU]."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0):
        super().__init__(Conv2d(n_in, n_out, kernel_size, stride, padding),
                         LeakyReLU())


class LeakyReLULinear(nn.Sequential):
    """``leaky_relu_linear``: [linear, LeakyReLU]."""

    def __init__(self, n_in, n_out):
        super().__init__(Linear(n_in, n_out), LeakyReLU())


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0), with no linear cut-off above
    a threshold as ``F.softplus`` has."""
    return torch.logaddexp(x, torch.zeros_like(x))


def reset_parameters(module: nn.Module, generator=None) -> None:
    """Re-draw every parameter of ``module`` from ``generator``, in the
    order of ``module.modules()``."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.reset_parameters(generator)
