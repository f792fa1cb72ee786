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
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lsps_tpu_torch.ops.kernels import norm_act

LEAKY_SLOPE = 0.01


def _uniform_(t: torch.Tensor, fan_in: int, generator=None) -> None:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    nn.init.uniform_(t, -bound, bound, generator=generator)


class Conv2d(nn.Conv2d):
    """PyTorch-parity conv: cross-correlation, symmetric padding, bias;
    ``groups`` splits the channels as ``feature_group_count`` does."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1):
        super().__init__(n_in, n_out, kernel_size, stride, padding,
                         groups=groups)

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)
        fan_in = (self.in_channels // self.groups * self.kernel_size[0]
                  * self.kernel_size[1])
        _uniform_(self.bias, fan_in, generator)


class ConvTranspose2d(nn.ConvTranspose2d):
    """PyTorch ConvTranspose2d, ``output_padding`` included; weight
    (I, O, kh, kw), the JAX package's ``wt`` (kh, kw, I, O) permuted.
    Bias bound 1/sqrt(O * kh * kw), PyTorch's fan_in for this weight."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0):
        super().__init__(n_in, n_out, kernel_size, stride, padding,
                         output_padding)

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)
        fan_in = self.out_channels * self.kernel_size[0] * self.kernel_size[1]
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
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.reset_parameters(generator)


class LeakyReLUConvTranspose2d(nn.Sequential):
    """``leaky_relu_conv_transpose2d``: [conv transpose, LeakyReLU]."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0,
                 output_padding=0):
        super().__init__(ConvTranspose2d(n_in, n_out, kernel_size, stride,
                                         padding, output_padding),
                         LeakyReLU())


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW in plain torch ops: each
    (n, c) plane over H, W, biased variance, moments in
    ``promote(dtype, float32)`` (float64 stays float64), the result in
    x's dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean((2, 3), keepdim=True)
    var = (xf - mean).square().mean((2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class InstanceNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


class FusedINLeakyReLU(nn.Module):
    """IN + LeakyReLU as one op: the CUDA kernel pair of
    ``ops/kernels/norm_act.py`` on the card."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_act.fused_instance_norm_leaky_relu(x)


class GaussianNoise(nn.Module):
    """Additive N(0, 1) noise, active only in training.  ``noise`` is an
    injected draw of x's shape; else it is drawn from ``generator``."""

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training:
            return x
        if noise is None:
            if generator is None:
                raise ValueError("GaussianNoise needs noise or a generator "
                                 "in training")
            noise = torch.randn(x.shape, generator=generator,
                                dtype=x.dtype, device=x.device)
        return x + noise


class Dropout(nn.Module):
    """``dropout_layer``: in training keeps each value with probability
    1 - rate and scales it by 1 / (1 - rate); the keep-mask is drawn from
    ``generator``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout needs a generator in training")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class ResidualBody(nn.Sequential):
    """A residual block's body; the children are the JAX body's slots, so
    state_dict keys follow its pytree.  A trailing ``Dropout`` takes the
    generator."""

    def body(self, x: torch.Tensor, generator=None, stop=None):
        for m in list(self)[:stop]:
            x = m(x, generator=generator) if isinstance(m, Dropout) else m(x)
        return x


class LeakyINSResBlock(ResidualBody):
    """``leaky_ins_res_block``: x + [conv3x3, IN+LeakyReLU (kernel), no-op,
    conv3x3, IN](x), with a Dropout slot when ``dropout > 0``.  The no-op
    keeps the five-slot layout of the JAX pytree.  Under
    ``norm_act.in_res_fused_enabled()`` (and no dropout) the tail IN and
    the residual add run as one fused op instead; the math is the same."""

    def __init__(self, n_in: int, n_out: int, dropout: float = 0.0):
        body = [Conv2d(n_in, n_out, 3, 1, 1), FusedINLeakyReLU(),
                nn.Identity(), Conv2d(n_out, n_out, 3, 1, 1), InstanceNorm()]
        if dropout > 0:
            body.append(Dropout(dropout))
        super().__init__(*body)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if len(self) == 5 and norm_act.in_res_fused_enabled():
            return norm_act.fused_instance_norm_residual(
                self.body(x, stop=4), x)
        return x + self.body(x, generator)


class LeakyINSResNeXtBlock(ResidualBody):
    """``leaky_ins_resnext_block``: x + [1x1 expand, IN, LeakyReLU,
    grouped 3x3, IN, LeakyReLU, 1x1 project, IN](x), plain torch ops."""

    def __init__(self, n_in: int, n_out: int, k: int = 2,
                 cardinality: int = 8, dropout: float = 0.0):
        mid = k * n_in
        body = [Conv2d(n_in, mid, 1, 1, 0), InstanceNorm(), LeakyReLU(),
                Conv2d(mid, mid, 3, 1, 1, groups=cardinality),
                InstanceNorm(), LeakyReLU(), Conv2d(mid, n_out, 1, 1, 0),
                InstanceNorm()]
        if dropout > 0:
            body.append(Dropout(dropout))
        super().__init__(*body)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return x + self.body(x, generator)
