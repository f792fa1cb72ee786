"""The rest of the reference's block library (common_net.py:12-103,
183-379), as the JAX package keeps it (``lsps_tpu/ops/layers.py:457-691``).

No configuration of either package builds these blocks; they complete the
op library.  Each block nests like the JAX package's ``sequential`` list,
so ``weights.from_jax_params`` carries a JAX pytree across and
``load_state_dict(strict=True)`` takes it:

* ``GaussianSmoother``: a fixed Gaussian blur of each channel with a
  replicate border (cv2's ``getGaussianKernel(k, -1)`` tables for k <= 7);
  no parameters.
* ``GaussianVAEHead`` / ``GaussianVAE2DHead``: linear or conv heads for mu
  and a softplus sd, preset to N(0, 0.002); ``sample`` takes injected
  noise or draws it from a generator, as the port's other draws do.
* ``Bias2d``: a learnable per-channel bias preset to N(0, 0.002).
* ``BatchNorm``: per-channel normalization over every axis but the
  channel's with the batch's own statistics (the reference's BN blocks
  only ever ran in training mode), no running buffers; ``weight`` and
  ``bias`` are the JAX package's ``scale`` and ``shift``.
* the IN / BN conv and conv-transpose wrappers, the BN linear and the two
  residual blocks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lsps_tpu_torch.ops.layers import (Conv2d, ConvTranspose2d,
                                       InstanceNorm, LeakyReLU, Linear,
                                       ResidualBody, draw_normal, softplus)

PRESET_STD = 0.002

# cv2.getGaussianKernel(k, -1)'s fixed tables for small kernels
_SMALL_GAUSSIANS = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel_1d(kernel_size: int) -> np.ndarray:
    """cv2.getGaussianKernel(k, -1): the fixed tables for k <= 7, else
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8, normalized."""
    if kernel_size in _SMALL_GAUSSIANS:
        return np.asarray(_SMALL_GAUSSIANS[kernel_size], np.float64)
    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


class GaussianSmoother(nn.Module):
    """GaussianSmoother (common_net.py:12-30): each channel blurred by the
    fixed float32 outer product of ``gaussian_kernel_1d``, replicate
    border, same size out."""

    def __init__(self, kernel_size: int = 5):
        super().__init__()
        k1 = gaussian_kernel_1d(kernel_size)
        self.register_buffer("kernel", torch.from_numpy(
            np.outer(k1, k1).astype(np.float32)), persistent=False)
        self.pad = (kernel_size - 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        p = self.pad
        xp = F.pad(x, (p, p, p, p), mode="replicate")
        w = self.kernel.to(x.dtype)[None, None].expand(c, 1, -1, -1)
        return F.conv2d(xp, w, groups=c)


class _PresetLinear(Linear):
    """A Linear whose weight and bias are drawn from N(0, 0.002)."""

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.weight, 0.0, PRESET_STD, generator=generator)
        nn.init.normal_(self.bias, 0.0, PRESET_STD, generator=generator)


class _PresetConv2d(Conv2d):
    """A Conv2d whose weight is drawn from N(0, 0.002) (bias as any
    conv's)."""

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.weight, 0.0, PRESET_STD, generator=generator)
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        nn.init.uniform_(self.bias, -fan_in ** -0.5, fan_in ** -0.5,
                         generator=generator)


class _GaussianHead(nn.Module):
    """mu and a softplus sd from two parallel heads; ``sample`` adds sd
    times a unit normal draw (``noise``, or drawn from ``generator``)."""

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.en_mu(x), softplus(self.en_sigma(x))

    def sample(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
               generator=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mu, sd = self(x)
        if noise is None:
            if generator is None:
                raise ValueError("sample needs noise or a generator")
            noise = draw_normal(mu.shape, generator, mu.dtype, mu.device)
        return mu + sd * noise.to(mu.dtype), mu, sd


class GaussianVAEHead(_GaussianHead):
    """GaussianVAE (common_net.py:42-64): linear mu and sd heads."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.en_mu = _PresetLinear(n_in, n_out)
        self.en_sigma = _PresetLinear(n_in, n_out)


class GaussianVAE2DHead(_GaussianHead):
    """GaussianVAE2D (common_net.py:66-90): conv mu and sd heads."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int, stride: int,
                 padding: int = 0):
        super().__init__()
        self.en_mu = _PresetConv2d(n_in, n_out, kernel_size, stride, padding)
        self.en_sigma = _PresetConv2d(n_in, n_out, kernel_size, stride,
                                      padding)


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over dim 1 of an ``ndim`` input."""
    return v.reshape((1, -1) + (1,) * (ndim - 2))


class Bias2d(nn.Module):
    """Bias2d (common_net.py:92-103): x plus a learnable per-channel bias
    preset to N(0, 0.002)."""

    resets_own_parameters = True

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.bias, 0.0, PRESET_STD, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + _per_channel(self.bias, x.ndim)


class BatchNorm(nn.Module):
    """``batch_norm_layer``: each channel (dim 1) normalized over every
    other axis with the batch's mean and biased variance, moments in
    ``promote(dtype, float32)``; with ``affine``, times ``weight`` (ones)
    plus ``bias`` (zeros).  Takes (N, C, H, W) and (N, C)."""

    resets_own_parameters = True
    # the JAX package's leaf names (weights.from_jax_params / to_jax_params)
    jax_leaf_names = {"weight": "scale", "bias": "shift"}

    def __init__(self, n_out: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.empty(n_out))
            self.bias = nn.Parameter(torch.empty(n_out))
        else:
            self.weight = self.bias = None
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = (0,) + tuple(range(2, x.ndim))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(axes, keepdim=True)
        var = (xf - mean).square().mean(axes, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = (y * _per_channel(self.weight, x.ndim)
                 + _per_channel(self.bias, x.ndim))
        return y.to(x.dtype)


class LeakyReLUINSConv2d(nn.Sequential):
    """``leaky_relu_ins_conv2d`` (common_net.py:357-367): [conv, IN,
    LeakyReLU]."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0):
        super().__init__(Conv2d(n_in, n_out, kernel_size, stride, padding),
                         InstanceNorm(), LeakyReLU())


class LeakyReLUINSConvTranspose2d(nn.Sequential):
    """``leaky_relu_ins_conv_transpose2d`` (common_net.py:369-379)."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0,
                 output_padding=0):
        super().__init__(ConvTranspose2d(n_in, n_out, kernel_size, stride,
                                         padding, output_padding),
                         InstanceNorm(), LeakyReLU())


class ReLUINSConv2d(nn.Sequential):
    """``relu_ins_conv2d``: [conv, IN, ReLU]."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0):
        super().__init__(Conv2d(n_in, n_out, kernel_size, stride, padding),
                         InstanceNorm(), nn.ReLU())


class ReLUINSConvTranspose2d(nn.Sequential):
    """``relu_ins_conv_transpose2d``: [conv transpose, IN, ReLU]."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0,
                 output_padding=0):
        super().__init__(ConvTranspose2d(n_in, n_out, kernel_size, stride,
                                         padding, output_padding),
                         InstanceNorm(), nn.ReLU())


class LeakyReLUBNConv2d(nn.Sequential):
    """``leaky_relu_bn_conv2d`` (common_net.py:294-305): [conv without
    bias, BN (affine), LeakyReLU]."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0):
        super().__init__(Conv2d(n_in, n_out, kernel_size, stride, padding,
                                bias=False),
                         BatchNorm(n_out, affine=True), LeakyReLU())


class LeakyReLUBNConvTranspose2d(nn.Sequential):
    """``leaky_relu_bn_conv_transpose2d`` (common_net.py:307-318)."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0,
                 output_padding=0):
        super().__init__(ConvTranspose2d(n_in, n_out, kernel_size, stride,
                                         padding, output_padding, bias=False),
                         BatchNorm(n_out, affine=True), LeakyReLU())


class LeakyReLUBNNSConv2d(nn.Sequential):
    """``leaky_relu_bnns_conv2d`` (common_net.py:320-331): [conv, BN (no
    affine), Bias2d, LeakyReLU]."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0):
        super().__init__(Conv2d(n_in, n_out, kernel_size, stride, padding),
                         BatchNorm(n_out, affine=False), Bias2d(n_out),
                         LeakyReLU())


class LeakyReLUBNNSConvTranspose2d(nn.Sequential):
    """``leaky_relu_bnns_conv_transpose2d`` (common_net.py:333-344)."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0):
        super().__init__(ConvTranspose2d(n_in, n_out, kernel_size, stride,
                                         padding),
                         BatchNorm(n_out, affine=False), Bias2d(n_out),
                         LeakyReLU())


class LeakyReLUBNLinear(nn.Sequential):
    """``leaky_relu_bn_linear`` (common_net.py:282-292): [linear, BN (no
    affine), LeakyReLU]."""

    def __init__(self, n_in, n_out):
        super().__init__(Linear(n_in, n_out),
                         BatchNorm(n_out, affine=False), LeakyReLU())


class LeakyReLUResBlock(ResidualBody):
    """``leaky_relu_res_block`` (common_net.py:199-213): x + [conv,
    LeakyReLU, conv](x).  Both convs are (n_in, n_out) as in the
    reference, so only n_in == n_out runs."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0):
        super().__init__(Conv2d(n_in, n_out, kernel_size, stride, padding),
                         LeakyReLU(),
                         Conv2d(n_in, n_out, kernel_size, stride, padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class LeakyReLUBNNSResBlock(ResidualBody):
    """``leaky_relu_bnns_res_block`` (common_net.py:183-197): x + [conv
    without bias, BN (no affine), LeakyReLU, conv without bias, BN](x)."""

    def __init__(self, n_in, n_out, kernel_size, stride, padding=0):
        super().__init__(
            Conv2d(n_in, n_out, kernel_size, stride, padding, bias=False),
            BatchNorm(n_out, affine=False), LeakyReLU(),
            Conv2d(n_in, n_out, kernel_size, stride, padding, bias=False),
            BatchNorm(n_out, affine=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)
