"""NN building blocks of the port (NCHW inside, as PyTorch wants).

Counterparts of ``lsps_tpu/ops/layers.py``.  Each block nests like the
JAX package's ``sequential`` lists, so a JAX pytree path names the same
parameter here (``weights.from_jax_params``).  Initialisation matches the
reference's distributions: N(0, 0.02) conv kernels, PyTorch's uniform
bound 1/sqrt(fan_in) for linear weights and for every bias.  Each
``reset_parameters`` takes an optional ``torch.Generator``.

``set_im2col_stem`` turns on the JAX package's opt-in im2col stem: a
one-input-channel conv runs as ``F.unfold`` and one product instead of a
conv (the same math; ``LSPS_IM2COL_STEM=1`` is the default when the switch
is left ``None``).  The rest of the reference's block library is in
``ops/common_net.py``.

In bfloat16 the layers round where the JAX package's do: a conv (or
transposed conv) is rounded to bfloat16 before its bias is added in
bfloat16, and LeakyReLU multiplies by the slope rounded to bfloat16 (a
weakly typed Python float there).  Other dtypes take PyTorch's own ops.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lsps_tpu_torch.ops.kernels import norm_act

LEAKY_SLOPE = 0.01


def _uniform_(t: torch.Tensor, fan_in: int, generator=None) -> None:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    nn.init.uniform_(t, -bound, bound, generator=generator)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """NCHW ``y`` plus a per-channel bias (if any), in y's dtype."""
    return y if bias is None else y + bias[:, None, None]


_IM2COL_STEM: Optional[bool] = None   # None: LSPS_IM2COL_STEM decides


def set_im2col_stem(value: Optional[bool]) -> Optional[bool]:
    """Force the im2col stem on (True) or off (False), or leave it to
    ``LSPS_IM2COL_STEM`` (None); returns the previous setting."""
    global _IM2COL_STEM
    previous, _IM2COL_STEM = _IM2COL_STEM, value
    return previous


def im2col_stem_enabled() -> bool:
    if _IM2COL_STEM is not None:
        return bool(_IM2COL_STEM)
    return os.environ.get("LSPS_IM2COL_STEM", "0") == "1"


def patches_gemm(x: torch.Tensor, weight: torch.Tensor, stride: int,
                 padding: int) -> torch.Tensor:
    """A one-input-channel conv as patch extraction and one product: the
    (N, kh * kw, L) patches of ``F.unfold`` times the (O, kh * kw) kernel,
    summed in ``promote(dtype, float32)`` and returned in x's dtype."""
    n, _, h, w = x.shape
    o, _, kh, kw = weight.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    cols = F.unfold(x, (kh, kw), padding=padding, stride=stride)
    y = torch.matmul(weight.reshape(o, kh * kw).to(acc), cols.to(acc))
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    return y.reshape(n, o, ho, wo).to(x.dtype)


class Conv2d(nn.Conv2d):
    """PyTorch-parity conv: cross-correlation, symmetric padding, bias
    (unless ``bias=False``); ``groups`` splits the channels as
    ``feature_group_count`` does.  Under ``im2col_stem_enabled()`` a
    one-input-channel conv with a kernel over 1 runs as
    :func:`patches_gemm`."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True):
        super().__init__(n_in, n_out, kernel_size, stride, padding,
                         groups=groups, bias=bias)

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)
        fan_in = (self.in_channels // self.groups * self.kernel_size[0]
                  * self.kernel_size[1])
        if self.bias is not None:
            _uniform_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.groups == 1 and self.in_channels == 1
                and self.kernel_size[0] > 1 and im2col_stem_enabled()):
            return _add_bias(patches_gemm(x, self.weight, self.stride[0],
                                          self.padding[0]), self.bias)
        if x.dtype == torch.bfloat16:
            return _add_bias(self._conv_forward(x, self.weight, None),
                             self.bias)
        return super().forward(x)


class ConvTranspose2d(nn.ConvTranspose2d):
    """PyTorch ConvTranspose2d, ``output_padding`` included; weight
    (I, O, kh, kw), the JAX package's ``wt`` (kh, kw, I, O) permuted.
    Bias bound 1/sqrt(O * kh * kw), PyTorch's fan_in for this weight."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 bias: bool = True):
        super().__init__(n_in, n_out, kernel_size, stride, padding,
                         output_padding, bias=bias)

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)
        fan_in = self.out_channels * self.kernel_size[0] * self.kernel_size[1]
        if self.bias is not None:
            _uniform_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return _add_bias(F.conv_transpose2d(
                x, self.weight, None, self.stride, self.padding,
                self.output_padding, self.groups, self.dilation), self.bias)
        return super().forward(x)


class Linear(nn.Linear):
    """PyTorch Linear; weight (out, in), the JAX package's (in, out)^T."""

    def reset_parameters(self, generator=None) -> None:
        _uniform_(self.weight, self.in_features, generator)
        _uniform_(self.bias, self.in_features, generator)


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)``.  ``F.leaky_relu`` selects on
    ``x > 0`` instead; the two differ only at x = -0.0, where both give
    -0.0, so they agree bit for bit.  In bfloat16 the slope is rounded to
    bfloat16 first, as the JAX package's weakly typed slope is."""
    if x.dtype == torch.bfloat16:
        return torch.where(x >= 0, x,
                           x * torch.tensor(slope, dtype=torch.bfloat16))
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
        if (isinstance(m, (Conv2d, ConvTranspose2d, Linear))
                or getattr(m, "resets_own_parameters", False)):
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


def draw_normal(shape, generator, dtype, device) -> torch.Tensor:
    """N(0, 1) draws of ``shape`` from ``generator``: a ``torch.Generator``,
    or a rank's draw source (``parallel.mesh.RowDraws``), which draws at
    the global shape and returns the rank's rows."""
    if isinstance(generator, torch.Generator):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
    return generator.normal(shape, dtype, device)


def draw_uniform(shape, generator, device) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` from ``generator``, as ``draw_normal``."""
    if isinstance(generator, torch.Generator):
        return torch.rand(shape, generator=generator, device=device)
    return generator.uniform(shape, device)


class GaussianNoise(nn.Module):
    """Additive N(0, 1) noise, active only in training.  ``noise`` is an
    injected draw of x's shape, taken in x's dtype (the JAX package draws
    in x's dtype); else it is drawn from ``generator``."""

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training:
            return x
        if noise is None:
            if generator is None:
                raise ValueError("GaussianNoise needs noise or a generator "
                                 "in training")
            noise = draw_normal(x.shape, generator, x.dtype, x.device)
        return x + noise.to(x.dtype)


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
        mask = draw_uniform(x.shape, generator, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class ResidualBody(nn.Sequential):
    """A residual block's body; the children are the JAX body's slots, so
    state_dict keys follow its pytree.  A trailing ``Dropout`` takes the
    generator, and is skipped with ``dropout=False`` (the JAX package's
    ``train=False``)."""

    def body(self, x: torch.Tensor, generator=None, stop=None,
             dropout: bool = True):
        for m in list(self)[:stop]:
            if isinstance(m, Dropout):
                x = m(x, generator=generator) if dropout else x
            else:
                x = m(x)
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

    def forward(self, x: torch.Tensor, generator=None,
                dropout: bool = True) -> torch.Tensor:
        if len(self) == 5 and norm_act.in_res_fused_enabled():
            return norm_act.fused_instance_norm_residual(
                self.body(x, stop=4), x)
        return x + self.body(x, generator, dropout=dropout)


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

    def forward(self, x: torch.Tensor, generator=None,
                dropout: bool = True) -> torch.Tensor:
        return x + self.body(x, generator, dropout=dropout)
