"""Fused InstanceNorm (+ LeakyReLU, + residual add): CUDA kernels, their
plain versions and the autograd Functions around them.

Counterpart of ``lsps_tpu/ops/pallas/norm_act.py``.  Tensors are NCHW;
each (b, c) plane of H*W values is normalised on its own: mean, biased
variance from the mean (two passes), ``rstd = rsqrt(var + 1e-5)``,
``xhat = (x - mean) * rstd``.  Four kernels in ``csrc/norm_act.cu``:

* ``in_act_forward``   -> y = act(xhat), xhat, rstd  (``_pallas_fwd``)
* ``in_act_backward``  -> dx from (g, xhat, rstd)    (``_pallas_bwd``)
* ``in_res_forward``   -> y = xhat + res, mean, rstd (``_pallas_in_res_fwd``)
* ``in_res_backward``  -> dx from (g, x, mean, rstd) (``_pallas_in_res_bwd``)

``act`` is ``where(xhat >= 0, xhat, 0.01 * xhat)``, or the identity for
``slope=None``.  Moments are taken in ``promote(dtype, float32)``: bfloat16
gets float32 moments, float64 stays float64 (the plain versions only; the
kernels take float32 and bfloat16).  y is in x's dtype (res's for the
residual op), xhat/mean/rstd in the moment dtype, dx in g's dtype.

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors (``<wrapper>.launches`` counts the launches); any
other device raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

EPS = 1e-5
SLOPE = 0.01

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_IN_RES_FUSED = None  # None = LSPS_FUSED_IN_RES decides (default off)


def set_in_res_fused(value):
    """True/False force; None = the ``LSPS_FUSED_IN_RES`` default (off).
    Returns the previous setting, so that a caller can restore it."""
    global _IN_RES_FUSED
    prev, _IN_RES_FUSED = _IN_RES_FUSED, value
    return prev


def in_res_fused_enabled() -> bool:
    """Whether ``LeakyINSResBlock`` routes its tail through
    ``fused_instance_norm_residual`` (``set_in_res_fused`` or
    ``LSPS_FUSED_IN_RES=1``, read as the JAX package reads it)."""
    if _IN_RES_FUSED is not None:
        return bool(_IN_RES_FUSED)
    return os.environ.get("LSPS_FUSED_IN_RES", "0") == "1"


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _moment_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _act(xhat, slope):
    if slope is None:
        return xhat
    return torch.where(xhat >= 0, xhat, slope * xhat)


def _act_grad(g, xhat, slope):
    if slope is None:
        return g
    return torch.where(xhat >= 0, g, slope * g)


def _moments(xf):
    mean = xf.mean((2, 3), keepdim=True)
    var = (xf - mean).square().mean((2, 3), keepdim=True)
    return mean, torch.rsqrt(var + EPS)


def in_act_forward_reference(x: torch.Tensor, slope: Optional[float]):
    """``_jnp_fwd``: x (B, C, H, W) -> (y, xhat, rstd (B, C, 1, 1))."""
    xf = x.to(_moment_dtype(x.dtype))
    mean, rstd = _moments(xf)
    xhat = (xf - mean) * rstd
    return _act(xhat, slope).to(x.dtype), xhat, rstd


def in_act_backward_reference(g, xhat, rstd, slope: Optional[float]):
    """The jnp branch of ``_bwd_impl``: dx in g's dtype."""
    gp = _act_grad(g.to(_moment_dtype(g.dtype)), xhat, slope)
    m1 = gp.mean((2, 3), keepdim=True)
    m2 = (gp * xhat).mean((2, 3), keepdim=True)
    return (rstd * (gp - m1 - xhat * m2)).to(g.dtype)


def in_res_forward_reference(x: torch.Tensor, res: torch.Tensor):
    """The jnp branch of ``_in_res_fwd_impl``: (y, mean, rstd), y in
    res's dtype."""
    ft = _moment_dtype(x.dtype)
    xf = x.to(ft)
    mean, rstd = _moments(xf)
    y = ((xf - mean) * rstd + res.to(ft)).to(res.dtype)
    return y, mean, rstd


def in_res_backward_reference(g, x, mean, rstd):
    """The jnp branch of ``_in_res_vjp_bwd``: dx in g's dtype (dres is g
    itself)."""
    ft = _moment_dtype(g.dtype)
    gf = g.to(ft)
    xhat = (x.to(ft) - mean) * rstd
    m1 = gf.mean((2, 3), keepdim=True)
    m2 = (gf * xhat).mean((2, 3), keepdim=True)
    return (rstd * (gf - m1 - xhat * m2)).to(g.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, y, xhat, rstd, dtype, planes, hw, slope, has_slope, stream
    "lsps_in_act_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # g, xhat, rstd, dx, dtype, planes, hw, slope, has_slope, stream
    "lsps_in_act_bwd": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # x, res, y, mean, rstd, dtype, planes, hw, stream
    "lsps_in_res_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # g, x, mean, rstd, dx, dtype, planes, hw, stream
    "lsps_in_res_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}
_MAX_PLANES = 2 ** 31 - 1


def _kernel(name: str):
    from lsps_tpu_torch.ops.kernels.build import load_library

    fn = getattr(load_library("norm_act"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _route(x: torch.Tensor, op: str) -> bool:
    """True: launch the kernel; False: run the plain version."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {op} for device {x.device}")
    return True


def _check(op: str, *tensors: torch.Tensor, dtype: torch.dtype) -> None:
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{op} kernel takes float32 or bfloat16, not "
                        f"{dtype}")
    first = tensors[0]
    if first.dim() != 4:
        raise ValueError(f"{op} takes (B, C, H, W), not "
                         f"{tuple(first.shape)}")
    for t in tensors:
        if t.shape != first.shape:
            raise ValueError(f"{op}: shape {tuple(t.shape)} != "
                             f"{tuple(first.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {t.dtype} where {dtype} is needed")
        if t.device != first.device:
            raise ValueError(f"{op}: tensors on {t.device} and "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: tensors must be contiguous")
    if first.shape[0] * first.shape[1] > _MAX_PLANES:
        raise ValueError(f"{op}: more than {_MAX_PLANES} planes")


def _check_stats(op: str, x: torch.Tensor, *stats: torch.Tensor) -> None:
    want = (x.shape[0], x.shape[1], 1, 1)
    for s in stats:
        if (tuple(s.shape) != want or s.dtype != torch.float32
                or s.device != x.device or not s.is_contiguous()):
            raise ValueError(f"{op}: moments must be contiguous float32 "
                             f"{want} on {x.device}")


def _launch(name: str, x: torch.Tensor, *args) -> None:
    fn = _kernel(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _plane_dims(x):
    b, c, h, w = x.shape
    return b * c, h * w


def in_act_forward(x: torch.Tensor, slope: Optional[float]):
    """Fused IN + LeakyReLU forward; arguments and results as for
    ``in_act_forward_reference``."""
    if not _route(x, "in_act_forward"):
        return in_act_forward_reference(x, slope)
    _check("in_act_forward", x, dtype=x.dtype)
    planes, hw = _plane_dims(x)
    y = torch.empty_like(x)
    xhat = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rstd = torch.empty((x.shape[0], x.shape[1], 1, 1), dtype=torch.float32,
                       device=x.device)
    if x.numel():
        _launch("lsps_in_act_fwd", x, x.data_ptr(), y.data_ptr(),
                xhat.data_ptr(), rstd.data_ptr(), KERNEL_DTYPES[x.dtype],
                planes, hw, 0.0 if slope is None else slope,
                int(slope is not None))
        in_act_forward.launches += 1
    return y, xhat, rstd


def in_act_backward(g, xhat, rstd, slope: Optional[float]):
    """Backward of ``in_act_forward``: dx in g's dtype."""
    if not _route(g, "in_act_backward"):
        return in_act_backward_reference(g, xhat, rstd, slope)
    _check("in_act_backward", g, dtype=g.dtype)
    _check("in_act_backward", xhat, dtype=torch.float32)
    _check_stats("in_act_backward", g, rstd)
    if xhat.shape != g.shape or xhat.device != g.device:
        raise ValueError("in_act_backward: xhat and g differ in shape or "
                         "device")
    planes, hw = _plane_dims(g)
    dx = torch.empty_like(g)
    if g.numel():
        _launch("lsps_in_act_bwd", g, g.data_ptr(), xhat.data_ptr(),
                rstd.data_ptr(), dx.data_ptr(), KERNEL_DTYPES[g.dtype],
                planes, hw, 0.0 if slope is None else slope,
                int(slope is not None))
        in_act_backward.launches += 1
    return dx


def in_res_forward(x: torch.Tensor, res: torch.Tensor):
    """Fused IN + residual add forward: (y, mean, rstd)."""
    if not _route(x, "in_res_forward"):
        return in_res_forward_reference(x, res)
    _check("in_res_forward", x, res, dtype=x.dtype)
    planes, hw = _plane_dims(x)
    y = torch.empty_like(res)
    mean = torch.empty((x.shape[0], x.shape[1], 1, 1), dtype=torch.float32,
                       device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel():
        _launch("lsps_in_res_fwd", x, x.data_ptr(), res.data_ptr(),
                y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                KERNEL_DTYPES[x.dtype], planes, hw)
        in_res_forward.launches += 1
    return y, mean, rstd


def in_res_backward(g, x, mean, rstd):
    """Backward of ``in_res_forward`` for x: dx in g's dtype."""
    if not _route(g, "in_res_backward"):
        return in_res_backward_reference(g, x, mean, rstd)
    _check("in_res_backward", g, x, dtype=g.dtype)
    _check_stats("in_res_backward", g, mean, rstd)
    planes, hw = _plane_dims(g)
    dx = torch.empty_like(g)
    if g.numel():
        _launch("lsps_in_res_bwd", g, g.data_ptr(), x.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                KERNEL_DTYPES[g.dtype], planes, hw)
        in_res_backward.launches += 1
    return dx


for _fn in (in_act_forward, in_act_backward, in_res_forward,
            in_res_backward):
    _fn.launches = 0

KERNELS = {"in_act_forward": in_act_forward,
           "in_act_backward": in_act_backward,
           "in_res_forward": in_res_forward,
           "in_res_backward": in_res_backward}


# ---------------------------------------------------------------------------
# autograd Functions and the public ops (NCHW)
# ---------------------------------------------------------------------------

class FusedInstanceNormAct(torch.autograd.Function):
    """act(InstanceNorm(x)); saves (xhat, rstd) for the backward, as the
    custom VJP of ``fused_instance_norm_leaky_relu`` does."""

    @staticmethod
    def forward(ctx, x, slope):
        y, xhat, rstd = in_act_forward(x.contiguous(), slope)
        ctx.save_for_backward(xhat, rstd)
        ctx.slope = slope
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xhat, rstd = ctx.saved_tensors
        return in_act_backward(g.contiguous(), xhat, rstd, ctx.slope), None


class FusedInstanceNormResidual(torch.autograd.Function):
    """InstanceNorm(x) + res; saves (x, mean, rstd) and recomputes xhat
    in the backward; the gradient of res is g itself."""

    @staticmethod
    def forward(ctx, x, res):
        x = x.contiguous()
        y, mean, rstd = in_res_forward(x, res.contiguous())
        ctx.save_for_backward(x, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        return in_res_backward(g.contiguous(), x, mean, rstd), g


def fused_instance_norm_leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU_0.01(InstanceNorm(x)) on NCHW."""
    return FusedInstanceNormAct.apply(x, SLOPE)


def fused_instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm(x) (no activation) on NCHW."""
    return FusedInstanceNormAct.apply(x, None)


def fused_instance_norm_residual(x: torch.Tensor,
                                 res: torch.Tensor) -> torch.Tensor:
    """InstanceNorm(x) + res on NCHW: the tail of ``LeakyINSResBlock``."""
    return FusedInstanceNormResidual.apply(x, res)
