"""On-device preprocessing: depth frame -> normalized 128x128 crop.

Counterpart of ``lsps_tpu/serve/preprocess_jax.py`` and of the per-sample
builder in ``lsps_tpu/ops/pallas/warp.py:crop_normalize_batch_pallas``.
The crop affine is axis-aligned, so each output row has one source row
``iy`` and each output column one source column ``ix`` (-1 where the pixel
lies outside the destination box or the source frame).  The scalar math
that finds them runs here in PyTorch ops on (B,) tensors, in float32; the
gather and tail run in the ``warp_normalize`` kernel.

Crops must be bit-equal to the JAX package's, and one index off by one
breaks that.  The JAX package's arithmetic is what XLA compiles it to,
and XLA's CPU backend rewrites two patterns of that source:

* ``x / c`` for a compile-time constant ``c`` (``fx``, ``fy``) becomes
  ``x * (1 / c)``, the reciprocal rounded to float32;
* ``a * b + c`` is contracted into one fused multiply-add, rounded once.

(Found by holding each op of ``com_to_bounds`` against JAX on the CPU
over random CoMs: plain division and separately rounded products differ
in the last bits of many intermediates, and for a few CoMs in 1e5 move a
crop bound by one pixel.)  This module spells both rewrites out:
``_recip`` and ``fma``.  ``fma`` rounds once through float64, where the
float32 product is exact, and so is the sum at the magnitudes of these
bounds.  Divisions by a traced value (``/ com_z``, ``/ scale``, ``/ wb``)
stay true divisions in XLA and here.  Every op is an IEEE float32 or
float64 op, so the indices are the same on the CPU and on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lsps_tpu_torch.ops.kernels.warp import warp_normalize


def _f32(x: float) -> float:
    """The float32 rounding of a Python number, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.
    ``b`` and ``c`` are float32 tensors or Python numbers (taken at their
    float32 rounding, as XLA takes a weakly typed constant)."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else _f32(x)

    return (a.double() * f64(b) + f64(c)).float()


def _recip(c: float) -> float:
    """``1 / c`` in float32, as XLA folds a constant divisor."""
    return _f32(1.0 / _f32(c))


def com_to_bounds(com: torch.Tensor, size: torch.Tensor, fx: float,
                  fy: float):
    """3D cube -> 2D box: (xstart, xend, ystart, yend, zstart, zend),
    each of shape ``com.shape[:-1]``."""
    u, v, z = com[..., 0], com[..., 1], com[..., 2]
    rfx, rfy = _recip(fx), _recip(fy)
    half_x, half_y, half_z = size[..., 0] / 2.0, size[..., 1] / 2.0, \
        size[..., 2] / 2.0
    zstart = z - half_z
    zend = z + half_z

    def edge(c, r, f, half):
        return torch.floor(fma(fma(c * z, r, half) / z, f, 0.5))

    xstart = edge(u, rfx, fx, -half_x)
    xend = edge(u, rfx, fx, half_x)
    ystart = edge(v, rfy, fy, -half_y)
    yend = edge(v, rfy, fy, half_y)
    return xstart, xend, ystart, yend, zstart, zend


def crop_transform(com: torch.Tensor, size: torch.Tensor, fx: float,
                   fy: float, dsize: Tuple[int, int] = (128, 128)):
    """Crop affine M (..., 3, 3) mapping original (u, v) to crop (u, v),
    and (xstart, ystart, wb, hb, scale, xoff, yoff)."""
    xstart, xend, ystart, yend, _, _ = com_to_bounds(com, size, fx, fy)
    wb = xend - xstart
    hb = yend - ystart
    dsw = torch.full_like(wb, float(dsize[0]))
    dsh = torch.full_like(hb, float(dsize[1]))
    wide = wb > hb
    scale = torch.where(wide, dsw / wb, dsh / hb)
    sz_w = torch.floor(torch.where(wide, dsw, wb * scale))
    sz_h = torch.floor(torch.where(wide, hb * scale, dsh))
    xoff = torch.floor(dsize[0] / 2.0 - sz_w / 2.0)
    yoff = torch.floor(dsize[1] / 2.0 - sz_h / 2.0)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    M = torch.stack([
        torch.stack([scale, zero, fma(-xstart, scale, xoff)], -1),
        torch.stack([zero, scale, fma(-ystart, scale, yoff)], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return M, (xstart, ystart, wb, hb, scale, xoff, yoff)


def crop_indices(coms: torch.Tensor, cubes: torch.Tensor, fx: float,
                 fy: float, frame_hw: Tuple[int, int],
                 dsize: Tuple[int, int] = (128, 128)):
    """Per-sample warp inputs for (B, 3) CoMs and cubes.

    Returns (Ms (B, 3, 3), iy (B, dh) int32, ix (B, dw) int32,
    params (B, 4) float32 = [zstart, zend, com_z, half]).
    """
    h, w = frame_hw
    dw, dh = dsize
    M, (xstart, ystart, wb, hb, scale, xoff, yoff) = crop_transform(
        coms, cubes, fx, fy, dsize)
    col = torch.arange(dw, dtype=torch.float32, device=coms.device)[None]
    row = torch.arange(dh, dtype=torch.float32, device=coms.device)[None]

    def axis_index(pos, off, start, extent, n_src):
        off, start, extent = off[:, None], start[:, None], extent[:, None]
        src = torch.floor((pos - off) / scale[:, None] + start)
        ok = ((pos >= off) & (pos < off + torch.ceil(extent * scale[:, None]))
              & (src >= 0) & (src < n_src))
        return torch.where(ok, src, -1.0).to(torch.int32)

    ix = axis_index(col, xoff, xstart, wb, w)
    iy = axis_index(row, yoff, ystart, hb, h)
    half = cubes[:, 2] / 2.0
    params = torch.stack([coms[:, 2] - half, coms[:, 2] + half, coms[:, 2],
                          half], 1)
    return M, iy.contiguous(), ix.contiguous(), params.contiguous()


def crop_normalize_batch(frames: torch.Tensor, coms: torch.Tensor,
                         cubes: torch.Tensor, fx: float, fy: float,
                         dsize: Tuple[int, int] = (128, 128)):
    """(B, H, W) float32 or uint16 frames + (B, 3) CoMs + (B, 3) cubes ->
    (crops (B, dh, dw) in [-1, 1], Ms (B, 3, 3)).  The warp runs in the
    CUDA kernel for CUDA tensors."""
    coms = coms.to(torch.float32)
    cubes = cubes.to(torch.float32)
    Ms, iy, ix, params = crop_indices(coms, cubes, fx, fy,
                                      tuple(frames.shape[1:]), dsize)
    return warp_normalize(frames.contiguous(), iy, ix, params), Ms
