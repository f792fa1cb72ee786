"""On-device hand detection: raw depth frames -> CoMs, in plain PyTorch.

Counterpart of ``lsps_tpu/serve/detect_jax.py`` (which JAX also computes
outside Pallas), batched over frames instead of vmapped:

* a closest-object depth sweep over ``steps`` slices, as a per-pixel int8
  slice-index plane (-1 = invalid depth);
* a pixel is *interior* when its 3x3 window lies in one slice: the
  windowed max and min (``max_pool2d`` of the plane and of its negation,
  padding with -inf as ``reduce_window`` "SAME" does) are equal;
* the first slice from index 5 on with at least ``interior_min`` interior
  pixels is the hand; its mask centroid, rounded half to even, centres a
  +-100 px box whose z-window CoM starts
* ``refine_iters`` rounds of CoM refinement inside the metric cube.

Frames where no slice qualifies get a zero CoM.  As in the JAX package,
division by the constant ``steps`` is a multiplication by its float32
reciprocal and ``a * b + c`` one fused multiply-add (see
``ops/kernels/warp.py``).  The masked sums are float32 reductions, whose
order differs from XLA's, so CoMs agree with the JAX package to a
tolerance, not bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lsps_tpu_torch.ops.kernels.warp import _recip, com_to_bounds, fma

FIRST_SLICE = 5  # the nearest slices are skipped


def _masked_com(vals, weight, xs, ys):
    """Unweighted mean of masked pixel coords + mean masked depth, per
    frame: ((B, 3) CoM, (B,) pixel count)."""
    wts = weight.to(torch.float32)
    n = wts.sum((1, 2))
    safe = torch.clamp(n, min=1.0)
    com = torch.stack([(xs * wts).sum((1, 2)) / safe,
                       (ys * wts).sum((1, 2)) / safe,
                       (vals * wts).sum((1, 2)) / safe], 1)
    return com, n


def _slice_counts(bins: torch.Tensor, size: int) -> torch.Tensor:
    """Histogram of int64 ``bins`` over ``size`` bins, as a scatter-add
    into a fixed-size tensor: integer counts, exact in any order.  Not
    ``torch.bincount(bins, minlength=size)``: its length depends on the
    data, so ``torch.export`` guards it against the example's batch, and
    a symbolic-batch program then refuses any smaller batch."""
    ones = torch.ones(1, dtype=torch.int64, device=bins.device)
    return torch.zeros(size, dtype=torch.int64, device=bins.device
                       ).scatter_add_(0, bins, ones.expand(bins.shape[0]))


def device_detect_batch(frames: torch.Tensor, cubes: torch.Tensor,
                        fx: float, fy: float, steps: int = 65,
                        interior_min: int = 150,
                        refine_iters: int = 5) -> torch.Tensor:
    """(B, H, W) raw depth frames in mm + (B, 3) cubes -> (B, 3) CoMs
    (u, v, z[mm]), zeros where no slice qualifies."""
    if steps > 127:
        raise ValueError("slice index must fit in int8")
    dpt = frames.to(torch.float32)
    cubes = cubes.to(torch.float32)
    b, h, w = dpt.shape
    dev = dpt.device
    max_depth = torch.clamp(dpt.amax((1, 2)), max=6500.0)[:, None, None]
    min_depth = torch.clamp(dpt.amin((1, 2)), min=10.0)[:, None, None]
    d = torch.where((dpt > max_depth) | (dpt < min_depth), 0.0, dpt)
    dz = (max_depth - min_depth) * _recip(float(steps))

    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]

    # NaN (a flat frame: 0 / 0) -> slice 0, as XLA converts NaN to int
    s = torch.nan_to_num(torch.floor((d - min_depth) / dz), nan=0.0)
    s = torch.where(d > 0.0, s.clamp(0, steps - 1), -1.0).to(torch.int8)

    sf = s.to(torch.float32)[:, None]
    smax = F.max_pool2d(sf, 3, 1, 1)[:, 0]
    smin = -F.max_pool2d(-sf, 3, 1, 1)[:, 0]
    inb = (xs >= 1) & (xs < w - 1) & (ys >= 1) & (ys < h - 1)
    interior = (smin == smax) & (s >= 0) & inb

    # interior pixels per slice, all frames in one histogram: frame i's
    # slice k lands in bin i * (steps + 1) + k + 1, other pixels in bin
    # i * (steps + 1)
    bins = (torch.where(interior, s.to(torch.int64) + 1, 0)
            + torch.arange(b, device=dev)[:, None, None] * (steps + 1))
    counts = _slice_counts(bins.reshape(-1), b * (steps + 1))
    counts = counts.reshape(b, steps + 1)[:, 1 + FIRST_SLICE:]
    oks = counts >= interior_min
    any_ok = oks.any(1)
    first = oks.to(torch.uint8).argmax(1) + FIRST_SLICE  # first qualifying
    kf = first.to(torch.float32)[:, None, None]
    lo = fma(kf, dz, min_depth)
    hi = fma(kf + 1.0, dz, min_depth)

    # blob centroid of the selected slice's full mask
    mf = (s == first.to(torch.int8)[:, None, None]).to(torch.float32)
    n = torch.clamp(mf.sum((1, 2)), min=1.0)
    cx = torch.round((xs * mf).sum((1, 2)) / n)[:, None, None]
    cy = torch.round((ys * mf).sum((1, 2)) / n)[:, None, None]

    # +-100 px box around the centroid, z-limited to the slice
    xstart = torch.clamp(cx - 100.0, min=0.0)
    xend = torch.clamp(cx + 100.0, max=float(w - 1))
    ystart = torch.clamp(cy - 100.0, min=0.0)
    yend = torch.clamp(cy + 100.0, max=float(h - 1))
    inbox = (xs >= xstart) & (xs < xend) & (ys >= ystart) & (ys < yend)
    m0 = inbox & (d >= lo) & (d <= hi) & (d > 0)
    com, _ = _masked_com(d, m0, xs, ys)

    # iterative refinement with the full metric cube: bounds from the
    # current CoM, near clamp / far cut, then the masked CoM again
    for _ in range(refine_iters):
        xst, xen, yst, yen, zs, ze = (
            t[:, None, None] for t in com_to_bounds(com, cubes, fx, fy))
        box = (xs >= xst) & (xs < xen) & (ys >= yst) & (ys < yen)
        v = torch.where(box, d, 0.0)
        v = torch.where((v < zs) & (v != 0.0), zs, v)
        v = torch.where(v > ze, 0.0, v)
        valid = box & (v >= min_depth) & (v <= max_depth) & (v != 0.0)
        new_com, cnt = _masked_com(v, valid, xs, ys)
        com = torch.where((cnt > 0)[:, None], new_com, com)
    return torch.where(any_ok[:, None], com, torch.zeros_like(com))


def device_detect(dpt: torch.Tensor, cube: torch.Tensor, fx: float,
                  fy: float, **kw) -> torch.Tensor:
    """(H, W) frame + (3,) cube -> (3,) CoM."""
    return device_detect_batch(dpt[None], cube[None], fx, fy, **kw)[0]
