"""Depth frames -> metric 3D joints in plain PyTorch.

The serving chain of masabdi/LSPS: the hand's centre of mass (CoM), the
crop of a metric cube around it, normalized to [-1, 1], the SharedDis
regressor of the real domain, the pose-VAE decoder and the
denormalization to millimetres.

The CoM detection and the crop index math are frozen copies of the
system's plain versions (the closest-object depth sweep of the JAX
package's ``detect_jax.py``; the crop bounds with XLA's ``x / c -> x *
(1 / c)`` and fused multiply-adds spelled out), because the crop bounds
are integers that a rounding in another place moves by a pixel.  The
nets run in the dtype of the parameters handed in.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from reference import nets as N

FIRST_SLICE = 5


def f32(x: float) -> float:
    return ctypes.c_float(x).value


def recip(c: float) -> float:
    return f32(1.0 / f32(c))


def fma(a, b, c):
    """float32 ``a * b + c`` rounded once."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else f32(x)

    return (a.double() * f64(b) + f64(c)).float()


class Camera:
    def __init__(self, fx, fy, ux, uy, flip_y):
        self.fx, self.fy, self.ux, self.uy, self.flip_y = fx, fy, ux, uy, \
            flip_y

    def img_to_3d(self, uvd):
        u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
        x = (u - self.ux) * d / self.fx
        y = ((self.uy - v) if self.flip_y else (v - self.uy)) * d / self.fy
        return torch.stack([x, y, d], -1)


def com_to_bounds(com, size, fx, fy):
    u, v, z = com[..., 0], com[..., 1], com[..., 2]
    rfx, rfy = recip(fx), recip(fy)
    hx, hy, hz = size[..., 0] / 2.0, size[..., 1] / 2.0, size[..., 2] / 2.0

    def edge(c, r, f, half):
        return torch.floor(fma(fma(c * z, r, half) / z, f, 0.5))

    return (edge(u, rfx, fx, -hx), edge(u, rfx, fx, hx),
            edge(v, rfy, fy, -hy), edge(v, rfy, fy, hy), z - hz, z + hz)


def crop_grid(coms, cubes, fx, fy, frame_hw, dsize=(128, 128)):
    """The source rows and columns of each crop, (B, dh) and (B, dw) long
    tensors, -1 outside the frame or the scaled box."""
    h, w = frame_hw
    dw, dh = dsize
    xstart, xend, ystart, yend, _, _ = com_to_bounds(coms, cubes, fx, fy)
    wb, hb = xend - xstart, yend - ystart
    dsw, dsh = torch.full_like(wb, float(dw)), torch.full_like(hb, float(dh))
    wide = wb > hb
    scale = torch.where(wide, dsw / wb, dsh / hb)
    sz_w = torch.floor(torch.where(wide, dsw, wb * scale))
    sz_h = torch.floor(torch.where(wide, hb * scale, dsh))
    xoff = torch.floor(dw / 2.0 - sz_w / 2.0)
    yoff = torch.floor(dh / 2.0 - sz_h / 2.0)

    def axis(n, off, start, extent, n_src):
        pos = torch.arange(n, dtype=torch.float32, device=coms.device)[None]
        off, start, extent = off[:, None], start[:, None], extent[:, None]
        src = torch.floor((pos - off) / scale[:, None] + start)
        ok = ((pos >= off) & (pos < off + torch.ceil(extent * scale[:, None]))
              & (src >= 0) & (src < n_src))
        return torch.where(ok, src, -1.0).long()

    return axis(dh, yoff, ystart, hb, h), axis(dw, xoff, xstart, wb, w)


def crop(frames, coms, cubes, fx, fy, dsize=(128, 128)):
    """(B, H, W) frames (mm) -> (B, dh, dw) crops in [-1, 1]."""
    frames = frames.to(torch.float32)
    b = frames.shape[0]
    iy, ix = crop_grid(coms, cubes, fx, fy, frames.shape[1:], dsize)
    bi = torch.arange(b, device=frames.device)[:, None, None]
    vals = frames[bi, iy.clamp(min=0)[:, :, None], ix.clamp(min=0)[:, None, :]]
    vals = torch.where(torch.isfinite(vals), vals, 0.0)
    vals = torch.where((iy >= 0)[:, :, None] & (ix >= 0)[:, None, :], vals,
                       0.0)
    half = (cubes[:, 2] / 2.0)[:, None, None]
    com_z = coms[:, 2][:, None, None]
    zstart, zend = com_z - half, com_z + half
    vals = torch.where((vals < zstart) & (vals != 0), zstart, vals)
    vals = torch.where((vals > zend) & (vals != 0), 0.0, vals)
    vals = torch.where(vals == 0, zend, vals)
    return (vals - com_z) / half


def crop_indices(coms, cubes, fx, fy, frame_hw, dsize=(128, 128)):
    """``crop_grid`` as numpy: what the bytes of a crop are counted
    from."""
    return tuple(a.cpu().numpy()
                 for a in crop_grid(coms, cubes, fx, fy, frame_hw, dsize))


def _masked_com(vals, weight, xs, ys):
    wts = weight.to(torch.float32)
    n = wts.sum((1, 2))
    safe = torch.clamp(n, min=1.0)
    com = torch.stack([(xs * wts).sum((1, 2)) / safe,
                       (ys * wts).sum((1, 2)) / safe,
                       (vals * wts).sum((1, 2)) / safe], 1)
    return com, n


def detect(frames, cubes, fx, fy, steps=65, interior_min=150,
           refine_iters=5):
    """(B, H, W) depth frames (mm) -> (B, 3) CoMs (u, v, z), zeros where
    no depth slice holds ``interior_min`` interior pixels."""
    dpt = frames.to(torch.float32)
    cubes = cubes.to(torch.float32)
    b, h, w = dpt.shape
    dev = dpt.device
    max_depth = torch.clamp(dpt.amax((1, 2)), max=6500.0)[:, None, None]
    min_depth = torch.clamp(dpt.amin((1, 2)), min=10.0)[:, None, None]
    d = torch.where((dpt > max_depth) | (dpt < min_depth), 0.0, dpt)
    dz = (max_depth - min_depth) * recip(float(steps))
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]

    s = torch.nan_to_num(torch.floor((d - min_depth) / dz), nan=0.0)
    s = torch.where(d > 0.0, s.clamp(0, steps - 1), -1.0)
    smax = F.max_pool2d(s[:, None], 3, 1, 1)[:, 0]
    smin = -F.max_pool2d(-s[:, None], 3, 1, 1)[:, 0]
    inb = (xs >= 1) & (xs < w - 1) & (ys >= 1) & (ys < h - 1)
    interior = (smin == smax) & (s >= 0) & inb
    # interior pixels per slice of each frame, as one histogram
    bins = (torch.where(interior, s.long() + 1, 0)
            + torch.arange(b, device=dev)[:, None, None] * (steps + 1))
    counts = torch.bincount(bins.reshape(-1), minlength=b * (steps + 1))
    oks = counts.reshape(b, steps + 1)[:, 1 + FIRST_SLICE:] >= interior_min
    any_ok = oks.any(1)
    first = oks.to(torch.uint8).argmax(1) + FIRST_SLICE
    kf = first.to(torch.float32)[:, None, None]
    lo = fma(kf, dz, min_depth)
    hi = fma(kf + 1.0, dz, min_depth)

    mf = (s == kf).to(torch.float32)
    n = torch.clamp(mf.sum((1, 2)), min=1.0)
    cx = torch.round((xs * mf).sum((1, 2)) / n)[:, None, None]
    cy = torch.round((ys * mf).sum((1, 2)) / n)[:, None, None]
    inbox = ((xs >= torch.clamp(cx - 100.0, min=0.0))
             & (xs < torch.clamp(cx + 100.0, max=float(w - 1)))
             & (ys >= torch.clamp(cy - 100.0, min=0.0))
             & (ys < torch.clamp(cy + 100.0, max=float(h - 1))))
    com, _ = _masked_com(d, inbox & (d >= lo) & (d <= hi) & (d > 0), xs, ys)
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


def joints(params, hyp, cam: Camera, frames, coms, cubes):
    """Frames with their CoMs and cubes -> (B, J, 3) joints in mm; the
    nets in the dtype of ``params``, the rest in float32."""
    dtype = next(iter(params.values())).dtype
    crops = crop(frames, coms, cubes, cam.fx, cam.fy)
    post = N.regress(params, hyp["dis"], "B", crops[:, None].to(dtype))
    pose = N.vae_decode(params, post).to(torch.float32)
    j = pose.reshape(pose.shape[0], -1, 3)
    return j * (cubes[:, 2:3, None] / 2.0) + cam.img_to_3d(coms)[:, None, :]


def call_flops(hyp, batch: int, hw: int = 128) -> int:
    """Matmul and conv FLOPs of the nets for ``batch`` crops (regress and
    decode), counted by ``FlopCounterMode`` on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    params = {s.key: torch.empty(s.shape, device="meta")
              for s in N.param_specs(hyp, ("dis", "vae"))}
    with FlopCounterMode(display=False) as fc:
        N.vae_decode(params, N.regress(
            params, hyp["dis"], "B", torch.empty((batch, 1, hw, hw),
                                                 device="meta")))
    return int(fc.get_total_flops())
