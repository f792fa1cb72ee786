"""Seeded depth scenes of a hand, rendered on the device in batches.

A hand is a palm disc and five finger discs, each of one whole-millimetre
depth on an empty (0) background: what the closest-object detector of
the system finds.  Frames are uint16 millimetres, as a depth camera gives
them.  ``raw_crops`` renders the cached 128 x 128 crops of a training set
with the augment parameters of each sample, as the training loader hands
them to the fused-augment step.
"""

from __future__ import annotations

import math

import numpy as np

PALM_MM = 35.0


def render(torch, hw, fx, cx, cy, z, spread, finger_dz):
    """(n, H, W) float32 mm: palm at (cx, cy) of depth z (n,), fingers
    at angles ``spread`` (n, 5) and depths z + finger_dz (n, 5)."""
    h, w = hw
    dev = cx.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    r = (PALM_MM * fx / z)[:, None, None]
    c_x, c_y, zz = cx[:, None, None], cy[:, None, None], z[:, None, None]
    d = torch.where((xx - c_x) ** 2 + (yy - c_y) ** 2 <= r * r, zz, 0.0)
    for k in range(5):
        a = spread[:, k, None, None]
        fxk = c_x + 1.6 * r * torch.cos(a)
        fyk = c_y - 1.6 * r * torch.sin(a)
        fz = zz + finger_dz[:, k, None, None]
        disc = (xx - fxk) ** 2 + (yy - fyk) ** 2 <= (0.35 * r) ** 2
        d = torch.where(disc & ((d == 0) | (d > fz)), fz, d)
    return d


def _fingers(torch, gen, n, dev):
    base = torch.tensor([math.pi * (0.15 + 0.175 * k) for k in range(5)],
                        device=dev)
    spread = base + (torch.rand((n, 5), generator=gen, device=dev) - 0.5) \
        * 0.2
    dz = torch.floor(torch.rand((n, 5), generator=gen, device=dev) * 20.0
                     - 15.0)
    return spread, dz


def still_hands(torch, gen, n, hw, fx, margin):
    """n frames of hands at random places and depths: (frames uint16
    (n, H, W) on the device, CoMs (n, 3) float32: the palm's centre)."""
    h, w = hw
    dev = gen.device
    u = torch.rand((n, 3), generator=gen, device=dev)
    cx = margin[0] + u[:, 0] * (w - 2 * margin[0])
    cy = margin[1] + u[:, 1] * (h - 2 * margin[1])
    z = torch.floor(600.0 + u[:, 2] * 300.0)
    spread, dz = _fingers(torch, gen, n, dev)
    frames = render(torch, hw, fx, cx, cy, z, spread, dz)
    return frames.to(torch.uint16), torch.stack([cx, cy, z], 1)


def moving_hand(torch, gen, n, hw, fx, fps):
    """n frames of one hand on a smooth path (a period of a few seconds
    on each axis), as a camera at ``fps`` sees it: uint16 (n, H, W)."""
    h, w = hw
    dev = gen.device
    t = torch.arange(n, dtype=torch.float32, device=dev) / fps
    per = 3.0 + 3.0 * torch.rand(4, generator=gen, device=dev)
    ph = 2 * math.pi * torch.rand(4, generator=gen, device=dev)

    def wave(i):
        return torch.sin(2 * math.pi * t / per[i] + ph[i])

    cx = w / 2 + 0.25 * w * wave(0)
    cy = h / 2 + 0.2 * h * wave(1)
    z = torch.floor(750.0 + 100.0 * wave(2))
    spread, dz = _fingers(torch, gen, n, dev)
    spread = spread + 0.15 * wave(3)[:, None]
    return render(torch, hw, fx, cx, cy, z, spread, dz).to(torch.uint16)


def crop_hands(torch, gen, com_z, half, hw):
    """(n, hw, hw) float32 mm: hands as a cached crop of the metric cube
    holds them, filling much of it and differing from crop to crop: a
    palm of 40-60 mm radius near the centre, a forearm to the crop's edge
    in a direction within 30 degrees of straight down, and five fingers,
    each extended with probability 0.8, at whole-mm depths around
    ``com_z``."""
    n, dev = com_z.shape[0], com_z.device
    u = torch.rand((n, 5), generator=gen, device=dev)
    r = ((40.0 + 20.0 * u[:, 0]) * (hw / 2.0) / half)[:, None, None]
    cx = (hw / 2.0 + (u[:, 1] - 0.5) * 16.0)[:, None, None]
    cy = (hw / 2.0 + (u[:, 2] - 0.5) * 16.0)[:, None, None]
    z = torch.floor(com_z)[:, None, None]
    yy = torch.arange(hw, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(hw, dtype=torch.float32, device=dev)[None, None, :]
    d = torch.where((xx - cx) ** 2 + (yy - cy) ** 2 <= r * r, z, 0.0)
    ang = (math.pi / 2 + (u[:, 3] - 0.5) * math.pi / 3)[:, None, None]
    along = (xx - cx) * torch.cos(ang) + (yy - cy) * torch.sin(ang)
    across = ((yy - cy) * torch.cos(ang) - (xx - cx) * torch.sin(ang)).abs()
    az = z + 30.0 + torch.floor(30.0 * u[:, 4])[:, None, None]
    arm = (along > 0) & (across < 0.65 * r)
    d = torch.where(arm & ((d == 0) | (d > az)), az, d)
    spread, dz = _fingers(torch, gen, n, dev)
    on = torch.rand((n, 5), generator=gen, device=dev) < 0.8
    for k in range(5):
        a = spread[:, k, None, None]
        fx_ = cx + 1.8 * r * torch.cos(a)
        fy_ = cy - 1.8 * r * torch.sin(a)
        fz = z + dz[:, k, None, None]
        disc = (((xx - fx_) ** 2 + (yy - fy_) ** 2 <= (0.45 * r) ** 2)
                & on[:, k, None, None])
        d = torch.where(disc & ((d == 0) | (d > fz)), fz, d)
    return d


def raw_crops(torch, gen, n, cube_mm, reg_dim, hw=128):
    """A training set of n cached crops with one draw of the augment
    each, as numpy: (raw, labels).  ``raw`` is ``(src uint16 codes,
    minv float64 (n, 3, 3), com_z, cube_z, premax, zstart, zend, vstar)``:
    the hands of ``crop_hands``, 0 for the background and code 1 for
    pixels clamped to the near plane (``vstar`` = com_z - cube / 2);
    each sample's transform one of the augment's modes (none, a CoM
    shift with its rescale, a rotation by up to 180 degrees), drawn in
    turn."""
    dev = gen.device
    u = torch.rand((n, 8), generator=gen, device=dev)
    com_z = 650.0 + 200.0 * u[:, 0]
    half = cube_mm / 2.0
    d = crop_hands(torch, gen, com_z, half, hw)
    # an occluder nearer than the cube in every fourth crop: clamped
    yy = torch.arange(hw, device=dev)[None, :, None]
    xx = torch.arange(hw, device=dev)[None, None, :]
    occ = ((torch.arange(n, device=dev) % 4 == 0)[:, None, None]
           & (yy < 12) & (xx > 90))
    src = torch.where(occ, 1.0, d).to(torch.uint16)
    near = (com_z - half).to(torch.float32)

    mode = torch.arange(n, device=dev) % 3
    ang = torch.deg2rad((u[:, 3] - 0.5) * 360.0)
    shift = (u[:, 4:6] - 0.5) * 20.0
    scale = 1.0 + (u[:, 6] - 0.5) * 0.04
    eye = torch.eye(3, dtype=torch.float64, device=dev).repeat(n, 1, 1)
    m = eye.clone()
    ca, sa = torch.cos(ang).double(), torch.sin(ang).double()
    ctr = hw // 2
    rot = eye.clone()
    rot[:, 0, 0], rot[:, 0, 1] = ca, sa
    rot[:, 1, 0], rot[:, 1, 1] = -sa, ca
    rot[:, 0, 2] = (1 - ca) * ctr - sa * ctr
    rot[:, 1, 2] = sa * ctr + (1 - ca) * ctr
    sh = eye.clone()
    sh[:, 0, 0] = sh[:, 1, 1] = scale.double()
    sh[:, :2, 2] = shift.double()
    m = torch.where((mode == 1)[:, None, None], sh, m)
    m = torch.where((mode == 2)[:, None, None], rot, m)
    minv = torch.linalg.inv(m)
    dz_com = torch.where(mode == 1, (u[:, 7] - 0.5) * 20.0, 0.0)
    new_z = com_z + dz_com
    cube = torch.full((n,), float(cube_mm), device=dev)
    labels = torch.rand((n, reg_dim), generator=gen, device=dev) - 0.5
    raw = (src, minv, new_z, cube, com_z + half, new_z - half,
           new_z + half, near)
    as_np = tuple(t.cpu().numpy() for t in raw)
    return (as_np[0],) + tuple(
        a if a.dtype == np.float64 else a.astype(np.float32)
        for a in as_np[1:]), labels.cpu().numpy().astype(np.float32)
