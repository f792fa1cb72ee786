"""On-device hand detection: raw depth frames -> CoMs.

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
``ops/kernels/warp.py``).

``device_detect_batch`` is the registered op ``lsps::detect_coms``, so that
``torch.export`` traces it as one node (a symbolic batch included) and an
exported program calls it as the live path does.  For CUDA tensors the op
launches ``csrc/detect.cu``: one memset and ``4 + refine_iters`` kernels a
call, whatever the batch (``device_detect_batch.launches`` counts the
calls that launch it, also those from an exported program).  CPU tensors
run the plain version, ``device_detect_batch_reference``; any other device
raises.  The plain version's masked sums are float32 reductions, whose
order differs from XLA's, so CoMs agree with the JAX package to a
tolerance, not bit for bit.  The kernel's sums are exact integers (depths
in fixed point), each CoM their float64 quotient rounded once: u and v
equal the plain version's where its sums are exact (whole numbers below
2**24), z lies at least as close to the exact mean.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lsps_tpu_torch.ops.kernels.warp import (FRAME_DTYPES, _check_device,
                                             _check_frames, _f32, _recip,
                                             com_to_bounds, fma)

FIRST_SLICE = 5  # the nearest slices are skipped

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # b, steps, refine_iters
    "lsps_detect_workspace": [_I, _I, _I],
    # frames, dtype, cubes, fx, fy, rfx, rfy, rsteps, steps, interior_min,
    # refine_iters, first_slice, work, out, b, h, w, stream
    "lsps_detect_coms": [_P, _I, _P, _F, _F, _F, _F, _F, _I, _I, _I, _I, _P,
                         _P, _I, _I, _I, _P],
}
_INT_MAX = 2 ** 31 - 1


@functools.cache
def _library() -> ctypes.CDLL:
    from lsps_tpu_torch.ops.kernels.build import load_library

    lib = load_library("detect")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


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


def device_detect_batch_reference(frames: torch.Tensor, cubes: torch.Tensor,
                                  fx: float, fy: float, steps: int = 65,
                                  interior_min: int = 150,
                                  refine_iters: int = 5,
                                  first_slice: int = FIRST_SLICE
                                  ) -> torch.Tensor:
    """Plain PyTorch version of ``device_detect_batch``: (B, H, W) raw
    depth frames in mm + (B, 3) cubes -> (B, 3) CoMs (u, v, z[mm]), zeros
    where no slice from ``first_slice`` on qualifies."""
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
    counts = counts.reshape(b, steps + 1)[:, 1 + first_slice:]
    oks = counts >= interior_min
    any_ok = oks.any(1)
    first = oks.to(torch.uint8).argmax(1) + first_slice  # first qualifying
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


@functools.cache
def _workspace_bytes(b: int, steps: int, refine_iters: int) -> int:
    n = _library().lsps_detect_workspace(b, steps, refine_iters)
    if n < 0:
        raise ValueError(f"no detection workspace for batch {b}, steps "
                         f"{steps}, refine_iters {refine_iters}")
    return n


@torch.library.custom_op("lsps::detect_coms", mutates_args=(),
                         device_types="cpu")
def _detect_coms_op(frames: torch.Tensor, cubes: torch.Tensor, fx: float,
                    fy: float, steps: int, interior_min: int,
                    refine_iters: int, first_slice: int) -> torch.Tensor:
    return device_detect_batch_reference(frames, cubes, fx, fy, steps,
                                         interior_min, refine_iters,
                                         first_slice)


@_detect_coms_op.register_kernel("cuda")
def _detect_coms_cuda(frames, cubes, fx, fy, steps, interior_min,
                      refine_iters, first_slice):
    _check_frames(frames, {"cubes": cubes})
    b, h, w = frames.shape
    if cubes.shape != (b, 3) or cubes.dtype != torch.float32:
        raise ValueError(f"cubes must be ({b}, 3) float32, not "
                         f"{tuple(cubes.shape)} {cubes.dtype}")
    if not 0 <= first_slice < steps:
        raise ValueError(f"first_slice {first_slice} must lie in [0, steps "
                         f"{steps})")
    if not (1 <= h <= 65535 and 1 <= w <= 65535 and h * w <= _INT_MAX):
        raise ValueError(f"frames of {h} x {w} pixels: the kernel takes 1 "
                         f"to 65535 a side and under 2**31 in all")
    out = torch.empty((b, 3), dtype=torch.float32, device=frames.device)
    if b == 0:
        return out
    iters = max(refine_iters, 0)
    work = torch.empty(_workspace_bytes(b, steps, iters), dtype=torch.uint8,
                       device=frames.device)
    lib = _library()
    with torch.cuda.device(frames.device):
        # counts never exceed h * w < 2**31, so the clamp keeps every test
        rc = lib.lsps_detect_coms(
            frames.data_ptr(), FRAME_DTYPES[frames.dtype], cubes.data_ptr(),
            _f32(fx), _f32(fy), _recip(fx), _recip(fy), _recip(float(steps)),
            steps, min(max(interior_min, 0), _INT_MAX), iters, first_slice,
            work.data_ptr(), out.data_ptr(), b, h, w,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"detect_coms kernel launch failed: CUDA error "
                           f"{rc}")
    device_detect_batch.launches += 1
    return out


@_detect_coms_op.register_fake
def _detect_coms_fake(frames, cubes, fx, fy, steps, interior_min,
                      refine_iters, first_slice):
    return frames.new_empty((frames.shape[0], 3), dtype=torch.float32)


def device_detect_batch(frames: torch.Tensor, cubes: torch.Tensor,
                        fx: float, fy: float, steps: int = 65,
                        interior_min: int = 150,
                        refine_iters: int = 5) -> torch.Tensor:
    """(B, H, W) raw depth frames in mm (float32 or uint16) + (B, 3) cubes
    -> (B, 3) CoMs (u, v, z[mm]), zeros where no slice qualifies, through
    the op ``lsps::detect_coms``.  CUDA tensors (float32 cubes, both
    contiguous) launch the kernel (``device_detect_batch.launches`` counts
    the calls); CPU tensors run ``device_detect_batch_reference``; any
    other device raises."""
    if steps > 127:
        raise ValueError("slice index must fit in int8")
    if frames.device.type != "cpu":
        _check_device(frames, "device_detect_batch")
    return _detect_coms_op(frames, cubes, float(fx), float(fy), int(steps),
                           int(interior_min), int(refine_iters), FIRST_SLICE)


device_detect_batch.launches = 0


def device_detect(dpt: torch.Tensor, cube: torch.Tensor, fx: float,
                  fy: float, **kw) -> torch.Tensor:
    """(H, W) frame + (3,) cube -> (3,) CoM."""
    return device_detect_batch(dpt[None], cube[None], fx, fy, **kw)[0]
