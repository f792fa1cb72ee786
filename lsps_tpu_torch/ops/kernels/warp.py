"""The serving crop warp + normalize tail: CUDA kernel and plain versions.

Replaces ``lsps_tpu/ops/pallas/warp.py``: ``_warp_kernel`` and the
per-sample index math of ``crop_normalize_batch_pallas`` that feeds it.  Per
frame ``b``: ``out[r, c] = frame[iy[r], ix[c]]`` (index -1 -> 0,
non-finite -> 0), then the near clamp to zstart, far -> 0, 0 -> zend, and
``(v - com_z) / half``.  The kernel is ``csrc/warp.cu``, with two entries:

* ``crop_normalize`` computes the indices, the tail parameters and the
  crop affine from the CoMs and cubes inside the kernel: one launch per
  batch.  Its plain version is ``crop_indices`` followed by
  ``warp_normalize_reference``.  It is the registered PyTorch op
  ``lsps::crop_normalize``, which ``torch.export`` traces.
* ``warp_normalize`` takes the indices and tail parameters as tensors.

Each wrapper launches the kernel for CUDA tensors and runs its plain
version for CPU tensors, and for nothing else.

The crop affine is axis-aligned, so each output row has one source row
``iy`` and each output column one source column ``ix`` (-1 where the pixel
lies outside the destination box or the source frame).  Crops must be
bit-equal to the JAX package's, and one index off by one breaks that.  The
JAX package's arithmetic is what XLA compiles it to, and XLA's CPU backend
rewrites two patterns of that source:

* ``x / c`` for a compile-time constant ``c`` (``fx``, ``fy``) becomes
  ``x * (1 / c)``, the reciprocal rounded to float32;
* ``a * b + c`` is contracted into one fused multiply-add, rounded once.

(Found by holding each op of ``com_to_bounds`` against JAX on the CPU over
random CoMs: plain division and separately rounded products differ in the
last bits of many intermediates, and for a few CoMs in 1e5 move a crop
bound by one pixel.)  The plain version spells both rewrites out:
``_recip`` and ``fma``.  ``fma`` rounds once through float64, where the
float32 product is exact, and so is the sum at the magnitudes of these
bounds.  Divisions by a traced value (``/ com_z``, ``/ scale``, ``/ wb``)
stay true divisions in XLA and here.  The kernel does the same operations
as explicitly rounded float32 intrinsics (``__fmaf_rn`` for ``fma``), so
its indices and affines are the plain version's, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

FRAME_DTYPES = {torch.float32: 0, torch.uint16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # frames, dtype, iy, ix, params, out, b, h, w, dh, dw, stream
    "lsps_warp_normalize": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # frames, dtype, coms, cubes, fx, fy, rfx, rfy, out, Ms, b, h, w, dh,
    # dw, stream
    "lsps_crop_normalize": [_P, _I, _P, _P, _F, _F, _F, _F, _P, _P, _I, _I,
                            _I, _I, _I, _P],
}


@functools.cache
def _library() -> ctypes.CDLL:
    from lsps_tpu_torch.ops.kernels.build import load_library

    lib = load_library("warp")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# the crop-index math (plain version)
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    """The float32 rounding of a Python number, as a Python float."""
    return ctypes.c_float(x).value


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


# ---------------------------------------------------------------------------
# plain versions and wrappers
# ---------------------------------------------------------------------------

def warp_normalize_reference(frames: torch.Tensor, iy: torch.Tensor,
                             ix: torch.Tensor,
                             params: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the gather form of
    ``lsps_tpu/serve/preprocess_jax.py:crop_normalize`` plus its tail.

    frames (B, H, W) float32 or uint16; iy (B, dh), ix (B, dw) int32 source
    rows/cols, -1 where invalid; params (B, 4) float32 (zstart, zend,
    com_z, half).  Returns (B, dh, dw) float32.
    """
    frames = frames.to(torch.float32)
    b = torch.arange(frames.shape[0], device=frames.device)[:, None, None]
    rows = iy.clamp(min=0).long()[:, :, None]
    cols = ix.clamp(min=0).long()[:, None, :]
    vals = frames[b, rows, cols]
    vals = torch.where(torch.isfinite(vals), vals, 0.0)
    valid = (iy >= 0)[:, :, None] & (ix >= 0)[:, None, :]
    vals = torch.where(valid, vals, 0.0)
    zstart, zend, com_z, half = (p[:, None, None] for p in params.unbind(1))
    vals = torch.where((vals < zstart) & (vals != 0), zstart, vals)
    vals = torch.where((vals > zend) & (vals != 0), 0.0, vals)
    vals = torch.where(vals == 0, zend, vals)
    return (vals - com_z) / half


def crop_normalize_reference(frames: torch.Tensor, coms: torch.Tensor,
                             cubes: torch.Tensor, fx: float, fy: float,
                             dsize: Tuple[int, int] = (128, 128)):
    """Plain PyTorch version of ``crop_normalize``: ``crop_indices``, then
    ``warp_normalize_reference``.  Returns (crops (B, dh, dw), Ms)."""
    Ms, iy, ix, params = crop_indices(coms, cubes, fx, fy,
                                      tuple(frames.shape[1:]), dsize)
    return warp_normalize_reference(frames, iy, ix, params), Ms


def _check_device(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"no {name} for device {t.device}")


def _check_frames(frames, tensors):
    if frames.dim() != 3:
        raise ValueError("frames must be (B, H, W)")
    if frames.dtype not in FRAME_DTYPES:
        raise TypeError(f"frames must be float32 or uint16, "
                        f"not {frames.dtype}")
    for name, t in (("frames", frames), *tensors.items()):
        if t.device != frames.device:
            raise ValueError(f"{name} is on {t.device}, frames on "
                             f"{frames.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(frames, iy, ix, params):
    if iy.dim() != 2 or ix.dim() != 2:
        raise ValueError("iy must be (B, dh), ix (B, dw)")
    b = frames.shape[0]
    if iy.shape[0] != b or ix.shape[0] != b or params.shape != (b, 4):
        raise ValueError(f"batch mismatch: frames {tuple(frames.shape)}, "
                         f"iy {tuple(iy.shape)}, ix {tuple(ix.shape)}, "
                         f"params {tuple(params.shape)}")
    if iy.dtype != torch.int32 or ix.dtype != torch.int32:
        raise TypeError("iy and ix must be int32")
    if params.dtype != torch.float32:
        raise TypeError("params must be float32")
    _check_frames(frames, {"iy": iy, "ix": ix, "params": params})


def warp_normalize(frames: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                   params: torch.Tensor) -> torch.Tensor:
    """Batched fused warp + normalize; arguments as for
    ``warp_normalize_reference``.  CUDA tensors launch the kernel
    (``warp_normalize.launches`` counts the launches); CPU tensors run the
    plain version; any other device raises."""
    if frames.device.type == "cpu":
        return warp_normalize_reference(frames, iy, ix, params)
    _check_device(frames, "warp_normalize")
    _check(frames, iy, ix, params)
    b, h, w = frames.shape
    dh, dw = iy.shape[1], ix.shape[1]
    out = torch.empty((b, dh, dw), dtype=torch.float32, device=frames.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(frames.device):
        rc = lib.lsps_warp_normalize(
            frames.data_ptr(), FRAME_DTYPES[frames.dtype], iy.data_ptr(),
            ix.data_ptr(), params.data_ptr(), out.data_ptr(), b, h, w, dh,
            dw, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"warp_normalize kernel launch failed: CUDA "
                           f"error {rc}")
    warp_normalize.launches += 1
    return out


# ``crop_normalize`` is the registered op ``lsps::crop_normalize``, so that
# ``torch.export`` traces it (as one opaque node with the shapes of its fake
# implementation) and an exported program calls it as the live path does.
# Its CUDA implementation launches the kernel and counts the launch, so a
# launch from inside an exported program counts too; its CPU
# implementation is the plain version.

@torch.library.custom_op("lsps::crop_normalize", mutates_args=(),
                         device_types="cpu")
def _crop_normalize_op(frames: torch.Tensor, coms: torch.Tensor,
                       cubes: torch.Tensor, fx: float, fy: float, dw: int,
                       dh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return crop_normalize_reference(frames, coms, cubes, fx, fy, (dw, dh))


@_crop_normalize_op.register_kernel("cuda")
def _crop_normalize_cuda(frames, coms, cubes, fx, fy, dw, dh):
    _check_frames(frames, {"coms": coms, "cubes": cubes})
    b, h, w = frames.shape
    for name, t in (("coms", coms), ("cubes", cubes)):
        if t.shape != (b, 3) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({b}, 3) float32, not "
                             f"{tuple(t.shape)} {t.dtype}")
    out = torch.empty((b, dh, dw), dtype=torch.float32, device=frames.device)
    Ms = torch.empty((b, 3, 3), dtype=torch.float32, device=frames.device)
    if b == 0:
        return out, Ms
    lib = _library()
    with torch.cuda.device(frames.device):
        rc = lib.lsps_crop_normalize(
            frames.data_ptr(), FRAME_DTYPES[frames.dtype], coms.data_ptr(),
            cubes.data_ptr(), _f32(fx), _f32(fy), _recip(fx), _recip(fy),
            out.data_ptr(), Ms.data_ptr(), b, h, w, dh, dw,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crop_normalize kernel launch failed: CUDA "
                           f"error {rc}")
    crop_normalize.launches += 1
    return out, Ms


@_crop_normalize_op.register_fake
def _crop_normalize_fake(frames, coms, cubes, fx, fy, dw, dh):
    b = frames.shape[0]
    return (frames.new_empty((b, dh, dw), dtype=torch.float32),
            frames.new_empty((b, 3, 3), dtype=torch.float32))


def crop_normalize(frames: torch.Tensor, coms: torch.Tensor,
                   cubes: torch.Tensor, fx: float, fy: float,
                   dsize: Tuple[int, int] = (128, 128)):
    """(B, H, W) float32 or uint16 frames + (B, 3) float32 CoMs (u, v, z)
    and cubes (mm) -> (crops (B, dh, dw) float32, Ms (B, 3, 3)), with
    ``dsize = (dw, dh)``, through the op ``lsps::crop_normalize``.  CUDA
    tensors launch the kernel once, index math included
    (``crop_normalize.launches`` counts the launches, also those from an
    exported program); CPU tensors run ``crop_normalize_reference``; any
    other device raises."""
    if frames.device.type != "cpu":
        _check_device(frames, "crop_normalize")
    dw, dh = dsize
    if dw < 1 or dh < 1:
        raise ValueError(f"dsize must be positive, not {dsize}")
    return _crop_normalize_op(frames, coms, cubes, float(fx), float(fy),
                              int(dw), int(dh))


warp_normalize.launches = 0
crop_normalize.launches = 0
