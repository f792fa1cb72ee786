"""The serving crop warp + normalize tail: CUDA kernel and plain version.

Replaces ``lsps_tpu/ops/pallas/warp.py:warp_normalize_pallas``.  Per frame
``b``: ``out[r, c] = frame[iy[r], ix[c]]`` (index -1 -> 0, non-finite ->
0), then the near clamp to zstart, far -> 0, 0 -> zend, and
``(v - com_z) / half``.  The kernel is ``csrc/warp.cu``; the wrapper
launches it for CUDA tensors and runs ``warp_normalize_reference`` for
CPU tensors, and for nothing else.
"""

from __future__ import annotations

import ctypes

import torch

FRAME_DTYPES = {torch.float32: 0, torch.uint16: 1}

_SIGNATURE = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
              + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_MAX_GRID_Y = 65535


def _kernel():
    from lsps_tpu_torch.ops.kernels.build import load_library

    fn = load_library("warp").lsps_warp_normalize
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


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


def _check(frames, iy, ix, params):
    if frames.dim() != 3 or iy.dim() != 2 or ix.dim() != 2:
        raise ValueError("frames must be (B, H, W), iy (B, dh), ix (B, dw)")
    b = frames.shape[0]
    if iy.shape[0] != b or ix.shape[0] != b or params.shape != (b, 4):
        raise ValueError(f"batch mismatch: frames {tuple(frames.shape)}, "
                         f"iy {tuple(iy.shape)}, ix {tuple(ix.shape)}, "
                         f"params {tuple(params.shape)}")
    if frames.dtype not in FRAME_DTYPES:
        raise TypeError(f"frames must be float32 or uint16, "
                        f"not {frames.dtype}")
    if iy.dtype != torch.int32 or ix.dtype != torch.int32:
        raise TypeError("iy and ix must be int32")
    if params.dtype != torch.float32:
        raise TypeError("params must be float32")
    for name, t in (("frames", frames), ("iy", iy), ("ix", ix),
                    ("params", params)):
        if t.device != frames.device:
            raise ValueError(f"{name} is on {t.device}, frames on "
                             f"{frames.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's {_MAX_GRID_Y}")


def warp_normalize(frames: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                   params: torch.Tensor) -> torch.Tensor:
    """Batched fused warp + normalize; arguments as for
    ``warp_normalize_reference``.  CUDA tensors launch the kernel
    (``warp_normalize.launches`` counts the launches); CPU tensors run the
    plain version; any other device raises."""
    if frames.device.type == "cpu":
        return warp_normalize_reference(frames, iy, ix, params)
    if frames.device.type != "cuda":
        raise ValueError(f"no warp_normalize for device {frames.device}")
    _check(frames, iy, ix, params)
    b, h, w = frames.shape
    dh, dw = iy.shape[1], ix.shape[1]
    out = torch.empty((b, dh, dw), dtype=torch.float32, device=frames.device)
    if b == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(frames.data_ptr(), FRAME_DTYPES[frames.dtype], iy.data_ptr(),
                ix.data_ptr(), params.data_ptr(), out.data_ptr(), b, h, w,
                dh, dw, stream)
    if rc != 0:
        raise RuntimeError(f"warp_normalize kernel launch failed: CUDA "
                           f"error {rc}")
    warp_normalize.launches += 1
    return out


warp_normalize.launches = 0
