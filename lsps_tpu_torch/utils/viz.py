"""Visualization: skeleton overlays, image strips, videos (numpy, no cv2).

The port's copy of ``lsps_tpu/utils/viz.py`` (reference: ``visPair``,
src/pose_train.py:39-60, src/depth_train.py:38-60; the image strip,
depth_train.py:174-184; the eval video, depth_train.py:195-246).

* ``vis_pair`` draws cv2's shapes in numpy (``utils/raster``): a filled
  circle of radius 2 is the pixels within distance 2 of the centre, and a
  one-pixel line steps along its longer axis and rounds the other.  The
  gray background is bit-equal to the JAX package's.
* ``save_image_strip`` and ``write_png`` write PNG (the JAX package
  writes JPEG through cv2): ``zlib`` and ``struct``, 8-bit gray or RGB
  from BGR.
* ``EvalVideoWriter`` writes an uncompressed RIFF AVI of BGR frames (the
  JAX package writes XVID through cv2).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from lsps_tpu_torch.data.transformations import transform_points_2d
from lsps_tpu_torch.utils.raster import disc, line1
from lsps_tpu_torch.utils.skeleton import FIG_COLOR


def vis_pair(camera, depth, pose=None, trans=None, com=None, cube=None,
             color_idx=None, bones=None) -> np.ndarray:
    """One 128x128 normalized depth crop as a (128, 128, 3) BGR uint8
    image, with an optional skeleton overlay (reference visPair).
    ``depth`` is (1, H, W) or (H, W, 1) in [-1, 1]; ``pose`` is a flat
    normalized pose."""
    img = np.asarray(depth).reshape(128, 128, 1).copy()
    img = ((img + 1) * 127.5).astype("uint8")
    img = np.repeat(img, 3, axis=2)
    if pose is None:
        return img

    pose = np.asarray(pose).reshape(-1, 3)
    com = np.asarray(com).reshape(-1)[:3]
    cube = np.asarray(cube).reshape(-1)
    gtorig = camera.to_img(pose * (cube[0] / 2.0) + com)
    gtcrop = transform_points_2d(gtorig, trans)

    pts = [(int(p[0]), int(p[1])) for p in gtcrop]
    for idx, pt in enumerate(pts):
        c = FIG_COLOR[color_idx[idx]] if color_idx is not None \
            else (0, 255, 0)
        disc(img, pt[0], pt[1], 2, c)
    if bones and len(pts) > 1:
        for b in bones:
            line1(img, pts[b[0]], pts[b[1]], b[2])
    return img


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, img) -> None:
    """Write a uint8 (H, W) gray or (H, W, 3) BGR image as PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        img = np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB
    else:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def save_image_strip(strip, path) -> None:
    """Save an assembled NHWC strip in [-1, 1] (the reference saves
    ``data / 2 + 0.5`` through torchvision, depth_train.py:176)."""
    if hasattr(strip, "detach"):
        strip = strip.detach().float().cpu().numpy()
    arr = np.asarray(strip)
    if arr.ndim == 4:
        arr = arr[0]
    img = np.clip((arr / 2.0 + 0.5) * 255.0, 0, 255).astype("uint8")
    write_png(path, img)


class EvalVideoWriter:
    """Uncompressed AVI (24-bit top-down BGR DIB frames) of gt-vs-pred pairs
    (depth_train.py:195-196,220,246).  Frames stream to the file; the
    headers' frame counts and the index are written on ``release``."""

    def __init__(self, path, fps=25, size=(128 * 2, 128)):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.w, self.h = int(size[0]), int(size[1])
        self.fps = int(fps)
        self.stride = (self.w * 3 + 3) // 4 * 4
        self.frame_bytes = self.stride * self.h
        self.n = 0
        self.f = open(path, "wb")
        self.f.write(self._header())

    def _header(self) -> bytes:
        avih = struct.pack("<IIIIIIIIII16x", 1000000 // self.fps,
                           self.frame_bytes * self.fps, 0, 0x10, self.n, 0,
                           1, self.frame_bytes, self.w, self.h)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"DIB ", 0, 0,
                           0, 0, 1, self.fps, 0, self.n, self.frame_bytes,
                           0xFFFFFFFF, 0, 0, 0, self.w, self.h)
        # a negative height: top-down rows (OpenCV's FFmpeg reader fails
        # on the bottom-up form)
        strf = struct.pack("<IiiHHIIiiII", 40, self.w, -self.h, 1, 24, 0,
                           self.frame_bytes, 0, 0, 0, 0)
        strl = (b"strl" + b"strh" + struct.pack("<I", len(strh)) + strh
                + b"strf" + struct.pack("<I", len(strf)) + strf)
        hdrl = (b"hdrl" + b"avih" + struct.pack("<I", len(avih)) + avih
                + b"LIST" + struct.pack("<I", len(strl)) + strl)
        movi_size = 4 + self.n * (8 + self.frame_bytes)
        riff_size = (4 + 8 + len(hdrl) + 8 + movi_size
                     + 8 + 16 * self.n)
        return (b"RIFF" + struct.pack("<I", riff_size) + b"AVI "
                + b"LIST" + struct.pack("<I", len(hdrl)) + hdrl
                + b"LIST" + struct.pack("<I", movi_size) + b"movi")

    def write(self, frame) -> None:
        frame = np.asarray(frame, np.uint8)
        if frame.shape != (self.h, self.w, 3):
            raise ValueError(f"frame of shape {frame.shape}, the video is "
                             f"{(self.h, self.w, 3)}")
        rows = np.zeros((self.h, self.stride), np.uint8)
        rows[:, :self.w * 3] = frame.reshape(self.h, -1)
        self.f.write(b"00db" + struct.pack("<I", self.frame_bytes)
                     + rows.tobytes())
        self.n += 1

    def write_pair(self, real_img, est_img) -> None:
        self.write(np.hstack((real_img, est_img)))

    def release(self) -> None:
        if self.f.closed:
            return
        idx = b"".join(
            b"00db" + struct.pack("<III", 0x10, 4 + i * (8 + self.frame_bytes),
                                  self.frame_bytes) for i in range(self.n))
        self.f.write(b"idx1" + struct.pack("<I", len(idx)) + idx)
        self.f.seek(0)
        self.f.write(self._header())
        self.f.close()
