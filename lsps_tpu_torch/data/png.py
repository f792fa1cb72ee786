"""A PNG reader in numpy and zlib, for the depth maps of the datasets.

The JAX package's importers read their depth maps with PIL
(``lsps_tpu/data/importers.py``: NYU's RGB frames that pack the depth as
``(G << 8) | B``, ICVL's 16-bit gray frames).  The port reads them here:
the signature, the IHDR fields, the CRC of every chunk, the IDAT chunks
joined and inflated with ``zlib``, and the five scanline filters undone.

``read_png`` returns what ``np.asarray(PIL.Image.open(path))`` gives for
the formats it covers: 8-bit gray (H, W) uint8, 16-bit gray (H, W) uint16
(big-endian in the file), and 8- or 16-bit gray + alpha, RGB and RGBA as
(H, W, C).  Interlaced and paletted files and bit depths below 8 raise a
``ValueError`` that names the field.

The filters are undone without a loop over pixels.  Rows filtered with
None, Sub (a cumulative sum mod 256 along the row) and Up (a row add) take
a few array operations each.  Average and Paeth read the decoded byte to
the left, so a run of rows that holds them is decoded along its
anti-diagonals: pixel (r, c) needs (r, c - 1), (r - 1, c) and
(r - 1, c - 1), all on earlier diagonals.  The run is stored with each
diagonal in one contiguous block, so a step is a few operations on whole
blocks; a 640 x 480 frame takes about 1100 of them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels: gray, RGB, gray + alpha, RGBA
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_NONE, _SUB, _UP, _AVERAGE, _PAETH = range(5)


def read_png(path) -> np.ndarray:
    """Decode the PNG file at ``path``; see the module docstring."""
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a PNG held in memory (``name`` is used in error messages)."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (signature)")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{name}: chunk {kind!r} is truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: CRC of chunk {kind.decode('latin-1')}"
                             " does not match")
        pos += 12 + length
        if header is None and kind != b"IHDR":
            raise ValueError(f"{name}: first chunk is {kind!r}, not IHDR")
        if kind == b"IHDR":
            header = _header(body, name)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if not idat:
        raise ValueError(f"{name}: no IDAT chunk")
    width, height, depth, channels = header
    bpp = channels * depth // 8          # bytes per pixel
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{name}: image data holds {raw.size} bytes, "
                         f"{height * (stride + 1)} expected")
    rows = raw.reshape(height, stride + 1)
    out = unfilter(rows[:, 1:].reshape(height, width, bpp), rows[:, 0], name)
    if depth == 16:
        out = out.reshape(height, width * channels, 2)
        out = (out[..., 0].astype(np.uint16) << 8) | out[..., 1]
    out = out.reshape(height, width, channels)
    return out[..., 0] if channels == 1 else out


def _header(body: bytes, name: str):
    if len(body) != 13:
        raise ValueError(f"{name}: IHDR holds {len(body)} bytes, not 13")
    width, height, depth, color, compression, filt, interlace = \
        struct.unpack(">IIBBBBB", body)
    if color == 3:
        raise ValueError(f"{name}: color type 3 (paletted) is not supported")
    if color not in CHANNELS:
        raise ValueError(f"{name}: color type {color} is not valid")
    if depth not in (8, 16):
        raise ValueError(f"{name}: bit depth {depth} is not supported "
                         "(8 or 16)")
    if compression != 0:
        raise ValueError(f"{name}: compression method {compression}")
    if filt != 0:
        raise ValueError(f"{name}: filter method {filt}")
    if interlace != 0:
        raise ValueError(f"{name}: interlace method {interlace} (Adam7) is "
                         "not supported")
    if width == 0 or height == 0:
        raise ValueError(f"{name}: width {width}, height {height}")
    return width, height, depth, CHANNELS[color]


def unfilter(filtered: np.ndarray, kinds: np.ndarray,
             name: str = "<bytes>") -> np.ndarray:
    """Undo the scanline filters: ``filtered`` (H, W, bpp) uint8, one
    filter type per row in ``kinds``; returns the (H, W, bpp) bytes."""
    kinds = np.asarray(kinds)
    if kinds.size and kinds.max() > _PAETH:
        row = int(np.argmax(kinds > _PAETH))
        raise ValueError(f"{name}: row {row} has filter type "
                         f"{int(kinds[row])}")
    h = filtered.shape[0]
    out = np.empty_like(filtered)
    hard = np.nonzero(kinds >= _AVERAGE)[0]
    first = int(hard[0]) if hard.size else h
    last = int(hard[-1]) + 1 if hard.size else h
    prior = np.zeros_like(filtered[0])
    for r in range(first):
        prior = out[r] = _easy_row(filtered[r], int(kinds[r]), prior)
    if hard.size:
        out[first:last] = _wavefront(filtered[first:last],
                                     kinds[first:last], prior)
        prior = out[last - 1]
    for r in range(last, h):
        prior = out[r] = _easy_row(filtered[r], int(kinds[r]), prior)
    return out


def _easy_row(row, kind, prior):
    if kind == _NONE:
        return row
    if kind == _SUB:
        return np.cumsum(row, axis=0, dtype=np.uint8)
    return row + prior          # Up; uint8 adds wrap mod 256


def _wavefront(filtered, kinds, prior):
    """Rows of any filter type, decoded diagonal by diagonal.  The run is
    stored diagonal-major: pixel (r, c) of the run at ``q[r + c + 2,
    r + 1]``, so diagonal t is the contiguous block ``q[t]``; row 0 holds
    the decoded row above the run, and the zeros around the skewed band
    are the filters' out-of-image bytes."""
    k, w, bpp = filtered.shape
    q = np.zeros((w + k + 1, k + 1, bpp), np.int16)
    f = np.zeros_like(q)
    q[1:w + 1, 0] = prior
    for r in range(k):
        f[r + 2:r + 2 + w, r + 1] = filtered[r]
    kinds = np.concatenate([[_NONE], kinds])[:, None]
    # the Paeth predictor everywhere, then the other rows' own
    others = [(kind, kinds == kind) for kind in (_NONE, _SUB, _UP, _AVERAGE)
              if (kinds[1:] == kind).any()]
    for t in range(2, k + w + 1):
        lo, hi = max(1, t - w), min(k, t - 1) + 1
        a = q[t - 1, lo:hi]             # left
        b = q[t - 1, lo - 1:hi - 1]     # up
        c = q[t - 2, lo - 1:hi - 1]     # up-left
        p = b - c
        pb = a - c
        pa = np.abs(p)
        p += pb
        pc = np.abs(p)
        pb = np.abs(pb)
        pred = np.where(pb <= pc, b, c)
        pred = np.where((pa <= pb) & (pa <= pc), a, pred)
        for kind, rows in others:
            pick = (0, a, b, None)[kind]
            if kind == _AVERAGE:
                pick = (a + b) >> 1
            pred = np.where(rows[lo:hi], pick, pred)
        pred += f[t, lo:hi]
        pred &= 0xFF
        q[t, lo:hi] = pred
    out = np.empty((k, w, bpp), np.uint8)
    for r in range(k):
        out[r] = q[r + 2:r + 2 + w, r + 1]
    return out
