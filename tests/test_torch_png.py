"""The port's PNG reader (``lsps_tpu_torch.data.png``) against PIL and cv2.

1. Depth maps as the datasets store them, written by PIL and by cv2: NYU's
   640 x 480 RGB frames that pack the depth as ``(G << 8) | B`` and ICVL's
   320 x 240 16-bit gray frames, read equal to ``PIL.Image.open`` and to
   ``cv2.imread(..., IMREAD_UNCHANGED)``.
2. A test-side encoder that forces one of the five scanline filters on
   every row, or a seeded mix per row, over seeded random bytes in each
   supported format, with the image data split over several IDAT chunks.
3. A bad CRC, an interlaced file, a paletted file and a bit depth below 8
   each raise a ``ValueError`` that names the field.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from lsps_tpu_torch.data.png import decode_png, read_png

# the formats the reader covers: (color type, bit depth, channels)
FORMATS = {"gray8": (0, 8, 1), "gray16": (0, 16, 1), "rgb8": (2, 8, 3),
           "rgba8": (6, 8, 4), "gray_alpha8": (4, 8, 2), "rgb16": (2, 16, 3)}


def _chunk(kind: bytes, body: bytes, crc=None) -> bytes:
    crc = zlib.crc32(kind + body) if crc is None else crc
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _filter_rows(img_bytes, bpp, kinds):
    """Apply filter ``kinds[r]`` to row r of the (H, stride) byte image."""
    x = img_bytes.astype(np.int32)
    h = x.shape[0]
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) // 2, paeth]
    out = np.empty((h, x.shape[1] + 1), np.uint8)
    for r in range(h):
        out[r, 0] = kinds[r]
        out[r, 1:] = (x[r] - preds[kinds[r]][r]) % 256
    return out


def encode_png(arr, color, depth, kinds, n_idat=3, interlace=0):
    """A PNG of ``arr`` with the given filter type per row, the zlib
    stream split over ``n_idat`` IDAT chunks."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    if depth == 16:
        raw = arr.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        raw = arr.astype(np.uint8).reshape(h, -1)
    bpp = channels * depth // 8
    data = zlib.compress(_filter_rows(raw, bpp, kinds).tobytes())
    cuts = np.linspace(0, len(data), n_idat + 1).astype(int)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(b"IDAT", data[i:j])
                       for i, j in zip(cuts[:-1], cuts[1:]))
            + _chunk(b"IEND", b""))


def _image(fmt, h, w, rs):
    _, depth, channels = FORMATS[fmt]
    shape = (h, w) if channels == 1 else (h, w, channels)
    top = 1 << depth
    return rs.randint(0, top, shape).astype(np.uint16 if depth == 16
                                            else np.uint8)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_each_filter_on_every_row(fmt, filt):
    """Random bytes (the hardest case for the predictors), 23 x 37 and
    one row, each forced filter and a seeded mix, four IDAT chunks."""
    color, depth, _ = FORMATS[fmt]
    rs = np.random.RandomState(zlib.crc32(f"{fmt} {filt}".encode()))
    for h, w in ((23, 37), (1, 5), (6, 1)):
        img = _image(fmt, h, w, rs)
        kinds = (rs.randint(0, 5, h) if filt == "mixed"
                 else np.full(h, filt))
        got = decode_png(encode_png(img, color, depth, kinds, n_idat=4))
        assert got.dtype == img.dtype and got.shape == img.shape
        np.testing.assert_array_equal(got, img)


def test_mixed_filters_agree_with_pil(tmp_path):
    """A mixed-filter RGB file of this encoder, read by PIL as well."""
    rs = np.random.RandomState(5)
    img = _image("rgb8", 48, 64, rs)
    path = tmp_path / "mixed.png"
    path.write_bytes(encode_png(img, 2, 8, rs.randint(0, 5, 48)))
    np.testing.assert_array_equal(read_png(path),
                                  np.asarray(Image.open(path)))


def _nyu_rgb(dpt):
    d = dpt.astype(np.int32)
    return np.stack([np.zeros_like(d, np.uint8), (d >> 8).astype(np.uint8),
                     (d & 0xFF).astype(np.uint8)], -1)


def _depth(h, w, rs):
    """A depth map with smooth regions, edges and noise, as the
    mini-datasets of the importer tests hold."""
    yy, xx = np.mgrid[0:h, 0:w]
    dpt = np.where((xx - w / 2) ** 2 + (yy - h / 2) ** 2 < (h / 4) ** 2,
                   700 + (xx % 37) + 3 * (yy % 11), 0)
    dpt = dpt + (rs.rand(h, w) < 0.02) * rs.randint(0, 4000, (h, w))
    return dpt.astype(np.int32)


def _write(kind, writer, path, rs):
    if kind == "nyu_rgb":
        dpt = _depth(480, 640, rs)
        arr = _nyu_rgb(dpt)
        if writer == "pil":
            Image.fromarray(arr, "RGB").save(path)
        else:
            cv2.imwrite(str(path), arr[..., ::-1])  # cv2 writes BGR
        return arr
    dpt = _depth(240, 320, rs).astype(np.uint16)
    if writer == "pil":
        Image.fromarray(dpt).save(path)
    else:
        cv2.imwrite(str(path), dpt)
    return dpt


@pytest.mark.parametrize("writer", ["pil", "cv2"])
@pytest.mark.parametrize("kind", ["nyu_rgb", "icvl_gray16"])
def test_dataset_depth_maps_read_as_pil_and_cv2_read_them(kind, writer,
                                                          tmp_path):
    rs = np.random.RandomState(7)
    path = tmp_path / f"{kind}_{writer}.png"
    want = _write(kind, writer, path, rs)
    got = read_png(path)
    pil = np.asarray(Image.open(path))
    ocv = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if ocv.ndim == 3:
        ocv = ocv[..., ::-1]
    for other, what in ((want, "written"), (pil, "PIL"), (ocv, "cv2")):
        assert got.shape == other.shape, what
        np.testing.assert_array_equal(got, other, err_msg=what)
    assert got.dtype == (np.uint8 if kind == "nyu_rgb" else np.uint16)


def test_bad_crc_raises_and_names_the_chunk():
    rs = np.random.RandomState(1)
    data = bytearray(encode_png(_image("gray8", 4, 5, rs), 0, 8,
                                np.zeros(4, int), n_idat=2))
    # the CRC of the first IDAT chunk: after the signature, IHDR (25 bytes)
    # and the IDAT's length, type and body
    (length,) = struct.unpack(">I", data[33:37])
    data[41 + length] ^= 0xFF
    with pytest.raises(ValueError, match="CRC of chunk IDAT"):
        decode_png(bytes(data))


def test_interlaced_raises():
    rs = np.random.RandomState(2)
    data = encode_png(_image("gray8", 4, 5, rs), 0, 8, np.zeros(4, int),
                      interlace=1)
    with pytest.raises(ValueError, match="interlace"):
        decode_png(data)


def test_paletted_raises(tmp_path):
    rs = np.random.RandomState(3)
    path = tmp_path / "palette.png"
    Image.fromarray(rs.randint(0, 4, (6, 7)).astype(np.uint8), "L").convert(
        "P").save(path)
    assert Image.open(path).mode == "P"
    with pytest.raises(ValueError, match="paletted"):
        read_png(path)


def test_low_bit_depth_and_bad_filter_type_raise(tmp_path):
    path = tmp_path / "mono.png"
    Image.fromarray(np.eye(8, dtype=bool)).save(path)
    with pytest.raises(ValueError, match="bit depth 1"):
        read_png(path)
    rs = np.random.RandomState(4)
    data = encode_png(_image("gray8", 3, 4, rs), 0, 8, np.zeros(3, int),
                      n_idat=1)
    ihdr = data[:33]
    raw = bytearray(zlib.decompress(data[41:41 + struct.unpack(
        ">I", data[33:37])[0]]))
    raw[5] = 7  # row 1's filter type
    body = zlib.compress(bytes(raw))
    bad = ihdr + _chunk(b"IDAT", body) + _chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="row 1 has filter type 7"):
        decode_png(bad)
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + bytes(20))
