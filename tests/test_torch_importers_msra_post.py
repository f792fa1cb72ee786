"""The port's MSRA15 and POST importers and its cv2-free colour code,
against the JAX package and cv2.

Mini datasets are written to a temporary directory the way the JAX
package's own tests write them (``tests/test_importers_fileformats.py``:
MSRA15 ``.bin`` patches behind a 6-int bounding-box header and a
``joint.txt`` per gesture; ``tests/test_post_importer.py``: 16-bit depth
and part-label PNGs for synthetic frames, a colour label PNG for real
ones).  Each sequence must load into ``FrameArrays`` equal to the JAX
importer's bit for bit, with every option, and the ``.npz`` caches must
load in the other package both ways.  ``bgr_to_hsv`` must equal
``cv2.cvtColor(..., COLOR_BGR2HSV)`` over all 2^24 BGR triples,
``imread_color`` ``cv2.imread(..., 1)`` on each PNG kind, ``in_range``
``cv2.inRange``.
"""

import os
import struct

import numpy as np
import pytest

from lsps_tpu.data import importers as jimp
from lsps_tpu_torch.data import importers as pimp
from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.data.color import bgr_to_hsv, imread_color, in_range
from lsps_tpu_torch.data.synthetic import render_hand_depth
from test_torch_host_detect import _RefineNet
from test_torch_importers import assert_arrays_equal
from test_torch_png import encode_png

cv2 = pytest.importorskip("cv2")

W, H = 640, 480


# --------------------------------------------------------------------------
# MSRA15
def write_bin(path, dpt):
    """An MSRA15 ``.bin``: width, height, left, top, right, bottom, then
    the float32 patch inside that box (the whole frame when blank)."""
    h, w = dpt.shape
    ys, xs = np.nonzero(dpt)
    top, bottom, left, right = ((ys.min(), ys.max() + 1, xs.min(),
                                 xs.max() + 1) if ys.size else (0, h, 0, w))
    with open(path, "wb") as f:
        f.write(struct.pack("6i", w, h, left, top, right, bottom))
        dpt[top:bottom, left:right].astype(np.float32).tofile(f)


def write_msra(root, subjects=("P0", "P3"), gestures=("1", "2"), n=8,
               seed=3):
    """Two subjects x two gestures x ``n`` frames at 320 x 240; in each
    gesture frame 2 is blank and frame ``n`` is listed without a file."""
    cam = Camera.msra()
    gen = np.random.RandomState(seed)
    for s in subjects:
        for g in gestures:
            d = os.path.join(root, s, g)
            os.makedirs(d)
            lines = [str(n + 1)]
            for i in range(n + 1):
                com3d = np.array([gen.uniform(-40, 40),
                                  gen.uniform(-30, 30),
                                  gen.uniform(300, 420)], np.float32)
                dpt, joints = render_hand_depth(cam, com3d, 21, gen)
                if i == 2:
                    dpt[:] = 0
                joints = joints.copy()
                joints[:, 2] *= -1.0      # MSRA15 stores z negated
                lines.append(" ".join(f"{v:.4f}" for v in joints.ravel()))
                if i < n:
                    write_bin(os.path.join(d, f"{i:06d}_depth.bin"), dpt)
            with open(os.path.join(d, "joint.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def msra_root(tmp_path_factory):
    return write_msra(str(tmp_path_factory.mktemp("msra")))


def _msra(pkg, root, cache_dir=None, **kw):
    mod = pimp if pkg == "port" else jimp
    return mod.MSRA15Importer(root, use_cache=cache_dir is not None,
                              cache_dir=cache_dir or "unused", **kw)


def test_msra_depth_map_equals_jax(msra_root, tmp_path):
    fname = os.path.join(msra_root, "P0", "1", "000001_depth.bin")
    got = _msra("port", msra_root).load_depth_map(fname)
    want = _msra("jax", msra_root).load_depth_map(fname)
    assert got.dtype == want.dtype == np.float32 and got.shape == (240, 320)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 500
    # a patch that does not start at the origin, read back in place
    patch = np.random.RandomState(1).uniform(300, 500, (40, 60))
    frame = np.zeros((240, 320), np.float32)
    frame[50:90, 100:160] = patch
    write_bin(str(tmp_path / "p.bin"), frame)
    np.testing.assert_array_equal(
        _msra("port", msra_root).load_depth_map(str(tmp_path / "p.bin")),
        frame)


MSRA_OPTIONS = {"plain": {}, "nmax": {"nmax": 5},
                "sub_seq": {"sub_seq": ["2"]}, "docom": {"docom": True},
                "cube": {"cube": (200, 200, 200)},
                "shuffle": {"shuffle": True}}


@pytest.mark.parametrize("option", sorted(MSRA_OPTIONS))
@pytest.mark.parametrize("seq", ["P0", "P3"])
def test_msra_sequence_equals_jax(msra_root, seq, option):
    kw = dict(MSRA_OPTIONS[option])
    if option == "shuffle":
        got = _msra("port", msra_root).load_sequence(
            seq, shuffle=True, rng=np.random.RandomState(4))
        want = _msra("jax", msra_root).load_sequence(
            seq, shuffle=True, rng=np.random.RandomState(4))
    else:
        got = _msra("port", msra_root).load_sequence(seq, **kw)
        want = _msra("jax", msra_root).load_sequence(seq, **kw)
    assert_arrays_equal(got, want, f"{seq} {option}")
    n = {"nmax": 5, "sub_seq": 7}.get(option, 14)
    assert len(got) == n and got.gtorig.shape[1:] == (21, 3)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_msra_cache_cross_loads(msra_root, tmp_path, writer):
    reader = "jax" if writer == "port" else "port"
    cache = str(tmp_path / "cache")
    first = _msra(writer, msra_root, cache).load_sequence(
        "P3", sub_seq=["1"])
    files = os.listdir(cache)
    assert files == ["MSRA15Importer_P3_1_None_gt_220.npz"]
    again = _msra(reader, msra_root, cache).load_sequence(
        "P3", sub_seq=["1"], nmax=6)
    fresh = _msra(reader, msra_root).load_sequence("P3", sub_seq=["1"])
    assert_arrays_equal(again, fresh.take(np.arange(6)), "cached")
    assert_arrays_equal(first.take(np.arange(6)), again, "cross")


def test_refine_net_sets_the_cache_key(msra_root):
    net = object()
    for mod in ("MSRA15Importer", "POSTImporter"):
        p = getattr(pimp, mod)(msra_root, cache_dir="c", refine_net=net)
        j = getattr(jimp, mod)(msra_root, cache_dir="c", refine_net=net)
        for docom, sub in ((True, None), (True, ["1", "2"])):
            assert p._cache_path("P0", sub, docom, (240,) * 3) == \
                j._cache_path("P0", sub, docom, (240,) * 3)
        assert "comref" in p._cache_path("P0", None, True, (240,) * 3)


@pytest.mark.parametrize("case", ["msra_P0", "msra_P3", "post_synth",
                                  "post_test"])
def test_refined_sequence_equals_jax(msra_root, post_root, case):
    """With a refinement hook and ``docom`` the crops are re-centred on
    the hook's offset, as in the JAX package, and differ from the
    unrefined ones."""
    kind, seq = case.split("_")
    root, make = (msra_root, _msra) if kind == "msra" else (post_root,
                                                            _post)
    net = _RefineNet()
    got = make("port", root, refine_net=net).load_sequence(seq, docom=True)
    want = make("jax", root, refine_net=net).load_sequence(seq, docom=True)
    assert_arrays_equal(got, want, case)
    assert net.calls == 2 * len(got) > 0
    plain = make("port", root).load_sequence(seq, docom=True)
    assert np.abs(got.com - plain.com).max() > 0.1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_refined_cache_cross_loads(msra_root, tmp_path, writer):
    reader = "jax" if writer == "port" else "port"
    cache = str(tmp_path / "cache")
    net = _RefineNet()
    first = _msra(writer, msra_root, cache, refine_net=net).load_sequence(
        "P0", sub_seq=["2"], docom=True)
    assert os.listdir(cache) == ["MSRA15Importer_P0_2_None_comref_240.npz"]
    calls = net.calls
    again = _msra(reader, msra_root, cache, refine_net=net).load_sequence(
        "P0", sub_seq=["2"], docom=True)
    assert net.calls == calls               # read from the cache
    assert_arrays_equal(again, _msra(writer, msra_root, cache,
                                     refine_net=net).load_sequence(
        "P0", sub_seq=["2"], docom=True), "cross")
    assert len(first) == len(again) == 7


def test_importers_are_registered():
    from lsps_tpu_torch.registry import lookup

    assert lookup("importer", "MSRA15Importer") is pimp.MSRA15Importer
    assert lookup("importer", "POSTImporter") is pimp.POSTImporter


# --------------------------------------------------------------------------
# POST
LBL_IDS = pimp.POSTImporter.LBL_IDS


def write_post_synth(base, n=4, empty=(3,), seq="synth0"):
    """Synthetic POST frames: 16-bit depth (invalid = 10000) with 18 part
    blobs and their label map; frames in ``empty`` carry no label."""
    ddir = os.path.join(base, "dmaps", seq)
    ldir = os.path.join(base, "lmaps", seq)
    os.makedirs(ddir), os.makedirs(ldir)
    rs = np.random.RandomState(len(seq) + n)
    for i in range(n):
        dpt = np.full((H, W), 10000, np.uint16)
        lbl = np.zeros((H, W), np.uint16)
        for j, pid in enumerate(LBL_IDS):
            r0 = 140 + (j // 6) * 60 + rs.randint(-8, 9)
            c0 = 200 + (j % 6) * 40 + rs.randint(-5, 6)
            hh, ww = rs.randint(12, 31), rs.randint(10, 31)
            dpt[r0:r0 + hh, c0:c0 + ww] = (rs.randint(1900, 2300, (hh, ww))
                                           + 10 * j + i)
            if i not in empty:
                lbl[r0:r0 + hh, c0:c0 + ww] = pid
        cv2.imwrite(os.path.join(ddir, f"img_d_{i:04d}.png"), dpt)
        cv2.imwrite(os.path.join(ldir, f"img_l_{i:04d}.png"), lbl)
    return os.path.join(base, "dmaps")


def write_post_real(base, n=3, seq="test0"):
    """Real POST frames: 16-bit depth (x5) and a BGR label image whose
    subject is painted in hues around the [169, 189] gate, some just
    outside it; the lower rows hold a floor the importer removes."""
    ddir = os.path.join(base, "dmaps", seq)
    ldir = os.path.join(base, "lmaps", seq)
    os.makedirs(ddir), os.makedirs(ldir)
    rs = np.random.RandomState(7)
    for i in range(n):
        dpt = np.zeros((H, W), np.uint16)
        r0, c0 = 90 + 10 * i, 260 + 15 * i
        dpt[r0:r0 + 110, c0:c0 + 90] = rs.randint(1800, 2300,
                                                   (110, 90)) * 5
        dpt[400:, :] = 2500 * 5                      # the floor
        hsv = np.zeros((H, W, 3), np.uint8)
        hsv[..., 0] = rs.randint(160, 180, (H, W))
        hsv[..., 1] = rs.randint(140, 256, (H, W))
        hsv[..., 2] = rs.randint(140, 256, (H, W))
        hsv[:r0] = hsv[r0 + 110:] = 0
        hsv[:, :c0] = hsv[:, c0 + 90:] = 0
        hsv[400:, 100:500] = (175, 200, 200)         # the floor's label
        bgr = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
        cv2.imwrite(os.path.join(ddir, f"img_{i:04d}.png"), dpt)
        cv2.imwrite(os.path.join(ldir, f"img_{i:04d}.png"), bgr)
    return os.path.join(base, "dmaps")


@pytest.fixture(scope="module")
def post_root(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("post"))
    write_post_synth(base)
    return write_post_real(base)


def _post(pkg, root, cache_dir=None, **kw):
    mod = pimp if pkg == "port" else jimp
    return mod.POSTImporter(root, use_cache=cache_dir is not None,
                            cache_dir=cache_dir or "unused", **kw)


@pytest.mark.parametrize("synth", [True, False])
def test_post_depth_and_labels_equal_jax(post_root, synth):
    sub = "synth0/img_d_0001.png" if synth else "test0/img_0001.png"
    fname = os.path.join(post_root, sub)
    p, j = _post("port", post_root), _post("jax", post_root)
    (gd, gl), (wd, wl) = (p.load_depth_map(fname, synth),
                          j.load_depth_map(fname, synth))
    for a, b in ((gd, wd), (gl, wl)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p.prepare_samples(gd, gl, synth),
                    j.prepare_samples(wd, wl, synth)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p.point_cloud(gd[:50, :60] / 40.0),
                                  j.point_cloud(wd[:50, :60] / 40.0))


POST_OPTIONS = {"plain": {}, "nmax": {"nmax": 2}, "docom": {"docom": True},
                "cube": {"cube": (1500, 1500, 1500)}}


@pytest.mark.parametrize("option", sorted(POST_OPTIONS))
@pytest.mark.parametrize("seq", ["synth", "test"])
def test_post_sequence_equals_jax(post_root, seq, option):
    kw = POST_OPTIONS[option]
    got = _post("port", post_root).load_sequence(seq, **kw)
    want = _post("jax", post_root).load_sequence(seq, **kw)
    assert_arrays_equal(got, want, f"{seq} {option}")
    # the synthetic frame without labels is skipped
    n = {"synth": 3, "test": 3}[seq] if option != "nmax" else 2
    assert len(got) == n
    assert got.gtorig.shape[1] == (18 if seq == "synth" else 1)


def test_post_shuffle_equals_jax(post_root):
    got = _post("port", post_root).load_sequence(
        "synth", shuffle=True, rng=np.random.RandomState(2))
    want = _post("jax", post_root).load_sequence(
        "synth", shuffle=True, rng=np.random.RandomState(2))
    assert_arrays_equal(got, want, "shuffle")


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("seq", ["synth", "test"])
def test_post_cache_cross_loads(post_root, tmp_path, writer, seq):
    reader = "jax" if writer == "port" else "port"
    cache = str(tmp_path / "cache")
    first = _post(writer, post_root, cache).load_sequence(seq)
    assert os.listdir(cache) == [f"POSTImporter_{seq}_None_gt_2000.npz"]
    again = _post(reader, post_root, cache).load_sequence(seq)
    own = _post(writer, post_root, cache).load_sequence(seq)
    assert_arrays_equal(again, own, "cross")
    # whole-mm crops are cached as uint16 codes, decoded to the same mm
    assert again.dpt.dtype == np.uint16
    np.testing.assert_array_equal(again.dpt_mm(), first.dpt)


def test_post_all_skipped_raises_in_both(tmp_path):
    root = write_post_synth(str(tmp_path), n=2, empty=(0, 1))
    cache = str(tmp_path / "cache")
    for pkg in ("port", "jax"):
        with pytest.raises(RuntimeError, match="all 2 readable frames"):
            _post(pkg, root, cache).load_sequence("synth")
    assert not os.path.exists(cache)


@pytest.mark.parametrize("error,raised", [(ValueError, RuntimeError),
                                          (TypeError, TypeError)])
def test_post_crop_errors_skip_but_type_errors_raise(post_root, monkeypatch,
                                                     error, raised):
    """A crop that raises ValueError is skipped (here every frame, so the
    sequence raises); a TypeError is a coding fault and propagates."""
    def broken(*a, **kw):
        raise error("broken crop")

    for mod in (pimp, jimp):
        monkeypatch.setattr(mod.HandDetector, "crop_area_3d", broken)
    for pkg in ("port", "jax"):
        with pytest.raises(raised):
            _post(pkg, post_root).load_sequence("test")


# --------------------------------------------------------------------------
# colour
def test_bgr_to_hsv_equals_cv2_on_every_triple():
    every = np.arange(1 << 24, dtype=np.uint32)
    for chunk in np.split(every, 8):
        img = np.stack([(chunk >> 16) & 255, (chunk >> 8) & 255,
                        chunk & 255], -1).astype(np.uint8).reshape(
                            1024, -1, 3)
        got = bgr_to_hsv(img)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(
            got, cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    assert bgr_to_hsv(img)[..., 0].max() < 180
    with pytest.raises(ValueError, match="uint8"):
        bgr_to_hsv(img.astype(np.uint16))


def _png_kinds(rs):
    """name -> (array as cv2 writes it, or None, PNG color type, depth)."""
    return {
        "rgb8": rs.randint(0, 256, (19, 23, 3)).astype(np.uint8),
        "rgba8": rs.randint(0, 256, (19, 23, 4)).astype(np.uint8),
        "gray8": rs.randint(0, 256, (19, 23)).astype(np.uint8),
        "gray16": rs.randint(0, 65536, (19, 23)).astype(np.uint16),
        "rgb16": rs.randint(0, 65536, (19, 23, 3)).astype(np.uint16),
        "rgba16": rs.randint(0, 65536, (19, 23, 4)).astype(np.uint16),
    }


def test_imread_color_equals_cv2(tmp_path):
    rs = np.random.RandomState(5)
    for name, arr in _png_kinds(rs).items():
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, arr)
        got = imread_color(path)
        assert got.dtype == np.uint8 and got.shape == arr.shape[:2] + (3,)
        np.testing.assert_array_equal(got, cv2.imread(path, 1),
                                      err_msg=name)
    # gray + alpha, which cv2 cannot write
    ga = rs.randint(0, 256, (9, 14, 2)).astype(np.uint8)
    path = tmp_path / "ga.png"
    path.write_bytes(encode_png(ga, 4, 8, np.arange(9) % 5))
    np.testing.assert_array_equal(imread_color(str(path)),
                                  cv2.imread(str(path), 1))


def test_in_range_equals_cv2():
    rs = np.random.RandomState(6)
    img = rs.randint(0, 256, (60, 70, 3)).astype(np.uint8)
    for lo, hi in (((169, 150, 150), (189, 255, 255)),
                   ((0, 0, 0), (255, 255, 255)), ((10, 20, 30), (9, 40, 50)),
                   ((100, 0, 50), (200, 128, 255))):
        lo, hi = np.array(lo, np.uint8), np.array(hi, np.uint8)
        got = in_range(img, lo, hi)
        assert got.dtype == np.uint8 and got.shape == img.shape[:2]
        np.testing.assert_array_equal(got, cv2.inRange(img, lo, hi))
