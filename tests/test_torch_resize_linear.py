"""The port's linear resizes and warps against cv2 5 and the JAX package.

``lsps_tpu_torch.data.detector`` reproduces ``cv2.resize(..., INTER_LINEAR)``
and ``cv2.warpAffine`` / ``cv2.warpPerspective`` with ``INTER_LINEAR`` and
``BORDER_CONSTANT`` in numpy, and carries its own copy of the JAX
package's ND-aware ``bilinear_resize``.  Every check here is bit for bit:

1. ``resize_linear`` against ``cv2.resize`` over random float32 crops
   with holes, at random sizes and at widths 128, 127, 131 and 45;
2. ``bilinear_resize`` against ``lsps_tpu``'s over crops with ND holes
   (0 and 32000 as the ND value);
3. the linear warps against cv2 over random rotations, shifted rotations
   and perspectives, at the same widths, border values 0, 32000 and 7.5;
4. the warps ``augment_crop`` makes under ``RESIZE_CV2_LINEAR`` against
   cv2, and the detector's augment methods under each linear method
   against the JAX ``HandDetector`` (which calls cv2);
5. ``crop_area_3d`` and ``apply_crop_3d`` under each of the three
   methods against the JAX ``HandDetector`` on rendered frames, and the
   nearest path unchanged by the new attribute.
"""

import numpy as np
import pytest
import torch

from lsps_tpu.data import detector as jdet
from lsps_tpu.data.camera import Camera as JCamera
from lsps_tpu.data.synthetic import render_hand_depth
from lsps_tpu_torch.data import augment as paug
from lsps_tpu_torch.data import detector as pdet
from lsps_tpu_torch.data.synthetic import SyntheticImporter

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)

WIDTHS = (128, 127, 131, 45)
BORDERS = (0.0, 32000.0, 7.5)
METHODS = {"bilinear": pdet.HandDetector.RESIZE_BILINEAR,
           "cv2_nn": pdet.HandDetector.RESIZE_CV2_NN,
           "cv2_linear": pdet.HandDetector.RESIZE_CV2_LINEAR}


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _tree_equal(a, b, what):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{what}[{i}]")
    else:
        _equal(a, b, what)


def _crop(rs, h, w, nd=0.0, holes=0.3, whole_mm=False):
    src = (rs.rand(h, w) * 1000 + 300).astype(np.float32)
    if whole_mm:
        src = np.round(src)
    src[rs.rand(h, w) < holes] = nd
    return src


# ---------------------------------------------------------------------------
# 1. cv2.resize(..., INTER_LINEAR)
# ---------------------------------------------------------------------------

def test_resize_linear_is_cv2s_over_random_sizes():
    for trial in range(400):
        rs = np.random.RandomState(trial)
        h, w = rs.randint(2, 320, 2)
        W = int(rs.choice(list(WIDTHS) + [rs.randint(2, 200)]))
        H = int(rs.choice(list(WIDTHS) + [rs.randint(2, 200)]))
        src = _crop(rs, h, w, whole_mm=trial % 3 == 0)
        _equal(pdet.resize_linear(src, (W, H)),
               cv2.resize(src, (W, H), interpolation=cv2.INTER_LINEAR),
               f"trial {trial}: {(h, w)} -> {(H, W)}")


def test_resize_linear_refuses_what_it_does_not_reproduce():
    with pytest.raises(ValueError, match="float32"):
        pdet.resize_linear(np.zeros((8, 8), np.uint16), (4, 4))
    with pytest.raises(ValueError, match="below 2"):
        pdet.resize_linear(np.zeros((1, 8), np.float32), (4, 4))


# ---------------------------------------------------------------------------
# 2. the ND-aware bilinear resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd", [0.0, 32000.0])
def test_bilinear_resize_is_jaxs(nd):
    for trial in range(60):
        rs = np.random.RandomState(100 + trial)
        h, w = rs.randint(3, 260, 2)
        W = int(rs.choice(list(WIDTHS) + [rs.randint(2, 160)]))
        H = int(rs.choice(list(WIDTHS) + [rs.randint(2, 160)]))
        src = _crop(rs, h, w, nd=nd, holes=[0.0, 0.2, 0.6][trial % 3])
        _equal(pdet.HandDetector.bilinear_resize(src, (W, H), nd),
               jdet.HandDetector.bilinear_resize(src, (W, H), nd),
               f"trial {trial}: {(h, w)} -> {(H, W)}")


# ---------------------------------------------------------------------------
# 3. the linear warps
# ---------------------------------------------------------------------------

def _cv2_affine(src, M, dsize, border=0.0):
    return cv2.warpAffine(src, M, tuple(dsize), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT,
                          borderValue=float(border))


def _cv2_perspective(src, M, dsize, border=0.0):
    return cv2.warpPerspective(src, M, tuple(dsize), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_CONSTANT,
                               borderValue=float(border))


@pytest.mark.parametrize("n", WIDTHS)
def test_affine_linear_is_cv2s_over_random_rotations(n):
    for trial in range(60):
        rs = np.random.RandomState(trial)
        src = _crop(rs, n, n)
        M = pdet.rotation_matrix_2d((n // 2, n // 2),
                                    rs.uniform(-180, 180), 1.0)
        if trial % 3 == 0:
            M[:, 2] += rs.uniform(-40, 40, 2)
        border = BORDERS[trial % 3]
        _equal(pdet.warp_affine_linear(src, M, (n, n), border),
               _cv2_affine(src, M, (n, n), border), f"{n} trial {trial}")


@pytest.mark.parametrize("n", WIDTHS)
def test_perspective_linear_is_cv2s_over_random_matrices(n):
    for trial in range(60):
        rs = np.random.RandomState(trial)
        src = _crop(rs, n, n)
        M = np.eye(3) + rs.uniform(-0.1, 0.1, (3, 3))
        M[2, :2] *= 0.01
        M[:2, 2] = rs.uniform(-10, 10, 2)
        border = BORDERS[trial % 3]
        _equal(pdet.warp_perspective_linear(src, M, (n, n), border),
               _cv2_perspective(src, M, (n, n), border), f"{n} trial {trial}")


# ---------------------------------------------------------------------------
# 4. the augment's own warps, and the detector's augment methods vs JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth():
    imp = SyntheticImporter(n_frames=24, seed=3)
    seq = imp.load_sequence("train")
    img0 = paug.normalize(seq.dpt_mm(0), seq.com[0], seq.cube)
    return imp, seq, img0


def _draw_inputs(imp, seq, k):
    i = k % len(seq)
    com = seq.com[i]
    img = paug.normalize(seq.dpt_mm(i), com, seq.cube)
    return (img, seq.gt3Dcrop[i], imp.joint_3d_to_img(com), seq.cube,
            seq.M[i])


def test_linear_warps_are_cv2_on_the_augments_own_matrices(monkeypatch,
                                                           synth):
    seen = {"perspective": 0, "affine": 0}

    def checked(name, ours, theirs):
        def warp(src, M, dsize, border=0.0):
            got = ours(src, M, dsize, border)
            _equal(got, theirs(src, M, dsize, border), name)
            seen[name] += 1
            return got
        return warp

    monkeypatch.setattr(pdet, "warp_perspective_linear", checked(
        "perspective", pdet.warp_perspective_linear, _cv2_perspective))
    monkeypatch.setattr(pdet, "warp_affine_linear", checked(
        "affine", pdet.warp_affine_linear, _cv2_affine))
    imp, seq, img0 = synth
    hd = pdet.HandDetector(img0, abs(imp.fx), abs(imp.fy), importer=imp)
    hd.resize_method = hd.RESIZE_CV2_LINEAR
    rng = np.random.RandomState(9)
    for k in range(120):
        paug.augment_crop(*_draw_inputs(imp, seq, k),
                          ["none", "com", "rot", "sc"], hd, rng=rng)
    assert seen["perspective"] > 40 and seen["affine"] > 20, seen


@pytest.mark.parametrize("method", ["recrop_hand", "move_com",
                                    "rotate_hand", "scale_hand"])
@pytest.mark.parametrize("resize", ["bilinear", "cv2_linear"])
def test_detector_augment_methods_match_jax_under_linear(method, resize,
                                                         synth):
    imp, seq, img0 = synth
    phd = pdet.HandDetector(img0, abs(imp.fx), abs(imp.fy), importer=imp)
    jhd = jdet.HandDetector(img0, abs(imp.fx), abs(imp.fy), importer=imp)
    phd.resize_method = jhd.resize_method = METHODS[resize]
    rs = np.random.RandomState(4)
    for k in range(30):
        img, gt3d, com2d, cube, M = _draw_inputs(imp, seq, k)
        mm = paug.denormalize(img, com2d, cube).astype(np.float32)
        if method == "recrop_hand":
            new_com = com2d + np.r_[rs.randn(2) * 4, rs.randn() * 15]
            Mnew = phd.com_to_transform(new_com, cube, mm.shape)
            args = (mm, Mnew, np.linalg.inv(M), mm.shape)
            kw = dict(background_value=0, nv_val=32000.0, thresh_z=True,
                      com=new_com, size=cube)
        elif method == "move_com":
            args = (mm, cube, com2d, rs.randn(3) * 10.0, gt3d, M)
            kw = {}
        elif method == "rotate_hand":
            args = (mm, cube, com2d, rs.uniform(-180, 180), gt3d)
            kw = {}
        else:
            args = (mm, cube, com2d, abs(1 + rs.randn() * 0.05), gt3d, M)
            kw = {}
        copy = [np.copy(a) if isinstance(a, np.ndarray) else a
                for a in args]
        got = getattr(phd, method)(*copy, **kw)
        copy = [np.copy(a) if isinstance(a, np.ndarray) else a
                for a in args]
        want = getattr(jhd, method)(*copy, **kw)
        _tree_equal(got, want, f"{method} {resize} draw {k}")


# ---------------------------------------------------------------------------
# 5. crop_area_3d and apply_crop_3d under each method
# ---------------------------------------------------------------------------

def _frames():
    cams = [JCamera.nyu(), JCamera.icvl()]
    out = []
    for i in range(6):
        cam = cams[i % 2]
        rs = np.random.RandomState(i)
        z = 420.0 + 70.0 * i if i % 2 else 650.0 + 60.0 * i
        com3d = np.asarray([30.0 * i - 80.0, 12.0 * i - 30.0, z],
                           np.float32)
        dpt = render_hand_depth(cam, com3d, 36, rs)[0].astype(np.float32)
        if i == 4:
            dpt[dpt == 0] = 32001.0    # a far background: ND value 32001
        out.append((cam, dpt))
    return out


@pytest.mark.parametrize("resize", sorted(METHODS))
def test_crop_area_3d_matches_jax_under_each_method(resize):
    for i, (cam, dpt) in enumerate(_frames()):
        phd = pdet.HandDetector(dpt, cam.fx, cam.fy)
        jhd = jdet.HandDetector(dpt, cam.fx, cam.fy)
        phd.resize_method = jhd.resize_method = METHODS[resize]
        for size in ((250, 250, 250), (300, 300, 300), (200, 260, 240)):
            for docom in (False, True):
                _tree_equal(phd.crop_area_3d(size=size, docom=docom),
                            jhd.crop_area_3d(size=size, docom=docom),
                            f"frame {i} {size} docom={docom}")
        com = jhd.calculate_com(dpt)
        _equal(phd.apply_crop_3d(dpt, com, (250, 250, 250), (128, 128)),
               jhd.apply_crop_3d(dpt, com, (250, 250, 250), (128, 128)),
               f"frame {i} apply_crop_3d")


def test_the_default_method_is_nearest_and_unchanged():
    cam, dpt = _frames()[0]
    hd = pdet.HandDetector(dpt, cam.fx, cam.fy)
    assert hd.resize_method == hd.RESIZE_CV2_NN
    crop, M, com = hd.crop_area_3d()
    xs, xe, ys, ye, zs, ze = hd.com_to_bounds(com, (250, 250, 250))
    cropped = hd.get_crop(hd.dpt, xs, xe, ys, ye, zs, ze)
    wb, hb = xe - xs, ye - ys
    sz = (128, hb * 128 // wb) if wb > hb else (wb * 128 // hb, 128)
    _equal(hd.resize_crop(cropped, sz), pdet.resize_nearest(cropped, sz),
           "nearest")
    hd.resize_method = 7
    with pytest.raises(NotImplementedError):
        hd.resize_crop(cropped, sz)
