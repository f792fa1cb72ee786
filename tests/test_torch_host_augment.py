"""The port's per-sample host augment, its datasets and its host and native
loaders against the JAX package's (and cv2's), bit for bit.

1. The numpy warps of ``data/detector.py`` against ``cv2.warpAffine`` /
   ``cv2.warpPerspective`` (``INTER_NEAREST``, ``BORDER_CONSTANT``) and
   ``cv2.getRotationMatrix2D``: random rotations and perspectives, the
   matrices ``augment_crop`` itself makes in all four modes, and
   coordinates on half pixels and on the border.
2. ``recrop_hand``, ``move_com``, ``rotate_hand``, ``scale_hand`` and
   ``augment_crop`` against the JAX ``HandDetector`` and ``augment_crop``
   over hundreds of draws, the RandomState left behind included, and
   ``augment_crop`` against ``tests/golden/preproc_golden.npz``.
3. The four real datasets over the NYU and ICVL mini-datasets of
   ``tests/test_torch_importers.py``, item for item in every mode, and an
   epoch of ``get_data_loader`` batches under ``host`` (the default) and
   ``native`` against the JAX loader's.
4. The port's build of the native library (into a temporary directory)
   against the JAX package's library, bit for bit, and its disagreement
   with the device augment: sparse boundary flips, as
   ``tests/test_fast_augment.py`` bounds the JAX package's.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from test_torch_importers import write_icvl, write_nyu

from lsps_tpu.data import augment as jaug
from lsps_tpu.data import detector as jdet
from lsps_tpu.data import loader as jloader
from lsps_tpu_torch.data import augment as paug
from lsps_tpu_torch.data import detector as pdet
from lsps_tpu_torch.data import loader as ploader
from lsps_tpu_torch.data.synthetic import SyntheticImporter

import lsps_tpu.data.datasets  # noqa: F401 (registration)

torch.set_num_threads(1)

ALL_MODES = ["none", "com", "rot", "sc"]
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _tree_equal(a, b, what):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            if x is None:
                assert y is None, what
                continue
            _tree_equal(x, y, f"{what}[{i}]")
    else:
        _equal(a, b, what)


def _cv2_affine(src, M, dsize, border=0.0):
    return cv2.warpAffine(src, M, dsize, flags=cv2.INTER_NEAREST,
                          borderMode=cv2.BORDER_CONSTANT,
                          borderValue=border)


def _cv2_perspective(src, M, dsize, border=0.0):
    return cv2.warpPerspective(src, M, dsize, flags=cv2.INTER_NEAREST,
                               borderMode=cv2.BORDER_CONSTANT,
                               borderValue=float(border))


# ---------------------------------------------------------------------------
# 1. the numpy warps against cv2
# ---------------------------------------------------------------------------

def test_rotation_matrix_is_cv2s():
    rs = np.random.RandomState(0)
    for _ in range(500):
        center = (int(rs.randint(0, 200)), int(rs.randint(0, 200)))
        angle, scale = rs.uniform(-360, 360), rs.choice([1, 0.5, 1.3])
        _equal(pdet.rotation_matrix_2d(center, angle, scale),
               cv2.getRotationMatrix2D(center, angle, scale), "rotation")


def test_affine_warp_is_cv2_over_random_rotations():
    rs = np.random.RandomState(1)
    for _ in range(300):
        src = rs.uniform(1, 1000, (128, 128)).astype(np.float32)
        M = cv2.getRotationMatrix2D((64, 64), -rs.uniform(0, 360), 1)
        _equal(pdet.warp_affine_nearest(src, M, (128, 128)),
               _cv2_affine(src, M, (128, 128)), "rotation warp")


def test_perspective_warp_is_cv2_over_random_matrices():
    rs = np.random.RandomState(2)
    spread = np.array([[0.1, 0.1, 5], [0.1, 0.1, 5], [1e-4, 1e-4, 0.01]])
    for _ in range(300):
        src = rs.uniform(1, 1000, (128, 128)).astype(np.float32)
        M = np.eye(3) + rs.randn(3, 3) * spread
        _equal(pdet.warp_perspective_nearest(src, M, (128, 128)),
               _cv2_perspective(src, M, (128, 128)), "perspective warp")


def test_warps_are_cv2_on_half_pixels_and_at_the_border():
    """Scales of 1/2, 3/2 and 2 and offsets of k/2 put source coordinates
    exactly on half pixels (a tie cv2 rounds to even) and on -0.5 and
    size - 0.5, the first and last pixels a border test keeps."""
    rs = np.random.RandomState(3)
    src = rs.uniform(1, 1000, (128, 128)).astype(np.float32)
    n = 0
    for s in (0.5, 1.0, 1.5, 2.0):
        for tx in np.arange(-3, 3.5, 0.5):
            for ty in (-0.5, 0.0, 0.5, 127.5):
                M = np.array([[s, 0, tx], [0, s, ty], [0, 0, 1.0]])
                got = pdet.warp_perspective_nearest(src, M, (128, 128), 7.0)
                _equal(got, _cv2_perspective(src, M, (128, 128), 7.0),
                       f"perspective s={s} t=({tx}, {ty})")
                got = pdet.warp_affine_nearest(src, M[:2], (128, 128), 7.0)
                _equal(got, _cv2_affine(src, M[:2], (128, 128), 7.0),
                       f"affine s={s} t=({tx}, {ty})")
                n += 1
    assert n == 4 * 13 * 4


@pytest.fixture(scope="module")
def synth():
    """24 synthetic crops (NYU camera) and the first one normalized, from
    which the detectors are made."""
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


def test_warps_are_cv2_on_the_augments_own_matrices(monkeypatch, synth):
    """Every warp ``augment_crop`` makes over 240 draws of all four modes
    (the perspective re-crops of com and sc, the rotations of rot), each
    held against cv2 on the same crop and matrix."""
    seen = {"perspective": 0, "affine": 0}

    def checked(name, ours, theirs):
        def warp(src, M, dsize, border=0.0):
            got = ours(src, M, dsize, border)
            _equal(got, theirs(src, M, tuple(dsize), border), name)
            seen[name] += 1
            return got
        return warp

    monkeypatch.setattr(pdet, "warp_perspective_nearest", checked(
        "perspective", pdet.warp_perspective_nearest, _cv2_perspective))
    monkeypatch.setattr(pdet, "warp_affine_nearest", checked(
        "affine", pdet.warp_affine_nearest, _cv2_affine))
    imp, seq, img0 = synth
    hd = pdet.HandDetector(img0, abs(imp.fx), abs(imp.fy), importer=imp)
    rng = np.random.RandomState(9)
    for k in range(240):
        paug.augment_crop(*_draw_inputs(imp, seq, k), ALL_MODES, hd,
                          rng=rng)
    assert seen["perspective"] > 80 and seen["affine"] > 40, seen


# ---------------------------------------------------------------------------
# 2. the detector's augment methods and augment_crop against JAX
# ---------------------------------------------------------------------------

def _detectors(synth):
    imp, seq, img0 = synth
    return (imp, seq,
            pdet.HandDetector(img0, abs(imp.fx), abs(imp.fy), importer=imp),
            jdet.HandDetector(img0, abs(imp.fx), abs(imp.fy), importer=imp))


@pytest.mark.parametrize("method", ["recrop_hand", "move_com",
                                    "rotate_hand", "scale_hand"])
def test_detector_augment_methods_match_jax(method, synth):
    imp, seq, phd, jhd = _detectors(synth)
    rs = np.random.RandomState(4)
    for k in range(60):
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
        got = getattr(phd, method)(*[np.copy(a) if isinstance(a, np.ndarray)
                                     else a for a in args], **kw)
        want = getattr(jhd, method)(*[np.copy(a) if isinstance(a, np.ndarray)
                                      else a for a in args], **kw)
        _tree_equal(got, want, f"{method} draw {k}")


@pytest.mark.parametrize("modes", [ALL_MODES, ["com"], ["rot"], ["sc"]],
                         ids=["all", "com", "rot", "sc"])
def test_augment_crop_matches_jax(modes, synth):
    """Hundreds of draws on one RandomState per package: every output
    equal, and the states left behind equal."""
    imp, seq, phd, jhd = _detectors(synth)
    rp, rj = np.random.RandomState(5), np.random.RandomState(5)
    draws = 240 if modes == ALL_MODES else 60
    for k in range(draws):
        inputs = _draw_inputs(imp, seq, k)
        got = paug.augment_crop(*[np.copy(x) for x in inputs], modes, phd,
                                rng=rp)
        want = jaug.augment_crop(*[np.copy(x) for x in inputs], modes, jhd,
                                 rng=rj)
        _tree_equal(got, want, f"{modes} draw {k}")
    _equal(rp.get_state()[1], rj.get_state()[1], "RandomState")
    assert rp.get_state()[2:] == rj.get_state()[2:]


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(os.path.join(GOLDEN_DIR, "preproc_golden.npz")))


@pytest.fixture(scope="module")
def golden_inputs():
    """The inputs of ``tests/golden/gen_golden_preproc.py``, cropped by
    the port's detector."""
    from lsps_tpu_torch.data.camera import Camera

    sys.path.insert(0, GOLDEN_DIR)
    try:
        import gen_golden_preproc as gen
    finally:
        sys.path.pop(0)
    dpt = gen.synth_depth()
    hd = pdet.HandDetector(dpt, gen.FX, gen.FY, importer=Camera.nyu())
    crop, m, com = hd.crop_area_3d(com=np.array([160.0, 120.0, 800.0]),
                                   size=(250, 250, 250), dsize=(128, 128))
    cube = np.array([250.0, 250.0, 250.0], np.float32)
    return hd, paug.normalize(crop.copy(), com, cube), m, com, cube


@pytest.mark.parametrize("mode", ALL_MODES)
def test_augment_crop_matches_the_golden_file(golden, golden_inputs, mode):
    hd, norm, m, com, cube = golden_inputs
    _equal(norm, golden["norm"], "normalized crop")
    rng = np.random.RandomState(23455 + len(mode))
    img, _, label, cube_o, com_o, m_o, rot = paug.augment_crop(
        norm.copy(), golden["gt3d"], com.astype(np.float32), cube.copy(),
        m.astype(np.float32), [mode], hd, rng=rng)
    for field, got in (("img", img), ("label", label), ("cube", cube_o),
                       ("com", com_o), ("M", m_o), ("rot", np.float64(rot))):
        _equal(got, golden[f"aug_{mode}_{field}"], f"aug {mode} {field}")


# ---------------------------------------------------------------------------
# 3. the four datasets and the loaders over the mini-datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("realdata")
    return {"nyu": write_nyu(str(base / "nyu"), n_train=9, n_test=4),
            "icvl": write_icvl(str(base / "icvl"), n_train=9, n_test=3),
            "cache": str(base)}


def _spec(roots, kind, class_name, subset, **extra):
    spec = {"seed": 23455, "class_name": class_name, "root": roots[kind],
            "subset": subset, "sample_poses": 0, "augment": False,
            "docom": False, "joint_subset": ""}
    spec.update(extra)
    return spec


def _pair(roots, spec):
    """The port's and the JAX package's dataset, each with its own cache
    (so that each imports the frames itself)."""
    p = ploader.get_dataset(dict(spec, cacheDir=os.path.join(
        roots["cache"], "port")))
    j = jloader.get_dataset(dict(spec, cacheDir=os.path.join(
        roots["cache"], "jax")))
    return p, j


def _items_equal(p, j, what, passes=2):
    assert len(p) == len(j), what
    for rep in range(passes):
        for i in range(len(p)):
            _tree_equal(p[i], j[i], f"{what} pass {rep} item {i}")
    _equal(p.rng.get_state()[1], j.rng.get_state()[1], f"{what} rng")


DATASETS = {
    "nyu_train_synth": ("nyu", "dataset_hand_NYU", "train_synth", "NYU"),
    "nyu_train": ("nyu", "dataset_hand_NYU", "train", "NYU"),
    "nyu_msra": ("nyu", "dataset_hand_NYU", "train", "MSRA"),
    "nyu_icvl_synth": ("nyu", "dataset_hand_NYU", "train_synth", "ICVL"),
    "icvl_train": ("icvl", "dataset_hand_ICVL", "train", "ICVL"),
}


@pytest.mark.parametrize("augment", [True, False], ids=["aug", "noaug"])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_training_datasets_match_jax_item_for_item(roots, name, augment):
    kind, cls, subset, js = DATASETS[name]
    p, j = _pair(roots, _spec(roots, kind, cls, subset, augment=augment,
                              joint_subset=js))
    _items_equal(p, j, f"{name} augment={augment}")
    # pose-only over the crops' labels
    p.pose_only = j.pose_only = True
    _items_equal(p, j, f"{name} pose_only", passes=1)


@pytest.mark.parametrize("name", ["nyu_train", "nyu_icvl_synth",
                                  "icvl_train"])
def test_sampled_poses_and_nmax_match_jax(roots, name):
    kind, cls, subset, js = DATASETS[name]
    p, j = _pair(roots, _spec(roots, kind, cls, subset, augment=True,
                              joint_subset=js, sample_poses=50))
    p.set_nmax(0.5)
    j.set_nmax(0.5)
    assert len(p) == len(j)
    p.sample_poses()
    j.sample_poses()
    _equal(p.sampled_poses, j.sampled_poses, "sampled poses")
    p.pose_only = j.pose_only = True
    assert len(p) == len(j) == 50
    _items_equal(p, j, f"{name} sampled poses", passes=1)
    # back to images: the augmented stream continues alike
    p.pose_only = j.pose_only = False
    p.sampled_poses = j.sampled_poses = None
    p.num = j.num = len(p.seq)
    p.nmax = j.nmax = np.inf
    _items_equal(p, j, f"{name} after sampling", passes=1)


@pytest.mark.parametrize("name,kind,cls,subset", [
    ("nyu_test", "nyu", "dataset_hand_NYU_test", "test"),
    ("icvl_test", "icvl", "dataset_hand_ICVL_test", "test_seq_1")])
def test_test_datasets_match_jax(roots, name, kind, cls, subset):
    p, j = _pair(roots, _spec(roots, kind, cls, subset))
    assert len(p) == len(j) == (3 if kind == "nyu" else 6)
    _items_equal(p, j, name, passes=1)


def test_datasets_take_cache_dir_as_well_as_cacheDir(roots, tmp_path):
    spec = _spec(roots, "icvl", "dataset_hand_ICVL_test", "test_seq_1",
                 cache_dir=str(tmp_path / "c"))
    ds = ploader.get_dataset(spec)
    assert len(ds) == 6
    assert len(os.listdir(tmp_path / "c")) == 2


@pytest.mark.parametrize("backend", ["host", "native"])
@pytest.mark.parametrize("name", ["nyu_train", "icvl_train"])
def test_loader_epochs_match_jax(roots, name, backend, monkeypatch,
                                 native_build):
    """Two epochs of the training loader (the final short batch
    included) and the test loader, under ``LSPS_AUGMENT`` unset (host)
    and ``native``, batch for batch against the JAX loader."""
    if backend == "host":
        monkeypatch.delenv("LSPS_AUGMENT", raising=False)
        monkeypatch.delenv("LSPS_NATIVE", raising=False)
    else:
        monkeypatch.setenv("LSPS_AUGMENT", "native")
    kind, cls, subset, js = DATASETS[name]
    p, j = _pair(roots, _spec(roots, kind, cls, subset, augment=True,
                              joint_subset=js))
    lp = ploader.get_data_loader(p, 3, shuffle=True, seed=7)
    lj = jloader.get_data_loader(j, 3, shuffle=True, seed=7)
    assert (lp.fast, lp.raw) == (lj.fast, lj.raw) == (backend == "native",
                                                      False)
    for ep in range(2):
        bp, bj = list(lp), list(lj)
        assert len(bp) == len(bj) >= 2
        for b, (x, y) in enumerate(zip(bp, bj)):
            _tree_equal(x, y, f"{name} {backend} epoch {ep} batch {b}")
    test_cls = "dataset_hand_NYU_test" if kind == "nyu" else \
        "dataset_hand_ICVL_test"
    tp, tj = _pair(roots, _spec(roots, kind, test_cls,
                                "test" if kind == "nyu" else "test_seq_1"))
    for x, y in zip(ploader.get_data_loader(tp, 4, shuffle=False),
                    jloader.get_data_loader(tj, 4, shuffle=False)):
        _tree_equal(x, y, f"{name} test batch")


# ---------------------------------------------------------------------------
# 4. the native library
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def native_build(tmp_path_factory):
    """The port's library built into a temporary directory, which the
    package then loads for this module's tests."""
    from lsps_tpu_torch import native

    build_dir = tmp_path_factory.mktemp("native_build")
    path = native.build(build_dir)
    assert path.parent == build_dir and path.is_file()
    old = native.BUILD_DIR
    native.BUILD_DIR = build_dir
    yield path
    native.BUILD_DIR = old


def _synthetic_raw(n_frames=48):
    from lsps_tpu_torch.data.fast_augment import FastAugmenter

    spec = {"seed": 23455, "root": "", "subset": "train", "docom": False,
            "augment": True, "sample_poses": 0, "joint_subset": "NYU",
            "n_frames": n_frames, "n_joints": 36,
            "class_name": "dataset_hand_synth"}
    ds = ploader.get_dataset(spec)
    raw = FastAugmenter(ds, "step").raw_batch(list(range(n_frames)) * 2)[0]
    from lsps_tpu_torch.data.basetypes import decode_dpt_u16

    if len(raw) == 8:
        raw = (decode_dpt_u16(raw[0], raw[7]),) + raw[1:7]
    return raw


def test_native_is_the_jax_native_library_bit_for_bit(native_build):
    from lsps_tpu import native as jnative
    from lsps_tpu_torch import native as pnative

    assert pnative.available() and jnative.available()
    from lsps_tpu_torch.data import fast_augment

    assert fast_augment.available("native")
    raw = _synthetic_raw()
    _equal(pnative.fused_recrop_normalize_batch(*raw),
           jnative.fused_recrop_normalize_batch(*raw), "fused batch")
    # a tie at every pixel: the source coordinates of a half-pixel shift
    shift = np.tile(np.array([[1, 0, 0.5], [0, 1, -0.5], [0, 0, 1.0]]),
                    (len(raw[0]), 1, 1))
    tied = (raw[0], shift) + raw[2:]
    _equal(pnative.fused_recrop_normalize_batch(*tied),
           jnative.fused_recrop_normalize_batch(*tied), "half-pixel ties")


def test_native_and_device_augment_differ_only_by_sparse_boundary_flips(
        native_build):
    """The port's native backend against its device augment (on the CPU)
    on the same warp parameters: the JAX package's bound on its own two
    backends (``tests/test_fast_augment.py``)."""
    from lsps_tpu_torch import native as pnative

    raw = _synthetic_raw()
    imgs_n = pnative.fused_recrop_normalize_batch(*raw)
    imgs_d = paug.recrop_normalize_batch(*raw).numpy()
    d = imgs_n - imgs_d
    nz = d != 0
    assert nz.mean() < 1e-3, f"{nz.mean():.2%} pixels differ"
    if nz.any():
        assert np.median(np.abs(d[nz])) > 0.1


def test_a_failed_native_build_raises(monkeypatch, tmp_path):
    from lsps_tpu_torch import native

    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(RuntimeError, match="failed"):
        native.build(tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    assert not native.available()


def test_native_builds_without_openmp_where_the_compiler_lacks_it(
        monkeypatch, tmp_path, native_build):
    """A compiler without an OpenMP runtime (it refuses ``-fopenmp``)
    builds the library without it, with the same results."""
    import shutil

    from lsps_tpu_torch import native

    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\nfor a in \"$@\"; do [ \"$a\" = -fopenmp ] "
                   f"&& exit 1; done\nexec {shutil.which('g++')} \"$@\"\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    path = native.build(tmp_path / "b")
    assert native.BUILT_FLAGS[path] == native.FLAGS
    raw = _synthetic_raw(n_frames=8)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    one_thread = native.fused_recrop_normalize_batch(*raw)
    monkeypatch.setattr(native, "BUILD_DIR", native_build.parent)
    _equal(one_thread, native.fused_recrop_normalize_batch(*raw),
           "with and without OpenMP")
