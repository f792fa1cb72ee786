"""The port's host data pipeline against the JAX package's, bit for bit.

``lsps_tpu_torch.data`` (transformations, camera in numpy, the cv2-free
``HandDetector``, the synthetic importer and dataset, ``FastAugmenter``'s
raw batches, the loader) against ``lsps_tpu.data`` on the same seeds, and
the port's nearest-neighbour resize against ``cv2.resize`` itself.
"""

import numpy as np
import pytest
import torch

import cv2

from lsps_tpu.data import camera as jcam
from lsps_tpu.data import detector as jdet
from lsps_tpu.data import loader as jloader
from lsps_tpu.data import transformations as jtr
import lsps_tpu.data.synthetic as jsyn
from lsps_tpu_torch.data import camera as pcam
from lsps_tpu_torch.data import detector as pdet
from lsps_tpu_torch.data import loader as ploader
from lsps_tpu_torch.data import transformations as ptr
import lsps_tpu_torch.data.synthetic as psyn

torch.set_num_threads(1)

SPEC = {"seed": 23455, "root": "", "subset": "train", "docom": False,
        "augment": True, "sample_poses": 60, "joint_subset": "NYU",
        "n_frames": 10, "n_joints": 36, "class_name": "dataset_hand_synth"}


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _tree_equal(a, b, what):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{what}[{i}]")
    else:
        _equal(a, b, what)


# ---------------------------------------------------------------------------
# the nearest-neighbour resize against cv2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.float64])
def test_resize_nearest_is_cv2_inter_nearest(dtype):
    """Source index min(floor(d * (1 / (dst / src))), src - 1) over a grid
    of source and destination sizes, odd and non-square included; the
    plain ratio src / dst picks other pixels for some of them."""
    rs = np.random.RandomState(0)
    n = 0
    for sh in (1, 2, 3, 7, 31, 64, 97, 128, 161, 200, 251):
        for sw in (1, 5, 33, 90, 127, 130, 199, 256):
            src = rs.uniform(0, 3000, (sh, sw)).astype(dtype)
            for h in (1, 3, 37, 64, 100, 127, 128, 150):
                for w in (1, 11, 64, 99, 128, 131):
                    want = cv2.resize(src, (w, h),
                                      interpolation=cv2.INTER_NEAREST)
                    got = pdet.resize_nearest(src, (w, h))
                    np.testing.assert_array_equal(got, want.reshape(got.shape),
                                                  err_msg=f"{(sh, sw)} -> "
                                                  f"{(h, w)}")
                    n += 1
    assert n == 11 * 8 * 8 * 6


def test_resize_nearest_index_rule_differs_from_plain_ratio():
    """Guard on the trap: at some sizes floor(d * src / dst) is not the
    index cv2 reads, and the port follows cv2."""
    differs = 0
    for src in range(1, 300):
        for dst in (64, 100, 127, 128):
            plain = np.minimum(np.floor(np.arange(dst) * (src / dst)),
                               src - 1).astype(np.int64)
            differs += not np.array_equal(plain,
                                          pdet.nearest_indices(src, dst))
    assert differs > 0


# ---------------------------------------------------------------------------
# transformations and the camera's numpy path
# ---------------------------------------------------------------------------

def test_transformations_and_camera_numpy_match_jax():
    rs = np.random.RandomState(1)
    pts = rs.uniform(-200, 600, (40, 3)).astype(np.float32)
    M = rs.uniform(-2, 2, (3, 3))
    _equal(ptr.transform_points_2d(pts, M), jtr.transform_points_2d(pts, M),
           "transform_points_2d")
    _equal(ptr.rotate_points_2d(pts[:, :2], pts[0, :2], 33.0),
           jtr.rotate_points_2d(pts[:, :2], pts[0, :2], 33.0),
           "rotate_points_2d")
    _equal(ptr.rotate_points_3d(pts, pts[0], 10.0, -20.0, 30.0),
           jtr.rotate_points_3d(pts, pts[0], 10.0, -20.0, 30.0),
           "rotate_points_3d")
    for name in ("nyu", "icvl", "msra", "post"):
        pc, jc = getattr(pcam.Camera, name)(), getattr(jcam.Camera, name)()
        for dt in (np.float32, np.float64):
            xyz = rs.uniform(-150, 150, (50, 3)).astype(dt)
            xyz[:, 2] = rs.uniform(500, 900, 50)
            xyz[3, 2] = 0.0
            _equal(pc.to_img(xyz), jc.to_img(xyz), f"{name} to_img {dt}")
            uvd = pc.to_img(xyz)
            _equal(pc.img_to_3d(uvd), jc.img_to_3d(uvd),
                   f"{name} img_to_3d {dt}")
        np.testing.assert_array_equal(pc.intrinsics(), jc.intrinsics())
        np.testing.assert_array_equal(pc.projection(), jc.projection())
    crop = np.where(rs.uniform(0, 1, (20, 24)) < 0.5, 0.0,
                    rs.uniform(500, 900, (20, 24))).astype(np.float32)
    T = np.array([[0.5, 0.0, -100.0], [0.0, 0.5, -80.0], [0.0, 0.0, 1.0]])
    pi = psyn.SyntheticImporter(n_frames=1)
    ji = jsyn.SyntheticImporter(n_frames=1)
    _equal(pi.depth_to_pcl(crop, T), ji.depth_to_pcl(crop, T), "pcl")
    _equal(pi.get_camera_intrinsics(), ji.get_camera_intrinsics(), "K")
    _equal(pi.get_camera_projection(), ji.get_camera_projection(), "P")
    # a torch tensor stays on the torch path
    t = torch.from_numpy(xyz)
    assert isinstance(pc.to_img(t), torch.Tensor)


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------

def _frames(n, seed):
    cam = jcam.Camera.nyu()
    rs = np.random.RandomState(seed)
    basis = jsyn.make_pose_basis(36, np.random.RandomState(77))
    out = []
    for _ in range(n):
        com3d = np.array([rs.uniform(-120, 120), rs.uniform(-120, 120),
                          rs.uniform(600, 900)], np.float32)
        dpt, joints = jsyn.render_hand_depth(cam, com3d, 36, rs,
                                             pose_basis=basis)
        out.append((dpt, joints))
    return out


@pytest.mark.parametrize("docom", [False, True])
def test_detector_crops_match_jax_at_random_coms(docom):
    cam = jcam.Camera.nyu()
    rs = np.random.RandomState(2)
    for dpt, joints in _frames(3, 3):
        jd = jdet.HandDetector(dpt, cam.fx, cam.fy)
        pd = pdet.HandDetector(dpt, cam.fx, cam.fy)
        assert pd.check_image(1) == jd.check_image(1)
        _equal(pd.calculate_com(dpt), jd.calculate_com(dpt), "com")
        assert pd.get_nd_value() == jd.get_nd_value()
        base = cam.to_img(joints[0])
        for _ in range(12):
            com = base + rs.randn(3) * np.array([15.0, 15.0, 30.0])
            size = (rs.uniform(150, 350),) * 3
            assert pd.com_to_bounds(com, size) == jd.com_to_bounds(com, size)
            _equal(pd.com_to_transform(com, size),
                   jd.com_to_transform(com, size), "com_to_transform")
            _tree_equal(pd.crop_area_3d(com, size, docom=docom),
                        jd.crop_area_3d(com, size, docom=docom),
                        "crop_area_3d")
            _equal(pd.apply_crop_3d(dpt, com, size, (128, 128)),
                   jd.apply_crop_3d(dpt, com, size, (128, 128)),
                   "apply_crop_3d")
        crop = pd.get_crop(dpt, 200, 330, 150, 270, 500.0, 800.0)
        _equal(crop, jd.get_crop(dpt, 200, 330, 150, 270, 500.0, 800.0),
               "get_crop")
        _equal(pd.resize_crop(crop, (100, 64)),
               jd.resize_crop(crop, (100, 64)), "resize_crop")


def test_sample_random_poses_matches_jax():
    imp_p = psyn.SyntheticImporter(n_frames=6, seed=4)
    imp_j = jsyn.SyntheticImporter(n_frames=6, seed=4)
    seq = imp_j.load_sequence("train")
    cube = np.repeat(seq.cube[None], len(seq), 0)
    modes = ["none", "rot", "sc", "com", "rot+com", "rot+com+sc"]
    for rot3d in (False, True):
        got = pdet.HandDetector.sample_random_poses(
            imp_p, np.random.RandomState(9), seq.gt3Dcrop, seq.com, cube,
            200, 5, modes, retall=True, rot3d=rot3d)
        want = jdet.HandDetector.sample_random_poses(
            imp_j, np.random.RandomState(9), seq.gt3Dcrop, seq.com, cube,
            200, 5, modes, retall=True, rot3d=rot3d)
        _tree_equal(got, want, f"sample_random_poses rot3d={rot3d}")


# ---------------------------------------------------------------------------
# the synthetic importer and dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("subset,docom", [("train", False), ("test", True)])
def test_synthetic_importer_load_sequence_matches_jax(subset, docom):
    got = psyn.SyntheticImporter(n_frames=5, seed=11).load_sequence(
        subset, docom=docom, shuffle=True, rng=np.random.RandomState(3))
    want = jsyn.SyntheticImporter(n_frames=5, seed=11).load_sequence(
        subset, docom=docom, shuffle=True, rng=np.random.RandomState(3))
    for k in ("dpt", "gtorig", "gtcrop", "M", "gt3Dorig", "gt3Dcrop",
              "com"):
        _equal(getattr(got, k), getattr(want, k), k)
    assert got.config == want.config and got.name == want.name
    # the reference-compatible wrapper
    frames = psyn.SyntheticImporter(n_frames=2, seed=11).loadSequence(subset)
    assert len(frames.data) == 2


def _datasets(**over):
    spec = dict(SPEC, **over)
    return ploader.get_dataset(spec), jloader.get_dataset(spec)


def test_dataset_pose_sampling_nmax_and_items_match_jax():
    p, j = _datasets(augment=False)
    for i in (0, 3, 9):
        _tree_equal(p[i], j[i], f"image item {i}")
    p.set_nmax(0.5)
    j.set_nmax(0.5)
    assert len(p) == len(j) == 5
    p.sample_poses()
    j.sample_poses()
    _equal(p.sampled_poses, j.sampled_poses, "sampled poses")
    p.pose_only = j.pose_only = True
    assert len(p) == len(j) == SPEC["sample_poses"]
    for i in (0, 17, 59):
        _equal(p[i], j[i], f"pose item {i}")
    # pose-only without sampled poses: the crop's labels
    q, k = _datasets(augment=False, sample_poses=0)
    q.pose_only = k.pose_only = True
    _equal(q[2], k[2], "pose_only label item")


def test_augmented_image_item_raises_and_names_the_roadmap_item():
    """The augmented image item of the synthetic dataset, which raised
    until the per-sample host augment was ported: now the JAX dataset's
    item for item, over two passes, the RandomState left behind
    included."""
    p, j = _datasets()
    for rep in range(2):
        for i in range(len(p)):
            _tree_equal(p[i], j[i], f"augmented item {i} pass {rep}")
    _equal(p.rng.get_state()[1], j.rng.get_state()[1], "rng state")


def test_fast_augmenter_raw_batch_matches_jax():
    from lsps_tpu.data.fast_augment import FastAugmenter as JFA
    from lsps_tpu_torch.data.fast_augment import FastAugmenter as PFA

    p, j = _datasets(n_frames=16)
    fp, fj = PFA(p, "step"), JFA(j, "jax")
    rs = np.random.RandomState(5)
    for _ in range(4):
        idx = list(rs.randint(0, 16, 12))
        _tree_equal(fp.raw_batch(idx), fj.raw_batch(idx), "raw_batch")
    # the RandomStates moved alike
    assert p.rng.randint(1 << 30) == j.rng.randint(1 << 30)


@pytest.mark.parametrize("backend", ["step", "jax"])
def test_loader_batches_match_jax(backend, monkeypatch):
    """Three epochs of both training loaders (the final short batch
    included), and the test loader, under LSPS_AUGMENT=backend.  Under
    ``jax`` the images come from the JAX device augment and from the
    port's, on the CPU."""
    monkeypatch.setenv("LSPS_AUGMENT", backend)
    p, j = _datasets(n_frames=10)
    lp = ploader.get_data_loader(p, 4, shuffle=True, seed=7, device="cpu")
    lj = jloader.get_data_loader(j, 4, shuffle=True, seed=7)
    assert (lp.raw, lp.fast) == (lj.raw, lj.fast) == (backend == "step",
                                                      True)
    for ep in range(3):
        bp, bj = list(lp), list(lj)
        assert len(bp) == len(bj) == 3
        for b, (x, y) in enumerate(zip(bp, bj)):
            _tree_equal(x, y, f"{backend} epoch {ep} batch {b}")
    _tree_equal(lp.get_state()["rng_state"][1],
                lj.get_state()["rng_state"][1], "shuffle state")
    tp, tj = _datasets(augment=False, subset="test", n_frames=6)
    for x, y in zip(ploader.get_data_loader(tp, 4, shuffle=False),
                    jloader.get_data_loader(tj, 4, shuffle=False)):
        _tree_equal(x, y, "test batch")


def test_loader_state_iter_from_and_disable_raw(monkeypatch):
    monkeypatch.setenv("LSPS_AUGMENT", "step")
    p, _ = _datasets(n_frames=10)
    lp = ploader.get_data_loader(p, 4, shuffle=True, seed=7, device="cpu")
    state = lp.get_state()
    first = list(lp)
    lp.set_state(state)
    again = list(lp.iter_from(1))
    assert len(again) == 2
    # the same frames (the augment draws move on with the dataset's rng)
    _equal(first[1][0][0], again[0][0][0], "iter_from source crops")
    lp.disable_raw()
    assert not lp.raw and lp.fast
    imgs = next(iter(lp))[0]
    assert imgs.shape == (4, 1, 128, 128) and imgs.dtype == np.float32


@pytest.mark.parametrize("value", ["host", "native", "bogus"])
def test_loader_refuses_backends_the_port_lacks(value, monkeypatch):
    """The port has every backend of the JAX package now: ``host`` and
    ``native`` are taken as they are (upper case too), and only a name
    that is none of them raises."""
    monkeypatch.setenv("LSPS_AUGMENT", value.upper())
    if value == "bogus":
        with pytest.raises(ValueError, match="not one of"):
            ploader.augment_backend()
    else:
        assert ploader.augment_backend() == value


def test_loader_default_is_step(monkeypatch):
    """``LSPS_AUGMENT`` unset means ``host``, as in the JAX package (it
    meant ``step`` before the host augment was ported), ``LSPS_NATIVE=1``
    then means ``native``, and ``step`` is taken when it is named."""
    monkeypatch.delenv("LSPS_AUGMENT", raising=False)
    monkeypatch.delenv("LSPS_NATIVE", raising=False)
    assert ploader.augment_backend() == "host"
    monkeypatch.setenv("LSPS_NATIVE", "1")
    assert ploader.augment_backend() == "native"
    monkeypatch.setenv("LSPS_AUGMENT", "step")
    assert ploader.augment_backend() == "step"
    p, _ = _datasets(n_frames=4)
    monkeypatch.delenv("LSPS_AUGMENT")
    monkeypatch.delenv("LSPS_NATIVE")
    lp = ploader.get_data_loader(p, 2, shuffle=True)
    assert not lp.fast and not lp.raw
