"""The port's host detection and tracking surface against the JAX package.

``lsps_tpu_torch.data.detector.HandDetector``'s ``detect`` (hand size on
and off), ``refine_com_iterative``, ``track`` (one seeded numpy
``refine_net`` shared by both sides), ``_hand_size_from_depth`` and
``estimate_hand_size`` must equal ``lsps_tpu.data.detector.HandDetector``'s
exactly: the CoMs are float64 and compared bit for bit.  Frames: rendered
hands on the NYU and ICVL cameras, a nearer distractor under and over the
detector's 200-pixel area, two objects in one depth slice and an empty
frame.  The port's host detector also agrees with its own device
detector (``serve/detect.py``) within the JAX package's bound for its own
pair (``tests/test_detect_jax.py``: 2 px in u and v, 3 mm in z).  Then
``utils.realtime.Frame`` (given a CoM and found), the legacy stacks and
``Evaluation`` against the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lsps_tpu.data import detector as jdet
from lsps_tpu.data import importers as jimp
from lsps_tpu.data.camera import Camera as JCamera
from lsps_tpu.data.stacks import SequenceDataset as JSequenceDataset
from lsps_tpu.data.stacks import img_stack_depth_only as j_stack
from lsps_tpu.data.synthetic import SyntheticImporter as JSynth
from lsps_tpu.data.synthetic import render_hand_depth
from lsps_tpu.eval.handpose_evaluation import Evaluation as JEvaluation
from lsps_tpu.utils import realtime as jrt
from lsps_tpu_torch.data import detector as pdet
from lsps_tpu_torch.data import importers as pimp
from lsps_tpu_torch.data.contours import find_contours
from lsps_tpu_torch.data.stacks import SequenceDataset, img_stack_depth_only
from lsps_tpu_torch.data.synthetic import SyntheticImporter as PSynth
from lsps_tpu_torch.eval.handpose_evaluation import Evaluation
from lsps_tpu_torch.serve.detect import device_detect
from lsps_tpu_torch.utils import realtime as prt
from lsps_tpu_torch.utils.skeleton import NYU_BONES, NYU_COLOR_IDX

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)

NYU, ICVL = JCamera.nyu(), JCamera.icvl()
CUBE = (300.0, 300.0, 300.0)
HOST_DEVICE_PX, HOST_DEVICE_MM = 2.0, 3.0   # tests/test_detect_jax.py:47-48


def _hand(cam, com3d, seed):
    rs = np.random.RandomState(seed)
    return render_hand_depth(cam, np.asarray(com3d, np.float32), 36,
                             rs)[0].astype(np.float32)


def _frames():
    """name -> (camera, raw depth frame)."""
    f = {}
    for i in range(3):
        f[f"nyu_{i}"] = (NYU, _hand(NYU, [40.0 * i - 20.0, 15.0 * i - 10.0,
                                          720.0 + 40.0 * i], i))
    for i in range(2):
        f[f"icvl_{i}"] = (ICVL, _hand(ICVL, [30.0 * i - 15.0, 10.0 - 20 * i,
                                             420.0 + 60.0 * i], 10 + i))
    hand = _hand(NYU, [0.0, 0.0, 800.0], 5)
    small = hand.copy()
    small[40:50, 60:70] = 500.0          # 100 px, nearer: skipped
    f["distractor_small"] = (NYU, small)
    big = hand.copy()
    big[40:70, 60:90] = 500.0            # 900 px, nearer: taken
    f["distractor_big"] = (NYU, big)
    two = np.zeros((480, 640), np.float32)
    two[100:130, 100:140] = 700.0        # two objects in one slice
    two[300:340, 400:430] = 702.0
    two[200:260, 250:300] = 1500.0
    f["two_in_a_slice"] = (NYU, two)
    f["empty"] = (NYU, np.zeros((480, 640), np.float32))
    return f


FRAMES = _frames()


def _pair(name, **kw):
    cam, dpt = FRAMES[name]
    return (pdet.HandDetector(dpt, cam.fx, cam.fy, **kw),
            jdet.HandDetector(dpt, cam.fx, cam.fy, **kw))


def _same(got, want, what):
    """(com, cube) results equal, CoMs float64 bit for bit."""
    gc, gs = got
    wc, ws = want
    assert gc.dtype == wc.dtype == np.float64, what
    np.testing.assert_array_equal(gc, wc, err_msg=what)
    assert tuple(gs) == tuple(ws), what


@pytest.mark.parametrize("hand_size", [True, False])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_detect_equals_jax(name, hand_size):
    p, j = _pair(name)
    got = p.detect(size=CUBE, do_hand_size=hand_size)
    _same(got, j.detect(size=CUBE, do_hand_size=hand_size), name)
    if name == "empty":
        assert not got[0].any()
    else:
        assert got[0][2] > 0, name
    if name == "distractor_big":
        assert abs(got[0][2] - 500.0) < 1.0     # the nearer object wins
    if name == "distractor_small":
        assert got[0][2] > 700.0                # too small: the hand wins


def test_detect_takes_the_first_contour_of_a_shared_slice():
    """Both objects of one slice qualify; the first contour in cv2's
    order (the newest top-level border, the lower object) is taken."""
    p, _ = _pair("two_in_a_slice")
    com, _ = p.detect(size=CUBE, do_hand_size=False)
    assert 300 <= com[1] <= 340 and 400 <= com[0] <= 430


@pytest.mark.parametrize("name", ["nyu_0", "nyu_2", "icvl_1",
                                  "distractor_big", "empty"])
def test_refine_com_iterative_equals_jax(name):
    p, j = _pair(name)
    found, _ = j.detect(size=CUBE, do_hand_size=False)
    starts = [np.zeros(3),                       # the z = 0 bounds branch
              np.array([5.0, 5.0, 3000.0])]      # an empty crop
    if found.any():
        starts += [found + [6.0, -4.0, 25.0], found + [-3.5, 2.5, -10.0]]
    for k, com in enumerate(starts):
        for n in (1, 5):
            got = p.refine_com_iterative(com, n, CUBE)
            want = j.refine_com_iterative(com, n, CUBE)
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name} {k} {n}")


class _RefineNet:
    """A seeded numpy stand-in for the CoM refinement net: a crop to a
    small (3,) offset in normalized units."""

    def __init__(self, seed=0):
        self.w = np.random.RandomState(seed).randn(3, 128 * 128) * 1e-3
        self.calls = 0

    def __call__(self, img):
        assert img.shape == (128, 128) and img.dtype == np.float32
        self.calls += 1
        return 0.2 * np.tanh(self.w @ img.reshape(-1).astype(np.float64))


@pytest.mark.parametrize("hand_size", [True, False])
@pytest.mark.parametrize("name", ["nyu_0", "nyu_1", "icvl_0"])
def test_track_equals_jax(name, hand_size):
    cam = FRAMES[name][0]
    net = _RefineNet()
    pimporter = pimp.NYUImporter("") if cam is NYU else pimp.ICVLImporter("")
    jimporter = jimp.NYUImporter("") if cam is NYU else jimp.ICVLImporter("")
    _, dpt = FRAMES[name]
    p = pdet.HandDetector(dpt, cam.fx, cam.fy, importer=pimporter,
                          refine_net=net)
    j = jdet.HandDetector(dpt, cam.fx, cam.fy, importer=jimporter,
                          refine_net=net)
    com, _ = j.detect(size=CUBE, do_hand_size=False)
    for k in range(3):
        got = p.track(com, CUBE, do_hand_size=hand_size)
        want = j.track(com, CUBE, do_hand_size=hand_size)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"{k}")
        assert tuple(got[1]) == tuple(want[1])
        com = want[0]
    assert net.calls == 6


def test_track_without_a_refine_net_raises():
    p, j = _pair("nyu_0", importer=pimp.NYUImporter(""))
    for det in (p, j):
        with pytest.raises(RuntimeError, match="refine_net"):
            det.track(np.array([320.0, 240.0, 800.0]), CUBE)


@pytest.mark.parametrize("name", ["nyu_0", "nyu_1", "icvl_1",
                                  "two_in_a_slice"])
def test_hand_size_equals_jax(name):
    p, j = _pair(name)
    com, _ = j.detect(size=CUBE, do_hand_size=False)
    for size in (CUBE, (250.0, 250.0, 250.0)):
        assert p._hand_size_from_depth(com, size) == \
            j._hand_size_from_depth(com, size)
    # estimate_hand_size on the largest contour, each side's own
    part = (p.dpt >= com[2] - 150) & (p.dpt <= com[2] + 150)
    got_c, _ = find_contours(part)
    want_c, _ = cv2.findContours(part.astype(np.uint8) * 255,
                                 cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    k = int(np.argmax([cv2.contourArea(c) for c in want_c]))
    for tol in (0.0, 15.0):
        assert p.estimate_hand_size(got_c[k], com, CUBE, tol) == \
            j.estimate_hand_size(want_c[k], com, CUBE, tol)


@pytest.mark.parametrize("name", ["nyu_0", "nyu_1", "nyu_2", "icvl_0",
                                  "icvl_1", "distractor_small"])
def test_host_detect_agrees_with_the_device_detector(name):
    cam, dpt = FRAMES[name]
    p = pdet.HandDetector(dpt, cam.fx, cam.fy)
    host, _ = p.detect(size=CUBE, do_hand_size=False)
    dev = device_detect(torch.from_numpy(dpt), torch.tensor(CUBE),
                        cam.fx, cam.fy).numpy()
    assert host[2] > 0 and dev[2] > 0
    np.testing.assert_allclose(dev[:2], host[:2], atol=HOST_DEVICE_PX)
    np.testing.assert_allclose(dev[2], host[2], atol=HOST_DEVICE_MM)


FRAME_FIELDS = ("dm", "skel", "com2d", "com3d", "crop_dm", "trans",
                "norm_skel")


def _same_frame(got, want, what):
    for k in FRAME_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if b is None:
            assert a is None, (what, k)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
    assert got.far_point == want.far_point and got.cube == want.cube
    assert dataclasses.astuple(got.camera) == \
        dataclasses.astuple(want.camera)


@pytest.mark.parametrize("camera", ["kinect", "intel"])
def test_frame_equals_jax(camera):
    pcam, far = prt.CAMERAS[camera]
    jcam, jfar = jrt.CAMERAS[camera]
    assert (pcam.fx, pcam.fy, pcam.ux, pcam.uy, pcam.flip_y, far) == \
        (jcam.fx, jcam.fy, jcam.ux, jcam.uy, jcam.flip_y, jfar)
    assert prt.SKEL_NORM_RATIO == jrt.SKEL_NORM_RATIO
    gen = np.random.RandomState(3)
    z = 700.0 if camera == "kinect" else 450.0
    com3d = np.array([20.0, -15.0, z], np.float32)
    dm, joints = render_hand_depth(jcam, com3d, 14, gen)
    dm[:20, :30] = far + 5.0              # far-point pixels are blanked
    given = dict(com2d=jcam.to_img(com3d), skel=joints.reshape(-1),
                 cube=(300, 300, 300))
    for kw in (given, {}, {"cube": (250, 250, 250)}):
        got = prt.Frame.from_depth(dm, pcam, far, **kw)
        want = jrt.Frame.from_depth(dm, jcam, far, **kw)
        _same_frame(got, want, f"{camera} {sorted(kw)}")
    f = prt.Frame.from_depth(dm, pcam, far, **given)
    jf = jrt.Frame.from_depth(dm, jcam, far, **given)
    np.testing.assert_array_equal(f.denormalize_skel(f.norm_skel),
                                  jf.denormalize_skel(jf.norm_skel))
    np.testing.assert_array_equal(f.skel_to_full2d(), jf.skel_to_full2d())
    np.testing.assert_array_equal(f.skel_to_crop2d(), jf.skel_to_crop2d())
    np.testing.assert_array_equal(f.skel_to_crop2d(joints[:3]),
                                  jf.skel_to_crop2d(joints[:3]))
    # render: the crop bit-equal, the drawn skeleton where cv2 draws it
    np.testing.assert_array_equal(f.render(), jf.render())
    got = f.render(f.norm_skel, NYU_COLOR_IDX[:14], None)
    want = jf.render(jf.norm_skel, NYU_COLOR_IDX[:14], None)
    bg = f.render()
    drawn_p, drawn_j = (got != bg).any(-1), (want != bg).any(-1)
    assert drawn_j.sum() > 30
    assert (drawn_p & drawn_j).sum() >= 0.9 * max(drawn_p.sum(),
                                                  drawn_j.sum())
    assert got.shape == (128, 128, 3) and got.dtype == np.uint8


def test_frame_render_with_bones_matches_jax():
    pcam, far = prt.CAMERAS["kinect"]
    jcam, _ = jrt.CAMERAS["kinect"]
    dm, joints = render_hand_depth(jcam, np.array([0.0, 0.0, 750.0],
                                                  np.float32), 36,
                                   np.random.RandomState(6))
    kw = dict(com2d=jcam.to_img(np.array([0.0, 0.0, 750.0], np.float32)),
              skel=joints.reshape(-1), cube=(300, 300, 300))
    f = prt.Frame.from_depth(dm, pcam, far, **kw)
    jf = jrt.Frame.from_depth(dm, jcam, far, **kw)
    got = f.render(f.norm_skel, NYU_COLOR_IDX, NYU_BONES)
    want = jf.render(jf.norm_skel, NYU_COLOR_IDX, NYU_BONES)
    bg = f.render()
    drawn_p, drawn_j = (got != bg).any(-1), (want != bg).any(-1)
    assert drawn_j.sum() > 100
    overlap = (drawn_p & drawn_j).sum() / max(drawn_p.sum(), drawn_j.sum())
    assert overlap >= 0.9, overlap


def test_stacks_equal_jax():
    for n, seed in ((3, 5), (5, 9)):
        pa = PSynth(n_frames=n, n_joints=14, seed=seed).load_sequence("train")
        ja = JSynth(n_frames=n, n_joints=14, seed=seed).load_sequence("train")
        (gi, gl), (wi, wl) = img_stack_depth_only(pa), j_stack(ja)
        assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        ds, jds = SequenceDataset(pa), JSequenceDataset(ja)
        assert len(ds) == len(jds) == n
        for a, b in zip(ds.imgStackDepthOnly(), jds.imgStackDepthOnly()):
            np.testing.assert_array_equal(a, b)


def test_evaluation_equals_jax(tmp_path):
    rs = np.random.RandomState(4)
    assert Evaluation.SCALE == JEvaluation.SCALE
    for _ in range(5):
        a, b = rs.randn(36 * 3), rs.randn(36 * 3)
        assert Evaluation.maxJntError(a, b) == JEvaluation.maxJntError(a, b)
        assert Evaluation.meanJntError(a, b) == \
            JEvaluation.meanJntError(a, b)
    for scores in (rs.uniform(0, 90, 200), [], [40.5, 40.5, 12.0, 81.0]):
        got = Evaluation.plotError(scores, str(tmp_path / "p.txt"))
        want = JEvaluation.plotError(scores, str(tmp_path / "j.txt"))
        assert got == want
        assert (tmp_path / "p.txt").read_bytes() == \
            (tmp_path / "j.txt").read_bytes()
        assert len((tmp_path / "p.txt").read_text().splitlines()) == 17
