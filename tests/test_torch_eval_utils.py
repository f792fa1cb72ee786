"""The port's eval metrics, GAN-health guard, viz and logging against the
JAX package's (and against cv2, which is installed here).

* ``eval/handpose_evaluation.py``: every ``get*`` metric and the joint
  tables of the NYU, ICVL and MSRA classes on random poses;
* ``train/gan_health.py``: the guard, the rescue controller and both
  notes on random accuracy streams;
* ``utils/viz.py``: ``vis_pair``'s gray background bit-equal to the JAX
  package's, its drawn pixels overlapping cv2's by at least 90 %; PNG and
  AVI files read back with ``cv2.imread`` / ``cv2.VideoCapture``;
* ``utils/logging.py``, ``utils/skeleton.py``, ``data/basetypes.py`` and
  ``LSPSTrainer.assemble_outputs`` beside their counterparts.
"""

import json
import os

import numpy as np
import pytest
import torch

import cv2

from lsps_tpu.data import basetypes as jbt
from lsps_tpu.data.camera import Camera as JCamera
from lsps_tpu.eval import handpose_evaluation as jev
from lsps_tpu.train import gan_health as jgh
from lsps_tpu.train.trainer import LSPSTrainer as JaxTrainer
from lsps_tpu.utils import logging as jlog
from lsps_tpu.utils import skeleton as jsk
from lsps_tpu.utils import viz as jviz
from lsps_tpu_torch.data import basetypes as pbt
from lsps_tpu_torch.data.camera import Camera as PCamera
from lsps_tpu_torch.eval import handpose_evaluation as pev
from lsps_tpu_torch.train import gan_health as pgh
from lsps_tpu_torch.train.trainer import LSPSTrainer as PortTrainer
from lsps_tpu_torch.utils import logging as plog
from lsps_tpu_torch.utils import skeleton as psk
from lsps_tpu_torch.utils import viz as pviz

torch.set_num_threads(1)

METRICS = ("getMeanError", "getStdError", "getMeanErrorOverSeq",
           "getMedianError", "getMaxError", "getMaxErrorOverSeq")
JOINT_METRICS = ("getJointMeanError", "getJointStdError",
                 "getJointErrorOverSeq", "getJointDiffOverSeq",
                 "getJointMaxError")
WITHIN = ("getNumFramesWithinMaxDist", "getNumFramesWithinMeanDist",
          "getNumFramesWithinMedianDist")


@pytest.mark.parametrize("cls,joints", [
    ("HandposeEvaluation", 36), ("NYUHandposeEvaluation", 14),
    ("NYUHandposeEvaluation", 36), ("ICVLHandposeEvaluation", 16),
    ("MSRAHandposeEvaluation", 21)])
def test_evaluation_metrics_match_jax(cls, joints):
    rs = np.random.RandomState(joints)
    gt = rs.uniform(-100, 100, (30, joints, 3))
    pred = gt + rs.randn(30, joints, 3) * 15.0
    pred[3, 2, 1] = np.nan  # NaN-tolerant like the reference
    p, j = getattr(pev, cls)(gt, pred), getattr(jev, cls)(gt, pred)
    for m in METRICS:
        np.testing.assert_array_equal(getattr(p, m)(), getattr(j, m)(),
                                      err_msg=m)
    for m in JOINT_METRICS:
        for jid in (0, joints - 1):
            np.testing.assert_array_equal(getattr(p, m)(jid),
                                          getattr(j, m)(jid), err_msg=m)
    for m in WITHIN:
        for d in (10.0, 25.0, 40.0):
            assert getattr(p, m)(d) == getattr(j, m)(d), m
    assert p.getJointNumFramesWithinMaxDist(30.0, 1) == \
        j.getJointNumFramesWithinMaxDist(30.0, 1)
    assert p.jointNames == j.jointNames
    assert p.jointConnections == j.jointConnections
    assert p.plotMaxJointDist == j.plotMaxJointDist
    for a, b in ((p.jointColors, j.jointColors),
                 (p.jointConnectionColors, j.jointConnectionColors)):
        assert len(a) == len(b)
        np.testing.assert_allclose(np.asarray(a, float),
                                   np.asarray(b, float), atol=1e-12)
    np.testing.assert_array_equal(pev.NYU_RESTRICTED_EVAL,
                                  jev.NYU_RESTRICTED_EVAL)
    with pytest.raises(ValueError):
        getattr(pev, cls)(gt, pred[:, :-1])


def test_gan_health_matches_jax_on_random_streams():
    for name in ("FAKE_ACC_DOMINANT", "COLLAPSE_CHECK_ITER",
                 "RESEED_WINDOW_FRAC"):
        assert getattr(pgh, name) == getattr(jgh, name)
    rs = np.random.RandomState(0)
    for trial in range(20):
        kw = dict(threshold=rs.uniform(0.8, 0.98),
                  check_iter=int(rs.randint(1, 30)),
                  window=int(rs.randint(1, 8)))
        gp, gj = pgh.CollapseGuard(**kw), jgh.CollapseGuard(**kw)
        rp, rj = (pgh.RescueController(2, phase_iters=5),
                  jgh.RescueController(2, phase_iters=5))
        level = rs.uniform(0.7, 1.0)
        for it in range(1, 60):
            t, f = rs.uniform(0.5, 1.0), min(1.0, level + rs.randn() * 0.05)
            fired = gp.observe(it, t, f)
            assert fired == gj.observe(it, t, f)
            assert rp.in_phase(it) == rj.in_phase(it)
            if fired and not rp.exhausted:
                assert rp.start(gp, it) == rj.start(gj, it)
            assert (gp.triggered_at, gp.triggered_fake, gp.tail) == \
                (gj.triggered_at, gj.triggered_fake, gj.tail)
        assert rp.history == rj.history
        assert pgh.gan_health_note(gp.tail) == jgh.gan_health_note(gj.tail)
        hist = [(i * 100, e) for i, e in enumerate(
            np.cumsum(rs.randn(12) * 2.0) + 20.0)]
        assert pgh.overfit_note(hist) == jgh.overfit_note(hist)


def _crop(seed):
    rs = np.random.RandomState(seed)
    return rs.uniform(-1, 1, (1, 128, 128)).astype(np.float32)


def _pose_args(seed):
    """A pose that lands inside the crop, with its crop transform."""
    rs = np.random.RandomState(seed)
    cam = JCamera.nyu()
    com = np.array([10.0, -20.0, 700.0], np.float32)
    pose = rs.uniform(-0.5, 0.5, (36, 3)).astype(np.float32)
    com2d = cam.to_img(com)
    trans = np.array([[0.6, 0.0, 64 - 0.6 * com2d[0]],
                      [0.0, 0.6, 64 - 0.6 * com2d[1]], [0, 0, 1.0]])
    return pose.reshape(-1), trans, com, np.full(3, 300.0, np.float32)


def test_vis_pair_background_is_bit_equal_to_jax():
    for seed in range(3):
        d = _crop(seed)
        got = pviz.vis_pair(PCamera.nyu(), d)
        want = jviz.vis_pair(JCamera.nyu(), d)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vis_pair_drawn_pixels_overlap_cv2(seed):
    d = np.zeros((1, 128, 128), np.float32)
    pose, trans, com, cube = _pose_args(seed)
    args = (pose, trans, com, cube, psk.NYU_COLOR_IDX, psk.NYU_BONES)
    got = pviz.vis_pair(PCamera.nyu(), d, *args)
    want = jviz.vis_pair(JCamera.nyu(), d, *args)
    bg = pviz.vis_pair(PCamera.nyu(), d)
    drawn_p = (got != bg).any(-1)
    drawn_j = (want != bg).any(-1)
    assert drawn_j.sum() > 200
    overlap = (drawn_p & drawn_j).sum() / max(drawn_p.sum(), drawn_j.sum())
    assert overlap >= 0.9, overlap
    same = (got == want).all(-1)
    assert same[drawn_p & drawn_j].mean() >= 0.9


def test_png_reads_back_with_cv2(tmp_path):
    rs = np.random.RandomState(0)
    color = rs.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    gray = rs.randint(0, 256, (21, 40)).astype(np.uint8)
    pviz.write_png(str(tmp_path / "c.png"), color)
    pviz.write_png(str(tmp_path / "g.png"), gray)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "c.png")),
                                  color)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED), gray)
    # an assembled strip in [-1, 1], as the JAX package scales it
    strip = rs.uniform(-1.2, 1.2, (1, 128, 1280, 1)).astype(np.float32)
    pviz.save_image_strip(torch.from_numpy(strip),
                          str(tmp_path / "s" / "gen.png"))
    jviz.save_image_strip(strip, str(tmp_path / "s" / "gen_jax.png"))
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "s" / "gen.png"), cv2.IMREAD_UNCHANGED),
        cv2.imread(str(tmp_path / "s" / "gen_jax.png"),
                   cv2.IMREAD_UNCHANGED))


def test_avi_reads_back_with_cv2(tmp_path):
    rs = np.random.RandomState(1)
    pairs = [(rs.randint(0, 256, (128, 128, 3)).astype(np.uint8),
              rs.randint(0, 256, (128, 128, 3)).astype(np.uint8))
             for _ in range(6)]
    vid = pviz.EvalVideoWriter(str(tmp_path / "v" / "gen.avi"))
    for real, est in pairs:
        vid.write_pair(real, est)
    vid.release()
    vid.release()  # a second release is a no-op
    cap = cv2.VideoCapture(str(tmp_path / "v" / "gen.avi"))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    assert len(frames) == len(pairs)
    for f, (real, est) in zip(frames, pairs):
        np.testing.assert_array_equal(f, np.hstack((real, est)))
    with pytest.raises(ValueError):
        pviz.EvalVideoWriter(str(tmp_path / "w.avi")).write(
            np.zeros((10, 10, 3), np.uint8))


def test_logging_matches_jax(tmp_path, capsys):
    metrics = {"dis_loss": torch.tensor(0.5), "gen_total_loss": 1.25,
               "dis_true_acc": np.float32(0.75), "gen_lr": 1e-4,
               "other": 3.0}
    pw = plog.MetricsWriter(str(tmp_path / "p"))
    plog.write_loss(9, 100, metrics, pw, 1.5)
    pw.close()
    jw = jlog.MetricsWriter(str(tmp_path / "j"))
    jlog.write_loss(9, 100, {k: float(v) for k, v in metrics.items()}, jw,
                    1.5)
    jw.close()
    rows = [json.loads((tmp_path / d / "metrics.jsonl").read_text())
            for d in ("p", "j")]
    assert rows[0] == rows[1]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "Iteration: 00000010/00000100 1.50s"
    img, snap = plog.prepare_snapshot_and_image_folder(
        str(tmp_path / "snap" / "pre"), 24, 8)
    assert os.path.isdir(img) and snap == str(tmp_path / "snap")
    plog.write_html(str(tmp_path / "p.html"), 24, 8, "imgs")
    jlog.write_html(str(tmp_path / "j.html"), 24, 8, "imgs")
    assert (tmp_path / "p.html").read_text() == \
        (tmp_path / "j.html").read_text().replace(".jpg", ".png")
    with plog.profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert os.path.isfile(tmp_path / "prof" / "trace.json")
    with plog.profile_trace(None):
        pass


def test_copied_tables_and_containers_match_jax():
    for name in ("FIG_COLOR", "NYU_COLOR_IDX", "ICVL_COLOR_IDX",
                 "MSRA_COLOR_IDX", "POST_COLOR_IDX", "NYU_BONES",
                 "ICVL_BONES", "MSRA_BONES", "POST_BONES"):
        assert getattr(psk, name) == getattr(jsk, name), name
    for cfg in ("nnyu.yaml", "nicvl.yaml", "msra.yaml", "post.yaml"):
        assert psk.tables_for(cfg) == jsk.tables_for(cfg)
    rs = np.random.RandomState(2)
    dpt = np.round(rs.uniform(300, 900, (3, 16, 16))).astype(np.float32)
    dpt[:, :2] = 0.0
    codes, vstar = pbt.encode_dpt_u16(dpt)
    jcodes, jvstar = jbt.encode_dpt_u16(dpt)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(vstar, jvstar)
    np.testing.assert_array_equal(pbt.decode_dpt_u16(codes, vstar), dpt)


def test_assemble_outputs_matches_jax():
    rs = np.random.RandomState(3)
    imgs = [rs.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)
            for _ in range(10)]
    got = PortTrainer.assemble_outputs(torch.from_numpy(imgs[0]), imgs[1],
                                       [torch.from_numpy(i)
                                        for i in imgs[2:]])
    want = JaxTrainer.assemble_outputs(imgs[0], imgs[1], imgs[2:])
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
