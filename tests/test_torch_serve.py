"""The PyTorch port's PoseEstimator vs the JAX package's, on the CPU.

Both estimators get the same JAX-initialised weights (the port through
``from_jax_params``) and the same ``render_hand_depth`` frames.
Tolerances, in mm of metric joints: 1e-3 (``FRAMES_MM``) for
``predict_frames`` and ``predict_frame`` (bit-equal crops; float32 convs
summed in another order, about 1e-5 relative on outputs near 800 mm).

``predict_raw`` detects the CoM first, and the detected CoMs agree as
``test_torch_detect.py`` derives: u, v equal, z within ``COM_Z_ULPS``
float32 ulps of z, so |dz| <= d = COM_Z_ULPS * spacing(z).  The joints are
``j * cube/2 + img_to_3d(com)``: through ``img_to_3d`` (x = (u - ux) z /
fx, y = +-(v - uy) z / fy, z) a depth error d moves a joint by at most
d * (1 + |u - ux| / fx + |v - uy| / fy).  The crop moves too: its values
are ``(depth - com_z) / half``, so the regressor's input shifts by
d / half and the joints by S * d, where S is the regressor's sensitivity
to the CoM's depth through the crop.  ``test_predict_raw_matches_jax``
measures S on these weights by a finite difference of ``COM_Z_ULPS``
ulps of z (it read 0.0078: one float32 rounding of the joints over d, so
the regressor's own share is smaller still) and holds it under
``CROP_SENSITIVITY``, that reading rounded up.  So a raw joint is held within d * (1 + |u - ux| /
fx + |v - uy| / fy + CROP_SENSITIVITY) + FRAMES_MM
(``raw_joint_tolerance``): 0.009-0.011 mm at 800 mm, over the first
``RAW_HANDS`` hands of ``test_torch_detect.sweep_hands`` and three fixed
ones.  (It was 5e-3 mm, from a CoM tolerance of 2e-3 mm that held for
the nine fixed hands only.)
"""

import numpy as np
import pytest
import torch

import jax

from lsps_tpu.config import default_hyperparameters
from lsps_tpu.data.camera import Camera
from lsps_tpu.data.synthetic import render_hand_depth
from lsps_tpu.models import build_model
from lsps_tpu.serve.inference import PoseEstimator as JaxEstimator
from lsps_tpu_torch.data.camera import Camera as PortCamera
from lsps_tpu_torch.serve.inference import PoseEstimator
from lsps_tpu_torch.weights import from_jax_params
from test_torch_detect import COM_Z_ULPS, assert_coms_match, sweep_hands

torch.set_num_threads(1)

CAM = Camera.nyu()
PORT_CAM = PortCamera.nyu()
HYP = default_hyperparameters(reg_dim=108, small=True)
HYP["dis"]["ch"] = 4
FRAMES_MM = 1e-3
CROP_SENSITIVITY = 0.01   # mm of joint per mm of CoM depth, via the crop
RAW_HANDS = 16            # the first hands of the detection sweep


def raw_joint_tolerance(coms, cam=CAM):
    """(B, 1, 1) per-frame bound on |port - JAX| raw-path joints, from the
    JAX CoMs (u, v, z) of the frames and the camera (see the module
    docstring)."""
    coms = np.asarray(coms, np.float32)
    d = COM_Z_ULPS * np.spacing(np.abs(coms[:, 2]))
    lever = (1 + np.abs(coms[:, 0] - cam.ux) / cam.fx
             + np.abs(coms[:, 1] - cam.uy) / cam.fy + CROP_SENSITIVITY)
    return (d * lever + FRAMES_MM)[:, None, None]


@pytest.fixture(scope="module")
def pair():
    kd, kv = jax.random.split(jax.random.PRNGKey(0))
    params = {"dis": build_model(HYP["dis"]).init(kd),
              "vae": build_model(HYP["vae"]).init(kv)}
    return (JaxEstimator(HYP, params, camera=CAM),
            PoseEstimator(HYP, from_jax_params(params), camera=PORT_CAM,
                          device="cpu"))


def _frames(n, seed=3):
    gen = np.random.RandomState(seed)
    frames, coms = [], []
    for i in range(n):
        com3d = np.array([35.0 * i - 30.0, 20.0 * i - 15.0,
                          700.0 + 45.0 * i], np.float32)
        frames.append(render_hand_depth(CAM, com3d, 36, gen)[0])
        coms.append(CAM.to_img(com3d))
    return (np.round(np.stack(frames)).astype(np.float32),
            np.stack(coms).astype(np.float32),
            np.full((n, 3), 300.0, np.float32))


def test_predict_frames_matches_jax(pair):
    jest, test = pair
    frames, coms, cubes = _frames(3)
    want = jest.predict_frames(frames, coms, cubes)
    got = test.predict_frames(frames, coms, cubes)
    assert isinstance(got, torch.Tensor) and got.shape == (3, 36, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FRAMES_MM)
    one = test.predict_frame(frames[1], coms[1], cubes[1])
    np.testing.assert_allclose(one.numpy(),
                               jest.predict_frame(frames[1], coms[1],
                                                  cubes[1]),
                               rtol=0, atol=FRAMES_MM)


def test_predict_crops_matches_jax(pair):
    jest, test = pair
    crops = np.random.RandomState(2).uniform(
        -1, 1, (2, 128, 128, 1)).astype(np.float32)
    np.testing.assert_allclose(test.predict_crops(crops).numpy(),
                               jest.predict_crops(crops), rtol=0, atol=1e-5)


def test_predict_raw_matches_jax(pair):
    """The seeded hands of the detection sweep plus the fixed ones and an
    empty frame: CoMs as ``test_torch_detect`` bounds them, joints within
    ``raw_joint_tolerance``; the measured crop sensitivity stays under
    ``CROP_SENSITIVITY``."""
    jest, test = pair
    fixed, _, _ = _frames(3, seed=8)
    frames = np.concatenate([sweep_hands()[:RAW_HANDS], fixed,
                             np.zeros((1, 480, 640), np.float32)])
    cubes = np.full((len(frames), 3), 300.0, np.float32)
    want_j, want_c = jest.predict_raw(frames, cubes, return_coms=True)
    got_j, got_c = test.predict_raw(frames, cubes, return_coms=True)
    assert_coms_match(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_c[-1].numpy(), 0.0)
    tol = raw_joint_tolerance(want_c)
    gap = np.abs(got_j.numpy() - want_j)
    assert np.all(gap[:-1] <= tol[:-1]), (gap[:-1] / tol[:-1]).max()
    # the empty frame: both CoMs are zero, so its joints agree as the
    # with-CoM path's do
    np.testing.assert_allclose(got_j[-1].numpy(), want_j[-1], rtol=0,
                               atol=FRAMES_MM, equal_nan=True)
    # default 300 mm cubes
    assert np.all(np.abs(test.predict_raw(frames[:2]).numpy() - want_j[:2])
                  <= tol[:2])
    # the regressor's sensitivity to the CoM's depth through the crop
    coms = want_c[:-1]
    d = COM_Z_ULPS * np.spacing(coms[:, 2])
    moved = coms.copy()
    moved[:, 2] += d
    j0 = test.predict_frames(frames[:-1], coms, cubes[:-1]).numpy()
    j1 = test.predict_frames(frames[:-1], moved, cubes[:-1]).numpy()
    geo = (PORT_CAM.img_to_3d(torch.from_numpy(moved))
           - PORT_CAM.img_to_3d(torch.from_numpy(coms))).numpy()
    sens = (np.abs(j1 - j0 - geo[:, None]).max((1, 2)) / d).max()
    assert sens <= CROP_SENSITIVITY, sens


def test_uint16_frames_identical_to_float32(pair):
    _, test = pair
    frames, coms, cubes = _frames(2, seed=5)
    u16 = frames.astype(np.uint16)
    assert torch.equal(test.predict_frames(u16, coms, cubes),
                       test.predict_frames(frames, coms, cubes))
    assert torch.equal(test.predict_raw(u16, cubes),
                       test.predict_raw(frames, cubes))


def test_bf16_trunk_close_to_float32(pair):
    _, test = pair
    kd, kv = jax.random.split(jax.random.PRNGKey(0))
    sd = from_jax_params({"dis": build_model(HYP["dis"]).init(kd),
                          "vae": build_model(HYP["vae"]).init(kv)})
    bf = PoseEstimator(HYP, sd, camera=PORT_CAM, dtype=torch.bfloat16,
                       device="cpu")
    assert bf.dis.Post.weight.dtype == torch.bfloat16
    assert bf.vae.de_fc2.weight.dtype == torch.float32
    frames, coms, cubes = _frames(2, seed=6)
    got = bf.predict_frames(frames, coms, cubes)
    assert got.dtype == torch.float32
    # joints sit within cube/2 * |pose| of the CoM; bf16 keeps ~3 digits
    torch.testing.assert_close(got, test.predict_frames(frames, coms, cubes),
                               rtol=0, atol=1.0)


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoseEstimator(HYP, {}, camera=PORT_CAM)


def test_strict_state_dict(pair):
    _, test = pair
    sd = {**{f"dis.{k}": v for k, v in test.dis.state_dict().items()},
          **{f"vae.{k}": v for k, v in test.vae.state_dict().items()}}
    sd.pop("vae.de_fc2.bias")
    with pytest.raises(RuntimeError, match="de_fc2.bias"):
        PoseEstimator(HYP, sd, camera=PORT_CAM, device="cpu")


# ---------------------------------------------------------------------------
# sharded serving: PoseEstimator(devices=...), the counterpart of the JAX
# package's PoseEstimator(mesh=...)
# ---------------------------------------------------------------------------

def _state_dict(est):
    return {**{f"dis.{k}": v for k, v in est.dis.state_dict().items()},
            **{f"vae.{k}": v for k, v in est.vae.state_dict().items()}}


def test_sharded_estimator_matches_single(pair):
    """Two replicas on the CPU, each regressing its contiguous half of the
    batch, give the single estimator's joints, crops' poses and CoMs (the
    same modules on fewer rows: float32 sums of another length, held to
    FRAMES_MM)."""
    _, single = pair
    multi = PoseEstimator(HYP, _state_dict(single), camera=PORT_CAM,
                          devices=("cpu", "cpu"))
    assert len(multi.replicas) == 2 and multi.device == torch.device("cpu")
    assert multi.replicas[0].frames.dis is not multi.replicas[1].frames.dis
    frames, coms, cubes = _frames(4)
    got = multi.predict_frames(frames, coms, cubes)
    assert got.shape == (4, 36, 3)
    np.testing.assert_allclose(got.numpy(),
                               single.predict_frames(frames, coms,
                                                     cubes).numpy(),
                               rtol=0, atol=FRAMES_MM)
    joints, got_coms = multi.predict_raw(frames, return_coms=True)
    want_joints, want_coms = single.predict_raw(frames, return_coms=True)
    assert torch.equal(got_coms, want_coms)
    np.testing.assert_allclose(joints.numpy(), want_joints.numpy(), rtol=0,
                               atol=FRAMES_MM)
    crops = np.random.RandomState(2).uniform(
        -1, 1, (4, 128, 128, 1)).astype(np.float32)
    np.testing.assert_allclose(multi.predict_crops(crops).numpy(),
                               single.predict_crops(crops).numpy(), rtol=0,
                               atol=1e-5)


def test_sharded_estimator_indivisible_batch_raises(pair):
    _, single = pair
    multi = PoseEstimator(HYP, _state_dict(single), camera=PORT_CAM,
                          devices=("cpu", "cpu"))
    frames, coms, cubes = _frames(3)
    with pytest.raises(ValueError, match="batch 3 not divisible by the mesh "
                       "data axis"):
        multi.predict_frames(frames, coms, cubes)
    with pytest.raises(ValueError, match="not divisible"):
        multi.predict_frame(frames[0], coms[0], cubes[0])
    with pytest.raises(ValueError, match="device or devices"):
        PoseEstimator(HYP, _state_dict(single), camera=PORT_CAM,
                      device="cpu", devices=("cpu", "cpu"))


def test_export_refuses_a_multi_device_estimator(pair):
    from lsps_tpu_torch.serve.export import export_pose_program

    _, single = pair
    multi = PoseEstimator(HYP, _state_dict(single), camera=PORT_CAM,
                          devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="mesh-free PoseEstimator"):
        export_pose_program(multi, batch=2, frame_shape=(48, 64))
