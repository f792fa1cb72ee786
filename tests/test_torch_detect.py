"""The PyTorch port's on-device hand detection vs the JAX package's.

Frames are ``lsps_tpu.data.synthetic.render_hand_depth`` hands plus an
empty frame and a speckle frame, both of which must give a zero CoM.
Tolerance: 2e-3 in u, v (px) and z (mm).  The CoM is a mean of masked
float32 sums over thousands of pixels, which XLA and PyTorch add up in
different orders; at 800 mm that is some 30 float32 ulps.  The slice
choice, the rounded blob centroid and the crop bounds are exact integers
and agree exactly.
"""

import numpy as np
import pytest
import torch

from lsps_tpu.data.camera import Camera
from lsps_tpu.data.synthetic import render_hand_depth
from lsps_tpu.serve.detect_jax import device_detect_batch as jax_detect
from lsps_tpu_torch.serve.detect import device_detect, device_detect_batch

torch.set_num_threads(1)

CAM = Camera.nyu()
ATOL = 2e-3


def _frames(n, seed=3):
    gen = np.random.RandomState(seed)
    frames = []
    for i in range(n):
        com3d = np.array([40.0 * i - 20.0, 15.0 * i - 10.0,
                          720.0 + 40.0 * i], np.float32)
        frames.append(render_hand_depth(CAM, com3d, 36, gen)[0])
    return np.stack(frames).astype(np.float32)


def _speckle():
    rs = np.random.RandomState(0)
    dpt = np.zeros((480, 640), np.float32)
    dpt.flat[rs.choice(480 * 640, 300, replace=False)] = 500.0
    return dpt


def _both(frames):
    cubes = np.full((len(frames), 3), 300.0, np.float32)
    want = np.asarray(jax_detect(frames, cubes, CAM.fx, CAM.fy))
    got = device_detect_batch(torch.from_numpy(frames),
                              torch.from_numpy(cubes), CAM.fx, CAM.fy)
    return got.numpy(), want


def test_detect_matches_jax():
    frames = np.concatenate([_frames(4), np.zeros((1, 480, 640), np.float32),
                             _speckle()[None]])
    got, want = _both(frames)
    assert np.all(want[:4] != 0), "JAX detector failed on a hand"
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[4:], 0.0)


@pytest.mark.parametrize("seed", [11, 12])
def test_detect_matches_jax_other_hands(seed):
    got, want = _both(_frames(3, seed=seed))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_single_frame_and_uint16():
    """``device_detect`` is the batch of one; whole-mm uint16 frames
    detect as their float32 copies."""
    frames = np.round(_frames(2, seed=4))
    cube = torch.full((3,), 300.0)
    one = device_detect(torch.from_numpy(frames[1]), cube, CAM.fx, CAM.fy)
    batch = device_detect_batch(torch.from_numpy(frames),
                                cube.expand(2, 3), CAM.fx, CAM.fy)
    torch.testing.assert_close(one, batch[1], rtol=0, atol=ATOL)
    u16 = device_detect_batch(torch.from_numpy(frames.astype(np.uint16)),
                              cube.expand(2, 3), CAM.fx, CAM.fy)
    assert torch.equal(u16, batch)
