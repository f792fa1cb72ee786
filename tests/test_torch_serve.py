"""The PyTorch port's PoseEstimator vs the JAX package's, on the CPU.

Both estimators get the same JAX-initialised weights (the port through
``from_jax_params``) and the same ``render_hand_depth`` frames.
Tolerances, in mm of metric joints: 1e-3 for ``predict_frames`` and
``predict_frame`` (bit-equal crops; float32 convs summed in another
order, about 1e-5 relative on outputs near 800 mm) and 5e-3 for
``predict_raw``, whose detected CoMs differ by up to 2e-3 px/mm (see
test_torch_detect.py) and carry that into the joints.
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

torch.set_num_threads(1)

CAM = Camera.nyu()
PORT_CAM = PortCamera.nyu()
HYP = default_hyperparameters(reg_dim=108, small=True)
HYP["dis"]["ch"] = 4
FRAMES_MM = 1e-3
RAW_MM = 5e-3


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
    jest, test = pair
    frames, _, cubes = _frames(3, seed=8)
    frames = np.concatenate([frames, np.zeros((1, 480, 640), np.float32)])
    cubes = np.concatenate([cubes, cubes[:1]])
    want_j, want_c = jest.predict_raw(frames, cubes, return_coms=True)
    got_j, got_c = test.predict_raw(frames, cubes, return_coms=True)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(got_c[3].numpy(), 0.0)
    np.testing.assert_allclose(got_j.numpy(), want_j, rtol=0, atol=RAW_MM)
    # default 300 mm cubes
    np.testing.assert_allclose(test.predict_raw(frames[:2]).numpy(),
                               want_j[:2], rtol=0, atol=RAW_MM)


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
