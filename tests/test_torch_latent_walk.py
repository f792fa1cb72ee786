"""The port's latent walk (``serve.inference.latent_walk``,
``cli/latent_walk.py``) against the JAX package's.

1. ``latent_walk`` on the JAX generator's weights (through
   ``from_jax_params``), from codes both packages encode from the same
   crops, in float64: codes and both domains' walks agree to 1e-10 (the
   same operations; the port's IN + LeakyReLU is its plain version on the
   CPU, JAX's its jnp path).  The generator runs in eval mode (no noise,
   no dropout, as JAX's ``train=False``) and the caller's mode is restored
   afterwards, a training generator's included.
2. ``cli.latent_walk.main`` resumes a 1-iteration snapshot the port's
   trainer wrote, writes the AVI (one 256 x 128 frame per step) and the
   strip, and the strip's pixels are within one grey level of the JAX
   CLI's on the same snapshot and config (float32 forwards summed in
   another order can move a value across a truncation to uint8).
"""

import os

import cv2
import numpy as np
import pytest
import torch

import jax
from jax import enable_x64

from helpers import make_synth_cfg
from lsps_tpu.config import default_hyperparameters
from lsps_tpu.models import build_model as jax_build
from lsps_tpu.ops.pallas import norm_act as J
from lsps_tpu.serve.inference import latent_walk as jax_walk
from lsps_tpu_torch.models import build_model
from lsps_tpu_torch.serve.inference import eval_mode, latent_walk
from lsps_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

F64_ATOL = 1e-10
STEPS = 5


@pytest.fixture(autouse=True)
def jnp_norms():
    J.set_pallas_enabled(False)
    yield
    J.set_pallas_enabled(None)


def _gen_pair():
    cfg = default_hyperparameters(small=True)["gen"]
    cfg["ch"] = 4
    jm = jax_build(cfg)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          jm.init(jax.random.PRNGKey(1)))
    tm = build_model(cfg).double()
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_latent_walk_matches_jax_and_restores_mode(mode):
    jm, p, tm = _gen_pair()
    rs = np.random.RandomState(3)
    img0, img1 = (rs.uniform(-1, 1, (1, 64, 64, 1)) for _ in range(2))
    with enable_x64():
        z0, z1 = jm.encode(p, img0, img1)
        want_a, want_b = jax_walk(jm, p, z0[0], z1[0], steps=STEPS)
    tm.train(mode == "train")
    with eval_mode(tm), torch.no_grad():
        c0, c1 = tm.encode(torch.from_numpy(img0), torch.from_numpy(img1))
    assert all(m.training == (mode == "train") for m in tm.modules())
    np.testing.assert_allclose(c0.numpy(), np.asarray(z0), rtol=0,
                               atol=F64_ATOL)
    np.testing.assert_allclose(c1.numpy(), np.asarray(z1), rtol=0,
                               atol=F64_ATOL)
    out_a, out_b = latent_walk(tm, c0[0], c1[0], steps=STEPS)
    assert all(m.training == (mode == "train") for m in tm.modules())
    assert out_a.shape == want_a.shape == (STEPS, 64, 64, 1)
    assert not out_a.requires_grad
    np.testing.assert_allclose(out_a.numpy(), want_a, rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(out_b.numpy(), want_b, rtol=0, atol=F64_ATOL)
    # the path's ends decode the codes themselves
    with eval_mode(tm), torch.no_grad():
        ends = tm.decode(torch.stack([c0[0], c1[0]]))
    torch.testing.assert_close(out_a[[0, -1]], ends[0], rtol=0,
                               atol=F64_ATOL)


def test_cli_writes_video_and_strip_like_jax(tmp_path):
    from lsps_tpu.cli import latent_walk as jax_cli
    from lsps_tpu_torch.cli import latent_walk as cli
    from lsps_tpu_torch.config import NetConfig
    from lsps_tpu_torch.train import LSPSTrainer
    from lsps_tpu_torch.train.trainer import fresh_state_dict

    cfg = make_synth_cfg(tmp_path, "walk", n_frames=2)
    config = NetConfig(cfg)
    hyp = config.hyperparameters
    trainer = LSPSTrainer(hyp, fresh_state_dict(hyp, 4), device="cpu")
    trainer.save(config.snapshot_prefix, 0, save_opt=False)
    out = str(tmp_path / "walk" / "walk.avi")
    cli.main(["--config", cfg, "--device", "cpu", "--steps", "4",
              "--out", out])
    strip = os.path.splitext(out)[0] + "_strip.png"
    assert os.path.isfile(out) and os.path.isfile(strip)
    avi = open(out, "rb").read()
    assert avi[:4] == b"RIFF" and avi[8:12] == b"AVI "
    assert avi.count(b"00db") == 2 * 4   # 4 frames and their index
    got = cv2.imread(strip, cv2.IMREAD_GRAYSCALE)
    assert got.shape == (128, 4 * 128)

    jax_out = str(tmp_path / "jax" / "walk.avi")
    jax_cli.main(["--config", cfg, "--steps", "4", "--out", jax_out])
    want = cv2.imread(os.path.splitext(jax_out)[0] + "_strip.png",
                      cv2.IMREAD_GRAYSCALE)
    assert want.shape == got.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_cli_without_a_card_needs_device_cpu(monkeypatch):
    from lsps_tpu_torch.cli import latent_walk as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", "exps/synth.yaml"])
