"""The PyTorch port's SharedDis and PoseVAE vs the JAX package's.

Weights are the JAX models' own initialisation, carried over by
``lsps_tpu_torch.weights.from_jax_params`` and loaded with
``strict=True``; inputs come from a numpy seed.  At the widths of
``exps/nnyu.yaml`` both sides run in float64 (JAX under ``enable_x64``,
torch ``.double()``) and agree to 1e-9.  In float32 at test widths they
agree to 1e-5 relative: the two frameworks sum a conv's products in a
different order, which moves the last bits of each layer's output.
"""

import numpy as np
import pytest
import torch

import jax
from jax import enable_x64

from lsps_tpu.config import default_hyperparameters
from lsps_tpu.models import build_model as jax_build
from lsps_tpu_torch.config import default_hyperparameters as port_hyp
from lsps_tpu_torch.models import build_model
from lsps_tpu_torch.ops import layers as L
from lsps_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

NNYU = default_hyperparameters()               # ch 64, reg_dim 108
SMALL = default_hyperparameters(small=True)    # ch 8
F64_ATOL = 1e-9
F32_RTOL, F32_ATOL = 1e-5, 1e-5


def _pair(cfg, seed=0):
    jm = jax_build(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg)
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm.eval()


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _close(got, want, f64):
    got = [g.detach().numpy() for g in got]
    want = [np.asarray(w) for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        if f64:
            np.testing.assert_allclose(g, w, rtol=0, atol=F64_ATOL)
        else:
            np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL)


def _crops(n, seed, dtype):
    rs = np.random.RandomState(seed)
    return rs.uniform(-1, 1, (n, 128, 128, 1)).astype(dtype)


def test_config_copy_matches():
    assert port_hyp() == default_hyperparameters()
    assert port_hyp(small=True) == default_hyperparameters(small=True)


def test_state_dict_keys_follow_pytree():
    _, params, tm = _pair(SMALL["dis"])
    sd = from_jax_params(params)
    assert "model_B.0.0.weight" in sd and "model_S.3.0.bias" in sd
    assert tuple(sd["model_B.0.0.weight"].shape) == (8, 1, 7, 7)
    assert set(sd) == set(tm.state_dict())
    _, vparams, _ = _pair(SMALL["vae"])
    vsd = from_jax_params(vparams)
    assert tuple(vsd["de_fc1.0.weight"].shape) == (50, 20)
    with pytest.raises(RuntimeError):
        build_model(NNYU["dis"]).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("f64", [True, False], ids=["nnyu_f64", "small_f32"])
def test_shared_dis_matches_jax(f64):
    cfg = NNYU["dis"] if f64 else SMALL["dis"]
    jm, params, tm = _pair(cfg, seed=1)
    dtype = np.float64 if f64 else np.float32
    x2 = _crops(2, 0, dtype)
    x1 = [_crops(1, s, dtype) for s in range(1, 5)]
    if f64:
        params, tm = _f64(params), tm.double()

    def jax_side():
        return (jm.regress_a(params, x2)[0], jm.regress_b(params, x2)[0],
                *jm(params, x1[0], x1[1]), *jm.feats(params, *x1))

    if f64:
        with enable_x64():
            want = jax_side()
    else:
        want = jax_side()
    t = [torch.from_numpy(a) for a in [x2] + x1]
    with torch.no_grad():
        got = (tm.regress_a(t[0])[0], tm.regress_b(t[0])[0],
               *tm(t[1], t[2]), *tm.feats(*t[1:]))
    assert got[1].shape == (2, cfg["post_dim"])
    _close(got, want, f64)


@pytest.mark.parametrize("f64", [True, False], ids=["nnyu_f64", "nnyu_f32"])
def test_pose_vae_matches_jax(f64):
    jm, params, tm = _pair(NNYU["vae"], seed=2)
    dtype = np.float64 if f64 else np.float32
    rs = np.random.RandomState(5)
    y = rs.randn(2, 108).astype(dtype)
    z = rs.randn(2, 20).astype(dtype)
    key = jax.random.PRNGKey(9)
    if f64:
        params, tm = _f64(params), tm.double()

    def jax_side():
        enc = jm.encode(params, y)
        noisy = jm.encode(params, y, rng=key)
        noise = jax.random.normal(key, enc[1].shape, enc[1].dtype)
        return (*enc, *noisy, jm.decode(params, z), *jm(params, y)), noise

    if f64:
        with enable_x64():
            want, noise = jax_side()
    else:
        want, noise = jax_side()
    ty, tz = torch.from_numpy(y), torch.from_numpy(z)
    with torch.no_grad():
        got = (*tm.encode(ty), *tm.encode(ty, noise=torch.from_numpy(
            np.array(noise))), tm.decode(tz), *tm(ty))
    _close(got, want, f64)


def test_pose_vae_generator_noise():
    _, _, tm = _pair(SMALL["vae"])
    y = torch.randn(3, 108, generator=torch.Generator().manual_seed(0))
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    with torch.no_grad():
        z1, mu, _ = tm.encode(y, generator=g1)
        z2, _, _ = tm.encode(y, generator=g2)
    assert torch.equal(z1, z2) and not torch.equal(z1, mu)


def test_leaky_relu_and_softplus_match_jax():
    x = np.array([-3.0, -1e-30, -0.0, 0.0, 1e-30, 2.5, 30.0, -30.0,
                  np.nan], np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        L.leaky_relu(t).numpy(),
        np.asarray(jax.numpy.where(x >= 0, x, 0.01 * x)))
    np.testing.assert_array_equal(np.signbit(L.leaky_relu(t).numpy()),
                                  np.signbit(x))
    np.testing.assert_allclose(L.softplus(t).numpy(),
                               np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=0)


def test_reset_parameters_uses_generator():
    a, b = build_model(SMALL["dis"]), build_model(SMALL["dis"])
    L.reset_parameters(a, torch.Generator().manual_seed(3))
    L.reset_parameters(b, torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.model_S[3][0].weight.detach()
    assert abs(float(w.std()) - 0.02) < 0.002
