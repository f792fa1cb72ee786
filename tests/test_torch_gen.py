"""The port's SharedResGen, SharedResXGen and Mapping vs the JAX package's.

Weights are the JAX models' own initialisation, carried over by
``weights.from_jax_params`` (the ``wt`` rule for transposed convs
included) and loaded with ``strict=True``.  In float64 at test width
every public method agrees to 1e-10 with the same noise injected on both
sides: the JAX draws are recorded by wrapping ``jax.random.normal`` around
an un-jitted call.  One float32 forward at the widths of
``exps/nnyu.yaml`` agrees to 2e-4: the two frameworks sum each conv's
products in another order, which moves the last float32 bits of every
one of the 30-odd layers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from lsps_tpu.config import default_hyperparameters
from lsps_tpu.models import build_model as jax_build
from lsps_tpu.ops.pallas import norm_act as J
from lsps_tpu_torch.models import build_model
from lsps_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

F64_ATOL = 1e-10
NNYU_F32_TOL = 2e-4


def _tiny(name="SharedResGen"):
    hyp = default_hyperparameters(small=True)
    hyp["gen"]["ch"] = 4
    hyp["gen"]["name"] = name
    hyp["map"]["output_ch"] = 16
    return hyp


@pytest.fixture(autouse=True)
def jnp_norms():
    J.set_pallas_enabled(False)
    yield
    J.set_pallas_enabled(None)


def _pair(cfg, seed, f64=True):
    jm = jax_build(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    if f64:
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    tm = build_model(cfg)
    if f64:
        tm = tm.double()
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm


def recorded(fn, *args, **kw):
    """fn(*args, **kw) with every jax.random.normal draw recorded."""
    draws, orig = [], jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        out = orig(key, shape, dtype)
        draws.append(torch.from_numpy(np.array(out)))
        return out

    jax.random.normal = normal
    try:
        return fn(*args, **kw), draws
    finally:
        jax.random.normal = orig


def _close(got, want, atol=F64_ATOL, rtol=0.0):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


def _imgs(n, seed, dtype=np.float64):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 128, 128, 1)) \
        .astype(dtype)


@pytest.mark.parametrize("name", ["SharedResGen", "SharedResXGen"])
def test_generator_methods_match_jax(name):
    cfg = _tiny(name)["gen"]
    xa, xb = _imgs(2, 0), _imgs(2, 1)
    t = torch.from_numpy
    key = jax.random.PRNGKey(7)
    with enable_x64():
        jm, p, tm = _pair(cfg, seed=1)
        z = np.random.RandomState(2).randn(2, 32, 32, jm.latent_ch)
        want_joint, d_joint = recorded(jm, p, xa, xb, rng=key, train=True)
        want_enc, d_enc = recorded(jm.encode, p, xa, xb, rng=key,
                                   train=True)
        want_a2b, d_a2b = recorded(jm.forward_a2b, p, xa, rng=key,
                                   train=True)
        want_b2a, d_b2a = recorded(jm.forward_b2a, p, xb, rng=key,
                                   train=True)
        want_eval = jm(p, xa, xb)
        want_dec = jm.decode(p, z)
    assert [len(d) for d in (d_joint, d_enc, d_a2b, d_b2a)] == [1, 2, 1, 1]
    assert tuple(d_joint[0].shape) == (4, 32, 32, jm.latent_ch)
    tm.train()
    _close(tm(t(xa), t(xb), noise=d_joint[0]), want_joint)
    _close(tm.encode(t(xa), t(xb), *d_enc), want_enc)
    _close(tm.forward_a2b(t(xa), noise=d_a2b[0]), want_a2b)
    _close(tm.forward_b2a(t(xb), noise=d_b2a[0]), want_b2a)
    tm.eval()
    _close(tm(t(xa), t(xb)), want_eval)
    _close(tm.decode(t(z)), want_dec)


def test_generator_draws_from_generator_in_training():
    _, _, tm = _pair(_tiny()["gen"], seed=3)
    xa, xb = torch.from_numpy(_imgs(1, 0)), torch.from_numpy(_imgs(1, 1))
    tm.train()
    with pytest.raises(ValueError, match="generator"):
        tm(xa, xb)
    outs = [tm(xa, xb, generator=torch.Generator().manual_seed(5))[4]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    tm.eval()
    assert not torch.equal(tm(xa, xb)[4], outs[0])


def test_mapping_matches_jax():
    cfg = _tiny()["map"]
    with enable_x64():
        jm, p, tm = _pair(cfg, seed=4)
        z = np.random.RandomState(3).randn(3, cfg["input_dim"])
        want = jm(p, z)
    got = tm(torch.from_numpy(z))
    assert tuple(got.shape) == (3, 32, 32, 16)
    _close([got], [want])


def test_wt_rule_and_strict_loading():
    cfg = _tiny()["map"]
    _, params, tm = _pair(cfg, seed=5, f64=False)
    sd = from_jax_params(params)
    wt = np.asarray(params[0][0]["wt"])            # (kh, kw, I, O)
    assert wt.shape == (4, 4, 20, 64)
    assert tuple(sd["0.0.weight"].shape) == (20, 64, 4, 4)
    np.testing.assert_array_equal(sd["0.0.weight"].numpy(),
                                  wt.transpose(2, 3, 0, 1))
    assert isinstance(tm[0][0], torch.nn.ConvTranspose2d)
    gsd = from_jax_params(_pair(_tiny()["gen"], seed=6, f64=False)[1])
    assert tuple(gsd["decode_A.3.0.weight"].shape) == (16, 8, 3, 3)
    assert tuple(gsd["decode_A.5.weight"].shape) == (4, 1, 1, 1)
    assert "encode_A.3.3.weight" in gsd and "enc_shared.0.0.bias" in gsd
    del sd["3.bias"]
    with pytest.raises(RuntimeError, match="3.bias"):
        build_model(cfg).load_state_dict(sd, strict=True)


def test_shared_res_gen_nnyu_width_float32():
    """One batch-1-per-domain forward at nnyu widths (ch 64, 256-channel
    32x32 latent), eval mode."""
    cfg = default_hyperparameters()["gen"]
    jm, p, tm = _pair(cfg, seed=8, f64=False)
    xa, xb = _imgs(1, 9, np.float32), _imgs(1, 10, np.float32)
    want = jm(p, xa, xb)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(xa), torch.from_numpy(xb))
    assert tuple(got[4].shape) == (2, 32, 32, 256)
    _close(got, want, atol=NNYU_F32_TOL, rtol=NNYU_F32_TOL)
