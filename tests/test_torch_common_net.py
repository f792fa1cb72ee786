"""The port's block library (``ops/common_net.py``) and im2col stem against
the JAX package's (``lsps_tpu/ops/layers.py:457-691``, ``:65-103``).

Every block is initialised by the JAX package, carried across with
``weights.from_jax_params`` and loaded with ``strict=True``; the same numpy
input goes through both in float64 (JAX under ``enable_x64``, torch
``.double()``): outputs and the gradient of a squared sum with respect to
the input and every parameter agree within 1e-10.  ``to_jax_params`` gives
the JAX tree back.  ``GaussianSmoother`` is also held against cv2's
``filter2D`` with a replicate border, as the JAX test holds the JAX one;
the VAE heads' sampling path against JAX's with the same noise; and the
im2col stem against the conv, forward and backward, both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from lsps_tpu.ops import layers as JL
from lsps_tpu_torch.ops import common_net as C
from lsps_tpu_torch.ops import layers as PL
from lsps_tpu_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

TOL = 1e-10
KEY = jax.random.PRNGKey(0)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape) * 0.7


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1)) if a.ndim == 4 else a


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _assert_trees_equal(a, b, what):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb, (what, ta, tb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=what)


# (name, JAX maker, port maker, input shape NHWC or NC)
BLOCKS = [
    ("leaky_relu_ins_conv2d", lambda: JL.leaky_relu_ins_conv2d(3, 5, 3, 1, 1),
     lambda: C.LeakyReLUINSConv2d(3, 5, 3, 1, 1), (2, 8, 8, 3)),
    ("leaky_relu_ins_conv_transpose2d",
     lambda: JL.leaky_relu_ins_conv_transpose2d(3, 5, 3, 2, 1, 1),
     lambda: C.LeakyReLUINSConvTranspose2d(3, 5, 3, 2, 1, 1), (2, 8, 8, 3)),
    ("relu_ins_conv2d", lambda: JL.relu_ins_conv2d(3, 5, 3, 2, 1),
     lambda: C.ReLUINSConv2d(3, 5, 3, 2, 1), (2, 8, 8, 3)),
    ("relu_ins_conv_transpose2d",
     lambda: JL.relu_ins_conv_transpose2d(3, 5, 3, 2, 1, 1),
     lambda: C.ReLUINSConvTranspose2d(3, 5, 3, 2, 1, 1), (2, 8, 8, 3)),
    ("leaky_relu_bn_conv2d", lambda: JL.leaky_relu_bn_conv2d(3, 5, 3, 1, 1),
     lambda: C.LeakyReLUBNConv2d(3, 5, 3, 1, 1), (2, 8, 8, 3)),
    ("leaky_relu_bn_conv_transpose2d",
     lambda: JL.leaky_relu_bn_conv_transpose2d(3, 5, 3, 2, 1, 1),
     lambda: C.LeakyReLUBNConvTranspose2d(3, 5, 3, 2, 1, 1), (2, 8, 8, 3)),
    ("leaky_relu_bnns_conv2d",
     lambda: JL.leaky_relu_bnns_conv2d(3, 5, 3, 1, 1),
     lambda: C.LeakyReLUBNNSConv2d(3, 5, 3, 1, 1), (2, 8, 8, 3)),
    ("leaky_relu_bnns_conv_transpose2d",
     lambda: JL.leaky_relu_bnns_conv_transpose2d(3, 5, 3, 1, 1),
     lambda: C.LeakyReLUBNNSConvTranspose2d(3, 5, 3, 1, 1), (2, 8, 8, 3)),
    ("leaky_relu_bn_linear", lambda: JL.leaky_relu_bn_linear(6, 4),
     lambda: C.LeakyReLUBNLinear(6, 4), (5, 6)),
    ("leaky_relu_res_block", lambda: JL.leaky_relu_res_block(3, 3, 3, 1, 1),
     lambda: C.LeakyReLUResBlock(3, 3, 3, 1, 1), (2, 8, 8, 3)),
    ("leaky_relu_bnns_res_block",
     lambda: JL.leaky_relu_bnns_res_block(3, 3, 3, 1, 1),
     lambda: C.LeakyReLUBNNSResBlock(3, 3, 3, 1, 1), (2, 8, 8, 3)),
    ("bias2d", lambda: JL.bias2d(3), lambda: C.Bias2d(3), (2, 8, 8, 3)),
    ("batch_norm_affine", lambda: JL.batch_norm_layer(3, affine=True),
     lambda: C.BatchNorm(3, affine=True), (2, 8, 8, 3)),
    ("batch_norm_1d", lambda: JL.batch_norm_layer(4, affine=False),
     lambda: C.BatchNorm(4, affine=False), (16, 4)),
    ("gaussian_smoother_5", lambda: JL.gaussian_smoother(5),
     lambda: C.GaussianSmoother(5), (2, 8, 8, 3)),
    ("gaussian_smoother_9", lambda: JL.gaussian_smoother(9),
     lambda: C.GaussianSmoother(9), (1, 12, 12, 2)),
]


def _perturbed(params, seed):
    """The JAX init with every leaf moved off its preset value (ones,
    zeros), so that an affine slot that read the wrong leaf shows."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(a, np.float64) + rs.randn(*np.shape(a)) * 0.1
        for a in leaves])


@pytest.mark.parametrize("name,jmake,pmake,shape", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_block_matches_jax_in_float64(name, jmake, pmake, shape):
    lay = jmake()
    params = _perturbed(lay.init(KEY), 1)
    port = pmake().double()
    port.load_state_dict(from_jax_params(params), strict=True)
    _assert_trees_equal(to_jax_params(port), params, name)
    x = _x(shape)
    with enable_x64():
        p64, x64 = _f64(params), jnp.asarray(x, jnp.float64)
        want = np.asarray(lay.apply(p64, x64))

        def loss(p, xx):
            return jnp.sum(jnp.square(lay.apply(p, xx)))

        gp, gx = jax.grad(loss, argnums=(0, 1))(p64, x64)
    xt = torch.tensor(_nchw(x), requires_grad=True)
    got = port(xt)
    np.testing.assert_allclose(got.detach().numpy(), _nchw(want), rtol=0,
                               atol=TOL, err_msg=name)
    got.square().sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _nchw(np.asarray(gx)),
                               rtol=0, atol=TOL * 100, err_msg=name)
    want_g = from_jax_params(jax.tree_util.tree_map(np.asarray, gp))
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   rtol=0, atol=TOL * 100,
                                   err_msg=f"{name} {k}")


def test_gaussian_smoother_matches_cv2_filter2d():
    cv2 = pytest.importorskip("cv2")
    x = _x((2, 3, 8, 8)).astype(np.float32)
    y = C.GaussianSmoother(5)(torch.from_numpy(x)).numpy()
    k1 = cv2.getGaussianKernel(5, -1)
    k2 = (k1 @ k1.T).astype(np.float32)
    for c in range(3):
        ref = cv2.filter2D(x[0, c], -1, k2, borderType=cv2.BORDER_REPLICATE)
        np.testing.assert_allclose(y[0, c], ref, rtol=1e-5, atol=1e-5)
    for k in (3, 5, 7):
        np.testing.assert_array_equal(
            C.gaussian_kernel_1d(k), JL._gaussian_kernel_1d(k))
    np.testing.assert_allclose(C.gaussian_kernel_1d(9),
                               JL._gaussian_kernel_1d(9), rtol=0, atol=0)
    assert dict(C.GaussianSmoother(5).state_dict()) == {}


@pytest.mark.parametrize("two_d", [False, True], ids=["linear", "conv"])
def test_vae_heads_match_jax_and_sample_with_injected_noise(two_d):
    if two_d:
        head, port, shape = (JL.GaussianVAE2DHead(3, 5, 3, 2, 1),
                             C.GaussianVAE2DHead(3, 5, 3, 2, 1),
                             (2, 8, 8, 3))
    else:
        head, port, shape = (JL.GaussianVAEHead(6, 4),
                             C.GaussianVAEHead(6, 4), (3, 6))
    params = head.init(KEY)
    port = port.double()
    port.load_state_dict(from_jax_params(params), strict=True)
    x = _x(shape)
    rng = jax.random.PRNGKey(1)
    with enable_x64():
        z, mu, sd = head.sample(_f64(params), jnp.asarray(x, jnp.float64),
                                rng)
        noise = jax.random.normal(rng, mu.shape, mu.dtype)
    zt, mut, sdt = port.sample(torch.from_numpy(_nchw(x)),
                               noise=torch.from_numpy(_nchw(
                                   np.array(noise))))
    for g, w in ((zt, z), (mut, mu), (sdt, sd)):
        np.testing.assert_allclose(g.detach().numpy(),
                                   _nchw(np.asarray(w)), rtol=0, atol=TOL)
    assert (sdt > 0).all()
    # drawn from a generator: the same draws for the same seed
    g1 = port.sample(torch.from_numpy(_nchw(x)),
                     generator=torch.Generator().manual_seed(3))[0]
    g2 = port.sample(torch.from_numpy(_nchw(x)),
                     generator=torch.Generator().manual_seed(3))[0]
    assert torch.equal(g1, g2) and not torch.equal(g1, mut)
    with pytest.raises(ValueError, match="noise or a generator"):
        port.sample(torch.from_numpy(_nchw(x)))


def test_fresh_blocks_draw_the_preset_distributions():
    gen = torch.Generator().manual_seed(0)
    head = C.GaussianVAEHead(256, 256)
    PL.reset_parameters(head, gen)
    assert head.en_mu.weight.std().item() == pytest.approx(0.002, rel=0.05)
    assert head.en_sigma.bias.abs().max().item() < 0.02
    bias = C.Bias2d(4096)
    PL.reset_parameters(bias, gen)
    assert bias.bias.std().item() == pytest.approx(0.002, rel=0.05)
    bn = C.BatchNorm(8)
    PL.reset_parameters(bn, gen)
    assert torch.equal(bn.weight, torch.ones(8))
    assert torch.equal(bn.bias, torch.zeros(8))
    assert dict(C.BatchNorm(8, affine=False).state_dict()) == {}


@pytest.fixture
def _stem_flags():
    yield
    PL.set_im2col_stem(None)
    JL.set_im2col_stem(None)


@pytest.mark.parametrize("k,stride,padding", [(7, 2, 3), (3, 2, 1),
                                              (5, 1, 2)])
def test_im2col_stem_equals_the_conv_and_jaxs(k, stride, padding,
                                              _stem_flags, monkeypatch):
    lay = JL.conv2d(1, 8, k, stride, padding)
    params = lay.init(KEY)
    conv = PL.Conv2d(1, 8, k, stride, padding).double()
    conv.load_state_dict(from_jax_params(params), strict=True)
    x = _x((2, 16, 16, 1), 2)
    outs, grads = [], []
    for on in (False, True):
        assert PL.set_im2col_stem(on) == (None if not on else False)
        assert PL.im2col_stem_enabled() is on
        xt = torch.tensor(_nchw(x), requires_grad=True)
        y = conv(xt)
        y.square().sum().backward()
        outs.append(y.detach().numpy())
        grads.append(np.concatenate([xt.grad.numpy().ravel(),
                                     conv.weight.grad.numpy().ravel()]))
        conv.zero_grad()
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=TOL * 100)
    JL.set_im2col_stem(True)
    with enable_x64():
        want = np.asarray(lay.apply(_f64(params),
                                    jnp.asarray(x, jnp.float64)))
    np.testing.assert_allclose(outs[1], _nchw(want), rtol=0, atol=TOL)
    # the environment decides when the switch is left None
    PL.set_im2col_stem(None)
    monkeypatch.setenv("LSPS_IM2COL_STEM", "1")
    assert PL.im2col_stem_enabled()
    monkeypatch.setenv("LSPS_IM2COL_STEM", "0")
    assert not PL.im2col_stem_enabled()


def test_im2col_stem_leaves_other_convs_alone(_stem_flags, monkeypatch):
    calls = []
    real = PL.patches_gemm
    monkeypatch.setattr(PL, "patches_gemm",
                        lambda *a: calls.append(1) or real(*a))
    PL.set_im2col_stem(True)
    x = torch.randn(1, 2, 8, 8, dtype=torch.float64)
    PL.Conv2d(2, 4, 3, 1, 1).double()(x)          # two input channels
    PL.Conv2d(1, 4, 1, 1, 0).double()(x[:, :1])   # a 1 x 1 kernel
    assert calls == []
    PL.Conv2d(1, 4, 3, 1, 1).double()(x[:, :1])
    assert calls == [1]
