"""The port's fused InstanceNorm ops vs ``lsps_tpu.ops.pallas.norm_act``.

The plain versions (what a CPU tensor runs) and the two autograd
Functions are held against the JAX package's jnp path and against its
Pallas kernels in interpret mode, forward and backward, for float32,
float64 and bfloat16 input.  Tolerances: float64 agrees to 1e-12 (the two
sides sum the planes in another order); float32 to 1e-5, the same reason
at float32's precision; bfloat16 y to one bfloat16 ulp (2^-7 relative),
since y is rounded from float32 values that may differ in the last bit.
The CUDA kernels are held against the plain versions on the card
(``test_cuda_kernels_match_plain``, skipped without one, and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from lsps_tpu.ops import layers as JL
from lsps_tpu.ops.pallas import norm_act as J
from lsps_tpu_torch.ops import layers as L
from lsps_tpu_torch.ops.kernels import norm_act as N
from lsps_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-5)}
BF16_ULP = 2.0 ** -7
SHAPES = [(2, 8, 8, 16), (1, 5, 7, 3)]   # NHWC, as the JAX ops take them


@pytest.fixture
def jax_route(request):
    """'jnp': the JAX package's plain path; 'pallas': its kernels in
    interpret mode (float32 only)."""
    if request.param == "pallas":
        J.set_pallas_enabled(True)
        J.set_pallas_interpret(True)
    else:
        J.set_pallas_enabled(False)
    yield request.param
    J.set_pallas_enabled(None)
    J.set_pallas_interpret(False)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().to(torch.float64).numpy().transpose(0, 2, 3, 1)


def _stats_nhwc(t):
    """(B, C, 1, 1) -> the JAX package's (B, 1, C)."""
    return t.detach().to(torch.float64).numpy()[:, None, :, 0, 0]


def _plane_nhwc(t):
    """(B, C, H, W) -> the JAX package's (B, H*W, C)."""
    b, c = t.shape[:2]
    return _nhwc(t).reshape(b, -1, c)


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _data(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 3 + 1).astype(dtype)
    res = rs.randn(*shape).astype(dtype)
    g = rs.randn(*shape).astype(dtype)
    return x, res, g


def _jax_ctx(dtype):
    return enable_x64() if dtype == "float64" else _Null()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("shape", SHAPES, ids=["8x8x16", "ragged"])
@pytest.mark.parametrize("slope", [N.SLOPE, None], ids=["lrelu", "identity"])
@pytest.mark.parametrize("dtype,jax_route", [("float64", "jnp"),
                                             ("float32", "jnp"),
                                             ("float32", "pallas")],
                         indirect=["jax_route"])
def test_in_act_plain_versions_match_jax(shape, slope, dtype, jax_route):
    x, _, g = _data(shape, dtype)
    with _jax_ctx(dtype):
        y, xhat, rstd = J._fwd_impl(jnp.asarray(x), slope)
        dx = J._bwd_impl(jnp.asarray(g), xhat, rstd, x.shape, slope)
        y, xhat, rstd, dx = (np.asarray(a) for a in (y, xhat, rstd, dx))
    ty, txhat, trstd = N.in_act_forward(_nchw(x), slope)
    tdx = N.in_act_backward(_nchw(g), txhat, trstd, slope)
    assert ty.dtype == tdx.dtype == getattr(torch, dtype)
    assert txhat.dtype == trstd.dtype == (torch.float64 if dtype == "float64"
                                          else torch.float32)
    _close(_nhwc(ty), y, dtype)
    _close(_plane_nhwc(txhat), xhat, dtype)
    _close(_stats_nhwc(trstd), rstd, dtype)
    _close(_nhwc(tdx), dx, dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=["8x8x16", "ragged"])
@pytest.mark.parametrize("dtype,jax_route", [("float64", "jnp"),
                                             ("float32", "jnp"),
                                             ("float32", "pallas")],
                         indirect=["jax_route"])
def test_in_res_plain_versions_match_jax(shape, dtype, jax_route):
    x, res, g = _data(shape, dtype, seed=1)
    with _jax_ctx(dtype):
        jx = jnp.asarray(x)
        y, mean, rstd = J._in_res_fwd_impl(jx, jnp.asarray(res))
        dx, dres = J._in_res_vjp_bwd((jx, mean, rstd), jnp.asarray(g))
        y, mean, rstd, dx, dres = (np.asarray(a)
                                   for a in (y, mean, rstd, dx, dres))
    ty, tmean, trstd = N.in_res_forward(_nchw(x), _nchw(res))
    tdx = N.in_res_backward(_nchw(g), _nchw(x), tmean, trstd)
    _close(_nhwc(ty), y, dtype)
    _close(_stats_nhwc(tmean), mean, dtype)
    _close(_stats_nhwc(trstd), rstd, dtype)
    _close(_nhwc(tdx), dx, dtype)
    np.testing.assert_array_equal(dres, g)


@pytest.mark.parametrize("jax_route", ["jnp", "pallas"], indirect=True)
def test_bf16_input_keeps_float32_moments(jax_route):
    x, res, g = _data((2, 8, 8, 16), "float32", seed=2)
    jx, jres, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, res, g))
    tx, tres, tg = (_nchw(a).to(torch.bfloat16) for a in (x, res, g))
    y, xhat, rstd = J._fwd_impl(jx, N.SLOPE)
    dx = J._bwd_impl(jg, xhat, rstd, x.shape, N.SLOPE)
    ry, _, rrstd = J._in_res_fwd_impl(jx, jres)
    ty, txhat, trstd = N.in_act_forward(tx, N.SLOPE)
    tdx = N.in_act_backward(tg, txhat, trstd, N.SLOPE)
    tyr, _, trrstd = N.in_res_forward(tx, tres)
    assert ty.dtype == tdx.dtype == tyr.dtype == torch.bfloat16
    assert txhat.dtype == trstd.dtype == torch.float32
    _close(_plane_nhwc(txhat), np.asarray(xhat), "float32")
    _close(_stats_nhwc(trstd), np.asarray(rstd), "float32")
    _close(_stats_nhwc(trrstd), np.asarray(rrstd), "float32")
    for got, want in ((ty, y), (tdx, dx), (tyr, ry)):
        np.testing.assert_allclose(_nhwc(got),
                                   np.asarray(want, np.float64),
                                   rtol=BF16_ULP, atol=BF16_ULP)


_PUBLIC = {
    "lrelu": (J.fused_instance_norm_leaky_relu,
              N.fused_instance_norm_leaky_relu, 1),
    "identity": (J.fused_instance_norm, N.fused_instance_norm, 1),
    "residual": (J.fused_instance_norm_residual,
                 N.fused_instance_norm_residual, 2),
}


@pytest.mark.parametrize("op", sorted(_PUBLIC))
@pytest.mark.parametrize("dtype,jax_route", [("float64", "jnp"),
                                             ("float32", "pallas")],
                         indirect=["jax_route"])
def test_public_ops_and_vjp_match_jax(op, dtype, jax_route):
    jop, top, nargs = _PUBLIC[op]
    x, res, g = _data((2, 6, 6, 8), dtype, seed=3)
    args = (x, res)[:nargs]
    with _jax_ctx(dtype):
        y, vjp = jax.vjp(jop, *(jnp.asarray(a) for a in args))
        grads = [np.asarray(a) for a in vjp(jnp.asarray(g))]
        y = np.asarray(y)
    targs = [_nchw(a).requires_grad_(True) for a in args]
    ty = top(*targs)
    tgrads = torch.autograd.grad(ty, targs, _nchw(g))
    _close(_nhwc(ty), y, dtype)
    for got, want in zip(tgrads, grads):
        _close(_nhwc(got), want, dtype)


@pytest.mark.parametrize("op", sorted(_PUBLIC))
def test_gradcheck_float64(op):
    _, top, nargs = _PUBLIC[op]
    rs = np.random.RandomState(4)
    args = [torch.from_numpy(rs.randn(2, 3, 4, 5) * 2 + 0.5)
            .requires_grad_(True) for _ in range(nargs)]
    assert torch.autograd.gradcheck(top, args, eps=1e-6, atol=1e-6)


def test_res_block_fused_route_matches_default():
    """LeakyINSResBlock with the fused IN + residual tail == the default
    tail (plain IN, then the add), values and gradients, and both == the
    JAX block."""
    jblock = JL.leaky_ins_res_block(8, 8)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          jblock.init(jax.random.PRNGKey(0)))
    x = np.random.RandomState(5).randn(2, 8, 8, 8)
    block = L.LeakyINSResBlock(8, 8).double()
    block.load_state_dict(from_jax_params(params), strict=True)
    J.set_pallas_enabled(False)
    try:
        with enable_x64():
            want = np.asarray(jblock.apply(params, jnp.asarray(x)))
    finally:
        J.set_pallas_enabled(None)
    outs, grads = [], []
    try:
        for fused in (False, True):
            N.set_in_res_fused(fused)
            assert N.in_res_fused_enabled() is fused
            before = {k: f.launches for k, f in N.KERNELS.items()}
            tx = _nchw(x).requires_grad_(True)
            y = block(tx)
            gs = torch.autograd.grad((y ** 2).sum(),
                                     [tx, *block.parameters()])
            assert {k: f.launches for k, f in N.KERNELS.items()} == before
            outs.append(y.detach())
            grads.append(gs)
    finally:
        N.set_in_res_fused(None)
    for y in outs:
        _close(_nhwc(y), want, "float64")
    # both conv biases feed an InstanceNorm: their gradients are zero up
    # to reduction noise on each route, so they are held to ~0, not to
    # each other
    names = ["x"] + [n for n, _ in block.named_parameters()]
    for name, a, b in zip(names, *grads):
        if name.endswith("bias"):
            assert float(a.abs().max()) < 1e-9
            assert float(b.abs().max()) < 1e-9
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                       atol=1e-10, err_msg=name)


def test_in_res_switch_reads_the_environment(monkeypatch):
    N.set_in_res_fused(None)
    monkeypatch.setenv("LSPS_FUSED_IN_RES", "1")
    assert N.in_res_fused_enabled() and J.in_res_fused_enabled()
    monkeypatch.setenv("LSPS_FUSED_IN_RES", "0")
    assert not N.in_res_fused_enabled() and not J.in_res_fused_enabled()


def test_cuda_kernels_match_plain():
    """The four CUDA kernels against the plain versions on the card, f32
    and bf16, with an aligned and a ragged plane (needs a CUDA device and
    nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for shape in ((2, 16, 32, 32), (3, 5, 7, 9)):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(0)
            x, res, g = (torch.randn(shape, generator=gen, device=dev)
                         .to(dtype) for _ in range(3))
            y, xhat, rstd = N.in_act_forward(x, N.SLOPE)
            dx = N.in_act_backward(g, xhat, rstd, N.SLOPE)
            yr, mean, rstd2 = N.in_res_forward(x, res)
            dxr = N.in_res_backward(g, x, mean, rstd2)
            torch.cuda.synchronize()
            want = (*N.in_act_forward_reference(x, N.SLOPE),
                    N.in_act_backward_reference(g, xhat, rstd, N.SLOPE),
                    *N.in_res_forward_reference(x, res),
                    N.in_res_backward_reference(g, x, mean, rstd2))
            tol = 1e-5 if dtype == torch.float32 else BF16_ULP * 4
            for got, w in zip((y, xhat, rstd, dx, yr, mean, rstd2, dxr),
                              want):
                torch.testing.assert_close(got.float(), w.float(),
                                           rtol=tol, atol=tol)
