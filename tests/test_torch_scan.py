"""The port's multi-step variants against K single JAX steps, in float64.

``pretrain_scan(raw=True)`` and ``post_scan(raw=False, mode=3)`` at K=2
and ``vae_scan`` at K=3, inputs stacked on a leading K axis (raw tuples
leaf by leaf, ``augment.stack_raw``), against K recorded un-jitted JAX
single steps with their draws injected as a list of K noise arguments:
each step's metrics (stacked to (K,)), the last step's outputs, and the
parameters after the chunk.  Without ``with_viz`` the outputs are None.
Tolerances are ``test_torch_train.py``'s.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from lsps_tpu_torch.data.augment import stack_raw
from torch_lockstep import (REG, TRAJ_ATOL, TRAJ_RTOL, batch, check_params,
                            jnp_norms,  # noqa: F401
                            pair, pretrain_noise, raw_batch, recorded)

torch.set_num_threads(1)


def _check_stacked(got, wants, what):
    k = len(wants)
    assert set(got) == set(wants[0]), what
    for key, v in got.items():
        assert tuple(v.shape) == (k,), f"{what}: {key} {tuple(v.shape)}"
        for i, want in enumerate(wants):
            np.testing.assert_allclose(float(v[i]), float(np.asarray(
                want[key])), rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                err_msg=f"{what} step {i}: {key}")


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


def test_pretrain_scan_raw_k2():
    with enable_x64():
        jt, state, port = pair()
        augment = jt._device_augment
        jt._device_augment = lambda raw: augment(raw).astype(jnp.float64)
        steps = [raw_batch(20 + k, u16=True) for k in range(2)]
        wants, noise = [], []
        for k, s in enumerate(steps):
            (state, want, jouts), d = recorded(
                jt._pretrain_update_raw, state, *s, jax.random.PRNGKey(k))
            wants.append(want)
            noise.append(pretrain_noise(d, False))
        ra = stack_raw([s[0] for s in steps])
        rb = stack_raw([s[2] for s in steps])
        assert ra[0].shape[0] == 2 and ra[0].dtype == np.uint16
        la = np.stack([s[1] for s in steps])
        lb = np.stack([s[3] for s in steps])
        mets, (outs, ia, ib) = port.pretrain_scan(ra, la, rb, lb, raw=True,
                                                  noise=noise)
        _check_stacked(mets, wants, "pretrain_scan")
        check_params(port, state, ("dis", "gen", "map"), "pretrain_scan")
        for g, w in zip(outs, jouts[0]):
            _close(g, w)
        assert np.array_equal(ia.numpy(), np.asarray(jouts[1]))
        assert np.array_equal(ib.numpy(), np.asarray(jouts[2]))


def test_post_scan_mode3_k2():
    with enable_x64():
        jt, state, port = pair()
        steps = [batch(60 + k) for k in range(2)]
        wants, noise = [], []
        for k, s in enumerate(steps):
            (state, want, jouts), d = recorded(
                jt._post_update, state, *s, jax.random.PRNGKey(k), mode=3)
            wants.append(want)
            noise.append(dict(zip(("gen", "vae_a"), d)))
        stacked = [np.stack([s[i] for s in steps]) for i in range(4)]
        mets, outs = port.post_scan(*stacked, mode=3, noise=noise)
        _check_stacked(mets, wants, "post_scan")
        check_params(port, state, ("dis",), "post_scan")
        for g, w in zip(outs, jouts):
            _close(g, w)
        mets, none = port.post_scan(*stacked, mode=3, with_viz=False)
        assert none is None
        assert all(tuple(v.shape) == (2,) for v in mets.values())


def test_vae_scan_k3():
    with enable_x64():
        jt, state, port = pair(sch_interval=1)
        ys = np.random.RandomState(70).uniform(-0.4, 0.4, (3, 8, REG))
        wants, noise = [], []
        for k in range(3):
            (state, want, jdec), d = recorded(jt._vae_update, state, ys[k],
                                              jax.random.PRNGKey(k))
            wants.append(want)
            noise.append(d[0])
        mets, dec = port.vae_scan(ys, noise=noise)
        _check_stacked(mets, wants, "vae_scan")
        _close(dec, jdec)
        check_params(port, state, ("vae",), "vae_scan")
    assert port.step == 3


def test_image_scan_equals_single_steps_on_loader_views():
    """The CLIs give an image step the loader's (B, 1, H, W) batch
    transposed to NHWC, a view whose size-1 channel has a large stride,
    and a scan the slices of a stacked chunk: the same values in other
    strides, by which the CPU convs choose their rounding.  In float32,
    two single steps on the views and a K=2 scan of the same batches
    leave the same parameters, bit for bit."""
    steps = []
    for k in range(2):
        xa, la, xb, lb = (np.asarray(v, np.float32) for v in batch(k))
        xa, xb = (np.transpose(np.transpose(x, (0, 3, 1, 2)).copy(),
                               (0, 2, 3, 1)) for x in (xa, xb))
        assert xa.strides[-1] != 4
        steps.append((xa, la, xb, lb))
    _, _, single = pair(dtype=jnp.float32)
    _, _, scanned = pair(dtype=jnp.float32)
    for s in steps:
        single.pretrain_update(*s, with_viz=False)
    scanned.pretrain_scan(*(np.stack([s[i] for s in steps])
                            for i in range(4)), with_viz=False)
    for (name, a), b in zip(single.nets.named_parameters(),
                            scanned.nets.parameters()):
        assert torch.equal(a, b), name
