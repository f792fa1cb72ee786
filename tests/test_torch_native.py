"""The port's bindings of its native host library
(``lsps_tpu_torch.native``) against the JAX package's
(``lsps_tpu.native``), held as ``tests/test_native.py`` holds the JAX
module.

Both libraries compile the same C source with the same flags, so the
port's ``warp_perspective_nn`` and ``normalize_batch`` equal the JAX
module's bit for bit.  The warp agrees with cv2's
``warpPerspective(INTER_NEAREST)`` on more than 98 % of the pixels (it
rounds double coordinates half away from zero, cv2 float32 ones half to
even), and ``normalize_batch`` with ``data.augment.normalize`` within 1e-6,
the JAX test's bounds.
"""

import numpy as np
import pytest

import cv2
from lsps_tpu import native as jnative
from lsps_tpu_torch import native
from lsps_tpu_torch.data.augment import normalize

M = np.array([[0.8, 0.1, 3.0], [-0.05, 0.9, 2.0], [0, 0, 1]], np.float64)


def test_both_libraries_build():
    assert native.available() and jnative.available()


@pytest.mark.parametrize("dsize", [(64, 64), (48, 80)])
def test_warp_perspective_nn_matches_jax_and_cv2(rng, dsize):
    src = rng.uniform(600, 900, (64, 64)).astype(np.float32)
    minv = np.linalg.inv(M)
    ours = native.warp_perspective_nn(src, minv, dsize, border=0.0)
    assert ours.shape == dsize and ours.dtype == np.float32
    np.testing.assert_array_equal(
        ours, jnative.warp_perspective_nn(src, minv, dsize, border=0.0))
    theirs = cv2.warpPerspective(src, M, dsize[::-1],
                                 flags=cv2.INTER_NEAREST,
                                 borderMode=cv2.BORDER_CONSTANT,
                                 borderValue=0.0)
    agree = np.mean(ours == theirs)
    assert agree > 0.98, f"only {agree:.2%} pixels agree with cv2"


def test_warp_perspective_nn_border_and_perspective(rng):
    src = rng.uniform(600, 900, (32, 40)).astype(np.float32)
    persp = np.array([[1.1, 0.05, -6.0], [0.02, 0.95, 4.0],
                      [1e-3, -5e-4, 1.0]])
    ours = native.warp_perspective_nn(src, persp, (40, 48), border=-7.0)
    np.testing.assert_array_equal(
        ours, jnative.warp_perspective_nn(src, persp, (40, 48), border=-7.0))
    assert (ours == -7.0).any() and (ours != -7.0).any()


def test_normalize_batch_matches_jax_and_normalize(rng):
    n = 4
    src = rng.uniform(600, 900, (n, 16, 16)).astype(np.float32)
    src[:, 0, 0] = 0.0
    com = np.stack([np.zeros(n), np.zeros(n),
                    rng.uniform(700, 800, n)], 1).astype(np.float32)
    cube = np.full((n, 3), 300.0, np.float32)
    out = native.normalize_batch(src, com[:, 2], cube[:, 2])
    assert out.shape == src.shape and out.dtype == np.float32
    np.testing.assert_array_equal(
        out, jnative.normalize_batch(src, com[:, 2], cube[:, 2]))
    for b in range(n):
        ref = normalize(src[b].copy(), com[b], cube[b])
        np.testing.assert_allclose(out[b], ref, atol=1e-6)


def test_shapes_are_checked_before_the_call(rng):
    src = rng.uniform(600, 900, (2, 8, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="one"):
        native.warp_perspective_nn(src, np.eye(3), (8, 8))
    with pytest.raises(ValueError, match="2 samples"):
        native.normalize_batch(src, np.full(3, 750.0), np.full(2, 300.0))
