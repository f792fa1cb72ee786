"""The PyTorch port's crop warp vs the JAX package's.

On the CPU ``lsps_tpu_torch.serve.preprocess.crop_normalize_batch`` runs
the plain version of the warp kernel; its crops and crop affines must be
bit-equal to ``lsps_tpu``'s einsum lowering and to its Pallas kernel in
interpret mode, edge cases included.  The CUDA kernel itself is held
against the plain versions on the card (``test_cuda_*``, skipped without
one, and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lsps_tpu.data.camera import Camera
from lsps_tpu.ops.pallas.warp import crop_normalize_batch_pallas
from lsps_tpu.serve.preprocess_jax import crop_normalize_batch, crop_transform
from lsps_tpu_torch.ops.kernels.warp import (crop_normalize,
                                             crop_normalize_reference,
                                             warp_normalize,
                                             warp_normalize_reference)
from lsps_tpu_torch.serve import preprocess as P

torch.set_num_threads(1)

CAM = Camera.nyu()
H, W = 480, 640


def _blob_frames(b=3, seed=0):
    rs = np.random.RandomState(seed)
    frames = np.zeros((b, H, W), np.float32)
    for i in range(b):
        y, x = rs.randint(80, H - 200), rs.randint(80, W - 200)
        frames[i, y:y + 140, x:x + 140] = rs.uniform(650, 950, (140, 140))
    coms = np.zeros((b, 3), np.float32)
    for i in range(b):
        ys, xs = np.nonzero(frames[i])
        coms[i] = (xs.mean(), ys.mean(), frames[i][ys, xs].mean())
    return frames, coms, np.full((b, 3), 300.0, np.float32)


def _edge_frames():
    """Border CoMs, NaN/inf outside the blob, near/far outliers inside it
    (the cases of tests/test_pallas_warp.py)."""
    rs = np.random.RandomState(3)
    frames = np.zeros((4, H, W), np.float32)
    frames[0, 100:260, 0:120] = rs.uniform(700, 900, (160, 120))
    frames[1, H - 130:, W - 130:] = rs.uniform(700, 900, (130, 130))
    frames[2, 200:330, 250:380] = rs.uniform(700, 900, (130, 130))
    frames[2, 10, 10] = np.nan
    frames[2, 20, 20] = np.inf
    frames[3, 200:330, 250:380] = rs.uniform(700, 900, (130, 130))
    frames[3, 240:250, 280:290] = 100.0
    frames[3, 260:270, 300:310] = 3000.0
    coms = np.asarray([[40.0, 180.0, 800.0],
                       [float(W - 60), float(H - 60), 800.0],
                       [315.0, 265.0, 800.0],
                       [315.0, 265.0, 800.0]], np.float32)
    return frames, coms, np.full((4, 3), 300.0, np.float32)


def _zero_com_frames():
    """A failed detection: a hand in the frame, CoM (0, 0, 0).  The crop
    bounds are then infinite and M holds NaN; the crop is all far plane."""
    frames, coms, cubes = _blob_frames(b=2, seed=5)
    coms[0] = 0.0
    return frames, coms, cubes


CASES = {"blobs": _blob_frames, "edges": _edge_frames,
         "zero_com": _zero_com_frames}


def _port(frames, coms, cubes, dsize=(128, 128)):
    crops, Ms = P.crop_normalize_batch(torch.from_numpy(frames),
                                       torch.from_numpy(coms),
                                       torch.from_numpy(cubes),
                                       CAM.fx, CAM.fy, dsize)
    return crops.numpy(), Ms.numpy()


def _jax(frames, coms, cubes, pallas=False, dsize=(128, 128)):
    args = (jnp.asarray(frames), jnp.asarray(coms), jnp.asarray(cubes),
            CAM.fx, CAM.fy)
    if pallas:
        out = crop_normalize_batch_pallas(*args, dsize=dsize, interpret=True)
    else:
        out = crop_normalize_batch(*args, dsize=dsize, warp="einsum")
    return tuple(np.asarray(o) for o in out)


def _same_bits_nan_aware(a, b):
    """Equal NaN masks, and bit-equal everywhere else (-0.0 != 0.0)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_array_equal(a[ok].view(np.int32), b[ok].view(np.int32))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pallas", [False, True], ids=["einsum", "pallas"])
def test_crops_bit_equal_to_jax(case, pallas):
    frames, coms, cubes = CASES[case]()
    crops, Ms = _port(frames, coms, cubes)
    ref_crops, ref_Ms = _jax(frames, coms, cubes, pallas=pallas)
    assert crops.shape == (len(frames), 128, 128)
    np.testing.assert_array_equal(crops, ref_crops)
    _same_bits_nan_aware(Ms, ref_Ms)
    assert np.all(np.isfinite(crops))
    if case == "zero_com":
        assert np.isnan(Ms[0]).any() and np.all(crops[0] == 1.0)


def test_crops_bit_equal_to_jax_any_dsize():
    """A crop whose width is not a multiple of 4 (the kernel's scalar
    path on the card) and is not square, against the JAX einsum route."""
    frames, coms, cubes = _edge_frames()
    crops, Ms = _port(frames, coms, cubes, dsize=(90, 60))
    ref_crops, ref_Ms = _jax(frames, coms, cubes, dsize=(90, 60))
    assert crops.shape == (len(frames), 60, 90)
    np.testing.assert_array_equal(crops, ref_crops)
    _same_bits_nan_aware(Ms, ref_Ms)


def test_uint16_frames_equal_float32():
    """Whole-millimetre frames: uint16 in, the same crops as float32 in,
    and as the JAX package's."""
    frames, coms, cubes = _blob_frames(b=4, seed=7)
    frames = np.round(frames)
    u16, _ = _port(frames.astype(np.uint16), coms, cubes)
    f32, _ = _port(frames, coms, cubes)
    np.testing.assert_array_equal(u16, f32)
    np.testing.assert_array_equal(u16, _jax(frames, coms, cubes)[0])


def _jax_crop_indices(coms, cubes):
    """The per-sample builder of lsps_tpu/ops/pallas/warp.py
    (crop_normalize_batch_pallas), on the package's crop_transform."""
    def per_sample(com, cube):
        M, (xstart, ystart, wb, hb, scale, xoff, yoff) = crop_transform(
            com, cube, CAM.fx, CAM.fy, (128, 128))
        col = jnp.arange(128, dtype=jnp.float32)
        row = jnp.arange(128, dtype=jnp.float32)
        ix1 = jnp.floor((col - xoff) / scale + xstart).astype(jnp.int32)
        iy1 = jnp.floor((row - yoff) / scale + ystart).astype(jnp.int32)
        col_ok = ((col >= xoff) & (col < xoff + jnp.ceil(wb * scale))
                  & (ix1 >= 0) & (ix1 < W))
        row_ok = ((row >= yoff) & (row < yoff + jnp.ceil(hb * scale))
                  & (iy1 >= 0) & (iy1 < H))
        pars = jnp.stack([com[2] - cube[2] / 2.0, com[2] + cube[2] / 2.0,
                          com[2], cube[2] / 2.0])
        return (M, jnp.where(row_ok, iy1, -1), jnp.where(col_ok, ix1, -1),
                pars)

    out = jax.jit(jax.vmap(per_sample))(jnp.asarray(coms),
                                        jnp.asarray(cubes))
    return [np.asarray(o) for o in out]


def test_crop_indices_bit_equal_over_random_coms():
    """Crop affines, source rows/cols and tail params for 20000 random
    CoMs and cubes, CoMs on and off the frame: every one bit-equal.  Plain
    float32 division by fx and separately rounded products would miss some
    (see serve/preprocess.py)."""
    rs = np.random.RandomState(0)
    n = 20000
    coms = np.stack([rs.uniform(-50, 700, n), rs.uniform(-50, 530, n),
                     rs.uniform(200, 2000, n)], 1).astype(np.float32)
    cubes = rs.uniform(150, 400, (n, 3)).astype(np.float32)
    cubes[::2] = 300.0
    got = P.crop_indices(torch.from_numpy(coms), torch.from_numpy(cubes),
                         CAM.fx, CAM.fy, (H, W))
    for name, g, want in zip(("M", "iy", "ix", "params"), got,
                             _jax_crop_indices(coms, cubes)):
        np.testing.assert_array_equal(g.numpy(), want, err_msg=name)


def test_fma_rounds_once():
    """fma differs from a separately rounded product-sum exactly where a
    fused multiply-add does: (1 + 2^-12)^2 - 1 keeps the 2^-24 that the
    float32 product rounds away."""
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    assert P.fma(a, a, -1.0).item() == 2.0 ** -11 + 2.0 ** -24
    assert (a * a - 1.0).item() == 2.0 ** -11


def test_reference_matches_direct_gather():
    """The plain version against an explicit per-pixel loop on a small
    frame with every branch of the tail: invalid index, NaN, near, far,
    zero, in range."""
    rs = np.random.RandomState(1)
    frame = rs.uniform(600, 1000, (1, 6, 7)).astype(np.float32)
    frame[0, 0, 0] = np.nan
    frame[0, 1, 1] = 50.0      # near -> zstart
    frame[0, 2, 2] = 5000.0    # far -> 0 -> zend
    frame[0, 3, 3] = 0.0       # background -> zend
    iy = np.array([[0, 1, 2, 3, -1, 5]], np.int32)
    ix = np.array([[0, 1, 2, 3, 6, -1, 4]], np.int32)
    par = np.array([[650.0, 950.0, 800.0, 150.0]], np.float32)
    got = warp_normalize_reference(*(torch.from_numpy(a)
                                     for a in (frame, iy, ix, par)))
    want = np.empty((1, 6, 7), np.float32)
    zs, ze, cz, half = (np.float32(v) for v in par[0])
    for r in range(6):
        for c in range(7):
            v = np.float32(0.0)
            if iy[0, r] >= 0 and ix[0, c] >= 0:
                v = frame[0, iy[0, r], ix[0, c]]
                v = v if np.isfinite(v) else np.float32(0.0)
            v = zs if (v < zs and v != 0) else v
            v = np.float32(0.0) if (v > ze and v != 0) else v
            v = ze if v == 0 else v
            want[0, r, c] = (v - cz) / half
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_normalize_reference_is_indices_then_warp():
    """The plain version of the computed-index entry is crop_indices
    followed by the plain warp, and the CPU path of crop_normalize_batch."""
    frames, coms, cubes = (torch.from_numpy(a) for a in _zero_com_frames())
    crops, Ms = crop_normalize_reference(frames, coms, cubes, CAM.fx, CAM.fy)
    want_M, iy, ix, par = P.crop_indices(coms, cubes, CAM.fx, CAM.fy, (H, W))
    assert torch.equal(crops, warp_normalize_reference(frames, iy, ix, par))
    _same_bits_nan_aware(Ms.numpy(), want_M.numpy())
    got, got_M = P.crop_normalize_batch(frames, coms, cubes, CAM.fx, CAM.fy)
    assert torch.equal(got, crops)
    _same_bits_nan_aware(got_M.numpy(), Ms.numpy())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def test_cuda_crop_normalize_bit_equal():
    """The computed-index entry against its plain version on the card:
    crops and M (NaN-aware), float32 and uint16 frames, the edge cases and
    a failed detection, one launch per call (needs a CUDA device and
    nvcc)."""
    dev = _cuda()
    frames, coms, cubes = (np.concatenate(a) for a in
                           zip(_edge_frames(), _zero_com_frames()))
    c, cu = torch.from_numpy(coms).to(dev), torch.from_numpy(cubes).to(dev)
    for f in (frames, np.round(np.nan_to_num(frames)).astype(np.uint16)):
        ft = torch.from_numpy(f).to(dev)
        for dsize in ((128, 128), (90, 60)):
            before = crop_normalize.launches
            got, got_M = crop_normalize(ft, c, cu, CAM.fx, CAM.fy, dsize)
            torch.cuda.synchronize()
            assert crop_normalize.launches == before + 1
            want, want_M = crop_normalize_reference(ft, c, cu, CAM.fx,
                                                    CAM.fy, dsize)
            assert torch.equal(got, want)
            _same_bits_nan_aware(got_M.cpu().numpy(), want_M.cpu().numpy())


def test_cuda_kernel_bit_equal():
    """The CUDA kernel against its plain version on the card, float32 and
    uint16 frames (needs a CUDA device and nvcc)."""
    dev = _cuda()
    frames, coms, cubes = _edge_frames()
    Ms, iy, ix, par = P.crop_indices(torch.from_numpy(coms).to(dev),
                                     torch.from_numpy(cubes).to(dev),
                                     CAM.fx, CAM.fy, (H, W))
    for f in (frames, np.round(np.nan_to_num(frames)).astype(np.uint16)):
        ft = torch.from_numpy(f).to(dev)
        before = warp_normalize.launches
        got = warp_normalize(ft, iy, ix, par)
        torch.cuda.synchronize()
        assert warp_normalize.launches == before + 1
        want = warp_normalize_reference(ft, iy, ix, par)
        assert torch.equal(got, want)
