"""The port's training augment against the JAX package's, bit for bit.

``lsps_tpu_torch.data.augment.recrop_normalize_batch`` against
``lsps_tpu/data/augment_jax.py:device_recrop_normalize_batch`` on the CPU:
float32 and uint16 sources; identity, translations, CoM shifts, scales and
random rotations over +-180 degrees; pixels at 0, at the NV sentinel, at
premax, below zstart and past zend.  Then raw tuples as
``FastAugmenter.raw_batch`` builds them from a synthetic dataset, float32
(7-tuple) and uint16-coded (8-tuple with ``vstar``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lsps_tpu.data.augment_jax import device_recrop_normalize_batch
from lsps_tpu.data.basetypes import encode_dpt_u16
from lsps_tpu.data.fast_augment import (FastAugmenter, NV_VAL, PAD_VALUE,
                                        _batched_com_to_transform,
                                        _batched_rotation_dst_to_src)
from lsps_tpu.data.loader import get_dataset
import lsps_tpu.data.synthetic  # noqa: F401
from lsps_tpu_torch.data import augment

torch.set_num_threads(1)

H = W = 128
SPEC = {"seed": 23455, "root": "", "subset": "train", "docom": False,
        "augment": True, "sample_poses": 0, "joint_subset": "NYU",
        "n_frames": 16, "n_joints": 36, "class_name": "dataset_hand_synth"}


def _transforms(rs):
    """(name, (n, 3, 3) dst -> src transforms) for each family."""
    n = 8
    ident = np.tile(np.eye(3), (n, 1, 1))
    trans = ident.copy()
    trans[:, 0, 2] = rs.uniform(-20, 20, n)
    trans[:, 1, 2] = rs.uniform(-20, 20, n)
    scale = ident.copy()
    s = np.abs(1.0 + rs.randn(n) * 0.05)
    scale[:, 0, 0] = scale[:, 1, 1] = s
    scale[:, :2, 2] = (1 - s[:, None]) * 64
    # CoM shifts as raw_batch makes them: M0 @ inv(M(new CoM))
    com = np.stack([rs.uniform(200, 440, n), rs.uniform(150, 330, n),
                    rs.uniform(600, 900, n)], 1)
    m0 = _batched_com_to_transform(com, (300.0, 300.0, 300.0), (H, W),
                                   588.0, 587.0)
    moved = com.copy()
    moved[:, :2] += rs.randn(n, 2) * 10.0
    m1 = _batched_com_to_transform(moved, (300.0, 300.0, 300.0), (H, W),
                                   588.0, 587.0)
    shift = np.matmul(m0, np.linalg.inv(m1))
    rot = _batched_rotation_dst_to_src((W // 2, H // 2),
                                       np.mod(rs.uniform(-180, 180, 96),
                                              360))
    return [("identity", ident), ("translation", trans), ("scale", scale),
            ("com_shift", shift), ("rotation", rot)]


def _sources(rs, n, com_z, cube_z, premax):
    """float32 mm crops of distinct in-range depths (an index off by one
    changes the crop) with sentinel pixels: 0, NV_VAL, premax, below
    zstart, past zend."""
    zs, ze = com_z - cube_z / 2, com_z + cube_z / 2
    src = np.empty((n, H, W), np.float32)
    for i in range(n):
        src[i] = (zs[i] + 5 + rs.permutation(H * W).reshape(H, W)
                  * ((ze[i] - zs[i] - 10) / (H * W)))
    src[:, :6] = 0.0
    src[:, 10:14, 20:60] = NV_VAL
    src[:, 30:34, 10:70] = premax[:, None, None]
    src[:, 50:54, 30:90] = (zs - 40)[:, None, None]
    src[:, 70:74, 40:110] = (ze + 40)[:, None, None]
    return src


def _raw(rs, minv):
    n = len(minv)
    com_z = rs.uniform(600, 900, n).astype(np.float32)
    cube_z = rs.choice([250.0, 300.0, 320.0], n).astype(np.float32)
    premax = (com_z + rs.uniform(100, 160, n)).astype(np.float32)
    zstart = com_z - cube_z / 2.0
    zend = com_z + cube_z / 2.0
    src = _sources(rs, n, com_z, cube_z, premax)
    return (src, minv, com_z, cube_z, premax, zstart, zend)


def _check(raw, what):
    want = np.asarray(device_recrop_normalize_batch(
        *raw, pad_value=PAD_VALUE, nv_val=NV_VAL))
    got = augment.recrop_normalize_batch(*raw)
    assert got.dtype == torch.float32 and got.shape == want.shape, what
    got = got.numpy()
    bad = np.argwhere(got.view(np.int32) != want.view(np.int32))
    assert bad.size == 0, (f"{what}: {len(bad)} pixels differ, first "
                           f"{bad[:4].tolist()}")
    return want


@pytest.mark.parametrize("kind", ["f32", "u16"])
def test_bit_equal_to_jax_over_transforms(kind):
    rs = np.random.RandomState(0 if kind == "f32" else 1)
    for name, minv in _transforms(rs):
        src, *rest = _raw(rs, minv)
        raw = (src, *rest)
        if kind == "u16":
            codes = np.round(src).astype(np.uint16)
            vstar = rs.uniform(500, 520, len(src)).astype(np.float32)
            codes[:, 90:92, 10:30] = 1  # decodes to vstar: below zstart
            raw = (codes, *rest, vstar)
        out = _check(raw, f"{kind} {name}")
        # every family lands pixels inside the crop and the sentinels
        # reach the output
        assert np.isfinite(out).all()
        assert (np.abs(out) <= 1.0 + 1e-6).all()


def test_out_of_range_pixels_take_the_normalized_pad():
    """A transform that sends every pixel outside the source: the crop is
    chain(pad_value) everywhere, as in JAX."""
    rs = np.random.RandomState(3)
    minv = np.tile(np.eye(3), (2, 1, 1))
    minv[:, 0, 2] = [500.0, -500.0]
    raw = _raw(rs, minv)
    out = _check(raw, "all outside")
    far = 1.0  # pad 0 -> the far plane -> +1 after normalization
    assert (out == far).all()


def _u16_dataset():
    """A synthetic dataset whose depth is snapped to whole mm and held in
    the uint16 code of ``encode_dpt_u16`` (one fractional value per frame,
    code 1, carried by ``vstar``)."""
    ds = get_dataset(SPEC)
    dpt = np.round(ds.seq.dpt).astype(np.float32)
    vs = np.random.RandomState(5).uniform(590.0, 610.0, len(ds))
    dpt[:, 60:62, 60:64] = vs.astype(np.float32)[:, None, None]
    codes, vstar = encode_dpt_u16(dpt)
    ds.seq = dataclasses.replace(ds.seq, dpt=codes, dpt_vstar=vstar)
    return ds


@pytest.mark.parametrize("kind", ["f32", "u16"])
def test_raw_batch_tuples_bit_equal(kind):
    ds = get_dataset(SPEC) if kind == "f32" else _u16_dataset()
    raw = FastAugmenter(ds).raw_batch(list(range(len(ds))))[0]
    assert len(raw) == (7 if kind == "f32" else 8)
    assert raw[0].dtype == (np.float32 if kind == "f32" else np.uint16)
    assert raw[1].dtype == np.float64
    _check(raw, f"raw_batch {kind}")
    # tensors on the CPU give the same crops as numpy inputs
    tensors = tuple(torch.from_numpy(np.asarray(a)) for a in raw)
    assert torch.equal(augment.recrop_normalize_batch(*tensors),
                       augment.recrop_normalize_batch(*raw))


def test_stack_raw_stacks_each_leaf():
    rs = np.random.RandomState(4)
    raws = [_raw(rs, np.tile(np.eye(3), (2, 1, 1))) for _ in range(3)]
    stacked = augment.stack_raw(raws)
    assert len(stacked) == 7
    for i, leaf in enumerate(stacked):
        assert leaf.shape == (3, *np.shape(raws[0][i]))
        np.testing.assert_array_equal(leaf[1], raws[1][i])


def test_uint16_needs_vstar():
    raw = _raw(np.random.RandomState(6), np.tile(np.eye(3), (1, 1, 1)))
    with pytest.raises(ValueError, match="vstar"):
        augment.recrop_normalize_batch(raw[0].astype(np.uint16), *raw[1:])
