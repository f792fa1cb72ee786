"""The detection kernel (``csrc/detect.cu``, the op ``lsps::detect_coms``)
against its plain version on the card.

Every test needs a CUDA device and nvcc and skips without them: the
kernel has no CPU mode.  The file imports no JAX, so it runs on a machine
without it (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_detect_cuda.py

Inputs: the 48 random hands of ``tests/test_torch_detect.py``'s sweep and
its ``_frames`` (rendered by the port's ``render_hand_depth``, which draws
the JAX package's pixels), the empty, speckle and flat frames, a frame
with depths above 6500, a hand cut by the frame's border, a blob too
small to qualify, float32 frames with a NaN and an infinite pixel; float32
and whole-mm uint16; batches 1, 7 and 256; several (steps, interior_min,
refine_iters, first_slice).  The bound is ``tests/test_torch_detect.py``'s:
u and v equal, z within ``COM_Z_ULPS`` float32 ulps.  The kernel's sums are
exact and the plain version's float32, so z may differ where the plain
sums round; u and v are whole-number sums below 2**24 in both.
"""

import numpy as np
import pytest
import torch

from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.data.synthetic import render_hand_depth
from lsps_tpu_torch.serve.detect import (FIRST_SLICE, device_detect_batch,
                                         device_detect_batch_reference)

CAM = Camera.nyu()
H, W = 480, 640
COM_Z_ULPS = 128   # tests/test_torch_detect.py derives it
SWEEP_HANDS = 48
BATCHES = (1, 7, 256)
# (steps, interior_min, refine_iters, first_slice): the default first
ARGS = ((65, 150, 5, FIRST_SLICE), (65, 150, 0, FIRST_SLICE),
        (40, 0, 2, 20), (127, 400, 1, FIRST_SLICE), (65, 150, 3, 0))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _hands(coms3d, seed):
    rs = np.random.RandomState(seed)
    return np.stack([render_hand_depth(CAM, np.asarray(c, np.float32), 36,
                                       rs)[0] for c in coms3d])


def sweep_hands(n=SWEEP_HANDS, seed=0):
    """``tests/test_torch_detect.py:sweep_hands``, drawn the same way."""
    rs = np.random.RandomState(seed)
    frames = []
    for _ in range(n):
        com3d = np.array([rs.uniform(-120, 120), rs.uniform(-80, 80),
                          rs.uniform(500, 1100)], np.float32)
        frames.append(render_hand_depth(CAM, com3d, 36, rs)[0])
    return np.stack(frames).astype(np.float32)


def _frames(n, seed=3):
    """``tests/test_torch_detect.py:_frames``."""
    return _hands([[40.0 * i - 20.0, 15.0 * i - 10.0, 720.0 + 40.0 * i]
                   for i in range(n)], seed)


def edge_frames():
    """(name, (n, H, W) float32) of the cases beyond the hands."""
    rs = np.random.RandomState(0)
    speckle = np.zeros((H, W), np.float32)
    speckle.flat[rs.choice(H * W, 300, replace=False)] = 500.0
    far = _frames(1, seed=8)[0]
    far[far == 0] = 7200.0          # a wall beyond 6500 mm
    far[:40, :60] = 9000.0
    border = _hands([[330.0, 10.0, 700.0]], 9)[0]   # cut by the right edge
    small = np.zeros((H, W), np.float32)
    small[200:210, 300:310] = 800.0                 # 64 interior pixels
    nan = _frames(1, seed=10)[0]
    nan[5, 7] = np.nan
    inf = _frames(1, seed=11)[0]
    inf[9, 3] = np.inf
    return [("empty", np.zeros((1, H, W), np.float32)),
            ("speckle", speckle[None]),
            ("flat", np.full((1, H, W), 800.0, np.float32)),
            ("far", far[None]), ("border", border[None]),
            ("small", small[None]), ("nan", nan[None]),
            ("inf", inf[None])]


def all_frames():
    """Every case as one float32 batch, the hands first, and its names."""
    edges = edge_frames()
    frames = np.concatenate([sweep_hands(), _frames(4)]
                            + [f for _, f in edges])
    names = ([f"sweep{i}" for i in range(SWEEP_HANDS)]
             + [f"frames{i}" for i in range(4)] + [n for n, _ in edges])
    return frames, names


def z_gap_ulps(got, want):
    z = np.abs(want[:, 2]).astype(np.float32)
    return np.abs(got[:, 2] - want[:, 2]) / np.spacing(z)


def assert_coms_match(got, want, what):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    bad = np.flatnonzero((got[:, :2] != want[:, :2]).any(1))
    assert bad.size == 0, (f"{what}: u, v differ for frames {bad[:8]}: "
                           f"{got[bad[:2]]} vs {want[bad[:2]]}")
    gap = z_gap_ulps(got, want)
    assert gap.max() <= COM_Z_ULPS, (
        f"{what}: z gap {gap.max()} ulps > {COM_Z_ULPS} (frame "
        f"{np.argmax(gap)})")


def _as(frames, dtype, dev):
    """float32 frames, or whole-mm uint16 ones (NaN and inf as 0)."""
    if dtype == torch.uint16:
        frames = np.round(np.nan_to_num(frames, nan=0.0, posinf=0.0,
                                        neginf=0.0)).astype(np.uint16)
    return torch.from_numpy(np.ascontiguousarray(frames)).to(dev)


@pytest.fixture(scope="module")
def cases():
    return all_frames()


def _pick(cases, names):
    frames, all_names = cases
    return frames[[all_names.index(n) for n in names]], list(names)


# the frames of each batch size: every case in a batch of 256
BATCH_7 = ("sweep3", "frames1", "empty", "far", "border", "nan", "inf")
ZERO = {"empty", "speckle", "flat", "small"}   # no slice qualifies


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint16],
                         ids=["f32", "u16"])
@pytest.mark.parametrize("batch", BATCHES)
def test_cuda_kernel_matches_the_plain_version(cases, batch, dtype):
    """Kernel vs plain version on the card at one batch size: u, v equal,
    z within COM_Z_ULPS; every hand found, the frames where no slice
    qualifies zero (a float32 frame with a NaN too); one launch counted a
    call."""
    dev = _cuda()
    names = {1: ("sweep0",), 7: BATCH_7,
             256: tuple(np.resize(cases[1], 256))}[batch]
    frames, names = _pick(cases, names)
    f = _as(frames, dtype, dev)
    cubes = torch.full((batch, 3), 300.0, device=dev)
    before = device_detect_batch.launches
    got = device_detect_batch(f, cubes, CAM.fx, CAM.fy)
    torch.cuda.synchronize()
    assert device_detect_batch.launches == before + 1
    want = device_detect_batch_reference(f, cubes, CAM.fx, CAM.fy)
    assert_coms_match(got, want, f"batch {batch} {dtype}")
    got = got.cpu().numpy()
    zero = ZERO | ({"nan"} if dtype == torch.float32 else set())
    for name, com in zip(names, got):
        if name.startswith(("sweep", "frames")):
            assert com[2] > 0, name
        if name in zero:
            assert not com.any(), name


@pytest.mark.parametrize("args", ARGS, ids=lambda a: "-".join(map(str, a)))
def test_cuda_kernel_op_arguments(cases, args):
    """Other steps, interior_min, refine_iters and first_slice through
    the op, float32 and uint16, at batch 7 of mixed frames and cubes."""
    dev = _cuda()
    frames, _ = _pick(cases, ("sweep0", "sweep1", "frames0", "far",
                              "border", "small", "inf"))
    cubes = torch.tensor([[300.0, 300.0, 300.0], [250.0, 260.0, 270.0],
                          [300.0] * 3, [310.0] * 3, [300.0] * 3,
                          [200.0] * 3, [300.0] * 3], device=dev)
    for dtype in (torch.float32, torch.uint16):
        f = _as(frames, dtype, dev)
        got = torch.ops.lsps.detect_coms(f, cubes, CAM.fx, CAM.fy, *args)
        want = device_detect_batch_reference(f, cubes, CAM.fx, CAM.fy,
                                             *args)
        assert_coms_match(got, want, f"{args} {dtype}")


def small_frames(h, w):
    """(4, h, w) float32: two blocks of one depth on an empty frame (the
    slice and box edges at the frame's border), a flat frame and a
    frame of two depths: small enough that the plain version's float32
    sums stay exact."""
    out = np.zeros((4, h, w), np.float32)
    out[0, 5:30, 10:40] = 640.0
    out[0, 20:h, w - 25:w] = 900.0
    out[1, :, :] = 800.0
    out[2, :h // 2, :] = 700.0
    out[2, h // 2:, :] = 1300.0
    out[3, 2:h - 3, 1:w - 1] = 555.0
    return out


@pytest.mark.parametrize("hw", [(61, 77), (64, 80), (130, 257)])
@pytest.mark.parametrize("first_slice", [0, FIRST_SLICE])
def test_cuda_kernel_other_frame_sizes(hw, first_slice):
    """Frame sizes off the tile and vector widths (61 x 77 takes pass 1's
    scalar loads), a flat frame whose slices are 0 / 0 (NaN -> slice 0,
    which qualifies from first_slice 0), interior_min 20."""
    dev = _cuda()
    frames = small_frames(*hw)
    cubes = torch.tensor([[300.0] * 3, [200.0] * 3, [400.0] * 3,
                          [300.0] * 3], device=dev)
    for dtype in (torch.float32, torch.uint16):
        f = _as(frames, dtype, dev)
        args = (65, 20, 5, first_slice)
        got = torch.ops.lsps.detect_coms(f, cubes, CAM.fx, CAM.fy, *args)
        want = device_detect_batch_reference(f, cubes, CAM.fx, CAM.fy,
                                             *args)
        assert_coms_match(got, want, f"{hw} {args} {dtype}")
        if first_slice == 0:
            assert bool(got[1].any())   # the flat frame's slice 0


def test_cuda_kernel_is_deterministic(cases):
    """Two calls on the same batch give the same bits."""
    dev = _cuda()
    f = _as(_pick(cases, np.resize(cases[1], 256))[0], torch.float32, dev)
    cubes = torch.full((256, 3), 300.0, device=dev)
    a = device_detect_batch(f, cubes, CAM.fx, CAM.fy)
    b = device_detect_batch(f, cubes, CAM.fx, CAM.fy)
    assert torch.equal(a, b)


def test_cuda_kernel_refuses_what_it_does_not_take(cases):
    dev = _cuda()
    f = _as(cases[0][:2], torch.float32, dev)
    cubes = torch.full((2, 3), 300.0, device=dev)
    with pytest.raises(TypeError, match="float32 or uint16"):
        device_detect_batch(f.double(), cubes, CAM.fx, CAM.fy)
    with pytest.raises(ValueError, match="contiguous"):
        device_detect_batch(f.transpose(1, 2), cubes, CAM.fx, CAM.fy)
    with pytest.raises(ValueError, match="cubes"):
        device_detect_batch(f, cubes.double(), CAM.fx, CAM.fy)
    with pytest.raises(ValueError, match="first_slice"):
        torch.ops.lsps.detect_coms(f, cubes, CAM.fx, CAM.fy, 5, 150, 5, 5)


def test_cuda_kernel_launches_in_a_profiler_trace(cases):
    """A call is one memset and 4 + refine_iters kernel launches at batch
    1 and 256 alike.  The profiler on the card's machine has returned
    short traces: a trace holding fewer launches is taken again."""
    from torch.profiler import ProfilerActivity, profile

    dev = _cuda()
    calls = 4
    for batch in (1, 256):
        f = _as(_pick(cases, np.resize(cases[1], batch))[0], torch.uint16,
                dev)
        cubes = torch.full((batch, 3), 300.0, device=dev)
        device_detect_batch(f, cubes, CAM.fx, CAM.fy)
        torch.cuda.synchronize()
        for _ in range(6):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    device_detect_batch(f, cubes, CAM.fx, CAM.fy)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            kernels = [n for n in names if "detect_" in n]
            if len(kernels) >= calls * 9:
                break
        assert len(kernels) == calls * 9, (batch, sorted(set(kernels)))
        assert sum("box_kernel" in n for n in kernels) == calls * 6
        memsets = [n for n in names if "memset" in n.lower()]
        assert len(memsets) <= calls, memsets


def test_cuda_replicas_call_the_op_once_each(cases):
    """A two-replica estimator (both replicas on the card) calls the op
    once per replica, each on its block of the batch, and detects the
    CoMs of the one-replica estimator."""
    from lsps_tpu_torch.config import default_hyperparameters
    from lsps_tpu_torch.serve.inference import PoseEstimator
    from lsps_tpu_torch.train.trainer import fresh_state_dict

    dev = _cuda()
    hyp = default_hyperparameters(reg_dim=108, small=True)
    hyp["dis"]["ch"] = hyp["gen"]["ch"] = 4
    sd = {k: v for k, v in fresh_state_dict(hyp, 0).items()
          if k.split(".")[0] in ("dis", "vae")}
    frames, _ = _pick(cases, ("sweep0", "sweep1", "frames2", "far"))
    frames = np.round(frames).astype(np.uint16)
    one = PoseEstimator(hyp, sd, device=dev)
    two = PoseEstimator(hyp, sd, devices=(dev, dev))
    _, want = one.predict_raw(frames, return_coms=True)
    before = device_detect_batch.launches
    _, got = two.predict_raw(frames, return_coms=True)
    torch.cuda.synchronize()
    assert device_detect_batch.launches == before + 2
    assert torch.equal(got.cpu(), want.cpu())
