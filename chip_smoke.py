"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, nvcc
and PyTorch built for CUDA.  It imports ``lsps_tpu_torch`` and nothing of
JAX or ``lsps_tpu``.  Phases, each of which must pass:

1. build every CUDA kernel of the port from ``lsps_tpu_torch/csrc`` (one
   nvcc per source, all started together) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card, bit for
   bit, at the batch sizes of the serving path (1, 32, 256), for float32
   and whole-millimetre uint16 frames, edge cases included;
3. serve ``PoseEstimator.predict_frames`` and ``predict_raw`` at the widths
   of ``exps/nnyu.yaml`` (seeded random weights) for requests of 1 and 32
   frames, with every kernel's launch count set to 0 just before and read
   just after; each kernel must have launched.  The joints are held
   against a plain route on the card (the reference warp + the same
   modules, TF32 off) and against the estimator on the CPU;
4. time ``predict_frames`` (ms per call at batch 1, frames/s at 32 and
   256, float32 and bf16 trunk) and each kernel beside its bound and its
   plain version (device time from torch.profiler, per-call time from
   CUDA events);
5. hold the four InstanceNorm kernels (IN + LeakyReLU and IN + residual,
   forward and backward) against their plain versions on the card at the
   training path's shapes (32 and 64 x 256 x 32 x 32), a ragged and a
   128 x 128 shape, float32 and bfloat16, slope 0.01 and None;
6. train at the widths of ``exps/nnyu.yaml`` (seeded random weights,
   seeded crops and poses): ``vae_update`` (batch 64), three
   ``pretrain_update`` (batch 32), ``post_update`` mode 3 and one
   ``pretrain_update`` with the fused IN + residual tail, with every norm
   kernel's launch count set to 0 just before and read just after; each
   must have launched, the IN + LeakyReLU counts as the generator's
   residual blocks give them.  Then one ``pretrain_update`` on the kernel
   route against the same step on the plain route (the wrappers bound to
   their plain versions within that one block), and one tiny-width step
   on the card against the CPU (TF32 off): losses, each gradient before
   the optimizer, and the updated parameters;
7. time each norm kernel beside its bound, its plain version and
   ``F.instance_norm``, and ``pretrain_update`` (batch 8 and 32) and
   ``vae_update``: ms per step, device time, idle share, top kernels,
   peak memory;
8. print the ``kernels`` line, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line.  Without a CUDA device,
or without the package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time
import unittest.mock
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H, W = 480, 640
CUBE_MM = 300.0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peak
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
WARP_FLOPS_PER_PIXEL = 9    # 3 compare-selects, isfinite, sub, div
WARP_BATCHES = (1, 32, 256)
SERVE_BATCHES = (1, 32)
TIMING_BATCHES = (1, 32, 256)
JOINTS_PLAIN_MM = 1e-3      # kernel route vs plain route, same modules
JOINTS_CPU_MM = 0.05        # card (cuDNN f32) vs CPU: sums in other orders


def log(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# frames, made from a numpy seed
# ---------------------------------------------------------------------------

def blob_frames(n, rs):
    """Square blobs of uniform random depth (650-950 mm), CoM at the blob's
    mean."""
    frames = np.zeros((n, H, W), np.float32)
    coms = np.zeros((n, 3), np.float32)
    for i in range(n):
        y, x = rs.randint(80, H - 200), rs.randint(80, W - 200)
        blob = rs.uniform(650, 950, (140, 140)).astype(np.float32)
        frames[i, y:y + 140, x:x + 140] = blob
        coms[i] = (x + 69.5, y + 69.5, blob.mean())
    return frames, coms


def edge_frames(rs):
    """Border CoMs, NaN/inf outside the blob, near/far outliers inside."""
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
                       [W - 60.0, H - 60.0, 800.0],
                       [315.0, 265.0, 800.0],
                       [315.0, 265.0, 800.0]], np.float32)
    return frames, coms


def hand_frames(n, rs):
    """A palm disc and five finger discs, each of one whole-mm depth,
    which the detector finds; CoM at the palm centre."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = np.zeros((n, H, W), np.float32)
    coms = np.zeros((n, 3), np.float32)
    for i in range(n):
        cx, cy = rs.uniform(150, W - 150), rs.uniform(130, H - 130)
        z = float(rs.randint(600, 900))
        r = 35.0 * 588.03 / z
        d = np.where((xx - cx) ** 2 + (yy - cy) ** 2 <= r * r, z, 0.0)
        for k in range(5):
            ang = np.pi * (0.15 + 0.175 * k) + rs.uniform(-0.1, 0.1)
            fx_, fy_ = cx + 1.6 * r * np.cos(ang), cy - 1.6 * r * np.sin(ang)
            fz = z + rs.randint(-15, 5)
            disc = (xx - fx_) ** 2 + (yy - fy_) ** 2 <= (0.35 * r) ** 2
            d = np.where(disc & ((d == 0) | (d > fz)), fz, d)
        frames[i] = d
        coms[i] = (cx, cy, z)
    return frames, coms


def warp_batch(n, seed):
    """n frames for the kernel comparison: the edge cases, then blobs and
    hands in turn."""
    rs = np.random.RandomState(seed)
    fs, cs = [], []
    ef, ec = edge_frames(rs)
    fs.append(ef), cs.append(ec)
    rest = max(n - 4, 0)
    bf, bc = blob_frames((rest + 1) // 2, rs)
    hf, hc = hand_frames(rest // 2, rs)
    fs += [bf, hf]
    cs += [bc, hc]
    frames = np.concatenate(fs)[:n]
    coms = np.concatenate(cs)[:n]
    return frames, coms, np.full((n, 3), CUBE_MM, np.float32)


def whole_mm_u16(frames):
    return np.clip(np.round(np.nan_to_num(frames, posinf=0.0)), 0,
                   65535).astype(np.uint16)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, iters, warmup=3):
    """Device time of one call, from CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters, warmup=3):
    """Wall time of one call that ends in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_kernels(torch, fn, iters=10):
    """Device time by kernel name over ``iters`` calls of ``fn``, from
    torch.profiler: ({name: (ms per call, launches per call)}, device ms
    per call, wall ms per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / iters,
                               n + 1 / iters)
    return by_name, sum(ms for ms, _ in by_name.values()), wall


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from lsps_tpu_torch.ops.kernels import SOURCES, build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(build.compile_source, SOURCES))
    for name in SOURCES:
        build.load_library(name)
    log(f"build: {len(libs)} kernel(s) {list(SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s with {build.nvcc_path()}")


def warp_bytes(frames, iy, ix):
    """Bytes the warp must move for these inputs: each distinct valid
    source pixel read once, the indices and params read, the float32 crop
    written."""
    b, dh, dw = iy.shape[0], iy.shape[1], ix.shape[1]
    src = 0
    for i in range(b):
        rows = np.unique(iy[i][iy[i] >= 0]).size
        cols = np.unique(ix[i][ix[i] >= 0]).size
        src += rows * cols
    return (src * frames.element_size() + b * (dh + dw) * 4 + b * 16
            + b * dh * dw * 4)


def phase_warp(torch, dev, cam):
    """Kernel vs plain version, bit for bit; returns the timing rows."""
    from lsps_tpu_torch.ops.kernels.warp import (warp_normalize,
                                                 warp_normalize_reference)
    from lsps_tpu_torch.serve.preprocess import crop_indices

    rows, max_err = [], 0.0
    for b in WARP_BATCHES:
        frames, coms, cubes = warp_batch(b, seed=100 + b)
        _, iy, ix, par = crop_indices(torch.from_numpy(coms).to(dev),
                                      torch.from_numpy(cubes).to(dev),
                                      cam.fx, cam.fy, (H, W))
        for kind, f in (("f32", frames), ("u16", whole_mm_u16(frames))):
            ft = torch.from_numpy(f).to(dev)
            got = warp_normalize(ft, iy, ix, par)
            torch.cuda.synchronize()
            want = warp_normalize_reference(ft, iy, ix, par)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, want) or not bool(got.isfinite().all()):
                raise AssertionError(f"warp kernel != plain version at "
                                     f"B={b} {kind}: max |diff| {err}")
            if kind == "u16":
                as_f32 = warp_normalize(ft.to(torch.float32), iy, ix, par)
                if not torch.equal(got, as_f32):
                    raise AssertionError(f"uint16 frames != their float32 "
                                         f"copy at B={b}")
            iters = 200 if b < 256 else 50
            nbytes = warp_bytes(ft, iy.cpu().numpy(), ix.cpu().numpy())
            flops = WARP_FLOPS_PER_PIXEL * b * 128 * 128
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / F32_FLOPS_PER_S * 1e3
            kernel = functools.partial(warp_normalize, ft, iy, ix, par)
            plain = functools.partial(warp_normalize_reference, ft, iy, ix,
                                      par)
            call_ms = cuda_ms(torch, kernel, iters)
            plain_call_ms = cuda_ms(torch, plain, iters)
            # device time: the kernel's own, and all kernels of the plain
            # version; a call timed back to back also holds the host's
            # launch cost, which is larger than the kernel at these sizes
            by_name, _, _ = profile_kernels(torch, kernel)
            dev_ms = sum(ms for k, (ms, _) in by_name.items()
                         if "warp_normalize_kernel" in k)
            _, plain_dev_ms, _ = profile_kernels(torch, plain)
            rows.append({
                "batch": b, "frames": kind,
                "ms": dev_ms or call_ms, "call_ms": call_ms,
                "plain_ms": plain_dev_ms or plain_call_ms,
                "plain_call_ms": plain_call_ms,
                "timed_by": "profiler" if dev_ms and plain_dev_ms
                else "cuda events",
                "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            })
        log(f"warp B={b}: kernel bit-equal to the plain version "
            f"(float32 and uint16 frames)")
    return rows, max_err


def seeded_state_dict(hyp, seed, nets=("dis", "vae")):
    import torch
    from torch import nn

    from lsps_tpu_torch.models import build_model
    from lsps_tpu_torch.ops.layers import reset_parameters

    nets = nn.ModuleDict({k: build_model(hyp[k]) for k in nets})
    reset_parameters(nets, torch.Generator().manual_seed(seed))
    return nets.state_dict()


def plain_route(torch, est, frames, coms, cubes):
    """The estimator's modules with the reference warp in place of the
    kernel."""
    from lsps_tpu_torch.ops.kernels.warp import warp_normalize_reference
    from lsps_tpu_torch.serve.preprocess import crop_indices

    _, iy, ix, par = crop_indices(coms, cubes, est.camera.fx, est.camera.fy,
                                  tuple(frames.shape[1:]))
    crops = warp_normalize_reference(frames, iy, ix, par)
    pose = est.predict_crops(crops[..., None])
    j = pose.reshape(pose.shape[0], -1, 3)
    return (j * (cubes[:, 2:3, None] / 2.0)
            + est.camera.img_to_3d(coms)[:, None, :])


def serve_requests():
    reqs = {}
    for b in SERVE_BATCHES:
        frames, coms = hand_frames(b, np.random.RandomState(7 + b))
        reqs[b] = (frames, coms, np.full((b, 3), CUBE_MM, np.float32))
    return reqs


def phase_serve(torch, dev, hyp, sd, kernels):
    """The main path: requests through the entry points, float32 and
    whole-mm uint16 frames, launch counts read around them; then the
    joints against the plain route on the card and against the CPU.  TF32
    is off for the whole phase."""
    from lsps_tpu_torch.serve.inference import PoseEstimator
    from lsps_tpu_torch.serve.preprocess import crop_normalize_batch

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        est = PoseEstimator(hyp, sd, device=dev)
        reqs = serve_requests()
        for k in kernels.values():
            k.launches = 0
        out = {}
        for b, (frames, coms, cubes) in reqs.items():
            u16 = frames.astype(np.uint16)
            out[b] = (est.predict_frames(frames, coms, cubes),
                      est.predict_frames(u16, coms, cubes),
                      *est.predict_raw(frames, cubes, return_coms=True),
                      est.predict_raw(u16, cubes))
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        log(f"main path launches: {launches}")
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"main path")

        cpu_est = PoseEstimator(hyp, sd, device="cpu")
        worst = 0.0
        for b, (frames, coms, cubes) in reqs.items():
            got, got_u16, raw_j, raw_c, raw_u16 = out[b]
            f, c, cu = (torch.from_numpy(a).to(dev)
                        for a in (frames, coms, cubes))
            if not (torch.equal(got, got_u16) and torch.equal(raw_j,
                                                              raw_u16)):
                raise AssertionError(f"B={b}: uint16 frames served "
                                     f"differently from float32")
            if bool((raw_c == 0).all(1).any()):
                raise AssertionError(f"predict_raw B={b}: a hand was not "
                                     f"detected")
            with torch.inference_mode():
                want = plain_route(torch, est, f, c, cu)
                raw_want = plain_route(torch, est, f, raw_c, cu)
            for tag, g, w in (("predict_frames", got, want),
                              ("predict_raw", raw_j, raw_want)):
                if g.shape != (b, hyp["vae"]["input_dim"] // 3, 3) or \
                        not bool(g.isfinite().all()):
                    raise AssertionError(f"{tag} B={b}: bad output "
                                         f"{tuple(g.shape)}")
                err = float((g - w).abs().max())
                worst = max(worst, err)
                if err > JOINTS_PLAIN_MM:
                    raise AssertionError(f"{tag} B={b}: kernel route vs "
                                         f"plain route {err} mm")
            # the CPU path is the one the tests hold against the JAX package
            n = min(b, 4)
            cpu = cpu_est.predict_frames(frames[:n], coms[:n], cubes[:n])
            cpu_err = float((got[:n].cpu() - cpu).abs().max())
            if cpu_err > JOINTS_CPU_MM:
                raise AssertionError(f"predict_frames B={b}: card vs CPU "
                                     f"{cpu_err} mm")
            gpu_crops, _ = crop_normalize_batch(f, c, cu, est.camera.fx,
                                                est.camera.fy)
            cpu_crops, _ = crop_normalize_batch(
                *(torch.from_numpy(a) for a in (frames, coms, cubes)),
                est.camera.fx, est.camera.fy)
            if not torch.equal(gpu_crops.cpu(), cpu_crops):
                raise AssertionError(f"crops B={b}: card != CPU")
            log(f"serve B={b}: joints {tuple(got.shape)} finite, uint16 == "
                f"float32; kernel vs plain route <= {worst:.3g} mm (tol "
                f"{JOINTS_PLAIN_MM}); card vs CPU {cpu_err:.3g} mm (tol "
                f"{JOINTS_CPU_MM}); crops card == CPU")
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev
    return launches, worst


def phase_timing(torch, dev, hyp, sd):
    """predict_frames per call (B=1) and frames/s (B=32, 256), float32 and
    bf16 trunk, frames already on the card; PyTorch's default TF32
    settings."""
    from lsps_tpu_torch.serve.inference import PoseEstimator

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        est = PoseEstimator(hyp, sd, dtype=dtype, device=dev)
        for b in TIMING_BATCHES:
            frames, coms = hand_frames(min(b, 8), np.random.RandomState(b))
            reps = -(-b // len(frames))
            f = torch.from_numpy(np.tile(frames, (reps, 1, 1))[:b]).to(dev)
            c = torch.from_numpy(np.tile(coms, (reps, 1))[:b]).to(dev)
            cu = torch.full((b, 3), CUBE_MM, device=dev)
            iters = 50 if b < 256 else 10
            ms = host_ms(torch, lambda: est.predict_frames(f, c, cu), iters)
            raw_ms = host_ms(torch, lambda: est.predict_raw(f, cu), iters)
            by_name, dev_ms, wall = profile_kernels(
                torch, lambda: est.predict_frames(f, c, cu))
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
            rows.append({"dtype": str(dtype).replace("torch.", ""),
                         "batch": b, "predict_frames_ms": ms,
                         "frames_per_s": b * 1e3 / ms,
                         "predict_raw_ms": raw_ms,
                         "profiled_wall_ms": wall, "device_ms": dev_ms,
                         "device_idle_share": max(0.0, 1 - dev_ms / wall),
                         "kernels_per_call": sum(n for _, n in
                                                 by_name.values()),
                         "top_kernels_ms": [[k[:60], round(v[0], 5)]
                                            for k, v in top]})
            log(f"predict_frames {rows[-1]['dtype']} B={b}: {ms:.3f} ms/call"
                f", {b * 1e3 / ms:.1f} frames/s; predict_raw {raw_ms:.3f} "
                f"ms/call")
    return rows


# ---------------------------------------------------------------------------
# the norm kernels and the trainer
# ---------------------------------------------------------------------------

NORM_SHAPES = ((32, 256, 32, 32), (64, 256, 32, 32), (3, 5, 7, 9),
               (2, 64, 128, 128))
NORM_TIMING_SHAPES = ((32, 256, 32, 32), (64, 256, 32, 32))
# float32 outputs: the kernel sums a plane in another order than torch
# does, which moves the last bits of the moments (~1e-6 at unit scale)
NORM_TOL = 1e-5
# bfloat16 outputs (y, dx) are rounded from float32 values that may differ
# in their last bit: one bfloat16 ulp, 2^-7 relative
NORM_BF16_RTOL = 2.0 ** -7
NORM_FLOPS_PER_VALUE = {"in_act_forward": 8, "in_act_backward": 9,
                        "in_res_forward": 8, "in_res_backward": 10}
NORM_REPLACES = {
    "in_act_forward": "lsps_tpu/ops/pallas/norm_act.py:92",
    "in_act_backward": "lsps_tpu/ops/pallas/norm_act.py:124",
    "in_res_forward": "lsps_tpu/ops/pallas/norm_act.py:275",
    "in_res_backward": "lsps_tpu/ops/pallas/norm_act.py:307",
}
NORM_SYMBOL = {"in_act_forward": "in_act_fwd_kernel",
               "in_act_backward": "in_act_bwd_kernel",
               "in_res_forward": "in_res_fwd_kernel",
               "in_res_backward": "in_res_bwd_kernel"}
TRAIN_BATCHES = (8, 32)
# kernel route vs plain route (and card vs CPU) of one pretrain step, TF32
# off.  Losses: 1e-4 relative, since the IN moments differ in their last
# bits and the difference passes through some 40 layers.  Gradients, as
# each optimizer is given them: for every parameter, |g_a - g_b| / |g_b|
# (Frobenius norms) within STEP_GRAD_RTOL.  The generator's gradients are
# ill-conditioned at random weights: the same step run twice on the kernel
# route differs by a few 1e-3 through cuDNN's nondeterministic algorithms
# alone, so the script measures that floor and logs it beside the gap; a
# backward off in scale (dx * 2) is 0.5 apart.  The conv biases that
# feed an InstanceNorm are left out of both gradient and parameter checks:
# their gradients are zero up to rounding.  Parameters: a first Adam step
# moves each element by lr * g / (|g| + eps), about +-lr whatever g's
# scale, so they check the optimizer and each gradient's sign: all but
# STEP_DISAGREE_SHARE of the elements within 1e-3 * lr + 1e-3 * |update|
# (an element whose gradient is within rounding of zero may flip).
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-2
STEP_DISAGREE_SHARE = 1e-3


def norm_data(torch, dev, shape, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
    res = torch.randn(shape, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev)
    return x.to(dtype), res.to(dtype), g.to(dtype)


def norm_pairs(N, x, res, g, slope):
    """(kernel name, kernel results, plain results) for the four kernels
    on one input; each backward is given the plain forward's moments."""
    ref_f = N.in_act_forward_reference(x, slope)
    ref_r = N.in_res_forward_reference(x, res)
    return [
        ("in_act_forward", N.in_act_forward(x, slope), ref_f),
        ("in_act_backward",
         (N.in_act_backward(g, ref_f[1], ref_f[2], slope),),
         (N.in_act_backward_reference(g, ref_f[1], ref_f[2], slope),)),
        ("in_res_forward", N.in_res_forward(x, res), ref_r),
        ("in_res_backward", (N.in_res_backward(g, x, ref_r[1], ref_r[2]),),
         (N.in_res_backward_reference(g, x, ref_r[1], ref_r[2]),)),
    ]


def phase_norm(torch, dev):
    """The four norm kernels against their plain versions on the card;
    returns the largest |kernel - plain| of each, for float32 and for
    bfloat16 inputs."""
    from lsps_tpu_torch.ops.kernels import norm_act as N

    errs = {dt: {name: 0.0 for name in N.KERNELS}
            for dt in (torch.float32, torch.bfloat16)}
    for i, shape in enumerate(NORM_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, res, g = norm_data(torch, dev, shape, dtype, seed=i)
            for slope in (N.SLOPE, None):
                for name, got, want in norm_pairs(N, x, res, g, slope):
                    torch.cuda.synchronize()
                    for a, b in zip(got, want):
                        if a.dtype != b.dtype or a.shape != b.shape:
                            raise AssertionError(
                                f"{name} {shape} {dtype}: kernel gives "
                                f"{a.dtype} {tuple(a.shape)}, plain "
                                f"{b.dtype} {tuple(b.shape)}")
                        if not bool(a.isfinite().all()):
                            raise AssertionError(f"{name} {shape} {dtype}"
                                                 f": non-finite output")
                        rtol = (NORM_BF16_RTOL if a.dtype == torch.bfloat16
                                else NORM_TOL)
                        a, b = a.float(), b.float()
                        diff = (a - b).abs()
                        errs[dtype][name] = max(errs[dtype][name],
                                                float(diff.max()))
                        if bool((diff > NORM_TOL + rtol * b.abs()).any()):
                            raise AssertionError(
                                f"{name} {shape} {dtype} slope={slope}: "
                                f"kernel != plain, max |diff| "
                                f"{float(diff.max())}")
            log(f"norm kernels {shape} {str(dtype)[6:]}: match the plain "
                f"versions (slope 0.01 and None)")
    return errs


def norm_bytes(name, shape, esize):
    """Bytes a norm kernel must move: each input read once, each output
    written once (planes of B*C*H*W values, moments of B*C float32)."""
    n = shape[0] * shape[1] * shape[2] * shape[3]
    planes = shape[0] * shape[1]
    return {
        "in_act_forward": n * esize * 2 + n * 4 + planes * 4,
        "in_act_backward": n * esize * 2 + n * 4 + planes * 4,
        "in_res_forward": n * esize * 3 + planes * 8,
        "in_res_backward": n * esize * 3 + planes * 8,
    }[name]


def phase_norm_timing(torch, dev):
    """Each norm kernel at the training path's shapes: device ms from
    torch.profiler, per-call ms from CUDA events, beside the plain version,
    the bound, and F.instance_norm for the one function a single PyTorch
    call computes (the slope-None forward)."""
    import torch.nn.functional as F

    from lsps_tpu_torch.ops.kernels import norm_act as N

    rows = []
    for shape in NORM_TIMING_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, res, g = norm_data(torch, dev, shape, dtype, seed=7)
            _, xhat, rstd = N.in_act_forward_reference(x, N.SLOPE)
            _, mean, rstd2 = N.in_res_forward_reference(x, res)
            calls = {
                "in_act_forward": (
                    functools.partial(N.in_act_forward, x, N.SLOPE),
                    functools.partial(N.in_act_forward_reference, x,
                                      N.SLOPE)),
                "in_act_backward": (
                    functools.partial(N.in_act_backward, g, xhat, rstd,
                                      N.SLOPE),
                    functools.partial(N.in_act_backward_reference, g, xhat,
                                      rstd, N.SLOPE)),
                "in_res_forward": (
                    functools.partial(N.in_res_forward, x, res),
                    functools.partial(N.in_res_forward_reference, x, res)),
                "in_res_backward": (
                    functools.partial(N.in_res_backward, g, x, mean, rstd2),
                    functools.partial(N.in_res_backward_reference, g, x,
                                      mean, rstd2)),
            }
            for name, (kernel, plain) in calls.items():
                call_ms = cuda_ms(torch, kernel, 100)
                plain_call_ms = cuda_ms(torch, plain, 50)
                by_name, _, _ = profile_kernels(torch, kernel)
                dev_ms = sum(ms for k, (ms, _) in by_name.items()
                             if NORM_SYMBOL[name] in k)
                _, plain_dev_ms, _ = profile_kernels(torch, plain)
                nbytes = norm_bytes(name, shape, x.element_size())
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = (NORM_FLOPS_PER_VALUE[name] * x.numel()
                          / F32_FLOPS_PER_S * 1e3)
                row = {"kernel": name, "shape": list(shape),
                       "dtype": str(dtype)[6:], "ms": dev_ms or call_ms,
                       "call_ms": call_ms,
                       "plain_ms": plain_dev_ms or plain_call_ms,
                       "plain_call_ms": plain_call_ms,
                       "timed_by": "profiler" if dev_ms and plain_dev_ms
                       else "cuda events",
                       "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
                       "bound_by": "bytes" if bytes_ms >= ops_ms
                       else "operations", "library_ms": None}
                if name == "in_act_forward":
                    ident = functools.partial(N.in_act_forward, x, None)
                    lib = functools.partial(F.instance_norm, x, eps=N.EPS)
                    by_name, _, _ = profile_kernels(torch, ident)
                    row["ms_slope_none"] = sum(
                        ms for k, (ms, _) in by_name.items()
                        if NORM_SYMBOL[name] in k) or cuda_ms(torch, ident,
                                                              100)
                    _, lib_dev_ms, _ = profile_kernels(torch, lib)
                    row["library_ms"] = lib_dev_ms or cuda_ms(torch, lib,
                                                              100)
                    row["library_call_ms"] = cuda_ms(torch, lib, 100)
                rows.append(row)
                log(f"{name} {shape} {row['dtype']}: {row['ms']:.4f} ms "
                    f"device, bound {row['bound_ms']:.4f} ms, plain "
                    f"{row['plain_ms']:.4f} ms")
    return rows


def train_batch(torch, dev, b, seed, reg_dim):
    """Crops in [-1, 1] and pose labels of both domains, from a numpy
    seed, on the card."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        out.append(torch.from_numpy(rs.uniform(-1, 1, (b, 128, 128, 1))
                                    .astype(np.float32)).to(dev))
        out.append(torch.from_numpy(rs.uniform(-0.3, 0.3, (b, reg_dim))
                                    .astype(np.float32)).to(dev))
    return out


def in_act_counts(gcfg):
    """IN+LeakyReLU launches of one joint generator pass and of one
    one-way pass (a2b, b2a): one per LeakyINSResBlock run."""
    one_way = (gcfg["n_enc_res_blk"] + gcfg["n_enc_shared_blk"]
               + gcfg["n_gen_shared_blk"] + gcfg["n_gen_res_blk"])
    joint = one_way + gcfg["n_enc_res_blk"] + gcfg["n_gen_res_blk"]
    return joint, one_way


def pretrain_noise(torch, dev, b, ch, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(n):
        return torch.randn((n, 32, 32, ch), generator=gen, device=dev)

    return {"dis": {"gen": draw(2 * b)},
            "gen": {"gen": draw(2 * b), "a2b": draw(b), "b2a": draw(b)}}


def in_fed_biases(trainer):
    """Names of the conv biases that feed an InstanceNorm: their gradients
    are zero up to noise."""
    from lsps_tpu_torch.ops import layers as L

    names = set()
    for net_name, net in trainer.nets.items():
        for mod_name, mod in net.named_modules():
            if isinstance(mod, L.LeakyINSResBlock):
                names |= {f"{net_name}.{mod_name}.0.bias",
                          f"{net_name}.{mod_name}.3.bias"}
            elif isinstance(mod, L.LeakyINSResNeXtBlock):
                names |= {f"{net_name}.{mod_name}.{i}.bias"
                          for i in (0, 3, 6)}
    return names


@contextlib.contextmanager
def in_res_fused(N, value):
    """The fused IN + residual tail forced on or off within the block."""
    prev = N.set_in_res_fused(value)
    try:
        yield
    finally:
        N.set_in_res_fused(prev)


def record_grads(trainer):
    """From now on, keep a copy of the gradients each optimizer of
    ``trainer`` is given, by parameter name (None where a head was not
    reached); returns the dict that fills."""
    names = {id(p): f"{net}.{n}" for net, m in trainer.nets.items()
             for n, p in m.named_parameters()}
    seen = {}
    for opt in (trainer.dis_opt, trainer.gen_opt, trainer.vae_opt):
        def step(grads, opt=opt, inner=opt.step):
            for p, g in zip(opt.params, grads):
                seen[names[id(p)]] = None if g is None else g.detach().clone()
            inner(grads)
        opt.step = step
    return seen


def compare_grads(torch, ga, gb, skip, what):
    """Relative Frobenius error of every gradient; see STEP_GRAD_RTOL.
    Returns the worst."""
    if ga.keys() != gb.keys():
        raise AssertionError(f"{what}: gradients of different parameters")
    errs = []
    for k, a in ga.items():
        b = gb[k]
        if (a is None) != (b is None):
            raise AssertionError(f"{what}: gradient of {k} is None on one "
                                 f"side only")
        if a is None or k in skip:
            continue
        a, b = a.double().cpu(), b.double().cpu()
        if not bool(a.isfinite().all()):
            raise AssertionError(f"{what}: gradient of {k} not finite")
        errs.append((float((a - b).norm() / b.norm().clamp_min(1e-30)), k))
    errs.sort(reverse=True)
    log(f"{what}: {len(errs)} gradients, worst relative errors "
        + ", ".join(f"{k} {e:.3g}" for e, k in errs[:3]))
    if not errs:
        raise AssertionError(f"{what}: no gradient to compare")
    err, name = errs[0]
    if err > STEP_GRAD_RTOL:
        raise AssertionError(f"{what}: gradient of {name} {err:.3g} apart")
    return err


def compare_steps(torch, start, a, b, ma, mb, ga, gb, lr, what):
    """Losses, gradients and parameter updates of two trainers that took
    the same step from the same start; see STEP_LOSS_RTOL.  Returns (worst
    loss rel err, worst gradient rel err, share of disagreeing
    elements)."""
    worst = 0.0
    for k, va in ma.items():
        va, vb = float(va), float(mb[k])
        if not (np.isfinite(va) and np.isfinite(vb)):
            raise AssertionError(f"{what}: {k} not finite ({va}, {vb})")
        rel = abs(va - vb) / max(abs(vb), 1e-12)
        worst = max(worst, rel)
        if rel > STEP_LOSS_RTOL:
            raise AssertionError(f"{what}: {k} {va} vs {vb}")
    skip = in_fed_biases(a)
    grad_err = compare_grads(torch, ga, gb, skip, what)
    sa, sb = a.nets.state_dict(), b.nets.state_dict()
    bad = total = 0
    for k, p0 in start.items():
        da = sa[k].float().cpu() - p0.float()
        db = sb[k].float().cpu() - p0.float()
        diff = (da - db).abs()
        if k not in skip:
            bad += int((diff > 1e-3 * lr + 1e-3 * db.abs()).sum())
            total += diff.numel()
    share = bad / max(total, 1)
    if share > STEP_DISAGREE_SHARE:
        raise AssertionError(f"{what}: {bad} of {total} parameter elements "
                             f"disagree")
    return worst, grad_err, share


def phase_train(torch, dev, hyp, sd):
    """The training path at nnyu widths: vae_update, three
    pretrain_updates, a post_update (mode 3) and a pretrain_update with
    the fused IN + residual tail, with every norm kernel's launch count
    set to 0 just before and read just after; then one pretrain step on
    the kernel route against the plain route (TF32 off)."""
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.train import LSPSTrainer

    b, reg = hyp["batch_size"], hyp["vae"]["input_dim"]
    batch = train_batch(torch, dev, b, seed=11, reg_dim=reg)
    poses = torch.from_numpy(np.random.RandomState(12).uniform(
        -0.3, 0.3, (hyp["batch_size_pose"], reg)).astype(np.float32)).to(dev)
    trainer = LSPSTrainer(hyp, sd, device=dev, seed=0)
    for k in N.KERNELS.values():
        k.launches = 0
    with in_res_fused(N, False):
        mets = [trainer.vae_update(poses)[0]]
        mets += [trainer.pretrain_update(*batch, with_viz=False)[0]
                 for _ in range(3)]
        mets.append(trainer.post_update(*batch, mode=3, with_viz=False)[0])
    with in_res_fused(N, True):
        mets.append(trainer.pretrain_update(*batch, with_viz=False)[0])
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in N.KERNELS.items()}
    log(f"train path launches: {launches}")
    joint, one_way = in_act_counts(hyp["gen"])
    per_step_fwd, per_step_bwd = 2 * joint + 2 * one_way, joint + 2 * one_way
    want = {"in_act_forward": 4 * per_step_fwd + joint,
            "in_act_backward": 4 * per_step_bwd,
            "in_res_forward": per_step_fwd, "in_res_backward": per_step_bwd}
    if launches != want:
        raise AssertionError(f"train path launches {launches}, the code "
                             f"gives {want}")
    for m in mets:
        for k, v in m.items():
            if not np.isfinite(float(v)):
                raise AssertionError(f"train: {k} = {float(v)}")
    log(f"train: vae_update, 3 pretrain_update, post_update(3), fused "
        f"pretrain_update: losses finite; IN+LeakyReLU {per_step_fwd} fwd /"
        f" {per_step_bwd} bwd per pretrain_update, as counted from the code")

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        noise = pretrain_noise(torch, dev, b, trainer.gen.latent_ch, seed=13)
        kern = LSPSTrainer(hyp, sd, device=dev)
        again = LSPSTrainer(hyp, sd, device=dev)
        plain = LSPSTrainer(hyp, sd, device=dev)
        gk, ga, gp = (record_grads(kern), record_grads(again),
                      record_grads(plain))
        with in_res_fused(N, False):
            mk, _ = kern.pretrain_update(*batch, noise=noise, with_viz=False)
            again.pretrain_update(*batch, noise=noise, with_viz=False)
            torch.cuda.synchronize()
            before = {name: k.launches for name, k in N.KERNELS.items()}
            # the plain route: the wrappers bound to their plain versions
            # for this block only
            with unittest.mock.patch.multiple(N, **{
                    name: getattr(N, f"{name}_reference")
                    for name in N.KERNELS}):
                mp, _ = plain.pretrain_update(*batch, noise=noise,
                                              with_viz=False)
                torch.cuda.synchronize()
        if {name: k.launches for name, k in N.KERNELS.items()} != before:
            raise AssertionError("a norm kernel launched on the plain route")
        floor = compare_grads(torch, ga, gk, in_fed_biases(kern),
                              "kernel route run twice")
        start = {k: v.float() for k, v in sd.items()}
        loss_err, grad_err, share = compare_steps(
            torch, start, kern, plain, mk, mp, gk, gp, hyp["lr"],
            "kernel vs plain route")
        log(f"pretrain_update B={b}: kernel route vs plain route: losses "
            f"<= {loss_err:.3g} relative (tol {STEP_LOSS_RTOL}), gradients "
            f"<= {grad_err:.3g} relative (tol {STEP_GRAD_RTOL}; the kernel "
            f"route run twice: {floor:.3g}), "
            f"{share:.3g} of parameter elements apart (tol "
            f"{STEP_DISAGREE_SHARE})")
        del kern, again, plain, gk, ga, gp
        cpu_err = phase_train_cpu(torch, dev, hyp)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev
    return launches, trainer, {"route_loss_rel": loss_err,
                               "route_grad_rel": grad_err,
                               "kernel_twice_grad_rel": floor,
                               "route_param_share": share,
                               "cpu_loss_rel": cpu_err[0],
                               "cpu_grad_rel": cpu_err[1],
                               "cpu_param_share": cpu_err[2]}


def phase_train_cpu(torch, dev, hyp):
    """One tiny-width pretrain step on the card against the same step on
    the CPU (the path the tests hold against the JAX package)."""
    import copy

    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.train import LSPSTrainer

    tiny = copy.deepcopy(hyp)
    tiny["gen"]["ch"] = tiny["dis"]["ch"] = 4
    tiny["map"]["output_ch"] = 16
    sd = seeded_state_dict(tiny, seed=3, nets=("dis", "gen", "vae", "map"))
    b = 2
    batch = train_batch(torch, "cpu", b, seed=14, reg_dim=tiny["vae"][
        "input_dim"])
    noise = pretrain_noise(torch, "cpu", b, 16, seed=15)
    card = LSPSTrainer(tiny, sd, device=dev)
    cpu = LSPSTrainer(tiny, sd, device="cpu")
    gg, gc = record_grads(card), record_grads(cpu)
    to_dev = {k: {n: t.to(dev) for n, t in d.items()}
              for k, d in noise.items()}
    with in_res_fused(N, False):
        mg, _ = card.pretrain_update(*(t.to(dev) for t in batch),
                                     noise=to_dev, with_viz=False)
        mc, _ = cpu.pretrain_update(*batch, noise=noise, with_viz=False)
    torch.cuda.synchronize()
    err = compare_steps(torch, sd, card, cpu, mg, mc, gg, gc, tiny["lr"],
                        "tiny width card vs CPU")
    log(f"pretrain_update tiny width: card vs CPU losses <= {err[0]:.3g} "
        f"relative, gradients <= {err[1]:.3g} relative, {err[2]:.3g} of "
        f"parameter elements apart")
    return err


def phase_train_timing(torch, dev, hyp, trainer):
    """ms per update (host clock around calls ending in a synchronize),
    device time, idle share and top kernels (torch.profiler), peak memory
    per step; PyTorch's default TF32 settings, the unfused IN + residual
    tail."""
    from lsps_tpu_torch.ops.kernels import norm_act as N

    rows = []
    reg = hyp["vae"]["input_dim"]
    for b in TRAIN_BATCHES:
        batch = train_batch(torch, dev, b, seed=20 + b, reg_dim=reg)

        def step():
            return trainer.pretrain_update(*batch, with_viz=False)

        with in_res_fused(N, False):
            ms = host_ms(torch, step, 10, warmup=2)
            by_name, dev_ms, wall = profile_kernels(torch, step, iters=3)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        rows.append({"update": "pretrain_update", "batch": b, "ms": ms,
                     "profiled_wall_ms": wall, "device_ms": dev_ms,
                     "device_idle_share": max(0.0, 1 - dev_ms / wall),
                     "kernels_per_step": sum(n for _, n in
                                             by_name.values()),
                     "norm_kernel_ms": sum(
                         ms_ for k, (ms_, _) in by_name.items()
                         if any(s in k for s in NORM_SYMBOL.values())),
                     "peak_bytes_over_state": peak - base,
                     "peak_bytes": peak,
                     "top_kernels_ms": [[k[:70], round(v[0], 5)]
                                        for k, v in top]})
        log(f"pretrain_update B={b}: {ms:.2f} ms/step, device "
            f"{dev_ms:.2f} ms, idle {rows[-1]['device_idle_share']:.2f}, "
            f"peak {peak / 2**30:.2f} GiB")
    poses = torch.from_numpy(np.random.RandomState(30).uniform(
        -0.3, 0.3, (hyp["batch_size_pose"], reg)).astype(np.float32)).to(dev)
    vae_ms = host_ms(torch, lambda: trainer.vae_update(poses), 50)
    rows.append({"update": "vae_update", "batch": hyp["batch_size_pose"],
                 "ms": vae_ms})
    log(f"vae_update B={hyp['batch_size_pose']}: {vae_ms:.3f} ms/step")
    return rows


def gpu_name_and_power():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lsps_tpu_torch.config import load_config
    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.ops.kernels.warp import warp_normalize

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    cam = Camera.nyu()
    hyp = load_config(str(Path(__file__).resolve().parent / "exps"
                          / "nnyu.yaml")).hyperparameters
    kernels = {"warp_normalize": warp_normalize}

    phase_build()
    warp_rows, warp_err = phase_warp(torch, dev, cam)
    sd = seeded_state_dict(hyp, seed=0)
    launches, _ = phase_serve(torch, dev, hyp, sd, kernels)
    timing = phase_timing(torch, dev, hyp, sd)
    norm_errs = phase_norm(torch, dev)
    log("norm max |kernel - plain|: float32 "
        f"{norm_errs[torch.float32]}, bfloat16 {norm_errs[torch.bfloat16]}")
    train_sd = seeded_state_dict(hyp, seed=1,
                                 nets=("dis", "gen", "vae", "map"))
    train_launches, trainer, train_checks = phase_train(torch, dev, hyp,
                                                        train_sd)
    norm_rows = phase_norm_timing(torch, dev)
    train_rows = phase_train_timing(torch, dev, hyp, trainer)

    log("warp timing " + json.dumps(warp_rows))
    log("serve timing " + json.dumps(timing))
    log("norm timing " + json.dumps(norm_rows))
    log("train timing " + json.dumps(train_rows))
    log("train checks " + json.dumps(train_checks))
    main_row = next(r for r in warp_rows
                    if r["batch"] == 32 and r["frames"] == "f32")
    log("library_ms: null for warp_normalize: no single PyTorch call "
        "gathers, clamps and normalizes a crop")
    log("library_ms: F.instance_norm for in_act_forward (timed at slope "
        "None, the function it computes; ms_slope_none beside it); null "
        "for in_act_backward, in_res_forward and in_res_backward: no "
        "single PyTorch call computes them")
    rows = [{
        "name": "warp_normalize", "route": "cuda",
        "source": "lsps_tpu_torch/csrc/warp.cu",
        "replaces": "lsps_tpu/ops/pallas/warp.py:42",
        "launches": launches["warp_normalize"],
        "max_abs_err": warp_err, "ms": main_row["ms"],
        "call_ms": main_row["call_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None,
        "timed_by": main_row["timed_by"],
        "at": "batch 32 float32 frames, 128x128 crops",
    }]
    for name, replaces in NORM_REPLACES.items():
        r = next(r for r in norm_rows if r["kernel"] == name
                 and r["shape"][0] == hyp["batch_size"]
                 and r["dtype"] == "float32")
        rows.append({
            "name": name, "route": "cuda",
            "source": "lsps_tpu_torch/csrc/norm_act.cu",
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": norm_errs[torch.float32][name],
            "max_abs_err_bf16": norm_errs[torch.bfloat16][name],
            "ms": r["ms"],
            "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "timed_by": r["timed_by"],
            "at": f"{tuple(r['shape'])} float32 (the batch-"
                  f"{hyp['batch_size']} training path)",
        })
    log(json.dumps({"kernels": rows}))
    log(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
