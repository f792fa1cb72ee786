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
5. print the ``kernels`` line, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line.  Without a CUDA device,
or without the package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
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


def seeded_state_dict(hyp, seed):
    import torch
    from torch import nn

    from lsps_tpu_torch.models import build_model
    from lsps_tpu_torch.ops.layers import reset_parameters

    nets = nn.ModuleDict({"dis": build_model(hyp["dis"]),
                          "vae": build_model(hyp["vae"])})
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

    log("warp timing " + json.dumps(warp_rows))
    log("serve timing " + json.dumps(timing))
    main_row = next(r for r in warp_rows
                    if r["batch"] == 32 and r["frames"] == "f32")
    log("library_ms: null for warp_normalize: no single PyTorch call "
        "gathers, clamps and normalizes a crop")
    log(json.dumps({"kernels": [{
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
    }]}))
    log(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
