"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, nvcc
and PyTorch built for CUDA.  It imports ``lsps_tpu_torch`` and nothing of
JAX or ``lsps_tpu``.  Phases, each of which must pass:

1. build every CUDA kernel of the port from ``lsps_tpu_torch/csrc`` (one
   nvcc per source, all started together) and print the build seconds;
2. hold both entries of the crop-warp kernel (``crop_normalize``, which
   computes the crop indices itself, and ``warp_normalize``, which reads
   them) against their plain PyTorch versions on the card, crops and crop
   affines bit for bit (NaN-aware: a failed detection gives NaN in M), on
   the edge frames and a zero-CoM frame and at the batch sizes of the
   serving path (1, 32, 256), for float32 and whole-millimetre uint16
   frames, at 128 x 128 and at 90 x 60 (the kernel's scalar path); check
   that ``crop_normalize_batch`` is one kernel launch; time both entries
   beside their bounds and plain versions (device time from
   torch.profiler with the frames warm in L2, per-call time from CUDA
   events), and ``crop_normalize`` also with the frames cold in L2; then
   the same checks over 20000 random CoMs and cubes on frames of distinct
   depths;
3. serve ``PoseEstimator.predict_frames`` and ``predict_raw`` at the widths
   of ``exps/nnyu.yaml`` (seeded random weights) for requests of 1 and 32
   frames, with every kernel's launch count set to 0 just before and read
   just after; ``crop_normalize`` must launch once per call and
   ``warp_normalize`` (counted too) not at all.  The joints are held
   against a plain route on the card (the reference warp + the same
   modules, TF32 off) and against the estimator on the CPU;
4. time ``predict_frames`` (ms per call at batch 1, frames/s at 32 and
   256, float32 and bf16 trunk; kernels per call and the device's idle
   share), beside the same call on the index route (the crop indices in
   PyTorch ops and the loaded-index kernel, as before the index math
   moved into the kernel), in turns;
5. detect and track a live sequence on the host and estimate it on the card
   (``exps/nnyu.yaml`` widths, the serve phase's weights): 64 frames of
   one rendered hand on a smooth CoM path, ``HandDetector.detect`` (hand
   size on) on every frame, ``refine_com_iterative`` from the previous
   CoM (5 rounds), a ``utils.realtime.Frame`` per frame, and
   ``predict_frames`` at batch 1 per frame and once at batch 64: host
   CoMs within 2 px and 3 mm of the device detector's (``predict_raw``),
   the joints within 0.05 mm of the CPU's and of batch 1's, one crop
   launch per call (the counter, and torch.profiler over 10 calls); host
   ms a frame for each step and the live loop's (track + estimate) beside
   the 33 ms of a 30 fps camera.  Then MSRA15 (2 subjects x 2 gestures x 8
   ``.bin`` frames) and POST (8 synthetic and 4 real frames, written by
   ``png_bytes``) mini-trees imported fresh and from their caches (held
   equal; frames/s), and MSRA15's raw frames through ``predict_frames``,
   card against CPU.  On the same 64 frames: the evaluation plots (the
   card's joints against the rendered ones through ``plotEvaluation``,
   its three PDFs checked: header, xref offsets, ``%%EOF``;
   ``plotResult`` of the card's crop of frame 0 with both skeletons,
   (512, 512, 3) with both stroke colours; ``plotResult3D`` of it as a
   PNG read back by the port's reader; host ms of each); the resize
   methods (``crop_area_3d`` under the default, ``RESIZE_CV2_NN``,
   ``RESIZE_CV2_LINEAR`` and ``RESIZE_BILINEAR``, host ms per crop, the
   cv2-nearest crops bit-equal to the default's; ``recrop_hand`` and
   ``rotate_hand`` under linear; the bilinear crops' poses through
   ``predict_crops`` on the card finite); and every common_net block
   (``ops/common_net.py``) forward and backward at 64 channels on
   128 x 128, batch 8, card against CPU with TF32 off within 1e-4
   relative, and the im2col stem against the conv on the card;
6. hold the four InstanceNorm kernels (IN + LeakyReLU and IN + residual,
   forward and backward) against their plain versions on the card at the
   training path's shapes (32 and 64 x 256 x 32 x 32), a ragged and a
   128 x 128 shape, float32 and bfloat16, slope 0.01 and None;
7. train at the widths of ``exps/nnyu.yaml`` (seeded random weights,
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
8. hold the training augment (``data/augment.py``) on the card against
   the same function on the CPU, bit for bit, at batch 32 with rotations,
   float32 and uint16 sources, and time it;
9. drive this slice's training paths at the widths of ``exps/nnyu.yaml``
   (batch 32), each with the norm kernels' launch counts set to 0 just
   before and read just after: ``pretrain_update_raw`` against the
   augment + ``pretrain_update`` from the same state and noise (losses
   1e-4, gradients 1e-2 beside the raw step's own run-to-run floor) with
   launches equal to the image step's; a ``compute_dtype: bfloat16``
   step (every IN + LeakyReLU launch on bfloat16 planes, losses within
   the JAX package's bfloat16 criterion of the float32 step, parameters,
   moments and outputs float32); a ``remat`` step (peak memory with and
   without, losses within 1e-4, the joint pass recomputed in the
   counts); ``pretrain_scan(raw=True)`` at K=4 against 4 single raw steps
   (cuDNN deterministic); then save, resume a fresh trainer, and hold the
   next step of both;
10. time each norm kernel beside its bound, its plain version and
   ``F.instance_norm``; ``pretrain_update`` (batch 8 and 32) and
   ``vae_update``: ms per step, device time, idle share, top kernels,
   peak memory; ``pretrain_update_raw`` beside ``pretrain_update`` at
   batch 8 and 32 in float32 and bfloat16, and ``vae_scan`` K=8 beside 8
   ``vae_update`` calls at batch 64;
11. drive the training CLIs in process through their ``main(argv)``, at
    the nnyu widths of ``exps/synth_full.yaml`` cut as ``CLI_CUTS`` says
    (frames per dataset and cadences), with the norm kernels' launch
    counts set to 0 just before each run and read just after:
    ``pose_train --frac 0.5`` (scan of 8), ``depth_train --mode
    pretrain`` on the ``step``, ``jax`` and ``jax`` + ``--bf16`` augment
    paths (at least 44 / 30 IN + LeakyReLU launches per iteration),
    ``--mode estimate3 --frac 0.5`` from those snapshots (the generator's
    no-grad forwards in every iteration, no backward, a finite mean
    error, ``_test3d.png`` written and no "3D plot skipped" line), each
    leaving the files it should and snapshots a fresh
    trainer resumes bit for bit; then ``pose_train`` on
    ``exps/synth.yaml`` for 2001 iterations, whose last eval must be at
    most a third of its first and at most 4.4 mm.  Each run prints its
    dataset seconds, ms per iteration over the loop beside the bare
    step's from phase 10, launches per iteration and eval errors;
12. the real-data path at the widths and batch sizes of
    ``exps/nnyu.yaml`` and ``exps/nicvl.yaml``: NYU and ICVL
    mini-datasets written as PNGs by a writer here that cycles the five
    scanline filters (64 + 64 NYU training frames, 32 test frames, 64 ICVL
    training frames and 8 in each test sequence, hands rendered by the
    port's ``render_hand_depth``), each split imported fresh and again
    from its cache (held equal; decode and import frames/s), the native
    library built (a failed build fails the run), each augment backend's
    loader ms per batch, ``pose_train`` on the NYU split, ``depth_train
    --mode pretrain`` under ``host``, ``native`` and ``step`` and
    ``--mode estimate3`` under ``host`` with its test-set evaluation, and
    ``exps/nicvl.yaml`` pretrain under ``host``, each with the norm
    kernels' launch counts set to 0 just before and read just after (44 /
    30 per pretrain iteration, 14 forward and no backward per estimate3
    iteration); then ``host`` against ``native`` over one epoch (labels
    within 1e-4, under 1e-3 of the pixels picked differently).  The cuts
    (iterations, ``sample_poses``, cadences, frames) are on the phase's
    line;
13. the system's own tools through their ``main`` (``lsps_tpu_torch/
    scripts/``), TF32 off: ``realtime_demo --ch 64`` over 64 frames on the
    host route and on ``--device-detect``, the crop launch count set to 0
    just before each and read just after (one launch a frame), each AVI
    well formed with 64 frames, finite joints, the host route's CoMs on the
    card within 2 px and 3 mm of the same route's first 16 frames on the
    CPU (and the device route's of the host route's), its joints within
    0.05 mm; the detect and infer medians beside the card's name and power
    limit;
    ``eval_checkpoints`` over the CLI phase's ``est_gen`` snapshots, each
    printed error within 0.05 mm of the CPU run's; ``parity_gate`` on
    ``.pkl`` files of the serve phase's weights and phase 12's NYU
    mini-dataset: 2 for a missing file, 0 with ``--expect`` at the CPU's
    error, 1 with it 1 mm away;
14. the serving surface, each with the launch counts set to 0 just before
    and read just after: ``device_detect_batch`` over 256 seeded random
    hands on the card against the CPU (run after phase 3: u and v equal, z
    within the 128 float32 ulps that ``tests/test_torch_detect.py``
    derives); the daemon (``serve.server.build_estimator`` from the CLI
    phase's snapshots, a ``PoseServer`` at ``--batch-window-ms 2
    --max-batch 64`` on an ephemeral port answering /healthz, JSON with
    CoMs, npz with uint16 frames, raw JSON and 16 concurrent 1-frame
    clients: joints equal to direct calls within 1e-3 mm, one
    ``crop_normalize`` launch per dispatched batch, some batch coalesced;
    requests/s and frames/s); export (a static batch-32 float32 frames
    program and a symbolic-batch uint16 raw program through
    ``torch.export``, saved, loaded and run: joints within 1e-3 mm of the
    live estimator, CoMs equal, one launch per program call counted from
    inside the program; then ``serve.server --artifact`` answering a
    request; export and load seconds, ms per call beside the live call);
    the latent walk (``cli.latent_walk.main``, 16 steps: the AVI and the
    strip, finite frames, 15 IN + LeakyReLU launches, the walk within 1e-3
    of the same walk on the CPU);
15. data parallelism (``lsps_tpu_torch/parallel``) at nnyu widths: (a)
    two ranks sharing the card under gloo, started by ``python -m
    torch.distributed.run --nproc-per-node 2 chip_smoke.py --dp-rank
    SPEC``, take three ``pretrain_update_raw`` steps at global batch 32
    (16 a rank), TF32 off and cuDNN deterministic, held against one
    process at batch 32 (losses 1e-4) with every rank's parameters bit for
    bit rank 0's after every step; (b) an NCCL group of one rank, two
    steps against the no-mesh trainer; (c) in the same two ranks,
    ``depth_train --mesh-data 2`` pretrain and estimate3 (from the CLI
    phase's snapshots, the sharded eval over 31 test frames, padded to 32)
    against ``--mesh-data 0`` at the same global batch: first-iteration
    losses 1e-4, the eval's mean error 1e-3; (d) ``PoseEstimator(devices=(card, card))`` at batch 32
    against the single estimator, two crop launches a call; (e) the IN +
    LeakyReLU launches per rank and step (44 / 30); (f) in the same two
    ranks, tensor parallelism (``make_mesh(1, 2)``, ``shard_state_tp``
    at ``min_out_ch=512``: the three wide ``model_S`` convs split) of
    ``SharedDis`` at nnyu widths, ``regress_b`` at batch 32 with TF32 off
    and cuDNN deterministic against the replicated module: the forward
    and every gradient within 1e-4, the gathered state dict bit for bit,
    each rank's parameter bytes and ms per forward beside the replicated
    module's.  It prints each rank's ms per step, peak memory and the
    gradient all-reduce's ms per step beside the card's name and power
    limit: two ranks sharing one card, not a scaling figure (``python3
    chip_smoke.py --dp-cards`` runs parts (a) and (f) with one NCCL rank
    on each card of a machine with several);
16. the detection kernel (``lsps::detect_coms``, ``csrc/detect.cu``)
    against its plain version on the card over phase 14's hands at batch
    1, 32 and 256, float32 and uint16 (u and v equal, z within 128 ulps,
    two calls bit-identical, one counted launch a call), then its device
    ms a call on uint16 frames with the frames warm and cold in L2,
    beside two reads of the frames at 3.35 TB/s and the plain version's
    ms and the kernels a call counted in the trace (4 + refine_iters);
    run right after phase 14's CoM sweep (``python3 chip_smoke.py
    --detect`` runs the build and this phase alone);
17. print the ``kernels`` line, the card's name and power limit, and last
    ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line.  Without a CUDA device,
or without the package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
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
WARP_INDEX_FLOPS = 8        # per output row or column: sub, div, add,
                            # floor and four compares
WARP_BATCHES = (1, 32, 256)
RANDOM_COMS = 20000         # as tests/test_torch_warp.py draws them
RANDOM_CHUNK = 2000
SCALAR_DSIZE = (90, 60)     # dw % 4 != 0: the kernel's scalar path
COLD_BYTES = 256 * 2 ** 20  # frames rotated over for a cold-L2 timing
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
    """Border CoMs, NaN/inf outside the blob, near/far outliers inside, and
    a failed detection (a blob, CoM 0: infinite bounds, NaN in M)."""
    frames = np.zeros((5, H, W), np.float32)
    frames[0, 100:260, 0:120] = rs.uniform(700, 900, (160, 120))
    frames[1, H - 130:, W - 130:] = rs.uniform(700, 900, (130, 130))
    frames[2, 200:330, 250:380] = rs.uniform(700, 900, (130, 130))
    frames[2, 10, 10] = np.nan
    frames[2, 20, 20] = np.inf
    frames[3, 200:330, 250:380] = rs.uniform(700, 900, (130, 130))
    frames[3, 240:250, 280:290] = 100.0
    frames[3, 260:270, 300:310] = 3000.0
    frames[4, 200:330, 250:380] = rs.uniform(700, 900, (130, 130))
    coms = np.asarray([[40.0, 180.0, 800.0],
                       [W - 60.0, H - 60.0, 800.0],
                       [315.0, 265.0, 800.0],
                       [315.0, 265.0, 800.0],
                       [0.0, 0.0, 0.0]], np.float32)
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
    rest = max(n - len(ef), 0)
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


def profile_kernels(torch, fn, iters=10, tries=6, symbol=None):
    """Device time by kernel name over ``iters`` calls of ``fn``, from
    torch.profiler: ({name: (ms per call, launches per call)}, device ms
    per call, wall ms per call).  A trace that holds no device event at
    all, or, given ``symbol``, fewer launches of the kernel whose name
    holds it than calls, is taken again (and logged), up to ``tries``
    times: the profiler on the card's machine has returned an empty trace
    for a call that launches a kernel, three times in a row once.  Each
    trace opens with LEAD_IN launches that it leaves out (see
    ``_profile_once``)."""
    for attempt in range(tries):
        by_name, dev_ms, wall = _profile_once(torch, fn, iters)
        if by_name and (symbol is None or round(
                launches_of(by_name, symbol), 6) >= 1):
            break
        log(f"profiler: a short trace (attempt {attempt + 1} of {tries})")
    return by_name, dev_ms, wall


def launches_of(by_name, symbol):
    """Launches per call of the kernels whose names hold ``symbol``."""
    return sum(n for name, (_, n) in by_name.items() if symbol in name)


# torch.profiler on the card's machine loses the first device activities
# of a trace: none in a young process, then more as it ages (4 launches a
# trace after one minute, 8 after two), in a process that only ever ran
# two ATen kernels and the crop kernel, and also where the first launch
# came 20 ms after the trace opened.  So each trace opens with this many
# spin kernels, synchronized and left out of the counts.
LEAD_IN = 64
LEAD_IN_KERNEL = "spin_kernel"


def _profile_once(torch, fn, iters):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                LEAD_IN_KERNEL not in e.name:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / iters,
                               n + 1 / iters)
    return by_name, sum(ms for ms, _ in by_name.values()), wall


def kernel_device_ms(torch, fn, symbol, iters=10):
    """Device ms of one launch of the kernel whose name holds ``symbol``,
    for an ``fn`` that launches it once per call: the mean over the
    launches the trace holds (torch.profiler), which stays right where the
    profiler drops some of them (seen on the card's machine: a trace of
    10 calls holding fewer launches); 0.0 if it saw none."""
    by_name, _, _ = profile_kernels(torch, fn, iters)
    hits = [v for k, v in by_name.items() if symbol in k]
    launches = sum(n for _, n in hits)
    if hits and round(launches, 6) != 1:
        log(f"profiler: {launches * iters:.0f} launches of {symbol} in a "
            f"trace of {iters} calls")
    return sum(ms for ms, _ in hits) / launches if launches else 0.0


def rotating(frames):
    """(n, an endless iterator over n copies of ``frames``): n at least 4
    and the copies together at least COLD_BYTES, so that a call taking its
    frames in turn finds them last read more than L2's 50 MB ago, as in
    serving, where every call brings new frames."""
    n = max(4, math.ceil(COLD_BYTES / frames.nbytes))
    return n, itertools.cycle([frames.clone() for _ in range(n)])


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


def source_pixels(iy, ix):
    """Distinct valid source pixels of each frame's crop, summed."""
    src = 0
    for i in range(iy.shape[0]):
        rows = np.unique(iy[i][iy[i] >= 0]).size
        cols = np.unique(ix[i][ix[i] >= 0]).size
        src += rows * cols
    return src


def warp_bytes(esize, iy, ix, computed):
    """Bytes the warp must move for these inputs: each distinct valid
    source pixel read once and the float32 crop written once; the loaded
    entry also reads the indices and tail parameters, the computed entry
    the CoM and cube (24 B) and writes M (36 B) per frame."""
    b, dh, dw = iy.shape[0], iy.shape[1], ix.shape[1]
    per_frame = 24 + 36 if computed else (dh + dw) * 4 + 16
    return source_pixels(iy, ix) * esize + b * per_frame + b * dh * dw * 4


def sector_bytes(esize, iy, ix):
    """The 32-byte sectors of the frames that the gathers touch, in bytes
    (what DRAM serves when nothing is cached, beside the bound's count)."""
    b, h = iy.shape[0], H
    valid = (iy >= 0)[:, :, None] & (ix >= 0)[:, None, :]
    addr = ((np.arange(b)[:, None, None] * h + iy[:, :, None]) * W
            + ix[:, None, :]) * esize // 32
    return np.unique(addr[valid]).size * 32


def same_bits(torch, a, b):
    """The same shape, dtype and NaN positions, and the same bits
    everywhere else (so -0.0 != 0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = a.isnan(), b.isnan()
    if not torch.equal(na, nb):
        return False
    return torch.equal(a.masked_fill(na, 0).view(torch.int32),
                       b.masked_fill(nb, 0).view(torch.int32))


def abs_err(a, b):
    return float((a - b).abs().nan_to_num(0.0).max()) if a.numel() else 0.0


def check_warp(torch, WK, cam, ft, c, cu, what, dsize=(128, 128)):
    """Both warp entries on one batch against their plain versions on the
    card, crops and M bit for bit (NaN-aware); returns (the plain indices,
    the largest |kernel - plain|)."""
    Ms, iy, ix, par = WK.crop_indices(c, cu, cam.fx, cam.fy, (H, W), dsize)
    loaded = WK.warp_normalize(ft, iy, ix, par)
    crops, got_M = WK.crop_normalize(ft, c, cu, cam.fx, cam.fy, dsize)
    torch.cuda.synchronize()
    want = WK.warp_normalize_reference(ft, iy, ix, par)
    for name, got, ref in (("warp_normalize crops", loaded, want),
                           ("crop_normalize crops", crops, want),
                           ("crop_normalize M", got_M, Ms)):
        if not same_bits(torch, got, ref):
            raise AssertionError(f"{name} != plain version at {what}: max "
                                 f"|diff| {abs_err(got, ref)}")
    if not bool(crops.isfinite().all()):
        raise AssertionError(f"non-finite crops at {what}")
    return (iy, ix, par), max(abs_err(loaded, want), abs_err(crops, want),
                              abs_err(got_M, Ms))


def time_kernel(torch, kernel, plain, symbol, iters):
    """Device ms of the kernel (torch.profiler, kernels whose name holds
    ``symbol``) and of all kernels of its plain version, and the per-call
    ms of both from CUDA events."""
    call_ms = cuda_ms(torch, kernel, iters)
    plain_call_ms = cuda_ms(torch, plain, iters)
    # a call timed back to back also holds the host's launch cost, which
    # is larger than the kernel at these sizes
    dev_ms = kernel_device_ms(torch, kernel, symbol)
    _, plain_dev_ms, _ = profile_kernels(torch, plain)
    return {"ms": dev_ms or call_ms, "call_ms": call_ms,
            "plain_ms": plain_dev_ms or plain_call_ms,
            "plain_call_ms": plain_call_ms,
            "timed_by": "profiler" if dev_ms and plain_dev_ms
            else "cuda events"}


def bound(nbytes, flops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_warp(torch, dev, cam):
    """Both warp entries vs their plain versions, bit for bit (crops and M,
    NaN-aware), on the edge frames and at the serving batch sizes, float32
    and uint16 frames, 128 x 128 and SCALAR_DSIZE crops, then timed;
    returns (timing rows, max |err|)."""
    from lsps_tpu_torch.ops.kernels import warp as WK
    from lsps_tpu_torch.serve.preprocess import crop_normalize_batch

    rows, max_err = [], 0.0
    batches = [("edges", edge_frames(np.random.RandomState(3)))]
    batches += [(b, warp_batch(b, seed=100 + b)[:2]) for b in WARP_BATCHES]
    for b, (frames, coms) in batches:
        n = len(frames)
        c = torch.from_numpy(coms).to(dev)
        cu = torch.full((n, 3), CUBE_MM, device=dev)
        for kind, f in (("f32", frames), ("u16", whole_mm_u16(frames))):
            ft = torch.from_numpy(f).to(dev)
            (iy, ix, par), err = check_warp(torch, WK, cam, ft, c, cu,
                                            f"B={b} {kind}")
            _, scalar_err = check_warp(torch, WK, cam, ft, c, cu,
                                       f"B={b} {kind} {SCALAR_DSIZE}",
                                       SCALAR_DSIZE)
            max_err = max(max_err, err, scalar_err)
            if kind == "u16":
                ff = ft.to(torch.float32)
                if not (torch.equal(WK.warp_normalize(ft, iy, ix, par),
                                    WK.warp_normalize(ff, iy, ix, par))
                        and torch.equal(
                            WK.crop_normalize(ft, c, cu, cam.fx, cam.fy)[0],
                            WK.crop_normalize(ff, c, cu, cam.fx, cam.fy)[0])):
                    raise AssertionError(f"uint16 frames != their float32 "
                                         f"copy at B={b}")
            if b == "edges":
                continue
            # on the card crop_normalize_batch is one kernel, index math
            # included: one launch per call by the wrapper's count, and no
            # other kernel in the trace (which may drop a launch, never
            # add one)
            call = functools.partial(crop_normalize_batch, ft, c, cu,
                                     cam.fx, cam.fy)
            before = WK.crop_normalize.launches
            for _ in range(3):
                call()
            counted = (WK.crop_normalize.launches - before) / 3
            by_name, _, _ = profile_kernels(torch, call, iters=3)
            per_call = sum(k for _, k in by_name.values())
            if counted != 1 or len(by_name) != 1 or \
                    round(per_call, 6) > 1:
                raise AssertionError(f"crop_normalize_batch B={b}: "
                                     f"{counted} launches per call, "
                                     f"{per_call} kernels per call in the "
                                     f"trace: {list(by_name)}")
            iters = 200 if b < 256 else 50
            iy_np, ix_np = iy.cpu().numpy(), ix.cpu().numpy()
            esize = ft.element_size()
            pixels = b * 128 * 128
            flops = WARP_FLOPS_PER_PIXEL * pixels
            for entry, kernel, plain, computed in (
                    ("crop_normalize",
                     functools.partial(WK.crop_normalize, ft, c, cu, cam.fx,
                                       cam.fy),
                     functools.partial(WK.crop_normalize_reference, ft, c,
                                       cu, cam.fx, cam.fy), True),
                    ("warp_normalize",
                     functools.partial(WK.warp_normalize, ft, iy, ix, par),
                     functools.partial(WK.warp_normalize_reference, ft, iy,
                                       ix, par), False)):
                row = {"entry": entry, "batch": b, "frames": kind,
                       **time_kernel(torch, kernel, plain, "crop_warp_kernel",
                                     iters),
                       **bound(warp_bytes(esize, iy_np, ix_np, computed),
                               flops + (WARP_INDEX_FLOPS * b * 256
                                        if computed else 0)),
                       "sector_bytes": sector_bytes(esize, iy_np, ix_np)
                       + pixels * 4}
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
                if computed:
                    n, turn = rotating(ft)
                    row["cold_ms"] = kernel_device_ms(
                        torch, lambda: WK.crop_normalize(
                            next(turn), c, cu, cam.fx, cam.fy),
                        "crop_warp_kernel", max(20, n))
                    del turn
                    row["cold_share_of_bound"] = (row["bound_ms"]
                                                  / row["cold_ms"])
                rows.append(row)
                log(f"{entry} B={b} {kind}: {row['ms']:.5f} ms device, "
                    f"bound {row['bound_ms']:.5f} ms "
                    f"({row['share_of_bound']:.0%}), plain "
                    f"{row['plain_ms']:.5f} ms"
                    + (f", L2 cold {row['cold_ms']:.5f} ms" if computed
                       else ""))
        log(f"warp B={b}: both entries bit-equal to their plain versions, "
            f"crops and M (float32 and uint16 frames, {SCALAR_DSIZE} "
            f"crops too)")
    return rows, max_err


def phase_warp_random(torch, dev, cam):
    """Both entries over RANDOM_COMS random CoMs and cubes, drawn as
    tests/test_torch_warp.py draws them, on frames whose pixels are
    distinct depths inside each crop's z-range, so that an index off by
    one changes the crop; the card's plain indices are also held against
    the CPU's (which the tests hold against the JAX package)."""
    from lsps_tpu_torch.ops.kernels import warp as WK

    rs = np.random.RandomState(0)
    n = RANDOM_COMS
    coms = np.stack([rs.uniform(-50, 700, n), rs.uniform(-50, 530, n),
                     rs.uniform(200, 2000, n)], 1).astype(np.float32)
    cubes = rs.uniform(150, 400, (n, 3)).astype(np.float32)
    cubes[::2] = 300.0
    ramp = ((rs.permutation(H * W).reshape(H, W) + 0.5) / (H * W)
            ).astype(np.float32)
    ramp = torch.from_numpy(ramp).to(dev)
    max_err, empty = 0.0, 0
    for lo in range(0, n, RANDOM_CHUNK):
        c = torch.from_numpy(coms[lo:lo + RANDOM_CHUNK]).to(dev)
        cu = torch.from_numpy(cubes[lo:lo + RANDOM_CHUNK]).to(dev)
        frames = (c[:, 2, None, None]
                  + cu[:, 2, None, None] * (0.9 * ramp - 0.45))
        (iy, ix, par), err = check_warp(torch, WK, cam, frames, c, cu,
                                        f"random CoMs {lo}+")
        max_err = max(max_err, err)
        empty += int(((iy < 0).all(1) | (ix < 0).all(1)).sum())
        cpu = WK.crop_indices(c.cpu(), cu.cpu(), cam.fx, cam.fy, (H, W))
        card = WK.crop_indices(c, cu, cam.fx, cam.fy, (H, W))
        for name, a, b in zip(("M", "iy", "ix", "params"), card, cpu):
            if not same_bits(torch, a.cpu().float(), b.float()):
                raise AssertionError(f"plain {name} card != CPU at random "
                                     f"CoMs {lo}+")
        del frames
    log(f"warp: {n} random CoMs ({empty} with an empty crop): both entries "
        f"bit-equal to their plain versions, crops and M; plain indices "
        f"card == CPU")
    return max_err


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
    is off for the whole phase.  Returns (the launches of ``kernels``, those
    of the loaded-index entry, the worst joint gap to the plain route)."""
    from lsps_tpu_torch.ops.kernels import warp as WK
    from lsps_tpu_torch.serve.inference import PoseEstimator
    from lsps_tpu_torch.serve.preprocess import crop_normalize_batch

    with tf32_off(torch):
        est = PoseEstimator(hyp, sd, device=dev)
        reqs = serve_requests()
        for k in (*kernels.values(), WK.warp_normalize):
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
        loaded_launches = WK.warp_normalize.launches
        log(f"main path launches: {launches}, warp_normalize "
            f"{loaded_launches}")
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"main path")
        # four calls per request, each one crop_normalize launch, two of
        # them predict_raw with one detection launch each; the
        # loaded-index entry is off the main path
        if launches["crop_normalize"] != 4 * len(reqs) or loaded_launches \
                or launches["device_detect_batch"] != 2 * len(reqs):
            raise AssertionError(f"launches {launches}, warp_normalize "
                                 f"{loaded_launches}: the main path gives "
                                 f"{4 * len(reqs)} crops, "
                                 f"{2 * len(reqs)} detections and 0")

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
    return launches, loaded_launches, worst


def index_route(frames, coms, cubes, fx, fy, dsize=(128, 128)):
    """The crop as the serving path ran it before the index math moved
    into the kernel: crop_indices in PyTorch ops, then the loaded-index
    entry."""
    import torch

    from lsps_tpu_torch.ops.kernels import warp as WK

    Ms, iy, ix, par = WK.crop_indices(coms.to(torch.float32),
                                     cubes.to(torch.float32), fx, fy,
                                     tuple(frames.shape[1:]), dsize)
    return WK.warp_normalize(frames.contiguous(), iy, ix, par), Ms


def phase_timing(torch, dev, hyp, sd):
    """predict_frames per call (B=1) and frames/s (B=32, 256), float32 and
    bf16 trunk, frames already on the card; PyTorch's default TF32
    settings.  Beside each, the same call with the crop on the index route
    (crop_indices in PyTorch ops + the loaded-index kernel), timed in
    turns: index, kernel, kernel, index."""
    from lsps_tpu_torch.serve import inference
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

            def call():
                return est.predict_frames(f, c, cu)

            def measure():
                ms = host_ms(torch, call, iters)
                by_name, dev_ms, wall = profile_kernels(torch, call)
                return ms, by_name, dev_ms, wall

            def index_measure():
                with unittest.mock.patch.object(
                        inference, "crop_normalize_batch", index_route):
                    return measure()

            runs = [index_measure(), measure(), measure(), index_measure()]
            ms = (runs[1][0] + runs[2][0]) / 2
            idx_ms = (runs[0][0] + runs[3][0]) / 2
            _, by_name, dev_ms, wall = runs[2]
            _, idx_names, idx_dev_ms, idx_wall = runs[3]
            raw_ms = host_ms(torch, lambda: est.predict_raw(f, cu), iters)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
            rows.append({"dtype": str(dtype).replace("torch.", ""),
                         "batch": b, "predict_frames_ms": ms,
                         "predict_frames_ms_runs": [runs[1][0], runs[2][0]],
                         "frames_per_s": b * 1e3 / ms,
                         "predict_raw_ms": raw_ms,
                         "profiled_wall_ms": wall, "device_ms": dev_ms,
                         "device_idle_share": max(0.0, 1 - dev_ms / wall),
                         "kernels_per_call": sum(n for _, n in
                                                 by_name.values()),
                         "index_route_ms": idx_ms,
                         "index_route_ms_runs": [runs[0][0], runs[3][0]],
                         "index_route_device_ms": idx_dev_ms,
                         "index_route_idle_share": max(
                             0.0, 1 - idx_dev_ms / idx_wall),
                         "index_route_kernels_per_call": sum(
                             n for _, n in idx_names.values()),
                         "top_kernels_ms": [[k[:60], round(v[0], 5)]
                                            for k, v in top]})
            r = rows[-1]
            log(f"predict_frames {r['dtype']} B={b}: {ms:.3f} ms/call, "
                f"{b * 1e3 / ms:.1f} frames/s, {r['kernels_per_call']:.0f} "
                f"kernels, idle {r['device_idle_share']:.2f} (index route "
                f"{idx_ms:.3f} ms, {r['index_route_kernels_per_call']:.0f} "
                f"kernels, idle {r['index_route_idle_share']:.2f}); "
                f"predict_raw {raw_ms:.3f} ms/call")
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
                row = {"kernel": name, "shape": list(shape),
                       "dtype": str(dtype)[6:],
                       **time_kernel(torch, kernel, plain, NORM_SYMBOL[name],
                                     100),
                       **bound(norm_bytes(name, shape, x.element_size()),
                               NORM_FLOPS_PER_VALUE[name] * x.numel()),
                       "library_ms": None}
                if name == "in_act_forward":
                    ident = functools.partial(N.in_act_forward, x, None)
                    lib = functools.partial(F.instance_norm, x, eps=N.EPS)
                    row["ms_slope_none"] = kernel_device_ms(
                        torch, ident, NORM_SYMBOL[name]) or cuda_ms(
                            torch, ident, 100)
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


@contextlib.contextmanager
def tf32_off(torch, deterministic=False):
    """TF32 off (and with ``deterministic``, cuDNN's deterministic
    algorithms) within the block."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


def norm_launches(N):
    return {name: k.launches for name, k in N.KERNELS.items()}


def zero_norm_launches(N):
    for k in N.KERNELS.values():
        k.launches = 0


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
    zero_norm_launches(N)
    with in_res_fused(N, False):
        mets = [trainer.vae_update(poses)[0]]
        mets += [trainer.pretrain_update(*batch, with_viz=False)[0]
                 for _ in range(3)]
        mets.append(trainer.post_update(*batch, mode=3, with_viz=False)[0])
    with in_res_fused(N, True):
        mets.append(trainer.pretrain_update(*batch, with_viz=False)[0])
    torch.cuda.synchronize()
    launches = norm_launches(N)
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

    with tf32_off(torch):
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
            before = norm_launches(N)
            # the plain route: the wrappers bound to their plain versions
            # for this block only
            with unittest.mock.patch.multiple(N, **{
                    name: getattr(N, f"{name}_reference")
                    for name in N.KERNELS}):
                mp, _ = plain.pretrain_update(*batch, noise=noise,
                                              with_viz=False)
                torch.cuda.synchronize()
        if norm_launches(N) != before:
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
            over, peak, _ = step_peak_bytes(torch, step)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        rows.append({"update": "pretrain_update", "batch": b, "ms": ms,
                     "profiled_wall_ms": wall, "device_ms": dev_ms,
                     "device_idle_share": max(0.0, 1 - dev_ms / wall),
                     "kernels_per_step": sum(n for _, n in
                                             by_name.values()),
                     "norm_kernel_ms": sum(
                         ms_ for k, (ms_, _) in by_name.items()
                         if any(s in k for s in NORM_SYMBOL.values())),
                     "peak_bytes_over_state": over,
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


# ---------------------------------------------------------------------------
# the fused-augment, bfloat16, remat, scan and checkpoint paths
# ---------------------------------------------------------------------------

AUG_BATCH = 32
AUG_HW = 128
# per output pixel: three coordinate rows (2 mul + 2 add each), 2 divides,
# 2 add + floor, 4 compares; per source pixel the chain: ~14 (compares,
# selects, clamp, subtract, divide)
AUG_OPS_PER_PIXEL = 16 + 14
SCAN_K = 4
VAE_SCAN_K = 8
# bfloat16 against float32 from the same state and noise: the JAX
# package's own criterion (tests/test_bf16_training.py), 8 % relative or
# 0.05 absolute
BF16_LOSS_RTOL, BF16_LOSS_ATOL = 0.08, 0.05
NV_VAL = 32000.0


def rotation_dst_to_src(center, deg):
    """(n, 3, 3) dst -> src transforms of rotations by ``deg`` about
    ``center``, as the training augment's raw batches carry them."""
    a = np.deg2rad(-np.asarray(deg, np.float64))
    ca, sa = np.cos(a), np.sin(a)
    cx, cy = center
    fwd = np.zeros((a.shape[0], 3, 3))
    fwd[:, 0, 0], fwd[:, 0, 1] = ca, sa
    fwd[:, 0, 2] = (1 - ca) * cx - sa * cy
    fwd[:, 1, 0], fwd[:, 1, 1] = -sa, ca
    fwd[:, 1, 2] = sa * cx + (1 - ca) * cy
    fwd[:, 2, 2] = 1.0
    return np.linalg.inv(fwd)


def raw_tuple(b, rs, u16):
    """One domain's raw tuple, (src, minv, com_z, cube_z, premax, zstart,
    zend[, vstar]): cached (b, 128, 128) crops of distinct whole-mm
    depths inside the cube, with background, NV, premax, near and far
    pixels; transforms rotating by up to +-180 degrees, scaling and
    shifting; uint16 codes (code 1 -> vstar) or float32 mm."""
    hw = AUG_HW
    minv = rotation_dst_to_src((hw // 2, hw // 2), rs.uniform(0, 360, b))
    minv[:, :2, :2] *= np.abs(1.0 + rs.randn(b) * 0.05)[:, None, None]
    minv[:, :2, 2] += rs.uniform(-10, 10, (b, 2))
    com_z = rs.uniform(650, 850, b).astype(np.float32)
    cube_z = np.full(b, 300.0, np.float32)
    premax = (com_z + rs.uniform(120, 160, b)).astype(np.float32)
    ramp = rs.permutation(hw * hw).reshape(hw, hw) / (hw * hw)
    src = np.round(com_z[:, None, None] - 140 + 280 * ramp).astype(
        np.float32)
    src[:, :12] = 0.0
    src[:, 20:24] = NV_VAL
    src[:, 40:44] = np.round(premax)[:, None, None]
    premax = np.round(premax).astype(np.float32)
    src[:, 60:64] = (com_z - 200)[:, None, None].round()
    src[:, 80:84] = (com_z + 200)[:, None, None].round()
    raw = (src, minv, com_z, cube_z, premax, com_z - cube_z / 2,
           com_z + cube_z / 2)
    if u16:
        codes = src.astype(np.uint16)
        codes[:, 100:102] = 1
        raw = (codes, *raw[1:], rs.uniform(500, 520, b).astype(np.float32))
    return raw


def raw_step_batch(b, seed, reg_dim, u16=True):
    """(raw_a, labels_a, raw_b, labels_b) for one fused-augment step, as
    numpy arrays (what the data loader hands the trainer)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        out.append(raw_tuple(b, rs, u16))
        out.append(rs.uniform(-0.3, 0.3, (b, reg_dim)).astype(np.float32))
    return out


def aug_bytes(raw):
    """Bytes the augment must move: the source crops and per-sample
    parameters read once, the float32 crops written once."""
    n = raw[0].size
    per_sample = 9 * 4 + 5 * 4 + (4 if len(raw) == 8 else 0)
    return n * raw[0].itemsize + raw[0].shape[0] * per_sample + n * 4


def phase_augment(torch, dev):
    """The training augment on the card against the same function on the
    CPU, bit for bit, at batch 32 with rotations, for float32 and uint16
    sources; then, with its inputs on the card, its device time, kernels
    per call and host ms per call."""
    from lsps_tpu_torch.data import augment as A

    rows = []
    for kind in ("f32", "u16"):
        raw = raw_tuple(AUG_BATCH, np.random.RandomState(40), kind == "u16")
        card = A.recrop_normalize_batch(*raw, device=dev)
        torch.cuda.synchronize()
        cpu = A.recrop_normalize_batch(*raw)
        if not same_bits(torch, card.cpu(), cpu):
            raise AssertionError(f"augment {kind}: card != CPU, max |diff| "
                                 f"{abs_err(card.cpu(), cpu)}")
        if card.shape != (AUG_BATCH, AUG_HW, AUG_HW) or \
                not bool(card.isfinite().all()):
            raise AssertionError(f"augment {kind}: bad crops")
        on_dev = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in raw)
        call = functools.partial(A.recrop_normalize_batch, *on_dev)
        by_name, dev_ms, wall = profile_kernels(torch, call, iters=10)
        row = {"frames": kind, "batch": AUG_BATCH, "device_ms": dev_ms,
               "host_ms": host_ms(torch, call, 50),
               "kernels_per_call": sum(n for _, n in by_name.values()),
               **bound(aug_bytes(raw),
                       AUG_OPS_PER_PIXEL * raw[0].size)}
        rows.append(row)
        log(f"augment B={AUG_BATCH} {kind}: card == CPU bit for bit; "
            f"{dev_ms:.4f} ms device in {row['kernels_per_call']:.0f} "
            f"kernels, {row['host_ms']:.3f} ms per call, bound "
            f"{row['bound_ms']:.5f} ms")
    return rows


def phase_raw_step(torch, dev, hyp, sd):
    """pretrain_update_raw (batch 32, uint16 raw tuples from the host)
    against augment + pretrain_update from the same state and noise, TF32
    off, with the raw step run twice for the floor; the norm launches of
    the raw step, each read around its own step, equal the image
    step's."""
    from lsps_tpu_torch.data import augment as A
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.train import LSPSTrainer

    b, reg = hyp["batch_size"], hyp["vae"]["input_dim"]
    raw_a, la, raw_b, lb = raw_step_batch(b, 41, reg)
    with tf32_off(torch), in_res_fused(N, False):
        raw_t, again, image_t = (LSPSTrainer(hyp, sd, device=dev)
                                 for _ in range(3))
        noise = pretrain_noise(torch, dev, b, raw_t.gen.latent_ch, seed=42)
        gr, ga, gi = (record_grads(t) for t in (raw_t, again, image_t))
        zero_norm_launches(N)
        mr, outs = raw_t.pretrain_update_raw(raw_a, la, raw_b, lb,
                                             noise=noise)
        torch.cuda.synchronize()
        raw_launches = norm_launches(N)
        again.pretrain_update_raw(raw_a, la, raw_b, lb, noise=noise,
                                  with_viz=False)
        ia = A.recrop_normalize_batch(*raw_a, device=dev)[..., None]
        ib = A.recrop_normalize_batch(*raw_b, device=dev)[..., None]
        zero_norm_launches(N)
        mi, _ = image_t.pretrain_update(ia, la, ib, lb, noise=noise,
                                        with_viz=False)
        torch.cuda.synchronize()
        image_launches = norm_launches(N)
    log(f"raw step launches {raw_launches}, image step {image_launches}")
    if raw_launches != image_launches or not raw_launches[
            "in_act_forward"] or not raw_launches["in_act_backward"]:
        raise AssertionError("pretrain_update_raw's norm launches differ "
                             "from the image step's")
    gen_outs, oa, ob = outs
    if not (torch.equal(oa, ia) and torch.equal(ob, ib)
            and oa.shape == (b, AUG_HW, AUG_HW, 1) and len(gen_outs) == 8):
        raise AssertionError("pretrain_update_raw's crops differ from the "
                             "augment's")
    floor = compare_grads(torch, ga, gr, in_fed_biases(raw_t),
                          "raw step run twice")
    start = {k: v.float() for k, v in sd.items()}
    loss_err, grad_err, share = compare_steps(
        torch, start, raw_t, image_t, mr, mi, gr, gi, hyp["lr"],
        "pretrain_update_raw vs augment + pretrain_update")
    log(f"pretrain_update_raw B={b}: vs augment + pretrain_update losses <= "
        f"{loss_err:.3g} relative (tol {STEP_LOSS_RTOL}), gradients <= "
        f"{grad_err:.3g} (tol {STEP_GRAD_RTOL}; the raw step run twice: "
        f"{floor:.3g}), {share:.3g} of parameter elements apart")
    return raw_launches, {"loss_rel": loss_err, "grad_rel": grad_err,
                          "twice_grad_rel": floor, "param_share": share}


def phase_bf16(torch, dev, hyp, sd):
    """compute_dtype bfloat16 pretrain_update (batch 32) against the
    float32 step from the same state and noise, TF32 off: every norm
    kernel launch of the step sees bfloat16 planes; losses within the JAX
    package's bf16 criterion; parameters and moments float32 at rest,
    outputs float32."""
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.train import LSPSTrainer

    b, reg = hyp["batch_size"], hyp["vae"]["input_dim"]
    batch = train_batch(torch, dev, b, seed=43, reg_dim=reg)
    # the dtype of the planes each IN + LeakyReLU kernel launch is given
    seen = {"lsps_in_act_fwd": set(), "lsps_in_act_bwd": set()}
    launch = N._launch

    def spy(name, x, *args):
        if name in seen:
            seen[name].add(x.dtype)
        return launch(name, x, *args)

    with tf32_off(torch), in_res_fused(N, False):
        f32_t = LSPSTrainer(hyp, sd, device=dev)
        bf_t = LSPSTrainer(dict(hyp, compute_dtype="bfloat16"), sd,
                           device=dev)
        noise = pretrain_noise(torch, dev, b, f32_t.gen.latent_ch, seed=44)
        m32, _ = f32_t.pretrain_update(*batch, noise=noise, with_viz=False)
        zero_norm_launches(N)
        with unittest.mock.patch.object(N, "_launch", spy):
            mbf, outs = bf_t.pretrain_update(*batch, noise=noise)
        torch.cuda.synchronize()
        launches = norm_launches(N)
    log(f"bf16 step launches {launches}, dtypes seen "
        f"{ {k: sorted(map(str, v)) for k, v in seen.items()} }")
    for name, sym in (("in_act_forward", "lsps_in_act_fwd"),
                      ("in_act_backward", "lsps_in_act_bwd")):
        if not launches[name] or seen[sym] != {torch.bfloat16}:
            raise AssertionError(f"bf16 step: {name} launched "
                                 f"{launches[name]} times on {seen[sym]}")
    rels = {}
    for k, v32 in m32.items():
        a, w = float(mbf[k]), float(v32)
        if not np.isfinite(a):
            raise AssertionError(f"bf16 step: {k} = {a}")
        rels[k] = abs(a - w) / max(abs(w), 1e-12)
        if abs(a - w) > max(BF16_LOSS_RTOL * abs(w), BF16_LOSS_ATOL):
            raise AssertionError(f"bf16 step: {k} {a} vs float32 {w}")
    if any(p.dtype != torch.float32 for p in bf_t.nets.parameters()) or \
            any(m.dtype != torch.float32 for opt in (bf_t.dis_opt,
                                                     bf_t.gen_opt)
                for m in opt.mu + opt.nu) or \
            any(o.dtype != torch.float32 for o in outs):
        raise AssertionError("bf16 step: a parameter, moment or output is "
                             "not float32")
    log(f"pretrain_update B={b} bfloat16: every IN+LeakyReLU launch on "
        f"bfloat16; relative gap to the float32 step by metric "
        f"{ {k: float(f'{v:.3g}') for k, v in rels.items()} } (tol "
        f"{BF16_LOSS_RTOL} relative or {BF16_LOSS_ATOL} absolute); "
        f"parameters, moments and outputs float32")
    return launches, {"rel_vs_f32": rels}


def step_peak_bytes(torch, fn):
    """(peak device bytes allocated during ``fn`` above what was allocated
    before it, the peak itself, ``fn()``)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak - base, peak, out


def phase_remat(torch, dev, hyp, sd):
    """One batch-32 pretrain_update with and without remat from the same
    state and noise, TF32 off: peak memory of each, the losses (the plain
    step run twice for the floor), and the recompute in the norm launches
    (one more joint pass forward)."""
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.train import LSPSTrainer

    b, reg = hyp["batch_size"], hyp["vae"]["input_dim"]
    batch = train_batch(torch, dev, b, seed=45, reg_dim=reg)
    res = {}
    with tf32_off(torch), in_res_fused(N, False):
        for tag, h in (("plain", hyp), ("again", hyp),
                       ("remat", dict(hyp, remat=True))):
            t = LSPSTrainer(h, sd, device=dev)
            noise = pretrain_noise(torch, dev, b, t.gen.latent_ch, seed=46)
            zero_norm_launches(N)
            peak, _, (met, _) = step_peak_bytes(
                torch, lambda: t.pretrain_update(*batch, noise=noise,
                                                 with_viz=False))
            res[tag] = (peak, met, norm_launches(N))
            del t, noise
    joint, _ = in_act_counts(hyp["gen"])
    want = dict(res["plain"][2])
    want["in_act_forward"] += joint
    if res["remat"][2] != want:
        raise AssertionError(f"remat launches {res['remat'][2]}, the "
                             f"recompute gives {want}")

    def loss_rel(ma, mb):
        return max(abs(float(ma[k]) - float(mb[k]))
                   / max(abs(float(mb[k])), 1e-12) for k in ma)

    floor = loss_rel(res["again"][1], res["plain"][1])
    err = loss_rel(res["remat"][1], res["plain"][1])
    if err > STEP_LOSS_RTOL:
        raise AssertionError(f"remat losses {err:.3g} apart")
    out = {"peak_bytes_plain": res["plain"][0],
           "peak_bytes_remat": res["remat"][0], "loss_rel": err,
           "twice_loss_rel": floor}
    log(f"remat B={b}: peak {res['plain'][0] / 2**30:.3f} GiB without, "
        f"{res['remat'][0] / 2**30:.3f} GiB with; losses {err:.3g} apart "
        f"(tol {STEP_LOSS_RTOL}; the plain step run twice: {floor:.3g}); "
        f"launches {res['remat'][2]} (the joint pass recomputed)")
    return res["remat"][2], out


def phase_scan_ckpt(torch, dev, hyp, sd, raw_launches):
    """pretrain_scan(raw=True) at K=4 against 4 single raw steps (TF32 off,
    cuDNN deterministic); then save the scanned trainer at nnyu width,
    resume a fresh trainer from it (optimizers included), and hold the
    next step of both against each other."""
    import shutil

    from lsps_tpu_torch.data.augment import stack_raw
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.train import LSPSTrainer

    b, reg = hyp["batch_size"], hyp["vae"]["input_dim"]
    steps = [raw_step_batch(b, 50 + k, reg) for k in range(SCAN_K + 1)]
    save_dir = Path(__file__).resolve().parent / "build" / "smoke_ckpt"
    shutil.rmtree(save_dir, ignore_errors=True)
    prefix = str(save_dir / "pre")
    with tf32_off(torch, deterministic=True), in_res_fused(N, False):
        scan_t, single_t = (LSPSTrainer(hyp, sd, device=dev)
                            for _ in range(2))
        noises = [pretrain_noise(torch, dev, b, scan_t.gen.latent_ch,
                                 seed=60 + k) for k in range(SCAN_K + 1)]
        stacked = [stack_raw([s[0] for s in steps[:SCAN_K]]),
                   np.stack([s[1] for s in steps[:SCAN_K]]),
                   stack_raw([s[2] for s in steps[:SCAN_K]]),
                   np.stack([s[3] for s in steps[:SCAN_K]])]
        zero_norm_launches(N)
        mets, outs = scan_t.pretrain_scan(*stacked, raw=True,
                                          noise=noises[:SCAN_K],
                                          with_viz=False)
        torch.cuda.synchronize()
        scan_launches = norm_launches(N)
        singles = [single_t.pretrain_update_raw(*steps[k], noise=noises[k],
                                                with_viz=False)[0]
                   for k in range(SCAN_K)]
        torch.cuda.synchronize()
        worst = 0.0
        for k, v in mets.items():
            if tuple(v.shape) != (SCAN_K,):
                raise AssertionError(f"pretrain_scan: {k} {tuple(v.shape)}")
            for i, m in enumerate(singles):
                rel = abs(float(v[i]) - float(m[k])) / max(abs(float(m[k])),
                                                           1e-12)
                worst = max(worst, rel)
                if rel > STEP_LOSS_RTOL:
                    raise AssertionError(f"pretrain_scan step {i}: {k} "
                                         f"{float(v[i])} vs {float(m[k])}")
        if outs is not None:
            raise AssertionError("pretrain_scan with_viz=False gave outputs")
        if scan_launches != {k: SCAN_K * n for k, n in raw_launches.items()}:
            raise AssertionError(f"pretrain_scan launches {scan_launches}, "
                                 f"{SCAN_K} raw steps give "
                                 f"{SCAN_K} x {raw_launches}")
        param_gap = max(float((a - c).abs().max()) for a, c in zip(
            scan_t.nets.state_dict().values(),
            single_t.nets.state_dict().values()))
        log(f"pretrain_scan K={SCAN_K} B={b}: metrics ({SCAN_K},), within "
            f"{worst:.3g} of {SCAN_K} single raw steps, parameters "
            f"{param_gap:.3g} apart; launches {scan_launches}")

        # checkpoint: save the scanned trainer, resume a fresh one
        scan_t.save(prefix, SCAN_K - 1)
        scan_t.save_vae(prefix, SCAN_K - 1, 1.0)
        fresh = LSPSTrainer(hyp, seeded_state_dict(
            hyp, seed=9, nets=("dis", "gen", "vae", "map")), device=dev)
        it = fresh.resume(prefix, load_opt=True)
        if it != SCAN_K or not fresh.load_vae(prefix, 1.0):
            raise AssertionError(f"resume found iteration {it}")
        for opt_a, opt_b in ((scan_t.gen_opt, fresh.gen_opt),
                             (scan_t.dis_opt, fresh.dis_opt)):
            if (opt_b.count, opt_b.sched_count) != (opt_a.count,
                                                    opt_a.sched_count) \
                    or not all(torch.equal(x, y) for x, y in zip(
                        opt_a.mu + opt_a.nu, opt_b.mu + opt_b.nu)):
                raise AssertionError("resumed optimizer != saved")
        if not all(torch.equal(x, y) for x, y in zip(
                scan_t.nets.parameters(), fresh.nets.parameters())):
            raise AssertionError("resumed parameters != saved")
        start = {k: v.float().cpu()
                 for k, v in scan_t.nets.state_dict().items()}
        ga, gb = record_grads(scan_t), record_grads(fresh)
        ma, _ = scan_t.pretrain_update_raw(*steps[SCAN_K],
                                           noise=noises[SCAN_K],
                                           with_viz=False)
        mb, _ = fresh.pretrain_update_raw(*steps[SCAN_K],
                                          noise=noises[SCAN_K],
                                          with_viz=False)
        torch.cuda.synchronize()
    files = sorted(p.name for p in save_dir.iterdir())
    shutil.rmtree(save_dir)
    loss_err, grad_err, share = compare_steps(
        torch, start, fresh, scan_t, mb, ma, gb, ga, hyp["lr"],
        "resumed vs saved trainer")
    log(f"checkpoint: saved {files}; resumed at iteration {it}, parameters "
        f"and optimizers bit-equal; next step losses <= {loss_err:.3g} "
        f"relative, gradients <= {grad_err:.3g}, {share:.3g} of parameter "
        f"elements apart")
    return scan_launches, {"scan_loss_rel": worst, "scan_param_gap": param_gap,
                           "resume_loss_rel": loss_err,
                           "resume_grad_rel": grad_err}


def profiled_step(torch, fn, symbols=None):
    """Device ms, idle share, kernels per call and (for ``symbols``) the
    device ms and launches per call of those kernels, from torch.profiler
    over 3 calls of ``fn``."""
    by_name, dev_ms, wall = profile_kernels(torch, fn, iters=3)
    row = {"device_ms": dev_ms, "profiled_wall_ms": wall,
           "device_idle_share": max(0.0, 1 - dev_ms / wall),
           "kernels_per_call": sum(n for _, n in by_name.values())}
    for name, sym in (symbols or {}).items():
        hits = [v for k, v in by_name.items() if sym in k]
        row[f"{name}_ms"] = sum(v[0] for v in hits)
        row[f"{name}_launches"] = sum(v[1] for v in hits)
    return row


def timed_in_turns(torch, fns, iters, symbols=None):
    """(name, callable) pairs timed on the host clock in turns, forwards
    then backwards (a, b, c, c, b, a): ``ms`` is the mean of each one's
    two runs, ``ms_runs`` the runs (the host clock drifts within a call);
    then each profiled (``profiled_step``).  Returns a row per name."""
    runs = {name: [] for name, _ in fns}
    for name, fn in (*fns, *reversed(fns)):
        runs[name].append(host_ms(torch, fn, iters, warmup=2))
    return {name: {"ms": sum(runs[name]) / 2, "ms_runs": runs[name],
                   **profiled_step(torch, fn, symbols)}
            for name, fn in fns}


def phase_raw_timing(torch, dev, hyp, sd):
    """pretrain_update_raw (uint16 raw tuples from the host) beside
    pretrain_update (crops already on the card) and pretrain_update_raw
    on raw tuples already on the card, at batch 8 and 32, float32 and
    bfloat16 compute; vae_scan K=8 beside 8 vae_update at batch 64; each
    set timed in turns.  PyTorch's default TF32 settings, the unfused IN
    + residual tail."""
    from lsps_tpu_torch.data import augment as A
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.train import LSPSTrainer

    rows = []
    reg = hyp["vae"]["input_dim"]
    with in_res_fused(N, False):
        for dtype, h in (("float32", hyp),
                         ("bfloat16", dict(hyp, compute_dtype="bfloat16"))):
            trainer = LSPSTrainer(h, sd, device=dev)
            for b in TRAIN_BATCHES:
                raw_a, la, raw_b, lb = raw_step_batch(b, 70 + b, reg)
                img = (A.recrop_normalize_batch(*raw_a, device=dev)[..., None],
                       torch.from_numpy(la).to(dev),
                       A.recrop_normalize_batch(*raw_b, device=dev)[..., None],
                       torch.from_numpy(lb).to(dev))
                # the raw step once more with its inputs already on the
                # card: no host-to-device copy (nor the stream
                # synchronization a copy from pageable memory makes) in
                # the step
                on_card = [tuple(torch.from_numpy(np.ascontiguousarray(a))
                                 .to(dev) for a in raw) for raw in
                           (raw_a, raw_b)]
                timed = timed_in_turns(torch, (
                    ("pretrain_update_raw", lambda: trainer.
                     pretrain_update_raw(raw_a, la, raw_b, lb,
                                         with_viz=False)),
                    ("pretrain_update", lambda: trainer.pretrain_update(
                        *img, with_viz=False)),
                    ("pretrain_update_raw on card", lambda: trainer.
                     pretrain_update_raw(on_card[0], img[1], on_card[1],
                                         img[3], with_viz=False))),
                    6, NORM_SYMBOL)
                for update, row in timed.items():
                    rows.append({"update": update, "dtype": dtype,
                                 "batch": b, **row})
                    log(f"{update} {dtype} B={b}: {row['ms']:.2f} ms/step "
                        f"(runs {row['ms_runs'][0]:.2f}, "
                        f"{row['ms_runs'][1]:.2f}), device "
                        f"{row['device_ms']:.2f} ms, idle "
                        f"{row['device_idle_share']:.2f}, "
                        f"{row['kernels_per_call']:.0f} kernels")
            del trainer
        trainer = LSPSTrainer(hyp, sd, device=dev)
        pb = hyp["batch_size_pose"]
        poses = torch.from_numpy(np.random.RandomState(31).uniform(
            -0.3, 0.3, (VAE_SCAN_K, pb, reg)).astype(np.float32)).to(dev)
        timed = timed_in_turns(torch, (
            ("vae_scan", lambda: trainer.vae_scan(poses)),
            ("vae_update x8", lambda: [trainer.vae_update(poses[i])
                                       for i in range(VAE_SCAN_K)])), 10)
        for update, row in timed.items():
            rows.append({"update": update, "dtype": "float32", "batch": pb,
                         "steps": VAE_SCAN_K, **row})
            log(f"{update} K={VAE_SCAN_K} B={pb}: {row['ms']:.2f} ms per "
                f"{VAE_SCAN_K} steps (runs {row['ms_runs'][0]:.2f}, "
                f"{row['ms_runs'][1]:.2f}), device {row['device_ms']:.2f} "
                f"ms, {row['kernels_per_call']:.0f} kernels")
    return rows


# ---------------------------------------------------------------------------
# the training CLIs, driven in process through their main(argv)
# ---------------------------------------------------------------------------

# exps/synth_full.yaml (the nnyu widths on the synthetic hand data) as the
# CLI phase runs it; the cuts, each from the file's value:
CLI_CUTS = {
    # rendering a 640 x 480 frame costs tens of ms on the host
    "n_frames": {"train_a": 64, "train_b": 64, "test_b": 32},  # 384/384/32
    # cadences short enough that each fires within a run
    "display": 5,                     # 100
    "image_display_iterations": 5,    # 500
    "image_save_iterations": 10,      # 1000 (pose eval every 10x: 100)
    # 5000 (VAE snapshot every 4x: 160); one snapshot per depth run: a
    # save of the nnyu nets and optimizers costs ~40 s of compressed npz
    "snapshot_save_iterations": 40,
}
CLI_POSE_ITERS = 160   # an eval at 100, the VAE snapshot at 160
CLI_DEPTH_ITERS = 40   # strips every 5 and 10, the snapshot at 40
CLI_BATCH = 8
CONV_ITERS = 2001      # docs/BENCHMARKS.md: 11.4 -> 2.2 mm
CONV_MAX_MM = 4.4      # twice the JAX package's 2.2 mm
CONV_MIN_DROP = 3.0    # last eval at most a third of the first
STEP_METHODS = ("vae_update", "vae_scan", "pretrain_update",
                "pretrain_update_raw", "pretrain_scan", "post_update",
                "post_update_raw", "post_scan", "gen_update",
                "gen_update_raw")


def cli_config(root, tmp):
    """A copy of exps/synth_full.yaml with the cuts of ``CLI_CUTS``."""
    import yaml

    doc = yaml.safe_load((root / "exps" / "synth_full.yaml").read_text())
    train = doc["train"]
    for k, v in CLI_CUTS.items():
        if k != "n_frames":
            train[k] = v
    for name, n in CLI_CUTS["n_frames"].items():
        train["datasets"][name]["n_frames"] = n
    path = tmp / "synth_full_cli.yaml"
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def run_cli(torch, module, argv, augment=None):
    """``module.main(argv)`` in process, with the norm kernels' launch
    counts set to 0 just before and read just after.  Returns the run's
    record: its stdout, the trainer it built, the seconds spent building
    the datasets, the wall seconds, the iterations its update calls
    covered, the host-clock ms per iteration from the end of its first
    update call to the end of its last, and the launches."""
    import io

    from lsps_tpu_torch.cli import common as C
    from lsps_tpu_torch.ops.kernels import norm_act as N

    rec = {"ends": [], "steps": [], "trainers": [], "depth": 0}
    make_trainer, make_datasets = C.make_trainer, C.make_datasets

    def stamped(fn, name):
        # a scan and a raw step call the single steps through the
        # instance: only the outermost call is the loop's
        def call(*args, **kw):
            rec["depth"] += 1
            try:
                out = fn(*args, **kw)
            finally:
                rec["depth"] -= 1
            if rec["depth"] == 0:
                # a scan's steps: the leading axis of its labels
                k = (len(args[0] if name == "vae_scan" else args[1])
                     if name.endswith("scan") else 1)
                rec["steps"].append(k)
                rec["ends"].append(time.perf_counter())
            return out
        return call

    def timed_trainer(*args, **kw):
        trainer = make_trainer(*args, **kw)
        for name in STEP_METHODS:
            setattr(trainer, name, stamped(getattr(trainer, name),
                                           name))
        rec["trainers"].append(trainer)
        return trainer

    def timed_datasets(*args, **kw):
        t0 = time.perf_counter()
        out = make_datasets(*args, **kw)
        rec["datasets_s"] = rec.get("datasets_s", 0.0) + (
            time.perf_counter() - t0)
        return out

    buf = io.StringIO()
    zero_norm_launches(N)
    t0 = time.perf_counter()
    try:
        with unittest.mock.patch.object(C, "make_trainer", timed_trainer), \
                unittest.mock.patch.object(C, "make_datasets",
                                           timed_datasets), \
                unittest.mock.patch.dict(os.environ), \
                contextlib.redirect_stdout(buf):
            os.environ.pop("LSPS_AUGMENT", None)
            if augment is not None:
                os.environ["LSPS_AUGMENT"] = augment
            module.main(argv)
    except BaseException:
        log("\n".join(buf.getvalue().splitlines()[-40:]))
        raise
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = norm_launches(N)
    rec["stdout"] = buf.getvalue()
    rec["iterations"] = sum(rec["steps"])
    rec["loop_ms_per_iter"] = (
        (rec["ends"][-1] - rec["ends"][0]) * 1e3
        / max(1, rec["iterations"] - rec["steps"][0]))
    # per call after the first: the gap to the call before over its steps
    # (a call after cadence work, such as an eval or a snapshot, pays it)
    gaps = [(b - a) * 1e3 / k for a, b, k in zip(
        rec["ends"], rec["ends"][1:], rec["steps"][1:])]
    rec["median_ms_per_iter"] = float(np.median(gaps)) if gaps else None
    rec["trainer"] = rec["trainers"][-1]
    return rec


def stdout_errors(text, pattern):
    import re

    return [float(m) for m in re.findall(pattern, text)]


def check_files(directory, names, what):
    missing = [n for n in names if not (directory / n).is_file()]
    if missing:
        raise AssertionError(f"{what}: missing {missing} in {directory}")


def same_tensors(torch, xs, ys):
    xs, ys = list(xs), list(ys)
    return len(xs) == len(ys) and all(torch.equal(x.cpu(), y.cpu())
                                      for x, y in zip(xs, ys))


def fresh_port_trainer(torch, dev, config_path):
    from lsps_tpu_torch.config import NetConfig
    from lsps_tpu_torch.train import LSPSTrainer
    from lsps_tpu_torch.train.trainer import fresh_state_dict

    hyp = NetConfig(config_path).hyperparameters
    return LSPSTrainer(hyp, fresh_state_dict(hyp, 99), device=dev)


def device_flag(dev):
    """``--device`` of the CLIs for ``dev``: ``cpu`` or the CUDA index."""
    return "cpu" if dev.type == "cpu" else str(dev.index or 0)


def bare_step(raw_rows, update, dtype, batch, steps=1):
    row = next((r for r in raw_rows if r["update"] == update
                and r["dtype"] == dtype and r["batch"] == batch), None)
    return None if row is None else row["ms"] / steps


def phase_cli(torch, dev, raw_rows):
    """The training CLIs at the nnyu widths on ``exps/synth_full.yaml`` cut
    as ``CLI_CUTS`` says, in process: pose_train (default scan of 8),
    depth_train pretrain on the step, jax and jax + bf16 augment paths,
    estimate3 from the pretrain and VAE snapshots; then the pose
    convergence of ``exps/synth.yaml``.  Each run must finish, write its
    files, launch the norm kernels as its updates give them, and leave
    snapshots a fresh trainer resumes bit for bit.  Returns (the runs'
    rows, the phase's directory, the cut config, the prefix of the step
    pretrain's snapshots and the VAE), which the serving phases read and
    ``main`` removes."""
    import shutil

    from lsps_tpu_torch.cli import depth_train, pose_train

    root = Path(__file__).resolve().parent
    tmp = root / "build" / "smoke_cli"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cfg = cli_config(root, tmp)
    from lsps_tpu_torch.config import NetConfig

    cli_hyp = NetConfig(cfg).hyperparameters
    joint, one_way = in_act_counts(cli_hyp["gen"])
    pose_batch = cli_hyp["batch_size_pose"]
    pre_fwd, pre_bwd = 2 * joint + 2 * one_way, joint + 2 * one_way
    rows = []

    def common(name, prefix):
        return ["--config", cfg, "--device", device_flag(dev),
                "--log", str(tmp / "logs" / name),
                "--snapshot-prefix", str(prefix)]

    def report(name, rec, bare_ms, bare_what, errors=()):
        n = rec["iterations"]
        per_it = {k: v / n for k, v in rec["launches"].items()}
        row = {"run": name, "iterations": n,
               "datasets_s": rec["datasets_s"], "wall_s": rec["wall_s"],
               "loop_ms_per_iter": rec["loop_ms_per_iter"],
               "median_ms_per_iter": rec["median_ms_per_iter"],
               "bare_step_ms": bare_ms, "bare_step": bare_what,
               "launches": rec["launches"],
               "launches_per_iter": per_it, "eval_mm": list(errors)}
        rows.append(row)
        bare = "not timed" if bare_ms is None else f"{bare_ms:.2f} ms"
        log(f"cli {name}: datasets {rec['datasets_s']:.2f} s, {n} "
            f"iterations, {rec['loop_ms_per_iter']:.2f} ms/iteration over "
            f"the loop, median {rec['median_ms_per_iter']:.2f} (bare step "
            f"{bare}: {bare_what}), "
            f"wall {rec['wall_s']:.1f} s; launches per iteration "
            f"{json.dumps({k: round(v, 3) for k, v in per_it.items()})}; "
            f"eval mm {[round(e, 4) for e in errors]}")
        return row

    def check_pretrain_launches(name, rec):
        n = rec["iterations"]
        got = rec["launches"]
        if got["in_act_forward"] < pre_fwd * n or \
                got["in_act_backward"] < pre_bwd * n:
            raise AssertionError(f"cli {name}: launches {got} over {n} "
                                 f"iterations, want >= {pre_fwd} / "
                                 f"{pre_bwd} per iteration")

    def check_resume(name, rec, prefix, it, est=False):
        fresh = fresh_port_trainer(torch, dev, cfg)
        got = fresh.resume(str(prefix), load_opt=not est, est=est)
        t = rec["trainer"]
        nets = ("gen", "dis") if est else ("gen", "dis", "map")
        if got != it or not all(same_tensors(
                torch, t.nets[k].parameters(), fresh.nets[k].parameters())
                for k in nets):
            raise AssertionError(f"cli {name}: a fresh trainer resumed "
                                 f"iteration {got}, not the run's {it} "
                                 "parameters")
        if not est and not all(
                same_tensors(torch, a.mu + a.nu, b.mu + b.nu)
                for a, b in ((t.gen_opt, fresh.gen_opt),
                             (t.dis_opt, fresh.dis_opt))):
            raise AssertionError(f"cli {name}: resumed optimizers differ")

    # 1. pose_train, default scan of 8; its VAE snapshot feeds estimate3
    run_a = tmp / "a"
    rec = run_cli(torch, pose_train, common("pose", run_a / "pre") + [
        "--frac", "0.5", "--max-iterations", str(CLI_POSE_ITERS)])
    errs = stdout_errors(rec["stdout"], r"Mean error: ([0-9.eE+-]+)mm")
    if not errs or not all(math.isfinite(e) for e in errs):
        raise AssertionError(f"cli pose: eval errors {errs}")
    check_files(run_a, ["pre_vae_2.50_00000160.npz", "index.html",
                        "images/_test.png"], "cli pose")
    fresh = fresh_port_trainer(torch, dev, cfg)
    if not fresh.load_vae(str(run_a / "pre"), 2.5) or not same_tensors(
            torch, fresh.vae.parameters(), rec["trainer"].vae.parameters()):
        raise AssertionError("cli pose: the VAE snapshot does not load to "
                             "the run's VAE")
    if any(rec["launches"].values()):
        raise AssertionError(f"cli pose: norm launches {rec['launches']}")
    report("pose_train --frac 0.5", rec,
           bare_step(raw_rows, "vae_scan", "float32", pose_batch,
                     VAE_SCAN_K),
           f"vae_scan K={VAE_SCAN_K} per step at batch {pose_batch}; the "
           "CLI steps on 2x that (frac > 0)",
           errs)

    # 2-3. depth_train pretrain on the three augment paths
    pre_files = [f"pre_{n}_{CLI_DEPTH_ITERS:08d}.npz" for n in
                 ("gen", "dis", "map", "optg", "optd")]
    pre_files += ["index.html", "images/gen.png"] + [
        f"images/gen_{it:08d}.png" for it in (10, 20, 30, 40)]
    for name, run_dir, augment, extra, bare in (
            ("pretrain step", run_a, "step", [],
             ("pretrain_update_raw", "float32")),
            ("pretrain jax", tmp / "b", "jax", [],
             ("pretrain_update", "float32")),
            ("pretrain jax bf16", tmp / "c", "jax", ["--bf16"],
             ("pretrain_update", "bfloat16"))):
        rec = run_cli(torch, depth_train, common(name.replace(" ", "_"),
                                                 run_dir / "pre") + [
            "--mode", "pretrain", "--batch-size", str(CLI_BATCH),
            "--max-iterations", str(CLI_DEPTH_ITERS)] + extra,
            augment=augment)
        fused = "fused into the training step" in rec["stdout"]
        if fused != (augment == "step"):
            raise AssertionError(f"cli {name}: in-step augment {fused}")
        check_files(run_dir, pre_files, f"cli {name}")
        check_pretrain_launches(name, rec)
        check_resume(name, rec, run_dir / "pre", CLI_DEPTH_ITERS)
        report(name, rec, bare_step(raw_rows, *bare, CLI_BATCH),
               f"{bare[0]} {bare[1]} batch {CLI_BATCH}")

    # 4. estimate3 from the step pretrain's snapshots and the VAE
    rec = run_cli(torch, depth_train, common("estimate3", run_a / "pre") + [
        "--mode", "estimate3", "--frac", "0.5", "--batch-size",
        str(CLI_BATCH), "--max-iterations", str(CLI_DEPTH_ITERS)],
        augment="step")
    out = rec["stdout"]
    if "Loading pretrained VAE parameters" not in out or \
            f"Resume from iteration {CLI_DEPTH_ITERS}" not in out:
        raise AssertionError("cli estimate3: did not load the pretrain "
                             "and VAE snapshots")
    errs = stdout_errors(out, r"Mean err: ([0-9.eE+-]+) ")
    if len(errs) != CLI_DEPTH_ITERS // CLI_CUTS["image_save_iterations"] \
            or not all(math.isfinite(e) for e in errs):
        raise AssertionError(f"cli estimate3: Mean err {errs}")
    check_files(run_a, [f"pre_est_{n}_{CLI_DEPTH_ITERS:08d}.npz" for n in
                        ("gen", "dis", "map", "optg", "optd")]
                + ["images/gen.avi", "images/_test.png", "images/_test3d.png"],
                "cli estimate3")
    # the first test frame's point cloud and skeletons (plotResult3D):
    # written, read back whole, and no failure caught on the way
    from lsps_tpu_torch.data.png import read_png

    plot3d = read_png(str(run_a / "images" / "_test3d.png"))
    if "3D plot skipped" in out or plot3d.shape != (600, 600, 3) or \
            (plot3d == 255).all():
        raise AssertionError(f"cli estimate3: _test3d.png {plot3d.shape}, "
                             f"skipped: {'3D plot skipped' in out}")
    n = rec["iterations"]
    if rec["launches"]["in_act_forward"] != joint * n or \
            rec["launches"]["in_act_backward"] != 0:
        raise AssertionError(f"cli estimate3: launches {rec['launches']} "
                             f"over {n} iterations, want {joint} forward "
                             "(the generator's no-grad pass) and no "
                             "backward per iteration")
    check_resume("estimate3", rec, run_a / "pre", CLI_DEPTH_ITERS, est=True)
    report("estimate3 --frac 0.5", rec, None,
           "no timing phase of post_update", errs)

    # 5. convergence: pose_train on exps/synth.yaml, as recorded for the
    # JAX package in docs/BENCHMARKS.md
    rec = run_cli(torch, pose_train, [
        "--config", str(root / "exps" / "synth.yaml"),
        "--device", device_flag(dev),
        "--log", str(tmp / "logs" / "conv"),
        "--snapshot-prefix", str(tmp / "conv" / "pre"),
        "--max-iterations", str(CONV_ITERS)])
    errs = stdout_errors(rec["stdout"], r"Mean error: ([0-9.eE+-]+)mm")
    if len(errs) < 2 or not errs[-1] <= errs[0] / CONV_MIN_DROP or \
            not errs[-1] <= CONV_MAX_MM:
        raise AssertionError(f"cli convergence: evals {errs}, want the "
                             f"last <= first / {CONV_MIN_DROP} and <= "
                             f"{CONV_MAX_MM} mm")
    report("pose_train exps/synth.yaml convergence", rec,
           None, "no timing phase at synth.yaml widths", errs)
    return rows, tmp, cfg, run_a / "pre"


# ---------------------------------------------------------------------------
# the real-data path: PNG mini-datasets, the importers and their cache, the
# four datasets, and the host / native / step augments through the CLIs
# ---------------------------------------------------------------------------

REAL_FRAMES = {"nyu_train": 64, "nyu_test": 32, "icvl_train": 64,
               "icvl_test": 8}
REAL_CUTS = {
    "sample_poses": 4096,                 # 250000 (pose_train's draws)
    "display": 1,                         # 10
    "image_display_iterations": 3,        # 100
    "image_save_iterations": 3,           # 2500: estimate3 evals test_b
                                          # at 3 and 6, pose_train at 30
    "snapshot_save_iterations": 10 ** 6,  # 25000: no snapshot (~46 s each)
}
REAL_PRETRAIN_ITERS = 6
REAL_ICVL_ITERS = 2
REAL_EST_ITERS = 6
REAL_POSE_ITERS = 30
REAL_LOADER_BATCHES = 6
REAL_LABEL_TOL = 1e-4     # tests/test_fast_augment.py: labels, host vs native
REAL_FLIP_SHARE = 1e-3    # its bound on the pixels two backends may pick
                          # differently (nearest-neighbour tie flips)


def png_bytes(arr):
    """A PNG of an (H, W) uint16 or (H, W, 3) uint8 array, written with
    zlib and struct, the five filter types cycling row by row."""
    import struct
    import zlib

    h, w = arr.shape[:2]
    depth = 16 if arr.dtype == np.uint16 else 8
    color = 0 if arr.ndim == 2 else 2
    x = (arr.astype(">u2").view(np.uint8) if depth == 16
         else arr.astype(np.uint8)).reshape(h, -1).astype(np.int16)
    bpp = (1 if arr.ndim == 2 else arr.shape[2]) * depth // 8
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    rows = np.empty((h, x.shape[1] + 1), np.uint8)
    for kind in range(5):       # rows kind, kind + 5, ...: filter `kind`
        xs, b = x[kind::5], up[kind::5]
        a, c = np.zeros_like(xs), np.zeros_like(b)
        a[:, bpp:], c[:, bpp:] = xs[:, :-bpp], b[:, :-bpp]
        if kind == 4:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        else:
            pred = (0, a, b, (a + b) >> 1)[kind]
        rows[kind::5, 0] = kind
        rows[kind::5, 1:] = (xs - pred) & 0xFF

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def write_real_datasets(base, seed=0):
    """An NYU and an ICVL mini-dataset in the real layouts and camera
    shapes, the hands rendered by the port's ``render_hand_depth``: NYU
    ``train/`` (depth_1_* and synthdepth_1_*) and ``test/`` 640 x 480 RGB
    frames packing ``(G << 8) | B``, each with ``joint_data.mat``; ICVL
    ``Depth/sequence0/`` 320 x 240 16-bit frames with ``train.txt``,
    ``test_seq_1.txt`` and ``test_seq_2.txt``.  Returns the two roots."""
    import scipy.io

    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.data.synthetic import render_hand_depth

    rs = np.random.RandomState(seed)
    nyu, icvl = base / "nyu", base / "icvl"
    cam = Camera.nyu()

    def nyu_png(path, dpt):
        d = dpt.astype(np.int32)
        path.write_bytes(png_bytes(np.stack(
            [np.zeros_like(d, np.uint8), (d >> 8).astype(np.uint8),
             (d & 0xFF).astype(np.uint8)], -1)))

    for sub, n in (("train", REAL_FRAMES["nyu_train"]),
                   ("test", REAL_FRAMES["nyu_test"])):
        (nyu / sub).mkdir(parents=True)
        uvd, xyz = np.zeros((n, 36, 3)), np.zeros((n, 36, 3))
        for i in range(n):
            com3d = np.array([rs.uniform(-80, 80), rs.uniform(-60, 60),
                              rs.uniform(650, 900)], np.float32)
            dpt, joints3d = render_hand_depth(cam, com3d, 36, rs)
            uvd[i] = cam.to_img(joints3d)
            xyz[i] = cam.img_to_3d(uvd[i])
            nyu_png(nyu / sub / f"depth_1_{i + 1:07d}.png", dpt)
            if sub == "train":  # the synthetic domain: the same frames
                nyu_png(nyu / sub / f"synthdepth_1_{i + 1:07d}.png", dpt)
        scipy.io.savemat(nyu / sub / "joint_data.mat",
                         {"joint_xyz": [xyz], "joint_uvd": [uvd]})
    cam = Camera.icvl()
    (icvl / "Depth" / "sequence0").mkdir(parents=True)
    for name, n in (("train", REAL_FRAMES["icvl_train"]),
                    ("test_seq_1", REAL_FRAMES["icvl_test"]),
                    ("test_seq_2", REAL_FRAMES["icvl_test"])):
        lines = []
        for i in range(n):
            com3d = np.array([rs.uniform(-60, 60), rs.uniform(-40, 40),
                              rs.uniform(350, 500)], np.float32)
            dpt, joints3d = render_hand_depth(cam, com3d, 16, rs)
            fname = f"sequence0/{name}_{i}.png"
            (icvl / "Depth" / fname).write_bytes(
                png_bytes(dpt.astype(np.uint16)))
            lines.append(fname + " " + " ".join(
                f"{v:.3f}" for v in cam.to_img(joints3d).reshape(-1)))
        (icvl / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return nyu, icvl


def real_config(root, tmp, name, nyu, icvl, cache):
    """``exps/<name>.yaml`` with its roots at the mini-datasets, its caches
    in ``cache`` and the cuts of ``REAL_CUTS``; widths and batch sizes as
    the file has them."""
    import yaml

    doc = yaml.safe_load((root / "exps" / f"{name}.yaml").read_text())
    train = doc["train"]
    for k, v in REAL_CUTS.items():
        if k != "sample_poses":
            train[k] = v
    for spec in train["datasets"].values():
        spec["root"] = str(icvl if "ICVL" in spec["class_name"] else nyu)
        spec["cacheDir"] = str(cache)
        if spec.get("sample_poses"):
            spec["sample_poses"] = REAL_CUTS["sample_poses"]
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def same_sequence(a, b):
    return (len(a) == len(b) and np.array_equal(a.dpt_mm(), b.dpt_mm())
            and all(np.array_equal(getattr(a, k), getattr(b, k)) for k in
                    ("gtorig", "gtcrop", "M", "gt3Dorig", "gt3Dcrop",
                     "com"))
            and a.file_names == b.file_names)


def phase_realdata(torch, dev, raw_rows):
    """The real-data path at ``exps/nnyu.yaml`` width: mini-datasets
    written as PNGs, each split imported fresh and again from its cache
    (held equal; decode and import frames/s), each augment backend's
    loader ms per batch, ``depth_train --mode pretrain`` under ``host``,
    ``native`` and ``step``, ``--mode estimate3`` under ``host`` with its
    test_b evaluation, ``pose_train`` on the NYU split and
    ``exps/nicvl.yaml`` pretrain under ``host`` (the norm kernels' launch
    counts per iteration asserted), and ``host`` held against ``native``
    over one epoch.  Returns (rows, the runs' launches by path, the
    phase's directory and its ``exps/nnyu.yaml`` copy, which the tools
    phase reads and ``main`` removes)."""
    import shutil

    from lsps_tpu_torch import native
    from lsps_tpu_torch.cli import depth_train, pose_train
    from lsps_tpu_torch.config import NetConfig
    from lsps_tpu_torch.data.fast_augment import FastAugmenter
    from lsps_tpu_torch.data.importers import ICVLImporter, NYUImporter
    from lsps_tpu_torch.data.loader import get_data_loader, get_dataset
    from lsps_tpu_torch.data.png import read_png

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    tmp = root / "build" / "smoke_realdata"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cache = tmp / "cache"
    t0 = time.perf_counter()
    nyu, icvl = write_real_datasets(tmp)
    rows = {"write_s": time.perf_counter() - t0}
    native_s = time.perf_counter()
    native.get_lib()    # no fallback: a failed build fails the run
    rows["native_build_s"] = time.perf_counter() - native_s
    rows["native_flags"] = " ".join(native.BUILT_FLAGS.get(
        native.library_path(), ("(built before)",)))

    # decode, then import each split fresh and from its cache
    frames = sorted((nyu / "test").glob("depth_1_*.png")) + sorted(
        (icvl / "Depth" / "sequence0").glob("test_seq_*.png"))
    t0 = time.perf_counter()
    for f in frames:
        read_png(f)
    rows["decode_frames_per_s"] = len(frames) / (time.perf_counter() - t0)
    splits = {
        "NYU train": lambda: NYUImporter(
            str(nyu), cache_dir=str(cache), all_joints=True).load_sequence(
                "train"),
        "NYU train_synth": lambda: NYUImporter(
            str(nyu), cache_dir=str(cache), all_joints=True).load_sequence(
                "train_synth"),
        "NYU test": lambda: NYUImporter(
            str(nyu), cache_dir=str(cache), all_joints=True).load_sequence(
                "test"),
        "ICVL train": lambda: ICVLImporter(
            str(icvl), cache_dir=str(cache)).load_sequence("train",
                                                           sub_seq=["0"]),
        "ICVL test_seq_1": lambda: ICVLImporter(
            str(icvl), cache_dir=str(cache)).load_sequence("test_seq_1"),
        "ICVL test_seq_2": lambda: ICVLImporter(
            str(icvl), cache_dir=str(cache)).load_sequence("test_seq_2"),
    }
    imports = {}
    for name, load in splits.items():
        t0 = time.perf_counter()
        fresh = load()
        t1 = time.perf_counter()
        again = load()
        t2 = time.perf_counter()
        if not same_sequence(fresh, again) or not len(fresh):
            raise AssertionError(f"realdata {name}: the cached import "
                                 "differs from the fresh one")
        imports[name] = {"frames": len(fresh),
                         "import_frames_per_s": len(fresh) / (t1 - t0),
                         "cached_frames_per_s": len(fresh) / (t2 - t1)}
    rows["imports"] = imports

    cfg = real_config(root, tmp, "nnyu", nyu, icvl, cache)
    hyp = NetConfig(cfg).hyperparameters
    batch = hyp["batch_size"]
    joint, one_way = in_act_counts(hyp["gen"])
    pre_fwd, pre_bwd = 2 * joint + 2 * one_way, joint + 2 * one_way
    train_b = NetConfig(cfg).datasets["train_b"]

    # each backend's loader alone: ms per batch of the producer
    loaders = {}
    for backend in ("host", "native", "step"):
        with unittest.mock.patch.dict(os.environ, {"LSPS_AUGMENT": backend}):
            ds = get_dataset(train_b)
            lp = get_data_loader(ds, batch, shuffle=True, seed=1,
                                 device=dev)
            got = 0
            t0 = time.perf_counter()
            while got < REAL_LOADER_BATCHES:
                for _ in lp:
                    got += 1
                    if got == REAL_LOADER_BATCHES:
                        break
            loaders[backend] = (time.perf_counter() - t0) * 1e3 / got
    rows["loader_ms_per_batch"] = loaders

    # host against native over one epoch, from the same draws
    ds_h, ds_n = get_dataset(train_b), get_dataset(train_b)
    idx = list(range(len(ds_h)))
    host = [ds_h[i] for i in idx]
    imgs_n, labels_n = FastAugmenter(ds_n, "native").batch(idx)[:2]
    d = np.stack([h[0] for h in host]) - imgs_n
    flips = d != 0
    label_gap = float(np.abs(np.stack([h[1] for h in host])
                             - labels_n).max())
    rows["host_vs_native"] = {
        "samples": len(idx), "pixels_differing": float(flips.mean()),
        "median_flip": float(np.median(np.abs(d[flips])))
        if flips.any() else None, "label_max_abs": label_gap}
    if flips.mean() >= REAL_FLIP_SHARE or label_gap > REAL_LABEL_TOL:
        raise AssertionError(f"realdata host vs native: "
                             f"{rows['host_vs_native']}")

    # the CLIs
    runs, launches_by_path = [], {}

    def argv(config, name, *extra):
        return ["--config", config, "--device", device_flag(dev),
                "--log", str(tmp / "logs" / name), "--snapshot-prefix",
                str(tmp / name / "pre"), *extra]

    def record(name, rec, bare_ms=None, errors=()):
        n = rec["iterations"]
        row = {"run": name, "iterations": n,
               "datasets_s": rec["datasets_s"], "wall_s": rec["wall_s"],
               "median_ms_per_iter": rec["median_ms_per_iter"],
               "bare_step_ms": bare_ms,
               "launches_per_iter": {k: v / n for k, v in
                                     rec["launches"].items()},
               "eval_mm": list(errors)}
        runs.append(row)
        launches_by_path[f"realdata {name} ({n} iterations)"] = \
            rec["launches"]
        log(f"realdata {name}: datasets {rec['datasets_s']:.2f} s, {n} "
            f"iterations, median {row['median_ms_per_iter']} ms/iteration "
            f"(bare step {bare_ms}), wall {rec['wall_s']:.1f} s, launches "
            f"per iteration {json.dumps(row['launches_per_iter'])}, eval mm "
            f"{row['eval_mm']}")

    def check_pretrain(name, rec):
        n, got = rec["iterations"], rec["launches"]
        if n == 0 or got["in_act_forward"] != pre_fwd * n or \
                got["in_act_backward"] != pre_bwd * n:
            raise AssertionError(f"realdata {name}: launches {got} over {n} "
                                 f"iterations, want {pre_fwd} / {pre_bwd} "
                                 "per iteration")

    rec = run_cli(torch, pose_train, argv(cfg, "pose", "--max-iterations",
                                          str(REAL_POSE_ITERS)))
    errs = stdout_errors(rec["stdout"], r"Mean error: ([0-9.eE+-]+)mm")
    if not errs or not all(math.isfinite(e) for e in errs):
        raise AssertionError(f"realdata pose_train: eval errors {errs}")
    record("pose_train nnyu", rec, errors=errs)

    for backend, update in (("host", "pretrain_update"),
                            ("native", "pretrain_update"),
                            ("step", "pretrain_update_raw")):
        name = f"pretrain nnyu {backend}"
        rec = run_cli(torch, depth_train, argv(
            cfg, name.replace(" ", "_"), "--mode", "pretrain",
            "--batch-size", str(batch), "--max-iterations",
            str(REAL_PRETRAIN_ITERS)), augment=backend)
        fused = "fused into the training step" in rec["stdout"]
        if fused != (backend == "step"):
            raise AssertionError(f"realdata {name}: in-step augment {fused}")
        check_pretrain(name, rec)
        record(name, rec, bare_step(raw_rows, update, "float32", batch))

    rec = run_cli(torch, depth_train, argv(
        cfg, "estimate3", "--mode", "estimate3", "--idx", "0",
        "--batch-size", str(batch), "--max-iterations",
        str(REAL_EST_ITERS)), augment="host")
    errs = stdout_errors(rec["stdout"], r"Mean err: ([0-9.eE+-]+) ")
    n = rec["iterations"]
    if len(errs) != REAL_EST_ITERS // REAL_CUTS["image_save_iterations"] \
            or not all(math.isfinite(e) for e in errs):
        raise AssertionError(f"realdata estimate3: Mean err {errs}")
    if rec["launches"]["in_act_forward"] != joint * n or \
            rec["launches"]["in_act_backward"] != 0:
        raise AssertionError(f"realdata estimate3: launches "
                             f"{rec['launches']} over {n} iterations, want "
                             f"{joint} forward and no backward per "
                             "iteration")
    record("estimate3 nnyu host", rec, errors=errs)

    icvl_cfg = real_config(root, tmp, "nicvl", nyu, icvl, cache)
    rec = run_cli(torch, depth_train, argv(
        icvl_cfg, "pretrain_nicvl", "--mode", "pretrain", "--batch-size",
        str(batch), "--max-iterations", str(REAL_ICVL_ITERS)),
        augment="host")
    check_pretrain("pretrain nicvl host", rec)
    record("pretrain nicvl host", rec)
    rows["runs"] = runs
    rows["phase_s"] = time.perf_counter() - t_phase
    cuts = dict(REAL_CUTS, iterations={
        "pose_train": f"{REAL_POSE_ITERS} (500000)",
        "pretrain": f"{REAL_PRETRAIN_ITERS} (500000)",
        "estimate3": f"{REAL_EST_ITERS} (500000)",
        "nicvl pretrain": f"{REAL_ICVL_ITERS} (500000)"},
        frames=REAL_FRAMES)
    log(f"realdata phase {rows['phase_s']:.1f} s at exps/nnyu.yaml and "
        f"exps/nicvl.yaml widths, batch {batch} (pose {hyp['batch_size_pose']}"
        f"), cuts {json.dumps(cuts)}; decode "
        f"{rows['decode_frames_per_s']:.1f} frames/s; loader ms per batch "
        f"{json.dumps({k: round(v, 2) for k, v in loaders.items()})}; host "
        f"vs native {json.dumps(rows['host_vs_native'])}")
    return rows, launches_by_path, tmp, cfg


# ---------------------------------------------------------------------------
# host detection and tracking, and the MSRA15 and POST importers
# ---------------------------------------------------------------------------

TRACK_FRAMES = 64
TRACK_SEED = 21
TRACK_ITERS = 5           # refine_com_iterative rounds a frame, as the
                          # reference's live loop runs them
TRACK_PX, TRACK_MM = 2.0, 3.0   # host vs device CoM: the JAX package's own
                                # bound (tests/test_detect_jax.py:47-48)
LIVE_BUDGET_MS = 1000.0 / 30    # one frame of a 30 fps camera
FAR_POINT = 2001.0        # utils.realtime.CAMERAS["kinect"]'s far point
PROFILED_CALLS = 10
MSRA_SUBJECTS, MSRA_GESTURES, MSRA_FRAMES = ("P0", "P3"), ("1", "2"), 8
POST_SYNTH, POST_REAL = 8, 4
POST_LABEL_BGR = (60, 30, 220)  # HSV (175, 220, 220): inside the gate


def track_frames(n, seed):
    """``n`` NYU-camera (480, 640) frames of one hand rendered by the
    port's ``render_hand_depth`` (the same joints in every frame) whose
    CoM moves on a smooth closed path, ~5-7 px a frame, and each frame's
    (36, 3) joints in mm."""
    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.data.synthetic import render_hand_depth

    cam = Camera.nyu()
    frames = np.zeros((n, H, W), np.float32)
    joints = np.zeros((n, 36, 3), np.float32)
    for t in range(n):
        a = 2.0 * np.pi * t / n
        com3d = np.array([70.0 * np.sin(a), 45.0 * np.sin(2.0 * a),
                          780.0 + 60.0 * np.cos(a)], np.float32)
        frames[t], joints[t] = render_hand_depth(
            cam, com3d, 36, np.random.RandomState(seed))[:2]
    return frames, joints


def write_msra(base, seed=5):
    """An MSRA15 mini-tree: ``MSRA_SUBJECTS`` x ``MSRA_GESTURES`` x
    ``MSRA_FRAMES`` 320 x 240 ``.bin`` frames (a 6-int box header, the
    float32 patch inside it) with a ``joint.txt`` each, z negated."""
    import struct

    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.data.synthetic import render_hand_depth

    cam = Camera.msra()
    rs = np.random.RandomState(seed)
    for s in MSRA_SUBJECTS:
        for g in MSRA_GESTURES:
            d = base / s / g
            d.mkdir(parents=True)
            lines = [str(MSRA_FRAMES)]
            for i in range(MSRA_FRAMES):
                com3d = np.array([rs.uniform(-40, 40), rs.uniform(-30, 30),
                                  rs.uniform(300, 420)], np.float32)
                dpt, joints = render_hand_depth(cam, com3d, 21, rs)
                ys, xs = np.nonzero(dpt)
                top, bottom = ys.min(), ys.max() + 1
                left, right = xs.min(), xs.max() + 1
                with open(d / f"{i:06d}_depth.bin", "wb") as f:
                    f.write(struct.pack("6i", dpt.shape[1], dpt.shape[0],
                                        left, top, right, bottom))
                    dpt[top:bottom, left:right].tofile(f)
                joints = joints * np.float32([1, 1, -1])
                lines.append(" ".join(f"{v:.4f}" for v in joints.ravel()))
            (d / "joint.txt").write_text("\n".join(lines) + "\n")
    return base


def write_post(base, seed=6):
    """A POST mini-tree under ``base/dmaps`` and ``base/lmaps``:
    ``POST_SYNTH`` synthetic 640 x 480 16-bit depth maps (invalid 10000)
    with 18 part blobs and their 16-bit label maps, and ``POST_REAL`` real
    frames (depth x 5) with an RGB label image painted ``POST_LABEL_BGR``
    over the subject; written with ``png_bytes``."""
    from lsps_tpu_torch.data.importers import POSTImporter

    rs = np.random.RandomState(seed)
    for kind in ("dmaps", "lmaps"):
        for seq in ("synth0", "test0"):
            (base / kind / seq).mkdir(parents=True)
    for i in range(POST_SYNTH):
        dpt = np.full((H, W), 10000, np.uint16)
        lbl = np.zeros((H, W), np.uint16)
        for j, pid in enumerate(POSTImporter.LBL_IDS):
            r0 = 140 + (j // 6) * 60 + rs.randint(-8, 9)
            c0 = 200 + (j % 6) * 40 + rs.randint(-5, 6)
            dpt[r0:r0 + 30, c0:c0 + 30] = rs.randint(1900, 2300, (30, 30))
            lbl[r0:r0 + 30, c0:c0 + 30] = pid
        (base / "dmaps" / "synth0" / f"img_d_{i:04d}.png").write_bytes(
            png_bytes(dpt))
        (base / "lmaps" / "synth0" / f"img_l_{i:04d}.png").write_bytes(
            png_bytes(lbl))
    for i in range(POST_REAL):
        dpt = np.zeros((H, W), np.uint16)
        r0, c0 = 90 + 10 * i, 260 + 15 * i
        dpt[r0:r0 + 110, c0:c0 + 90] = rs.randint(1800, 2300,
                                                   (110, 90)) * 5
        dpt[400:] = 2500 * 5                          # a floor, removed
        rgb = np.zeros((H, W, 3), np.uint8)
        rgb[r0:r0 + 110, c0:c0 + 90] = POST_LABEL_BGR[::-1]
        (base / "dmaps" / "test0" / f"img_{i:04d}.png").write_bytes(
            png_bytes(dpt))
        (base / "lmaps" / "test0" / f"img_{i:04d}.png").write_bytes(
            png_bytes(rgb))
    return base / "dmaps"


def import_twice(make, seq):
    """Import ``seq`` fresh (writing its cache), then from the cache; the
    two held equal.  Returns (arrays, fresh frames/s, cached frames/s)."""
    t0 = time.perf_counter()
    fresh = make().load_sequence(seq)
    t1 = time.perf_counter()
    cached = make().load_sequence(seq)
    t2 = time.perf_counter()
    if not same_sequence(fresh, cached):
        raise AssertionError(f"import {seq}: the cached sequence differs "
                             f"from the fresh one")
    return fresh, len(fresh) / (t1 - t0), len(cached) / (t2 - t1)


def phase_track(torch, dev, hyp, sd):
    """A live depth sequence detected once and tracked on the host, each
    frame estimated on the card: ``HandDetector.detect`` (hand size on) on
    every frame, ``refine_com_iterative`` from the previous CoM, a
    ``Frame`` per frame, ``predict_frames`` at batch 1 per frame and once
    at batch 64; host CoMs against the device detector (``predict_raw``),
    joints against the CPU, one crop launch per call.  Then the MSRA15 and
    POST importers on mini-trees, fresh and cached, and MSRA15's raw
    frames through ``predict_frames`` against the CPU.  Returns (row, crop
    launches by path)."""
    import shutil

    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.data.detector import HandDetector
    from lsps_tpu_torch.data.importers import MSRA15Importer, POSTImporter
    from lsps_tpu_torch.ops.kernels import warp as WK
    from lsps_tpu_torch.serve.inference import PoseEstimator
    from lsps_tpu_torch.utils.realtime import Frame

    t_phase = time.perf_counter()
    cam, n = Camera.nyu(), TRACK_FRAMES
    cube = (CUBE_MM,) * 3
    cubes = np.full((n, 3), CUBE_MM, np.float32)
    frames, gt_joints = track_frames(n, TRACK_SEED)
    row = {"frames": n, "render_s": time.perf_counter() - t_phase}

    # the host detector on every frame; frame 0's CoM starts the track
    t0 = time.perf_counter()
    found = [HandDetector(f, cam.fx, cam.fy).detect(size=cube)
             for f in frames]
    row["detect_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / n
    detected = np.stack([c for c, _ in found])
    row["hand_size_mm"] = float(found[0][1][0])
    if not (detected[:, 2] > 0).all():
        raise AssertionError("track: the host detector missed a hand")

    launches = {}
    with tf32_off(torch):
        est = PoseEstimator(hyp, sd, device=dev)
        est.predict_frames(frames[:1], detected[:1], cubes[:1])  # warm-up
        torch.cuda.synchronize()
        # the live loop: track on the host, estimate on the card
        WK.crop_normalize.launches = 0
        tracked, live, loop_ms, refine_ms = [detected[0]], [], [], []
        for i in range(n):
            t0 = time.perf_counter()
            if i:
                hd = HandDetector(frames[i], cam.fx, cam.fy)
                tracked.append(hd.refine_com_iterative(tracked[-1],
                                                       TRACK_ITERS, cube))
            t1 = time.perf_counter()
            live.append(est.predict_frames(
                frames[i:i + 1], tracked[-1][None].astype(np.float32),
                cubes[:1]).cpu())
            t2 = time.perf_counter()
            refine_ms.append((t1 - t0) * 1e3)
            loop_ms.append((t2 - t0) * 1e3)
        launches["tracking loop (batch 1 per frame)"] = \
            WK.crop_normalize.launches
        tracked = np.stack(tracked)
        live = torch.cat(live)
        row["refine_ms_per_frame"] = float(np.mean(refine_ms[1:]))
        row["live_ms_per_frame"] = {
            "median": float(np.median(loop_ms)),
            "mean": float(np.mean(loop_ms)), "max": float(np.max(loop_ms)),
            "budget": LIVE_BUDGET_MS}

        t0 = time.perf_counter()
        built = [Frame.from_depth(f, cam, FAR_POINT, com2d=c, cube=cube)
                 for f, c in zip(frames, tracked)]
        row["frame_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / n
        for f, c in zip(built, tracked):
            if not (f.crop_dm.shape == (128, 128)
                    and np.isfinite(f.crop_dm).all()
                    and f.crop_dm.min() >= -0.5 and f.crop_dm.max() <= 0.5
                    and np.array_equal(f.com2d, c.astype(np.float32))):
                raise AssertionError("track: a Frame's crop or CoM is off")

        WK.crop_normalize.launches = 0
        batch = est.predict_frames(frames, tracked.astype(np.float32),
                                   cubes)
        _, dev_coms = est.predict_raw(frames, cubes, return_coms=True)
        torch.cuda.synchronize()
        launches["tracking batch 64 and predict_raw"] = \
            WK.crop_normalize.launches
        by_name, _, _ = profile_kernels(
            torch, lambda: est.predict_frames(
                frames[:1], tracked[:1].astype(np.float32), cubes[:1]),
            PROFILED_CALLS, symbol="crop_warp_kernel")
        per_call = launches_of(by_name, "crop_warp_kernel")
        cpu = PoseEstimator(hyp, sd, device="cpu").predict_frames(
            frames, tracked.astype(np.float32), cubes)
    if launches["tracking loop (batch 1 per frame)"] != n or \
            launches["tracking batch 64 and predict_raw"] != 2 or \
            round(per_call, 6) != 1:
        raise AssertionError(f"track: crop launches {launches}, {per_call} "
                             f"per call in the profiler; want one per call")
    batch = batch.cpu()
    cpu_err = float((batch - cpu).abs().max())
    b1_err = float((live - batch).abs().max())
    if batch.shape != (n, hyp["vae"]["input_dim"] // 3, 3) or \
            not bool(batch.isfinite().all()) or cpu_err > JOINTS_CPU_MM or \
            b1_err > JOINTS_CPU_MM:
        raise AssertionError(f"track: joints {tuple(batch.shape)}, card vs "
                             f"CPU {cpu_err} mm, batch 1 vs 64 {b1_err} mm "
                             f"(tol {JOINTS_CPU_MM})")
    dev_coms = dev_coms.cpu().numpy().astype(np.float64)
    gaps = {}
    for name, coms in (("detect", detected), ("tracked", tracked)):
        g = np.abs(coms - dev_coms)
        gaps[name] = {"du_px": float(g[:, 0].max()),
                      "dv_px": float(g[:, 1].max()),
                      "dz_mm": float(g[:, 2].max())}
        if g[:, :2].max() > TRACK_PX or g[:, 2].max() > TRACK_MM:
            raise AssertionError(f"track: {name} CoMs vs the device "
                                 f"detector {gaps[name]} (bound {TRACK_PX} "
                                 f"px, {TRACK_MM} mm)")
    row.update(host_vs_device=gaps, joints_card_vs_cpu_mm=cpu_err,
               joints_batch1_vs_64_mm=b1_err, crop_launches_per_call=per_call)
    log(f"track: {n} frames, host detect {row['detect_ms_per_frame']:.2f} "
        f"ms a frame (hand size {row['hand_size_mm']:.1f} mm), "
        f"refine_com_iterative {row['refine_ms_per_frame']:.2f}, "
        f"Frame.from_depth {row['frame_ms_per_frame']:.2f}; live loop "
        f"(track + predict_frames B=1) median "
        f"{row['live_ms_per_frame']['median']:.2f} ms a frame against "
        f"{LIVE_BUDGET_MS:.1f}; host vs device CoMs {json.dumps(gaps)}; "
        f"joints card vs CPU {cpu_err:.3g} mm, B=1 vs B=64 {b1_err:.3g}; "
        f"crop launches {json.dumps(launches)}, {per_call:g} per call")

    # the importers
    tmp = Path(__file__).resolve().parent / "build" / "smoke_track"
    shutil.rmtree(tmp, ignore_errors=True)
    cache = str(tmp / "cache")
    t0 = time.perf_counter()
    msra_root = write_msra(tmp / "msra")
    post_root = write_post(tmp / "post")
    row["write_s"] = time.perf_counter() - t0
    rates = {}
    msra = []
    for s in MSRA_SUBJECTS:
        arrays, fresh, cached = import_twice(
            lambda: MSRA15Importer(str(msra_root), cache_dir=cache), s)
        msra.append(arrays)
        rates[f"msra15 {s}"] = (fresh, cached)
    synth, fresh, cached = import_twice(
        lambda: POSTImporter(str(post_root), cache_dir=cache), "synth")
    rates["post synth"] = (fresh, cached)
    real, fresh, cached = import_twice(
        lambda: POSTImporter(str(post_root), cache_dir=cache), "test")
    rates["post real"] = (fresh, cached)
    want = MSRA_FRAMES * len(MSRA_GESTURES)
    if [len(a) for a in msra] != [want] * len(MSRA_SUBJECTS) or \
            synth.gtorig.shape != (POST_SYNTH, 18, 3) or \
            real.gtorig.shape != (POST_REAL, 1, 3) or \
            not all(np.isfinite(a.gt3Dcrop).all() for a in
                    (*msra, synth, real)):
        raise AssertionError(f"importers: MSRA15 {[len(a) for a in msra]}, "
                             f"POST {synth.gtorig.shape} {real.gtorig.shape}")
    for i, com in enumerate(real.gtorig[:, 0]):
        r0, c0 = 90 + 10 * i, 260 + 15 * i
        if not (c0 <= com[0] <= c0 + 90 and r0 <= com[1] <= r0 + 110):
            raise AssertionError(f"POST real frame {i}: CoM {com} outside "
                                 "the painted subject")

    # MSRA15's raw frames through the estimator, card against CPU
    mcam = Camera.msra()
    imp = MSRA15Importer(str(msra_root), use_cache=False)
    raw = np.stack([imp.load_depth_map(f) for a in msra
                    for f in a.file_names])
    mcoms = mcam.to_img(np.concatenate([a.com for a in msra]))
    mcubes = np.concatenate([np.broadcast_to(a.cube, (len(a), 3))
                             for a in msra]).astype(np.float32)
    with tf32_off(torch):
        WK.crop_normalize.launches = 0
        got = PoseEstimator(hyp, sd, camera=mcam, device=dev).predict_frames(
            raw, mcoms, mcubes)
        torch.cuda.synchronize()
        launches[f"msra15 raw frames (batch {len(raw)})"] = \
            WK.crop_normalize.launches
        want_j = PoseEstimator(hyp, sd, camera=mcam,
                               device="cpu").predict_frames(raw, mcoms,
                                                            mcubes)
    msra_err = float((got.cpu() - want_j).abs().max())
    if launches[f"msra15 raw frames (batch {len(raw)})"] != 1 or \
            not bool(got.isfinite().all()) or msra_err > JOINTS_CPU_MM:
        raise AssertionError(f"MSRA15 frames: launches {launches}, card vs "
                             f"CPU {msra_err} mm")
    shutil.rmtree(tmp)
    row.update(import_frames_per_s={k: {"fresh": f, "cached": c}
                                    for k, (f, c) in rates.items()},
               msra_joints_card_vs_cpu_mm=msra_err,
               phase_s=time.perf_counter() - t_phase)
    shown = {k: [round(f, 1), round(c, 1)] for k, (f, c) in rates.items()}
    log(f"track importers: MSRA15 {len(raw)} frames, POST {POST_SYNTH} "
        f"synthetic + {POST_REAL} real, written in {row['write_s']:.1f} s; "
        f"frames/s fresh / cached {json.dumps(shown)}; "
        f"MSRA15 raw frames card vs CPU {msra_err:.3g} mm; phase "
        f"{row['phase_s']:.1f} s")
    # what the plots and resize phases take up: the frames, their rendered
    # joints, the tracked CoMs and the card's joints for them
    return row, launches, {"frames": frames, "joints": gt_joints,
                           "coms": tracked, "pred": batch.numpy()}


# ---------------------------------------------------------------------------
# the evaluation plots, the resize methods and the common_net blocks
# ---------------------------------------------------------------------------

PLOT_STROKES = {"prediction": (0, 0, 255), "ground truth": (255, 0, 0)}
COMMON_SHAPE = (8, 64, 128, 128)   # batch, channels, height, width
COMMON_RTOL = 1e-4                 # card vs CPU, TF32 off (Frobenius)
COMMON_F64_RTOL = 1e-10            # the same in float64 on both
COMMON_NORM_GRAD_RTOL = 2e-3       # float32 gradients through a norm
RESIZE_WARPS = 16                  # recrop_hand / rotate_hand calls timed


def phase_plots(torch, dev, data):
    """The evaluation plots on the tracking phase's 64 frames: the card's
    joints against the rendered ground truth through ``plotEvaluation``
    (its three PDFs: header, xref offsets at their objects, ``%%EOF``),
    ``plotResult`` on the card's crop of frame 0 with both skeletons
    ((512, 512, 3), both stroke colours drawn) and ``plotResult3D`` of it
    (a PNG the port's reader reads back); host ms of each."""
    import shutil

    from lsps_tpu_torch.data.augment import denormalize
    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.data.png import read_png
    from lsps_tpu_torch.data.transformations import transform_points_2d
    from lsps_tpu_torch.eval.handpose_evaluation import NYUHandposeEvaluation
    from lsps_tpu_torch.ops.kernels import warp as WK
    from lsps_tpu_torch.serve.preprocess import crop_normalize_batch
    from lsps_tpu_torch.utils.pdf import check_pdf

    tmp = Path(__file__).resolve().parent / "build" / "smoke_plots"
    shutil.rmtree(tmp, ignore_errors=True)
    cam = Camera.nyu()
    gt, pred = data["joints"], data["pred"]
    ev = NYUHandposeEvaluation(gt, pred)
    ev.subfolder = str(tmp)
    row = {"frames": len(gt), "mean_error_mm": ev.getMeanError()}
    t0 = time.perf_counter()
    ev.plotEvaluation("smoke")
    row["plotEvaluation_ms"] = (time.perf_counter() - t0) * 1e3
    row["pdf_objects"] = {}
    for name in ("frameswithin", "joint_mean", "joint_max"):
        path = tmp / f"smoke_{name}.pdf"
        row["pdf_objects"][name] = check_pdf(path.read_bytes())

    # frame 0 cropped on the card, back to millimetres (background 0)
    coms = data["coms"][:1].astype(np.float32)
    cubes = np.full((1, 3), CUBE_MM, np.float32)
    WK.crop_normalize.launches = 0
    crops, ms_ = crop_normalize_batch(
        torch.from_numpy(data["frames"][:1]).to(dev),
        torch.from_numpy(coms).to(dev), torch.from_numpy(cubes).to(dev),
        cam.fx, cam.fy)
    torch.cuda.synchronize()
    row["crop_launches"] = WK.crop_normalize.launches
    if row["crop_launches"] != 1:
        raise AssertionError(f"plots: {row['crop_launches']} crop launches "
                             "for one crop")
    crop = crops[0].cpu().numpy()
    M = ms_[0].cpu().numpy().astype(np.float64)
    mm = denormalize(crop, coms[0], cubes[0])
    mm[crop >= 0.99] = 0.0
    gt2 = transform_points_2d(cam.to_img(gt[0]), M)
    pr2 = transform_points_2d(cam.to_img(pred[0]), M)
    t0 = time.perf_counter()
    img = ev.plotResult(mm, gt2, pr2)
    row["plotResult_ms"] = (time.perf_counter() - t0) * 1e3
    drawn = {k: int((img == c).all(-1).sum())
             for k, c in PLOT_STROKES.items()}
    if img.shape != (512, 512, 3) or min(drawn.values()) < 100:
        raise AssertionError(f"plotResult: {img.shape}, stroke pixels "
                             f"{drawn}")
    row["plotResult_stroke_pixels"] = drawn
    t0 = time.perf_counter()
    ev.plotResult3D(mm, M, gt[0], pred[0], filename="smoke3d", camera=cam,
                    niceColors=True)
    row["plotResult3D_ms"] = (time.perf_counter() - t0) * 1e3
    back = read_png(str(tmp / "smoke3d.png"))
    if back.shape != (600, 600, 3) or (back == 255).all():
        raise AssertionError(f"plotResult3D: read back {back.shape}")
    shutil.rmtree(tmp)
    log(f"plots: plotEvaluation {row['plotEvaluation_ms']:.1f} ms (PDF "
        f"objects {row['pdf_objects']}), plotResult "
        f"{row['plotResult_ms']:.1f} ms, plotResult3D "
        f"{row['plotResult3D_ms']:.1f} ms, host clock")
    return row


def phase_resize(torch, dev, hyp, sd, data):
    """The resize methods over the tracking frames: ``crop_area_3d`` under
    the default, ``RESIZE_CV2_NN``, ``RESIZE_CV2_LINEAR`` and
    ``RESIZE_BILINEAR`` (host ms per crop; ``RESIZE_CV2_NN`` bit-equal to
    the default), ``recrop_hand`` and ``rotate_hand`` under linear (host
    ms per call), and the bilinear crops normalized through
    ``predict_crops`` on the card (finite poses)."""
    from lsps_tpu_torch.data.augment import normalize
    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.data.detector import HandDetector
    from lsps_tpu_torch.data.synthetic import SyntheticImporter
    from lsps_tpu_torch.serve.inference import PoseEstimator

    cam = Camera.nyu()
    cube = (CUBE_MM,) * 3
    frames, coms = data["frames"], data["coms"]
    methods = {"default": None, "cv2_nn": HandDetector.RESIZE_CV2_NN,
               "cv2_linear": HandDetector.RESIZE_CV2_LINEAR,
               "bilinear": HandDetector.RESIZE_BILINEAR}
    crops, row = {}, {"frames": len(frames), "crop_ms": {}}
    for name, method in methods.items():
        out = []
        t0 = time.perf_counter()
        for f, c in zip(frames, coms):
            hd = HandDetector(f, cam.fx, cam.fy)
            if method is not None:
                hd.resize_method = method
            out.append(hd.crop_area_3d(c, cube))
        row["crop_ms"][name] = (time.perf_counter() - t0) * 1e3 / len(out)
        crops[name] = out
    for (a, ma, _), (b, mb, _) in zip(crops["cv2_nn"], crops["default"]):
        if not (np.array_equal(a, b) and np.array_equal(ma, mb)):
            raise AssertionError("resize: RESIZE_CV2_NN crops differ from "
                                 "the default path's")
    moved = sum(not np.array_equal(a, b) for (a, _, _), (b, _, _) in
                zip(crops["cv2_linear"], crops["default"]))
    row["linear_crops_unlike_nearest"] = moved

    imp = SyntheticImporter(n_frames=1)
    hd = HandDetector(frames[0], cam.fx, cam.fy, importer=imp)
    hd.resize_method = HandDetector.RESIZE_CV2_LINEAR
    rs = np.random.RandomState(3)
    recrop_ms, rotate_ms = [], []
    for i in range(RESIZE_WARPS):
        crop, M, com = crops["cv2_linear"][i]
        crop = crop.astype(np.float32)
        new_com = com + np.r_[rs.randn(2) * 4, rs.randn() * 15]
        Mnew = hd.com_to_transform(new_com, cube, crop.shape)
        t0 = time.perf_counter()
        a = hd.recrop_hand(crop, Mnew, np.linalg.inv(M), crop.shape,
                           background_value=0, nv_val=32000.0,
                           thresh_z=True, com=new_com, size=cube)
        t1 = time.perf_counter()
        b = hd.rotate_hand(crop, cube, com, rs.uniform(-180, 180),
                           data["joints"][i] - imp.joint_img_to_3d(com))[0]
        t2 = time.perf_counter()
        recrop_ms.append((t1 - t0) * 1e3)
        rotate_ms.append((t2 - t1) * 1e3)
        if a.shape != crop.shape or b.shape != crop.shape or \
                not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError("resize: a linear warp came out wrong")
    row["recrop_hand_linear_ms"] = float(np.mean(recrop_ms))
    row["rotate_hand_linear_ms"] = float(np.mean(rotate_ms))

    norm = np.stack([normalize(c.astype(np.float32).copy(), com, cube)
                     for c, _, com in crops["bilinear"]])[..., None]
    with tf32_off(torch):
        poses = PoseEstimator(hyp, sd, device=dev).predict_crops(norm)
        torch.cuda.synchronize()
    if poses.shape != (len(norm), hyp["vae"]["input_dim"]) or \
            not bool(poses.isfinite().all()):
        raise AssertionError(f"resize: bilinear crops' poses "
                             f"{tuple(poses.shape)}, finite "
                             f"{bool(poses.isfinite().all())}")
    log(f"resize: ms per crop {json.dumps(row['crop_ms'])}, linear warps "
        f"recrop {row['recrop_hand_linear_ms']:.2f} / rotate "
        f"{row['rotate_hand_linear_ms']:.2f} ms a call (host clock); "
        f"nearest crops bit-equal to the default; {moved} of "
        f"{len(frames)} linear crops differ from nearest; bilinear crops' "
        f"poses on the card finite")
    return row


def _common_blocks():
    """(name, maker, input shape) of every common_net block at 64
    channels."""
    from lsps_tpu_torch.ops import common_net as C

    b, c, h, w = COMMON_SHAPE
    img, vec = (b, c, h, w), (b, c)
    return [
        ("LeakyReLUINSConv2d", lambda: C.LeakyReLUINSConv2d(c, c, 3, 1, 1),
         img),
        ("LeakyReLUINSConvTranspose2d",
         lambda: C.LeakyReLUINSConvTranspose2d(c, c, 3, 2, 1, 1), img),
        ("ReLUINSConv2d", lambda: C.ReLUINSConv2d(c, c, 3, 1, 1), img),
        ("ReLUINSConvTranspose2d",
         lambda: C.ReLUINSConvTranspose2d(c, c, 3, 2, 1, 1), img),
        ("LeakyReLUBNConv2d", lambda: C.LeakyReLUBNConv2d(c, c, 3, 1, 1),
         img),
        ("LeakyReLUBNConvTranspose2d",
         lambda: C.LeakyReLUBNConvTranspose2d(c, c, 3, 2, 1, 1), img),
        ("LeakyReLUBNNSConv2d", lambda: C.LeakyReLUBNNSConv2d(c, c, 3, 1, 1),
         img),
        ("LeakyReLUBNNSConvTranspose2d",
         lambda: C.LeakyReLUBNNSConvTranspose2d(c, c, 3, 1, 1), img),
        ("LeakyReLUResBlock", lambda: C.LeakyReLUResBlock(c, c, 3, 1, 1),
         img),
        ("LeakyReLUBNNSResBlock",
         lambda: C.LeakyReLUBNNSResBlock(c, c, 3, 1, 1), img),
        ("Bias2d", lambda: C.Bias2d(c), img),
        ("BatchNorm", lambda: C.BatchNorm(c), img),
        ("GaussianSmoother", lambda: C.GaussianSmoother(5), img),
        ("GaussianVAE2DHead", lambda: C.GaussianVAE2DHead(c, c, 3, 1, 1),
         img),
        ("LeakyReLUBNLinear", lambda: C.LeakyReLUBNLinear(c, c), vec),
        ("GaussianVAEHead", lambda: C.GaussianVAEHead(c, c), vec),
    ]


@functools.lru_cache(maxsize=2)
def _loss_weight_host(shape, seed):
    """1 + N(0, 0.5) of ``shape`` from a numpy seed, float32, made once."""
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return w * np.float32(0.5) + np.float32(1.0)


@functools.lru_cache(maxsize=4)
def _loss_weight(torch, shape, seed, device, dtype):
    """``_fwd_bwd``'s weight of an output on ``device`` in ``dtype``, made
    once (outside the timed step)."""
    return torch.from_numpy(_loss_weight_host(shape, seed)).to(device,
                                                               dtype)


def _fwd_bwd(torch, module, x):
    """Outputs and gradients (input first, then the parameters by name)
    of each output's mean against a fixed seeded weight of its shape,
    1 + N(0, 0.5): a loss that no norm makes constant (as the mean square
    of a normalized output would be), and whose gradient sums over a
    batch's 500k pixels do not cancel to rounding size (as a zero-mean
    weight's would)."""
    x = x.detach().clone().requires_grad_(True)
    out = module(x)
    out = out if isinstance(out, tuple) else (out,)
    loss = sum((o * _loss_weight(torch, tuple(o.shape), i, o.device,
                                 o.dtype)).mean()
               for i, o in enumerate(out))
    names = [k for k, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, [x] + list(module.parameters()))
    return [o.detach() for o in out], dict(zip(["input"] + names, grads))


def _norm_fed_biases(module):
    """Names of the biases that feed an InstanceNorm or a BatchNorm: their
    gradient is zero in exact arithmetic (the norm takes the constant
    away), so what the card and the CPU give is rounding noise."""
    from torch import nn

    from lsps_tpu_torch.ops import common_net as C
    from lsps_tpu_torch.ops import layers as L

    out = set()
    if isinstance(module, nn.Sequential):
        kids = list(module)
        for i, (a, b) in enumerate(zip(kids, kids[1:])):
            if getattr(a, "bias", None) is not None and isinstance(
                    b, (L.InstanceNorm, C.BatchNorm)):
                out.add(f"{i}.bias")
    return out


def _rel(torch, a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)),
                                                1e-30))


def phase_common_net(torch, dev):
    """Every common_net block forward and backward at 64 channels on
    128 x 128, batch 8, TF32 off, against the CPU in float64: the card in
    float64 within ``COMMON_F64_RTOL`` (outputs and every gradient,
    relative Frobenius: the card computes the CPU's function), the card in
    float32 within ``COMMON_RTOL``, or ``COMMON_NORM_GRAD_RTOL`` for the
    gradients of a block with a norm (float32 keeps ~1e-3 of a gradient
    whose plane or channel mean the norm removes: 6.5e-4 and 9.3e-4 on the
    card for the transposed convs into IN at these shapes); the
    biases that feed a norm, zero in exact arithmetic, are left out and
    their largest value reported.  Card ms of each float32 step; the
    im2col stem against the conv on the card."""
    import copy

    from lsps_tpu_torch.ops import common_net as C
    from lsps_tpu_torch.ops import layers as L

    rows, worst, worst64 = {}, 0.0, 0.0
    with tf32_off(torch):
        for k, (name, make, shape) in enumerate(_common_blocks()):
            cpu = make()
            L.reset_parameters(cpu, torch.Generator().manual_seed(k))
            x = torch.from_numpy(np.random.RandomState(k).randn(*shape)
                                 .astype(np.float32))
            skip = _norm_fed_biases(cpu)
            normed = any(isinstance(m, (L.InstanceNorm, C.BatchNorm))
                         for m in cpu.modules())
            ref_o, ref_g = _fwd_bwd(torch, copy.deepcopy(cpu).double(),
                                    x.double())
            d64_o, d64_g = _fwd_bwd(torch, copy.deepcopy(cpu).to(
                dev, torch.float64), x.to(dev, torch.float64))
            card = cpu.to(dev)
            xd = x.to(dev)
            _fwd_bwd(torch, card, xd)                       # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_d, g_d = _fwd_bwd(torch, card, xd)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3

            def gaps(o, g):
                e = {f"out{i}": _rel(torch, a, b)
                     for i, (a, b) in enumerate(zip(o, ref_o))}
                e.update({n: _rel(torch, g[n], ref_g[n]) for n in ref_g
                          if n not in skip})
                return e

            e64, e32 = gaps(d64_o, d64_g), gaps(out_d, g_d)
            grad_tol = COMMON_NORM_GRAD_RTOL if normed else COMMON_RTOL
            bad = [n for n, e in e32.items()
                   if e > (COMMON_RTOL if n.startswith("out") else grad_tol)]
            rows[name] = {"card_ms": ms,
                          "f64_max_rel": max(e64.values()),
                          "f32_out_rel": max(e for n, e in e32.items()
                                             if n.startswith("out")),
                          "f32_grad_rel": max(e for n, e in e32.items()
                                              if not n.startswith("out")),
                          "norm_fed_bias_grad_abs": {
                              n: float(ref_g[n].abs().max()) for n in skip}}
            worst = max(worst, max(e32.values()))
            worst64 = max(worst64, max(e64.values()))
            if bad or max(e64.values()) > COMMON_F64_RTOL:
                raise AssertionError(f"common_net {name}: against CPU "
                                     f"float64, card float64 {e64}, card "
                                     f"float32 {e32}")
        stem = L.Conv2d(1, 64, 7, 2, 3).to(dev)
        x = torch.from_numpy(np.random.RandomState(99).uniform(
            -1, 1, (COMMON_SHAPE[0], 1, 128, 128)).astype(np.float32)).to(dev)
        prev = L.set_im2col_stem(False)
        try:
            conv_out, conv_g = _fwd_bwd(torch, stem, x)
            L.set_im2col_stem(True)
            gemm_out, gemm_g = _fwd_bwd(torch, stem, x)
        finally:
            L.set_im2col_stem(prev)
        stem_err = max([_rel(torch, gemm_out[0], conv_out[0])]
                       + [_rel(torch, gemm_g[k], conv_g[k])
                          for k in conv_g])
    if stem_err > COMMON_RTOL:
        raise AssertionError(f"im2col stem vs conv on the card: {stem_err}")
    log(f"common_net: {len(rows)} blocks at {COMMON_SHAPE}, against the "
        f"CPU in float64: card float64 worst {worst64:.3g} (tol "
        f"{COMMON_F64_RTOL}), card float32 worst {worst:.3g} (tol "
        f"{COMMON_RTOL}, {COMMON_NORM_GRAD_RTOL} for gradients through a "
        f"norm); im2col stem vs "
        f"conv {stem_err:.3g}; card ms (float32 forward + backward) "
        + json.dumps({k: round(v["card_ms"], 3) for k, v in rows.items()}))
    return {"blocks": rows, "worst_f32_rel": worst, "worst_f64_rel": worst64,
            "im2col_stem_rel": stem_err, "shape": COMMON_SHAPE}


# ---------------------------------------------------------------------------
# the serving surface: detection card vs CPU, the daemon, export, the walk
# ---------------------------------------------------------------------------

COM_HANDS = 256
COM_Z_ULPS = 128            # tests/test_torch_detect.py derives it
DAEMON_WINDOW_MS = 2.0
DAEMON_MAX_BATCH = 64
DAEMON_CLIENTS = 16
DAEMON_ROUNDS = 4           # rounds of DAEMON_CLIENTS concurrent requests
DAEMON_SINGLE = 16          # requests one after another
RATE_CLIENTS = (1, DAEMON_CLIENTS)  # concurrent clients of a rate window
RATE_WINDOW_S = 4.0         # seconds per rate window
RATE_WINDOWS = 2            # windows per client count: their spread
EXPORT_BATCH = 32
EXPORT_ITERS = 20
WALK_STEPS = 16
WALK_CPU_TOL = 1e-3         # card vs CPU, TF32 off: 16 residual blocks of
                            # float32 sums in other orders, on tanh outputs


def com_hands(n, seed):
    """``n`` random hands (as ``tests/test_torch_detect.py`` draws them):
    CoM x +-120 mm, y +-80 mm, z 500-1100 mm, rendered by the port's
    ``render_hand_depth``."""
    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.data.synthetic import render_hand_depth

    cam = Camera.nyu()
    rs = np.random.RandomState(seed)
    frames = np.zeros((n, H, W), np.float32)
    for i in range(n):
        com3d = np.array([rs.uniform(-120, 120), rs.uniform(-80, 80),
                          rs.uniform(500, 1100)], np.float32)
        frames[i] = render_hand_depth(cam, com3d, 36, rs)[0]
    return frames


def com_gap_ulps(got, want, what):
    """u and v equal and z within COM_Z_ULPS float32 ulps of ``want``'s z;
    returns the worst z gap in ulps."""
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(got[:, :2], want[:, :2]):
        raise AssertionError(f"{what}: u, v differ, max "
                             f"{np.abs(got[:, :2] - want[:, :2]).max()} px")
    gap = np.abs(got[:, 2] - want[:, 2]) / np.spacing(
        np.abs(want[:, 2]).astype(np.float32))
    if gap.max() > COM_Z_ULPS:
        raise AssertionError(f"{what}: z {gap.max()} ulps > {COM_Z_ULPS}")
    return float(gap.max())


def phase_com(torch, dev, cam):
    """``device_detect_batch`` over COM_HANDS seeded random hands on the
    card and on the CPU: u and v equal, z within COM_Z_ULPS float32 ulps
    of z, every hand detected.  Returns the worst z gap in ulps."""
    from lsps_tpu_torch.serve.detect import device_detect_batch

    t0 = time.perf_counter()
    frames = com_hands(COM_HANDS, seed=0)
    cubes = np.full((COM_HANDS, 3), CUBE_MM, np.float32)
    render_s = time.perf_counter() - t0
    card, cpu = [], []
    for s in range(0, COM_HANDS, 32):
        f, c = (torch.from_numpy(a[s:s + 32]) for a in (frames, cubes))
        card.append(device_detect_batch(f.to(dev), c.to(dev), cam.fx,
                                        cam.fy).cpu())
        cpu.append(device_detect_batch(f, c, cam.fx, cam.fy))
    card, cpu = torch.cat(card).numpy(), torch.cat(cpu).numpy()
    if not (np.all(card[:, 2] > 0) and np.all(cpu[:, 2] > 0)):
        raise AssertionError(f"CoM sweep: {np.sum(card[:, 2] <= 0)} hands "
                             f"undetected on the card, "
                             f"{np.sum(cpu[:, 2] <= 0)} on the CPU")
    gap = com_gap_ulps(card, cpu, "CoM sweep, card vs CPU")
    log(f"CoM sweep: {COM_HANDS} hands (rendered in {render_s:.1f} s), u, v "
        f"card == CPU; z gap max {gap:.0f} float32 ulps (bound "
        f"{COM_Z_ULPS}); {time.perf_counter() - t0:.1f} s")
    return gap


DETECT_BATCHES = (1, 32, 256)
DETECT_KERNELS = 9          # 4 + refine_iters (5) launches
DETECT_ITERS = 10           # calls a trace


def kernel_name(name):
    """``detect_box_kernel`` out of a mangled kernel name."""
    import re

    m = re.search(r"detect_\w*?kernel", name)
    return m.group(0) if m else name


def phase_detect(torch, dev, cam):
    """The detection kernel (the op ``lsps::detect_coms``) against its
    plain version on the card, over the COM_HANDS sweep hands at batch 1,
    32 and 256, float32 and whole-mm uint16 frames: u and v equal, z within
    COM_Z_ULPS, one counted launch a call, two calls bit-identical.  Then
    timed on uint16 frames (the serving cells'): device ms a call from
    torch.profiler with the same frames each call (warm) and rotating
    over COLD_BYTES of copies (cold in L2), beside the bound of two reads
    of the frames, and the plain version's device ms.  Returns (timing
    rows, the worst z gap in ulps)."""
    from lsps_tpu_torch.serve import detect as D

    frames = com_hands(COM_HANDS, seed=0)
    rows, worst = [], 0.0
    for b in DETECT_BATCHES:
        cu = torch.full((b, 3), CUBE_MM, device=dev)
        for kind, f in (("f32", frames[:b]),
                        ("u16", whole_mm_u16(frames[:b]))):
            ft = torch.from_numpy(np.ascontiguousarray(f)).to(dev)
            call = functools.partial(D.device_detect_batch, ft, cu, cam.fx,
                                     cam.fy)
            plain = functools.partial(D.device_detect_batch_reference, ft,
                                      cu, cam.fx, cam.fy)
            before = D.device_detect_batch.launches
            got = call()
            torch.cuda.synchronize()
            counted = D.device_detect_batch.launches - before
            if counted != 1:
                raise AssertionError(f"detect B={b}: {counted} launches "
                                     f"counted for one call")
            if not torch.equal(got, call()):
                raise AssertionError(f"detect B={b} {kind}: two calls differ")
            want = plain()
            if not bool((got[:, 2] > 0).all()):
                raise AssertionError(f"detect B={b} {kind}: a hand missed")
            gap = com_gap_ulps(got.cpu(), want.cpu(),
                               f"detect B={b} {kind}, kernel vs plain")
            worst = max(worst, gap)
            if kind == "f32":
                continue
            by_name, dev_ms, _ = profile_kernels(torch, call,
                                                 iters=DETECT_ITERS,
                                                 symbol="detect_finalize")
            kernels = launches_of(by_name, "detect_")
            if round(kernels, 6) != DETECT_KERNELS:
                raise AssertionError(f"detect B={b}: {kernels:g} kernels a "
                                     f"call in the trace, not "
                                     f"{DETECT_KERNELS}")
            n, turn = rotating(ft)

            def cold():
                return D.device_detect_batch(next(turn), cu, cam.fx, cam.fy)

            for _ in range(n):  # each copy next read after n - 1 others
                cold()
            _, cold_ms, _ = profile_kernels(torch, cold, iters=DETECT_ITERS,
                                            symbol="detect_finalize")
            del turn
            _, plain_ms, _ = profile_kernels(torch, plain, iters=2)
            row = {"batch": b, "frames": kind, "ms": dev_ms,
                   "cold_ms": cold_ms,
                   "call_ms": cuda_ms(torch, call, 4 * DETECT_ITERS),
                   "host_ms": host_ms(torch, call, 4 * DETECT_ITERS),
                   "plain_ms": plain_ms,
                   "plain_host_ms": host_ms(torch, plain, 3),
                   "kernels_per_call": kernels,
                   "by_kernel": {kernel_name(k): v[0]
                                 for k, v in by_name.items()},
                   "z_gap_ulps": gap,
                   **bound(2 * ft.numel() * ft.element_size(), 0)}
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["cold_share_of_bound"] = row["bound_ms"] / row["cold_ms"]
            rows.append(row)
            log(f"detect B={b} {kind}: {row['ms']:.5f} ms device, cold "
                f"{row['cold_ms']:.5f}, bound {row['bound_ms']:.5f} "
                f"({row['share_of_bound']:.1%}, cold "
                f"{row['cold_share_of_bound']:.1%}), plain "
                f"{row['plain_ms']:.3f} ms; host {row['host_ms']:.4f} ms a "
                f"call (plain {row['plain_host_ms']:.3f}); {kernels:g} "
                f"kernels a call in the trace")
    log(f"detect: kernel vs plain on the card, B={DETECT_BATCHES}, float32 "
        f"and uint16: u, v equal, z within {worst:.0f} ulps")
    return rows, worst


def http(url, path, body=None, npz=False):
    """One request; the decoded JSON or npz response."""
    import io
    import urllib.request

    data = None
    if body is not None:
        data = body if npz else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        raw = r.read()
    return dict(np.load(io.BytesIO(raw))) if npz else json.loads(raw)


def npz_body(**arrays):
    import io

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@contextlib.contextmanager
def serving(est, **kw):
    """A daemon over ``est`` on an ephemeral port, in a thread: yields
    (PoseServer, url); shut down after."""
    import threading

    from lsps_tpu_torch.serve import server as S

    ps, httpd = S.make_server(est, port=0, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield ps, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        if ps.batcher is not None:
            ps.batcher.close()


def serve_config(cfg, prefix):
    """A copy of the config ``cfg`` whose snapshot prefix is ``prefix``,
    beside it: the daemon reads its snapshots from the config alone."""
    import yaml

    doc = yaml.safe_load(Path(cfg).read_text())
    doc["train"]["snapshot_prefix"] = str(prefix)
    path = Path(cfg).with_name("serve.yaml")
    path.write_text(yaml.safe_dump(doc))
    return str(path)


# The rate windows' clients, a process of their own (stdlib only), so that
# they share no interpreter lock with the daemon.  argv: url, window
# seconds, windows per client count, the client counts joined by commas,
# then the request bodies (1-frame npz files), which the clients take in
# turns.  Prints one JSON object: per client count, per window, the
# requests completed inside the window, failures and latencies in ms.
RATE_CLIENT = r"""
import json, sys, threading, time, urllib.request
url, seconds, windows, counts = sys.argv[1], float(sys.argv[2]), \
    int(sys.argv[3]), [int(c) for c in sys.argv[4].split(",")]
bodies = [open(p, "rb").read() for p in sys.argv[5:]]

def client(i, end, lat, bad):
    k = i
    while True:
        t = time.perf_counter()
        if t >= end:
            return
        req = urllib.request.Request(url + "/predict_npz",
                                     data=bodies[k % len(bodies)])
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                ok = r.status == 200 and len(r.read()) > 0
        except Exception:
            ok = False
        done = time.perf_counter()
        if done <= end:
            (lat if ok else bad).append((done - t) * 1e3)
        k += 1

# warm-up, not recorded: every client count's batch sizes once
for n in counts:
    end = time.perf_counter() + 1.0
    threads = [threading.Thread(target=client, args=(i, end, [], []))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
out = {}
for n in counts:
    out[n] = []
    for _ in range(windows):
        lat, bad = [], []
        end = time.perf_counter() + seconds
        threads = [threading.Thread(target=client, args=(i, end, lat, bad))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out[n].append({"requests": len(lat), "failed": len(bad),
                       "ms": sorted(lat)})
print(json.dumps(out))
"""


def rate_windows(url, bodies, tmp):
    """The daemon's requests/s over RATE_WINDOWS windows of RATE_WINDOW_S
    seconds at each of RATE_CLIENTS concurrent 1-frame clients, driven
    from another process: {clients: [{"requests_per_s", "median_ms",
    "p90_ms", "requests"}, ...]}.  Any failed request fails the phase."""
    paths = []
    for i, body in enumerate(bodies):
        paths.append(tmp / f"rate_body_{i}.npz")
        paths[-1].write_bytes(body)
    n_windows = RATE_WINDOWS * len(RATE_CLIENTS)
    res = subprocess.run(
        [sys.executable, "-c", RATE_CLIENT, url, str(RATE_WINDOW_S),
         str(RATE_WINDOWS), ",".join(map(str, RATE_CLIENTS)),
         *map(str, paths)], capture_output=True, text=True,
        timeout=(RATE_WINDOW_S + 1) * n_windows + 120)
    for p in paths:
        p.unlink()
    if res.returncode:
        raise AssertionError(f"daemon rate clients: exit {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    out = {}
    for n, windows in json.loads(res.stdout).items():
        out[int(n)] = []
        for w in windows:
            if w["failed"] or not w["requests"]:
                raise AssertionError(f"daemon rate window, {n} clients: "
                                     f"{w['failed']} failed, "
                                     f"{w['requests']} answered")
            ms = np.asarray(w["ms"])
            out[int(n)].append({
                "requests": w["requests"],
                "requests_per_s": w["requests"] / RATE_WINDOW_S,
                "median_ms": float(np.median(ms)),
                "p90_ms": float(np.percentile(ms, 90))})
    return out


def phase_daemon(torch, dev, cfg, prefix, tmp):
    """``serve.server.build_estimator`` from the CLI phase's snapshots and
    a ``PoseServer`` at --batch-window-ms 2 --max-batch 64 on an ephemeral
    port: /healthz, /predict JSON with CoMs, /predict_npz with whole-mm
    uint16 frames, raw JSON, then DAEMON_SINGLE requests one after another
    and DAEMON_ROUNDS rounds of DAEMON_CLIENTS concurrent 1-frame clients.
    Joints equal direct predict_frames / predict_raw calls within
    JOINTS_PLAIN_MM (TF32 off); crop_normalize launches once per
    dispatched batch, and some batch coalesced more than one request.
    Then the rates: ``rate_windows`` from a client process, one launch
    per batch again.  Returns (estimator, a result row)."""
    from concurrent.futures import ThreadPoolExecutor as Pool

    from lsps_tpu_torch.ops.kernels import warp as WK
    from lsps_tpu_torch.serve.server import build_estimator

    t0 = time.perf_counter()
    est = build_estimator(serve_config(cfg, prefix), frac=0.5, device=dev)
    build_s = time.perf_counter() - t0
    frames, coms = hand_frames(DAEMON_CLIENTS, np.random.RandomState(61))
    cubes = np.full((len(frames), 3), CUBE_MM, np.float32)
    u16 = frames.astype(np.uint16)
    sizes = []
    with serving(est, batch_window_ms=DAEMON_WINDOW_MS,
                 max_batch=DAEMON_MAX_BATCH) as (ps, url):
        run_group = ps.batcher._run_group

        def recorded(f, c, k):
            sizes.append(len(f))
            return run_group(f, c, k)

        ps.batcher._run_group = recorded
        health = http(url, "/healthz")
        if not (health["ok"] and health["microbatch"]
                and health["joints"] == est.n_joints):
            raise AssertionError(f"daemon /healthz: {health}")
        WK.crop_normalize.launches = 0
        batches0 = ps.batches
        with tf32_off(torch):
            got = {
                "json": np.asarray(http(url, "/predict", {
                    "frames": frames[:2].tolist(),
                    "coms": coms[:2].tolist(),
                    "cubes": cubes[:2].tolist()})["joints"], np.float32),
                "npz_u16": http(url, "/predict_npz", npz_body(
                    frames=u16[2:4], coms=coms[2:4], cubes=cubes[2:4]),
                    npz=True)["joints"],
            }
            raw = http(url, "/predict", {"frames": frames[4:6].tolist()})
            got["raw"] = np.asarray(raw["joints"], np.float32)

            def one(i):
                return http(url, "/predict_npz", npz_body(
                    frames=u16[i:i + 1], coms=coms[i:i + 1],
                    cubes=cubes[i:i + 1]), npz=True)["joints"]

            single = [one(i % DAEMON_CLIENTS) for i in range(DAEMON_SINGLE)]
            with Pool(DAEMON_CLIENTS) as pool:
                conc = list(pool.map(one, list(range(DAEMON_CLIENTS))
                                     * DAEMON_ROUNDS))
            torch.cuda.synchronize()
        launches = WK.crop_normalize.launches
        dispatched = ps.batches - batches0
        checked = len(sizes)
        # the rates (TF32 as PyTorch's default): clients in another
        # process, windows of seconds
        rates = rate_windows(url, [npz_body(
            frames=u16[i:i + 1], coms=coms[i:i + 1], cubes=cubes[i:i + 1])
            for i in range(DAEMON_CLIENTS)], tmp)
        torch.cuda.synchronize()
        rate_launches = WK.crop_normalize.launches - launches
        rate_sizes = sizes[checked:]
        del sizes[checked:]
    if launches != dispatched or launches != len(sizes) \
            or rate_launches != len(rate_sizes):
        raise AssertionError(f"daemon: {launches} crop_normalize launches "
                             f"for {dispatched} dispatched batches "
                             f"({len(sizes)} recorded); {rate_launches} for "
                             f"{len(rate_sizes)} in the rate windows")
    if max(sizes) < 2:
        raise AssertionError(f"daemon: no request was coalesced, batches "
                             f"{sizes}")
    if not raw["detected"] == [True, True]:
        raise AssertionError(f"daemon raw: detected {raw['detected']}")

    with tf32_off(torch):
        want = est.predict_frames(frames, coms, cubes).cpu().numpy()
        want_raw = est.predict_raw(frames[4:6]).cpu().numpy()
    # the direct call a request makes, from numpy to numpy, at batch 1
    direct_ms = host_ms(torch, lambda: est.predict_frames(
        u16[:1], coms[:1], cubes[:1]).cpu().numpy(), DAEMON_SINGLE)
    worst = 0.0
    for name, g, w in (("json", got["json"], want[:2]),
                       ("npz uint16", got["npz_u16"], want[2:4]),
                       ("raw", got["raw"], want_raw),
                       *((f"client {i % DAEMON_CLIENTS}", j,
                          want[i % DAEMON_CLIENTS:i % DAEMON_CLIENTS + 1])
                         for i, j in enumerate(single + conc))):
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError(f"daemon {name}: joints {g.shape}")
        err = float(np.abs(g - w).max())
        worst = max(worst, err)
        if err > JOINTS_PLAIN_MM:
            raise AssertionError(f"daemon {name}: {err} mm from the direct "
                                 f"call")
    row = {"build_estimator_s": build_s, "batches": dispatched,
           "direct_predict_frames_ms_b1": direct_ms,
           "crop_normalize_launches": launches,
           "batch_sizes": sorted(set(sizes)), "max_batch_seen": max(sizes),
           "worst_joint_gap_mm": worst,
           # 1-frame requests, so requests/s = frames/s
           "rate_window_s": RATE_WINDOW_S, "rate_windows": rates,
           "rate_window_batches": len(rate_sizes),
           "rate_window_batch_sizes": sorted(set(rate_sizes))}
    log(f"daemon: build_estimator {build_s:.1f} s; {dispatched} batches, "
        f"{launches} crop_normalize launches, batch sizes "
        f"{row['batch_sizes']}; direct predict_frames B=1 (numpy to "
        f"numpy) {direct_ms:.3f} ms; joints vs direct calls <= "
        f"{worst:.3g} mm (tol {JOINTS_PLAIN_MM})")
    for n, windows in rates.items():
        log(f"daemon, {n} client(s) in another process, "
            f"{RATE_WINDOW_S} s windows: requests/s (= frames/s) "
            f"{[w['requests_per_s'] for w in windows]}, median ms "
            f"{[w['median_ms'] for w in windows]}, p90 ms "
            f"{[w['p90_ms'] for w in windows]}")
    return est, row


def phase_export(torch, dev, est, tmp, serve_cfg):
    """A static batch-32 float32 frames program and a symbolic-batch uint16
    raw program, exported, saved, loaded back and run: joints within
    JOINTS_PLAIN_MM of the live estimator and raw CoMs equal (TF32 off),
    one crop_normalize launch per call counted from inside the program;
    the symbolic raw program exported on the CPU by ``cli.export_model
    --device cpu`` (config ``serve_cfg``), loaded onto the card and held
    so too; then ``serve.server`` in --artifact mode serves the raw
    artifact for one request.  Times: export and load seconds, ms per call beside the
    live call.  Returns (launches by program, a result row)."""
    from lsps_tpu_torch.ops.kernels import warp as WK
    from lsps_tpu_torch.serve import export as E
    from lsps_tpu_torch.serve import server as S

    b = EXPORT_BATCH
    frames, coms = hand_frames(8, np.random.RandomState(67))
    f = torch.from_numpy(np.tile(frames, (b // 8, 1, 1))).to(dev)
    c = torch.from_numpy(np.tile(coms, (b // 8, 1))).to(dev)
    cu = torch.full((b, 3), CUBE_MM, device=dev)
    u16 = f.round().to(torch.uint16)
    programs = {"static32_frames": (b, False, torch.float32),
                "symbolic_u16_raw": (None, True, torch.uint16)}
    row, launches, arts = {}, {}, {}
    for name, (batch, raw, dtype) in programs.items():
        path = str(tmp / f"{name}.pt2")
        t0 = time.perf_counter()
        exported = E.export_pose_program(est, batch=batch, frame_shape=(H, W),
                                         raw=raw, frame_dtype=dtype)
        export_s = time.perf_counter() - t0
        E.save_pose_program(path, exported)
        t0 = time.perf_counter()
        art = E.ArtifactPoseEstimator(path)
        load_s = time.perf_counter() - t0
        arts[name] = (path, art)
        sizes = (b,) if batch else (b, 5, 1)
        WK.crop_normalize.launches = 0
        with tf32_off(torch):
            outs = [art.predict_raw(u16[:n], cu[:n], return_coms=True)
                    if raw else art.predict_frames(f[:n], c[:n], cu[:n])
                    for n in sizes]
            torch.cuda.synchronize()
            launches[name] = WK.crop_normalize.launches
            for n, got in zip(sizes, outs):
                if raw:
                    gj, gc = got
                    wj, wc = est.predict_raw(u16[:n], cu[:n],
                                             return_coms=True)
                    if not torch.equal(gc, wc):
                        raise AssertionError(f"export {name} B={n}: CoMs "
                                             f"differ from the live call")
                else:
                    gj = got
                    wj = est.predict_frames(f[:n], c[:n], cu[:n])
                err = float((gj - wj).abs().max())
                if err > JOINTS_PLAIN_MM or not bool(gj.isfinite().all()):
                    raise AssertionError(f"export {name} B={n}: {err} mm "
                                         f"from the live estimator")
        if launches[name] != len(sizes):
            raise AssertionError(f"export {name}: {launches[name]} "
                                 f"crop_normalize launches counted for "
                                 f"{len(sizes)} program calls")

        def call():
            return (art.predict_raw(u16, cu) if raw
                    else art.predict_frames(f, c, cu))

        def live():
            return (est.predict_raw(u16, cu) if raw
                    else est.predict_frames(f, c, cu))

        ms = [host_ms(torch, fn, EXPORT_ITERS) for fn in (live, call, call,
                                                          live)]
        # the same kernels? and what the device does per call
        prof = {k: profile_kernels(torch, fn) for k, fn in (("program", call),
                                                            ("live", live))}
        row[name] = {"export_s": export_s, "load_s": load_s,
                     "kernels_per_call": {k: sum(n for _, n in v[0].values())
                                          for k, v in prof.items()},
                     "device_ms": {k: v[1] for k, v in prof.items()},
                     "file_mb": os.path.getsize(path) / 2 ** 20,
                     "ms_per_call": (ms[1] + ms[2]) / 2,
                     "live_ms_per_call": (ms[0] + ms[3]) / 2,
                     "ms_runs": ms, "batch": b,
                     "launches_per_call": launches[name] / len(sizes),
                     "calls": len(sizes)}
        log(f"export {name}: export {export_s:.1f} s, load {load_s:.1f} s, "
            f"{row[name]['file_mb']:.1f} MiB; B={b}: "
            f"{row[name]['ms_per_call']:.3f} ms per call, live "
            f"{row[name]['live_ms_per_call']:.3f} ms (runs {ms}); "
            f"kernels per call {row[name]['kernels_per_call']}, device ms "
            f"{row[name]['device_ms']}; crop_normalize launches per program "
            f"call {row[name]['launches_per_call']:.0f}")

    # a program exported on the CPU (the export CLI with --device cpu),
    # loaded onto the card: load_pose_program moves it there
    from lsps_tpu_torch.cli import export_model

    name, path = "cpu_symbolic_raw", str(tmp / "cpu_symbolic_raw.pt2")
    t0 = time.perf_counter()
    export_model.main(["--config", serve_cfg, "--frac", "0.5", "--symbolic",
                       "--raw", "--device", "cpu", "--out", path])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = E.ArtifactPoseEstimator(path, device=dev)
    load_s = time.perf_counter() - t0
    sizes = (b, 5, 1)
    WK.crop_normalize.launches = 0
    with tf32_off(torch):
        outs = [art.predict_raw(f[:n], cu[:n], return_coms=True)
                for n in sizes]
        torch.cuda.synchronize()
        launches[name] = WK.crop_normalize.launches
        for n, (gj, gc) in zip(sizes, outs):
            wj, wc = est.predict_raw(f[:n], cu[:n], return_coms=True)
            err = float((gj - wj).abs().max())
            if gj.device != wj.device or not torch.equal(gc, wc) \
                    or err > JOINTS_PLAIN_MM:
                raise AssertionError(f"export {name} B={n}: on "
                                     f"{gj.device}, CoMs equal "
                                     f"{torch.equal(gc, wc)}, joints {err} "
                                     f"mm from the live estimator")
    if launches[name] != len(sizes):
        raise AssertionError(f"export {name}: {launches[name]} "
                             f"crop_normalize launches counted for "
                             f"{len(sizes)} program calls")
    ms = [host_ms(torch, fn, EXPORT_ITERS) for fn in (
        lambda: est.predict_raw(f, cu), lambda: art.predict_raw(f, cu))]
    row[name] = {"export_s": export_s, "load_s": load_s, "batch": b,
                 "ms_per_call": ms[1], "live_ms_per_call": ms[0],
                 "launches_per_call": launches[name] / len(sizes),
                 "calls": len(sizes)}
    log(f"export {name} (exported on the CPU, loaded on {dev}): export "
        f"{export_s:.1f} s, load {load_s:.1f} s; B={b}: {ms[1]:.3f} ms per "
        f"call, live {ms[0]:.3f} ms; joints within {JOINTS_PLAIN_MM} mm of "
        f"the live estimator, CoMs equal; crop_normalize launches per call "
        f"{row[name]['launches_per_call']:.0f}")

    # serve.server --artifact: the loaded raw artifact answers a request
    opts = S.parser().parse_args(["--artifact", arts["symbolic_u16_raw"][0],
                                  "--device", device_flag(dev)])
    art = S.load_estimator(opts, None)
    with tf32_off(torch), serving(art) as (ps, url):
        WK.crop_normalize.launches = 0
        resp = http(url, "/predict_npz", npz_body(frames=frames[:3].astype(
            np.uint16)), npz=True)
        torch.cuda.synchronize()
        launches["artifact daemon"] = WK.crop_normalize.launches
        want = est.predict_raw(frames[:3].astype(np.uint16)).cpu().numpy()
    err = float(np.abs(resp["joints"] - want).max())
    if not resp["detected"].all() or err > JOINTS_PLAIN_MM or \
            launches["artifact daemon"] != 1 or ps.batches != 1:
        raise AssertionError(f"artifact daemon: detected "
                             f"{resp['detected']}, {err} mm, launches "
                             f"{launches['artifact daemon']}, batches "
                             f"{ps.batches}")
    log(f"artifact daemon: 3 raw frames answered, joints vs live <= "
        f"{err:.3g} mm, {launches['artifact daemon']} crop_normalize launch")
    return launches, row


def phase_walk(torch, dev, cfg, prefix, tmp):
    """``cli.latent_walk.main`` in process on the CLI phase's snapshot,
    --steps 16, TF32 off, the IN + LeakyReLU launch counts set to 0 just
    before and read just after: the AVI and the strip written, finite
    walk frames, in_act_forward launched as the generator's blocks give
    it (the two encodes and one decode of the 16 codes), no other norm
    kernel; then the same encode and walk on a CPU copy of the generator
    within WALK_CPU_TOL.  Returns (launches, a result row)."""
    import copy
    import io

    from lsps_tpu_torch.cli import common as C
    from lsps_tpu_torch.cli import latent_walk as LW
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.serve.inference import eval_mode, latent_walk

    rec = {}
    make_trainer, make_datasets = C.make_trainer, C.make_datasets

    def keep_trainer(*a, **kw):
        rec["trainer"] = make_trainer(*a, **kw)
        return rec["trainer"]

    def keep_datasets(*a, **kw):
        rec["datasets"] = make_datasets(*a, **kw)
        return rec["datasets"]

    def keep_walk(gen, z0, z1, steps):
        rec["codes"] = (z0, z1)
        rec["out"] = latent_walk(gen, z0, z1, steps=steps)
        return rec["out"]

    out = tmp / "walk" / "walk.avi"
    buf = io.StringIO()
    zero_norm_launches(N)
    t0 = time.perf_counter()
    with tf32_off(torch), \
            unittest.mock.patch.object(C, "make_trainer", keep_trainer), \
            unittest.mock.patch.object(C, "make_datasets", keep_datasets), \
            unittest.mock.patch.object(LW, "latent_walk", keep_walk), \
            contextlib.redirect_stdout(buf):
        LW.main(["--config", cfg, "--snapshot-prefix", str(prefix),
                 "--device", device_flag(dev), "--steps", str(WALK_STEPS),
                 "--out", str(out)])
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = norm_launches(N)
    check_files(out.parent, ["walk.avi", "walk_strip.png"], "latent walk")
    if "Resume from iteration" not in buf.getvalue():
        raise AssertionError("latent walk: no snapshot resumed")
    gcfg = rec["trainer"].hyp["gen"]
    want = (2 * (gcfg["n_enc_res_blk"] + gcfg["n_enc_shared_blk"])
            + gcfg["n_gen_shared_blk"] + 2 * gcfg["n_gen_res_blk"])
    others = {k: v for k, v in launches.items() if k != "in_act_forward"}
    if launches["in_act_forward"] != want or any(others.values()):
        raise AssertionError(f"latent walk: launches {launches}, want "
                             f"{want} in_act_forward and nothing else")
    out_a, out_b = rec["out"]
    if out_a.shape != (WALK_STEPS, 128, 128, 1) or not (
            bool(out_a.isfinite().all()) and bool(out_b.isfinite().all())):
        raise AssertionError(f"latent walk: frames {tuple(out_a.shape)}")
    avi = out.read_bytes()
    if avi[:4] != b"RIFF" or avi.count(b"00db") < 2 * WALK_STEPS:
        raise AssertionError("latent walk: the AVI lacks its frames")

    # the same encode and walk on a CPU copy of the generator
    gen = copy.deepcopy(rec["trainer"].gen).cpu()
    ds_test = rec["datasets"][2]
    imgs = [torch.from_numpy(np.transpose(ds_test[i][0], (1, 2, 0))[None])
            for i in (0, 1)]
    with eval_mode(gen), torch.no_grad():
        z0, z1 = gen.encode(*imgs)
    cpu_a, cpu_b = latent_walk(gen, z0[0], z1[0], steps=WALK_STEPS)
    code_err = max(float((a.cpu() - b[0]).abs().max())
                   for a, b in zip(rec["codes"], (z0, z1)))
    err = max(float((out_a.cpu() - cpu_a).abs().max()),
              float((out_b.cpu() - cpu_b).abs().max()))
    row = {"wall_s": wall_s, "steps": WALK_STEPS, "launches": launches,
           "in_act_forward_want": want, "card_vs_cpu": err,
           "codes_card_vs_cpu": code_err}
    log(f"latent walk: {WALK_STEPS} steps in {wall_s:.1f} s (datasets, "
        f"trainer, resume included); in_act_forward {want} launches; card "
        f"vs CPU walk {err:.3g} (tol {WALK_CPU_TOL}), codes {code_err:.3g}")
    if err > WALK_CPU_TOL:
        raise AssertionError(f"latent walk: card vs CPU {err} > "
                             f"{WALK_CPU_TOL}")
    return launches, row


# ---------------------------------------------------------------------------
# data parallelism: ranks over torch.distributed, sharded serving
# ---------------------------------------------------------------------------

DP_WORLD = 2           # two ranks share the one card (gloo, by the rule)
DP_BATCH = 32          # the global batch of the trainer part: 16 a rank
DP_STEPS = 3
DP_NCCL_STEPS = 2
DP_CLI_ITERS = 2       # the estimate3 eval at 2
DP_CUTS = {
    # 31 test frames: the last (only) test batch is odd, padded to 32
    "n_frames": {"train_a": 32, "train_b": 32, "test_b": 31},
    "display": 1, "image_display_iterations": 2,
    "image_save_iterations": 2,
    "snapshot_save_iterations": 1000,  # no ~46 s snapshot write
}
DP_EVAL_RTOL = 1e-3    # the eval's mean error, --mesh-data 2 against 0
DP_TIMEOUT_S = 420
TP_MODEL = 2           # the model axis of the tensor-parallel part
TP_BATCH = 32          # regress_b's global batch there
TP_MIN_OUT_CH = 512    # the JAX default: SharedDis' three wide convs split
TP_RTOL = 1e-4         # TP vs the replicated module, TF32 off
TP_TIMED = 10          # forwards timed, TP and replicated in turns


def dp_config(cli_cfg, tmp):
    """The CLI phase's cut config with the cuts of ``DP_CUTS``."""
    import yaml

    doc = yaml.safe_load(Path(cli_cfg).read_text())
    train = doc["train"]
    for k, v in DP_CUTS.items():
        if k != "n_frames":
            train[k] = v
    for name, n in DP_CUTS["n_frames"].items():
        train["datasets"][name]["n_frames"] = n
    path = tmp / "synth_full_dp.yaml"
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def dp_steps(torch, trainer, reg, mesh=None, steps=DP_STEPS):
    """``steps`` pretrain_update_raw at the global batch ``DP_BATCH`` from
    numpy seeds (each rank of a mesh trains on its rows); per step the
    metrics, the host ms of the step (collectives included) and, under a
    mesh, whether every rank held rank 0's parameters bit for bit after
    it."""
    rows = []
    for k in range(steps):
        raw = raw_step_batch(DP_BATCH, 60 + k, reg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met, _ = trainer.pretrain_update_raw(*raw, with_viz=False)
        torch.cuda.synchronize()
        row = {"metrics": {n: float(v) for n, v in met.items()},
               "ms": (time.perf_counter() - t0) * 1e3}
        if mesh is not None:
            row["same_as_rank0"] = mesh.same_across_ranks(
                list(trainer.nets.parameters()))
        rows.append(row)
    return rows


def allreduce_ms(torch, mesh, trainer, reps=5):
    """Host ms of a pretrain step's gradient all-reduces (the dis
    optimizer's, then the gen + map optimizer's gradients; zeros of their
    shapes) and the megabytes they carry."""
    sets = [[torch.zeros_like(p) for p in opt.params]
            for opt in (trainer.dis_opt, trainer.gen_opt)]
    for s in sets:
        mesh.allreduce_mean_(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for s in sets:
            mesh.allreduce_mean_(s)
    torch.cuda.synchronize()
    mb = sum(t.numel() * t.element_size() for s in sets for t in s) / 1e6
    return (time.perf_counter() - t0) * 1e3 / reps, mb


def tp_part(torch, dev):
    """Tensor parallelism on the ranks of ``dp_rank``: ``SharedDis`` at
    nnyu widths (seeded alike on every rank) split over a model axis of
    ``TP_MODEL`` (``make_mesh(world // TP_MODEL, TP_MODEL)``, the data
    rows taking their rows of a batch of ``TP_BATCH``), ``regress_b``
    against the replicated module on the same rows with TF32 off and
    cuDNN deterministic: the forward within ``TP_RTOL`` of the largest
    output, every gradient (the rank's block of a split one) within
    ``TP_RTOL`` relative (Frobenius), the gathered state dict bit for
    bit; each rank's parameter bytes beside the replicated module's, and
    ms per forward of both, timed in turns."""
    import copy

    import torch.distributed as dist

    from lsps_tpu_torch.config import load_config
    from lsps_tpu_torch.models import build_model
    from lsps_tpu_torch.ops import layers as L
    from lsps_tpu_torch.parallel import (DataMesh, gather_state_dict,
                                         make_mesh, shard_state_tp)

    world = DataMesh.from_group(dev)
    hyp = load_config(str(Path(__file__).resolve().parent / "exps"
                          / "nnyu.yaml")).hyperparameters
    mesh = make_mesh(dist.get_world_size() // TP_MODEL, TP_MODEL,
                     device=dev)
    with tf32_off(torch, deterministic=True):
        ref = build_model(hyp["dis"])
        L.reset_parameters(ref, torch.Generator().manual_seed(7))
        ref = ref.to(dev)
        tp = copy.deepcopy(ref)
        dims = shard_state_tp(mesh, tp, TP_MIN_OUT_CH)
        full = gather_state_dict(mesh, tp)
        same = all(torch.equal(full[k], v)
                   for k, v in ref.state_dict().items())
        x = torch.from_numpy(np.random.RandomState(11).uniform(
            -1, 1, (TP_BATCH, 128, 128, 1)).astype(np.float32))
        x = mesh.data.local_rows(x).to(dev)
        outs, grads = [], []
        for m in (ref, tp):
            y = m.regress_b(x)[0]
            grads.append(dict(zip(
                [k for k, _ in m.named_parameters()],
                torch.autograd.grad(y.square().mean(),
                                    list(m.parameters()),
                                    allow_unused=True))))
            outs.append(y.detach())
        fwd = float((outs[1] - outs[0]).abs().max()
                    / outs[0].abs().max())
        grad_rel, split_rel = 0.0, 0.0
        for k, g in grads[1].items():
            w = grads[0][k]
            if w is None:
                if g is not None:
                    raise AssertionError(f"tp: {k} has a gradient")
                continue
            if dims[k] is not None:
                size = w.shape[dims[k]] // mesh.n_model
                w = w.narrow(dims[k], mesh.model_index * size, size)
            rel = float(torch.linalg.norm(g - w) / torch.linalg.norm(w))
            grad_rel = max(grad_rel, rel)
            if dims[k] is not None:
                split_rel = max(split_rel, rel)
        split = [k for k, d in dims.items() if d is not None]
        nbytes = {k: p.numel() * p.element_size()
                  for k, p in tp.named_parameters()}
        ref_bytes = {k: p.numel() * p.element_size()
                     for k, p in ref.named_parameters()}
        times = {"tp": [], "replicated": []}
        with torch.no_grad():
            for _ in range(2):
                tp.regress_b(x), ref.regress_b(x)
            for _ in range(TP_TIMED):
                for name, m in (("tp", tp), ("replicated", ref)):
                    world.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m.regress_b(x)
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
    row = {"mesh": mesh.shape, "data_index": mesh.data_index,
           "model_index": mesh.model_index, "split": split,
           "state_bit_equal": same, "forward_rel": fwd,
           "grad_rel": grad_rel, "split_grad_rel": split_rel,
           "split_bytes": sum(nbytes[k] for k in split),
           "split_bytes_replicated": sum(ref_bytes[k] for k in split),
           "param_bytes": sum(nbytes.values()),
           "param_bytes_replicated": sum(ref_bytes.values()),
           "ms_per_forward": {k: float(np.median(v))
                              for k, v in times.items()},
           "local_batch": int(x.shape[0])}
    if not same or fwd > TP_RTOL or grad_rel > TP_RTOL or \
            len(split) != 6:
        raise AssertionError(f"tp rank {mesh.rank}: {row}")
    return row


def dp_rank(spec_path):
    """One rank of ``phase_dp``, started by ``torch.distributed.run``: the
    trainer at nnyu widths (TF32 off) for ``DP_STEPS`` raw steps at the
    global batch, then the spec's ``depth_train --mesh-data`` runs in the
    same process group; writes what it saw to ``<out>/rank<r>.json``."""
    import gc
    import io

    import torch
    import torch.distributed as dist

    from lsps_tpu_torch.cli import depth_train
    from lsps_tpu_torch.config import load_config
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.parallel import DataMesh, initialize, rank_device
    from lsps_tpu_torch.train import LSPSTrainer

    spec = json.loads(Path(spec_path).read_text())
    ok, reason = initialize(on_cuda=True)
    if not ok:
        raise RuntimeError(f"rank: the process group failed: {reason}")
    try:
        dev = rank_device(True, int(os.environ["LOCAL_RANK"]))
        mesh = DataMesh.from_group(dev)
        # TF32 off and cuDNN deterministic, as (a) and (b) run in the
        # parent: what is left between the ranks and one process is the
        # batch's split
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        hyp = load_config(str(Path(__file__).resolve().parent / "exps"
                              / "nnyu.yaml")).hyperparameters
        sd = seeded_state_dict(hyp, seed=1, nets=("dis", "gen", "vae", "map"))
        out = {"rank": mesh.rank, "backend": mesh.backend,
               "device": str(dev), "card": torch.cuda.get_device_name(dev)}
        trainer = LSPSTrainer(hyp, sd, device=dev, mesh=mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_norm_launches(N)
        out["steps"] = dp_steps(torch, trainer, hyp["vae"]["input_dim"],
                                mesh)
        torch.cuda.synchronize()
        out["launches"] = norm_launches(N)
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        out["allreduce_ms"], out["allreduce_mb"] = allreduce_ms(
            torch, mesh, trainer)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        if spec.get("tp"):
            out["tp"] = tp_part(torch, dev)
            gc.collect()
            torch.cuda.empty_cache()
        out["cli"] = []
        for argv in spec["cli"]:
            buf = io.StringIO()
            zero_norm_launches(N)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf), \
                    unittest.mock.patch.dict(os.environ,
                                             {"LSPS_AUGMENT": "step"}):
                depth_train.main(argv)
            torch.cuda.synchronize()
            out["cli"].append({"wall_s": time.perf_counter() - t0,
                               "launches": norm_launches(N),
                               "stdout": buf.getvalue()[-6000:]})
        Path(spec["out"], f"rank{mesh.rank}.json").write_text(
            json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(spec_path, out_dir, world=DP_WORLD):
    """``python -m torch.distributed.run --nproc-per-node WORLD
    chip_smoke.py --dp-rank SPEC`` in a session of its own, killed whole
    at the deadline; its output into ``out_dir``."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", str(world), "--master-addr", "127.0.0.1",
           "--master-port", str(free_port()),
           str(Path(__file__).resolve()), "--dp-rank", str(spec_path)]
    with open(out_dir / "ranks.out", "w") as fo, \
            open(out_dir / "ranks.err", "w") as fe:
        proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                                stdout=fo, stderr=fe,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=DP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    if rc != 0:
        log((out_dir / "ranks.err").read_text()[-6000:])
        raise AssertionError(f"data-parallel ranks: exit {rc}")


def rel_close(got, want, rtol, what):
    """Every number of ``want`` within ``rtol`` relative of ``got``'s;
    returns the worst relative gap."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if not (math.isfinite(g) and math.isfinite(w)):
            raise AssertionError(f"{what}: {k} not finite ({g}, {w})")
        rel = abs(g - w) / max(abs(w), 1e-12)
        worst = max(worst, rel)
        if rel > rtol:
            raise AssertionError(f"{what}: {k} {g} vs {w}")
    return worst


def first_metrics(log_dir):
    rows = [json.loads(line) for line in next(Path(log_dir).glob(
        "*/metrics.jsonl")).read_text().splitlines()]
    return {k: v for k, v in rows[0].items()
            if "loss" in k or "acc" in k}


def dp_against_one_process(torch, dev, hyp, train_sd, ranks, backend):
    """Part (a) of ``phase_dp`` read from the ranks' files: every rank's
    losses within ``STEP_LOSS_RTOL`` of one process's at the global batch
    (TF32 off, cuDNN deterministic), its parameters rank 0's after every
    step, 44 / 30 IN + LeakyReLU launches per step.  Returns (the worst
    gap by step, one process's steps)."""
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.train import LSPSTrainer

    joint, one_way = in_act_counts(hyp["gen"])
    with tf32_off(torch, deterministic=True):
        single = LSPSTrainer(hyp, train_sd, device=dev)
        zero_norm_launches(N)
        ref = dp_steps(torch, single, hyp["vae"]["input_dim"])
        torch.cuda.synchronize()
        single_launches = norm_launches(N)
        del single
    want = {"in_act_forward": (2 * joint + 2 * one_way) * DP_STEPS,
            "in_act_backward": (joint + 2 * one_way) * DP_STEPS,
            "in_res_forward": 0, "in_res_backward": 0}
    by_step = [0.0] * DP_STEPS
    for r in ranks:
        if r["backend"] != backend:
            raise AssertionError(f"{len(ranks)} ranks: backend "
                                 f"{r['backend']}, want {backend}")
        for k, (got, one) in enumerate(zip(r["steps"], ref)):
            if not got["same_as_rank0"]:
                raise AssertionError(f"rank {r['rank']} step {k}: "
                                     "parameters differ from rank 0's")
            by_step[k] = max(by_step[k], rel_close(
                got["metrics"], one["metrics"], STEP_LOSS_RTOL,
                f"rank {r['rank']} step {k} vs one process"))
        if r["launches"] != want or single_launches != want:
            raise AssertionError(f"rank {r['rank']} launches "
                                 f"{r['launches']}, one process "
                                 f"{single_launches}, want {want}")
    return by_step, ref


def tp_summary(ranks):
    """The ranks' tensor-parallel rows, worst gaps first."""
    rows = [r["tp"] for r in ranks]
    return {"mesh": rows[0]["mesh"], "split": rows[0]["split"],
            "state_bit_equal": all(t["state_bit_equal"] for t in rows),
            "forward_rel": max(t["forward_rel"] for t in rows),
            "grad_rel": max(t["grad_rel"] for t in rows),
            "split_grad_rel": max(t["split_grad_rel"] for t in rows),
            "split_mb": [t["split_bytes"] / 1e6 for t in rows],
            "split_mb_replicated": rows[0]["split_bytes_replicated"] / 1e6,
            "param_mb": [t["param_bytes"] / 1e6 for t in rows],
            "param_mb_replicated": rows[0]["param_bytes_replicated"] / 1e6,
            "ms": [t["ms_per_forward"]["tp"] for t in rows],
            "ms_replicated": [t["ms_per_forward"]["replicated"]
                              for t in rows],
            "local_batch": rows[0]["local_batch"]}


def phase_dp_cards(torch, dev):
    """``python3 chip_smoke.py --dp-cards``: part (a) of ``phase_dp`` with
    one rank on each card of the machine (NCCL), against one process on
    ``dev``; prints each rank's ms per step, peak memory and all-reduce ms
    per step beside the card's name and power limit."""
    import shutil

    from lsps_tpu_torch.config import load_config

    n = torch.cuda.device_count()
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "smoke_dp_cards"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    phase_build()
    (out_dir / "spec.json").write_text(json.dumps({
        "out": str(out_dir), "cli": [], "tp": n % TP_MODEL == 0}))
    t0 = time.perf_counter()
    launch_ranks(out_dir / "spec.json", out_dir, world=n)
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(n)]
    hyp = load_config(str(root / "exps" / "nnyu.yaml")).hyperparameters
    sd = seeded_state_dict(hyp, seed=1, nets=("dis", "gen", "vae", "map"))
    by_step, ref = dp_against_one_process(torch, dev, hyp, sd, ranks,
                                          "nccl" if n > 1 else "gloo")
    row = {"cards": n, "card": gpu_name_and_power(),
           "ranks_wall_s": ranks_s, "global_batch": DP_BATCH,
           "rank_devices": [r["device"] for r in ranks],
           "rank_ms_per_step": [[s["ms"] for s in r["steps"]]
                                for r in ranks],
           "one_process_ms_per_step": [s["ms"] for s in ref],
           "rank_peak_gib": [r["peak_gib"] for r in ranks],
           "allreduce_ms_per_step": [r["allreduce_ms"] for r in ranks],
           "allreduce_mb_per_step": ranks[0]["allreduce_mb"],
           "loss_rel_vs_one_process_by_step": by_step,
           "launches_per_rank_step": [
               {k: v / DP_STEPS for k, v in r["launches"].items()}
               for r in ranks]}
    if n % TP_MODEL == 0:
        row["tensor_parallel"] = tp_summary(ranks)
    log("data-parallel over cards " + json.dumps(row))
    shutil.rmtree(out_dir)
    return 0


def phase_dp(torch, dev, hyp, train_sd, serve_sd, cli_cfg, cli_prefix,
             tmp):
    """Data parallelism at nnyu widths: (a) two ranks sharing the card
    (gloo) against one process at the global batch, TF32 off and cuDNN
    deterministic, every rank's
    parameters bit for bit rank 0's after every step; (b) an NCCL group of
    one rank against the no-mesh trainer; (c) ``depth_train --mesh-data
    2`` under ``torch.distributed.run`` (pretrain, then estimate3 from the
    CLI phase's snapshots with the sharded eval over an odd test set)
    against ``--mesh-data 0`` at the same global batch; (d) a two-replica
    ``PoseEstimator`` against the single one; (e) the IN + LeakyReLU
    launches per rank and step.  Returns (the phase's row, the launches by
    path)."""
    import torch.distributed as dist

    from lsps_tpu_torch.cli import depth_train
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.ops.kernels import warp as WK
    from lsps_tpu_torch.parallel import DataMesh
    from lsps_tpu_torch.serve.inference import PoseEstimator
    from lsps_tpu_torch.train import LSPSTrainer

    t_phase = time.perf_counter()
    reg = hyp["vae"]["input_dim"]
    joint, one_way = in_act_counts(hyp["gen"])
    pre_fwd, pre_bwd = 2 * joint + 2 * one_way, joint + 2 * one_way
    out_dir = tmp / "dp"
    out_dir.mkdir()
    cfg = dp_config(cli_cfg, out_dir)

    def argv(mode, prefix, name, mesh):
        a = ["--config", cfg, "--device", device_flag(dev),
             "--log", str(out_dir / "logs" / name),
             "--snapshot-prefix", str(prefix), "--batch-size",
             str(CLI_BATCH), "--max-iterations", str(DP_CLI_ITERS)]
        a += (["--mode", "pretrain"] if mode == "pretrain" else
              ["--mode", "estimate3", "--frac", "0.5"])
        return a + (["--mesh-data", str(DP_WORLD)] if mesh else [])

    spec = {"out": str(out_dir), "tp": True, "cli": [
        argv("pretrain", out_dir / "mesh" / "pre", "pre_mesh", True),
        argv("estimate3", cli_prefix, "est_mesh", True)]}
    (out_dir / "spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    launch_ranks(out_dir / "spec.json", out_dir)
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(DP_WORLD)]

    # (a) two ranks (gloo: they share the card) against one process
    by_step, ref = dp_against_one_process(torch, dev, hyp, train_sd, ranks,
                                          "gloo")
    worst = max(by_step)

    # (b) an NCCL group of one rank
    with tf32_off(torch, deterministic=True):
        dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                                f"{free_port()}", world_size=1, rank=0)
        try:
            mesh = DataMesh.from_group(dev)
            if mesh.backend != "nccl":
                raise AssertionError(f"NCCL group: backend {mesh.backend}")
            t = LSPSTrainer(hyp, train_sd, device=dev, mesh=mesh)
            zero_norm_launches(N)
            nccl = dp_steps(torch, t, reg, mesh, steps=DP_NCCL_STEPS)
            torch.cuda.synchronize()
            nccl_launches = norm_launches(N)
            del t
        finally:
            dist.destroy_process_group()
    nccl_by_step = [rel_close(g["metrics"], w["metrics"], STEP_LOSS_RTOL,
                              f"NCCL rank step {k} vs no mesh")
                    for k, (g, w) in enumerate(zip(nccl, ref))]
    nccl_worst = max(nccl_by_step)
    if nccl_launches["in_act_forward"] != pre_fwd * DP_NCCL_STEPS or \
            nccl_launches["in_act_backward"] != pre_bwd * DP_NCCL_STEPS:
        raise AssertionError(f"NCCL rank launches {nccl_launches}")

    # (c) the CLIs, --mesh-data 2 against 0 at the same global batch
    with tf32_off(torch, deterministic=True):
        pre0 = run_cli(torch, depth_train, argv(
            "pretrain", out_dir / "single" / "pre", "pre_single", False),
            augment="step")
        est0 = run_cli(torch, depth_train, argv(
            "estimate3", cli_prefix, "est_single", False), augment="step")
    pre_mesh, est_mesh = ranks[0]["cli"]
    if f"data-parallel over {DP_WORLD} ranks (gloo" not in \
            pre_mesh["stdout"]:
        raise AssertionError("cli --mesh-data: no data-parallel line")
    for r in ranks[1:]:
        if any(c["stdout"] for c in r["cli"]):
            raise AssertionError(f"cli --mesh-data: rank {r['rank']} "
                                 "printed")
    cli_pre_rel = rel_close(first_metrics(out_dir / "logs" / "pre_mesh"),
                            first_metrics(out_dir / "logs" / "pre_single"),
                            STEP_LOSS_RTOL, "cli pretrain first iteration")
    cli_est_rel = rel_close(first_metrics(out_dir / "logs" / "est_mesh"),
                            first_metrics(out_dir / "logs" / "est_single"),
                            STEP_LOSS_RTOL, "cli estimate3 first iteration")
    pat = r"Mean err: ([0-9.eE+-]+) "
    e_mesh = stdout_errors(est_mesh["stdout"], pat)
    e_single = stdout_errors(est0["stdout"], pat)
    if len(e_mesh) != 1 or len(e_single) != 1:
        raise AssertionError(f"cli estimate3 evals {e_mesh}, {e_single}")
    eval_rel = rel_close({"err": e_mesh[0]}, {"err": e_single[0]},
                         DP_EVAL_RTOL, "cli estimate3 sharded eval")
    for r in ranks:
        pre_l, est_l = (c["launches"] for c in r["cli"])
        if pre_l["in_act_forward"] < pre_fwd * DP_CLI_ITERS or \
                pre_l["in_act_backward"] < pre_bwd * DP_CLI_ITERS or \
                est_l["in_act_forward"] != joint * DP_CLI_ITERS or \
                est_l["in_act_backward"]:
            raise AssertionError(f"cli rank {r['rank']} launches {pre_l}, "
                                 f"{est_l}")

    # (d) sharded serving: two replicas on the card
    with tf32_off(torch):
        one = PoseEstimator(hyp, serve_sd, device=dev)
        two = PoseEstimator(hyp, serve_sd, devices=(dev, dev))
        frames, coms = hand_frames(DP_BATCH, np.random.RandomState(90))
        cubes = np.full((DP_BATCH, 3), CUBE_MM, np.float32)
        want = one.predict_frames(frames, coms, cubes)
        WK.crop_normalize.launches = 0
        got = two.predict_frames(frames, coms, cubes)
        torch.cuda.synchronize()
        serve_launches = WK.crop_normalize.launches
        del one, two
    serve_err = float((got - want).abs().max())
    if serve_launches != DP_WORLD or serve_err > JOINTS_PLAIN_MM or \
            got.shape != want.shape:
        raise AssertionError(f"sharded serving: {serve_launches} crop "
                             f"launches, {serve_err} mm from the single "
                             "estimator")

    # (e) launches per rank and step
    per_step = [{k: v / DP_STEPS for k, v in r["launches"].items()}
                for r in ranks]
    card = gpu_name_and_power()
    row = {
        "shared_card": f"{DP_WORLD} ranks share one card: not a scaling "
                       "figure",
        "card": card, "ranks_wall_s": ranks_s,
        "rank_ms_per_step": [[s["ms"] for s in r["steps"]] for r in ranks],
        "one_process_ms_per_step": [s["ms"] for s in ref],
        "nccl_rank_ms_per_step": [s["ms"] for s in nccl],
        "rank_peak_gib": [r["peak_gib"] for r in ranks],
        "allreduce_ms_per_step": [r["allreduce_ms"] for r in ranks],
        "allreduce_mb_per_step": ranks[0]["allreduce_mb"],
        "loss_rel_vs_one_process_by_step": by_step,
        "nccl_loss_rel_by_step": nccl_by_step,
        "cli_pretrain_first_rel": cli_pre_rel,
        "cli_estimate3_first_rel": cli_est_rel,
        "cli_eval_mm": {"mesh": e_mesh[0], "single": e_single[0],
                        "rel": eval_rel},
        "cli_rank_wall_s": [[c["wall_s"] for c in r["cli"]] for r in ranks],
        "cli_single_wall_s": [pre0["wall_s"], est0["wall_s"]],
        "serve_two_replicas_mm": serve_err,
        "launches_per_rank_step": per_step,
        "tensor_parallel": tp_summary(ranks),
    }
    row["phase_s"] = time.perf_counter() - t_phase
    tp = row["tensor_parallel"]
    log(f"tensor parallel ({card}; {DP_WORLD} gloo ranks SHARE ONE CARD, "
        f"not a scaling figure): SharedDis nnyu regress_b, mesh "
        f"{tp['mesh']}, {len(tp['split'])} split tensors; forward "
        f"{tp['forward_rel']:.3g}, gradients {tp['grad_rel']:.3g} relative "
        f"(tol {TP_RTOL}); split conv MB per rank {tp['split_mb']} of "
        f"{tp['split_mb_replicated']:.2f}; ms per forward {tp['ms']} "
        f"(replicated {tp['ms_replicated']})")
    log(f"data-parallel ({card}; {DP_WORLD} ranks SHARE ONE CARD, not a "
        f"scaling figure): ranks vs one process at global batch {DP_BATCH}"
        f" losses <= {worst:.3g} relative (tol {STEP_LOSS_RTOL}), "
        f"parameters bit-equal across ranks after each of {DP_STEPS} "
        f"steps; NCCL 1 rank <= {nccl_worst:.3g}; cli first iteration "
        f"{cli_pre_rel:.3g} / {cli_est_rel:.3g}, sharded eval "
        f"{e_mesh[0]:.4f} vs {e_single[0]:.4f} mm; two serving replicas "
        f"{serve_err:.3g} mm, {serve_launches} crop launches; IN + "
        f"LeakyReLU per rank and step {per_step}; ms per step by rank "
        f"{row['rank_ms_per_step']} (one process {row['one_process_ms_per_step']}"
        f"), peak GiB {row['rank_peak_gib']}, all-reduce ms per step "
        f"{row['allreduce_ms_per_step']} over {row['allreduce_mb_per_step']:.1f}"
        f" MB; phase {row['phase_s']:.1f} s")
    launches = {
        f"dp trainer rank {r['rank']} of {DP_WORLD} ({DP_STEPS} "
        f"pretrain_update_raw)": r["launches"] for r in ranks}
    launches[f"dp NCCL 1 rank ({DP_NCCL_STEPS} pretrain_update_raw)"] = \
        nccl_launches
    for r in ranks:
        for name, c in zip(("pretrain", "estimate3"), r["cli"]):
            launches[f"dp cli {name} --mesh-data {DP_WORLD} rank "
                     f"{r['rank']} ({DP_CLI_ITERS} iterations)"] = \
                c["launches"]
    return row, launches, serve_launches


# ---------------------------------------------------------------------------
# the system's own tools: the live demo, checkpoint re-evaluation and the
# parity gate
# ---------------------------------------------------------------------------

TOOLS_FRAMES = 64
TOOLS_CPU_FRAMES = 16    # the host route's first frames again on the CPU
TOOLS_CH = 64            # exps/nnyu.yaml's widths, the demo's default
TOOLS_EVAL_MM = JOINTS_CPU_MM   # a mean error moves at most as its joints
TOOLS_GATE_OFF_MM = 1.0  # --expect this far off must fail the 0.5 mm gate


def avi_frames(path, size):
    """The frame counts of an uncompressed AVI as ``EvalVideoWriter``
    writes it: the main header's, the ``movi`` list's (each chunk ``00db``
    of one top-down BGR frame of ``size``) and the index's.  Raises on a
    malformed file."""
    import struct

    b = Path(path).read_bytes()
    if b[:4] != b"RIFF" or b[8:12] != b"AVI " or \
            struct.unpack("<I", b[4:8])[0] != len(b) - 8:
        raise AssertionError(f"{path}: not a whole RIFF AVI")
    parts, pos = {}, 12
    while pos < len(b):
        tag, n = b[pos:pos + 4], struct.unpack("<I", b[pos + 4:pos + 8])[0]
        body = b[pos + 8:pos + 8 + n]
        parts[body[:4] if tag == b"LIST" else tag] = (
            body[4:] if tag == b"LIST" else body)
        pos += 8 + n + (n & 1)
    if pos != len(b) or not {b"hdrl", b"movi", b"idx1"} <= set(parts):
        raise AssertionError(f"{path}: chunks {sorted(parts)}")
    hdrl, movi, idx = parts[b"hdrl"], parts[b"movi"], parts[b"idx1"]
    total, = struct.unpack("<I", hdrl[8 + 16:8 + 20])
    w, h = struct.unpack("<II", hdrl[8 + 32:8 + 40])
    frame_bytes = (w * 3 + 3) // 4 * 4 * h
    chunks, pos = 0, 0
    while pos < len(movi):
        tag, n = movi[pos:pos + 4], struct.unpack("<I", movi[pos + 4:pos + 8])[0]
        if tag != b"00db" or n != frame_bytes:
            raise AssertionError(f"{path}: movi chunk {tag} of {n} bytes")
        chunks += 1
        pos += 8 + n
    if (w, h) != tuple(size) or len(idx) % 16:
        raise AssertionError(f"{path}: {w} x {h}, index {len(idx)} bytes")
    return {"header": total, "movi": chunks, "index": len(idx) // 16}


def phase_tools(torch, dev, sd, cli_cfg, cli_prefix, real_cfg, tmp):
    """The port's tools (``lsps_tpu_torch/scripts/``) through their
    ``main``, TF32 off: (a) ``realtime_demo`` at ``--ch 64`` over 64 frames
    on the host route and on ``--device-detect``, the crop launch count
    set to 0 just before each run and read just after (one launch a
    frame), each AVI well formed with 64 frames, the joints finite, and the
    host route's first 16 frames on the CPU: its CoMs within the tracking
    phase's bound of the card's (2 px, 3 mm), its joints within 0.05 mm;
    the device route's CoMs within the same bound of the host route's; (b)
    ``eval_checkpoints`` over the CLI phase's ``est_gen`` snapshots (the
    estimate3 run's, with its VAE of frac 2.5), each printed error within
    0.05 mm of the CPU run's on the same snapshots, the datasets made once
    for both; (c) ``parity_gate`` on ``.pkl`` files of the
    serve phase's seeded weights and the real-data phase's NYU
    mini-dataset: 2 for a missing file, 0 with ``--expect`` at the CPU's
    error, 1 with it 1 mm away, the card's error within 0.05 mm of the
    CPU's; the norm kernels' launches counted around the card's runs of
    (b) and (c), none expected.  Returns (a result row, crop launches by
    route, norm launches by path)."""
    import io
    import re
    import tempfile

    import yaml

    from lsps_tpu_torch.cli import common as C
    from lsps_tpu_torch.ops.kernels import norm_act as N
    from lsps_tpu_torch.ops.kernels import warp as WK
    from lsps_tpu_torch.scripts import eval_checkpoints as EC
    from lsps_tpu_torch.scripts import parity_gate as PG
    from lsps_tpu_torch.scripts import realtime_demo as RD

    t_phase = time.perf_counter()
    out_dir = tmp / "tools"
    out_dir.mkdir()
    cpu = torch.device("cpu")
    row = {"frames": TOOLS_FRAMES, "ch": TOOLS_CH}

    def printed(fn, argv):
        buf = io.StringIO()
        try:
            with tf32_off(torch), contextlib.redirect_stdout(buf):
                rc = fn(argv)
        except BaseException:
            log(buf.getvalue()[-4000:])
            raise
        return rc, buf.getvalue()

    # (a) the live demo, each route on the card, the host route on the CPU
    def demo(route, device, frames=TOOLS_FRAMES):
        rec = {"coms": [], "joints": []}
        run = RD.run

        def recording(est, n, device_detect=False, timings=None):
            rec["timings"] = timings
            for com, joints, img in run(est, n, device_detect, timings):
                rec["coms"].append(np.asarray(com, np.float64))
                rec["joints"].append(joints)
                yield com, joints, img

        avi = out_dir / f"demo_{route}_{device.type}.avi"
        argv = ["--frames", str(frames), "--ch", str(TOOLS_CH),
                "--out", str(avi), "--device", device_flag(device)]
        WK.crop_normalize.launches = 0
        t0 = time.perf_counter()
        with unittest.mock.patch.object(RD, "run", recording):
            _, out = printed(RD.main, argv + (
                ["--device-detect"] if route == "device" else []))
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = WK.crop_normalize.launches
        rec["line"] = json.loads(out.strip().splitlines()[-1])
        rec["avi"] = avi_frames(avi, (128, 128))
        rec["coms"], rec["joints"] = (np.stack(rec["coms"]),
                                      np.stack(rec["joints"]))
        return rec

    runs = {"host": demo("host", dev), "device": demo("device", dev),
            "host cpu": demo("host", cpu, TOOLS_CPU_FRAMES)}
    launches = {}
    for name in ("host", "device"):
        r = runs[name]
        launches[f"realtime_demo {name} route ({TOOLS_FRAMES} frames)"] = \
            r["launches"]
        if r["launches"] != TOOLS_FRAMES or \
                set(r["avi"].values()) != {TOOLS_FRAMES} or \
                r["joints"].shape != (TOOLS_FRAMES, 36, 3) or \
                not np.isfinite(r["joints"]).all() or \
                r["line"]["frames"] != TOOLS_FRAMES or \
                r["line"]["device_detect"] != (name == "device"):
            raise AssertionError(f"realtime_demo {name}: {r['launches']} "
                                 f"crop launches, AVI {r['avi']}, joints "
                                 f"{r['joints'].shape}, line {r['line']}")
    gaps = {}
    for name, a, b in (("host card vs cpu", "host", "host cpu"),
                       ("device vs host route", "device", "host")):
        n = min(len(runs[a]["coms"]), len(runs[b]["coms"]))
        g = np.abs(runs[a]["coms"][:n] - runs[b]["coms"][:n])
        gaps[name] = {"du_px": float(g[:, 0].max()),
                      "dv_px": float(g[:, 1].max()),
                      "dz_mm": float(g[:, 2].max())}
        if g[:, :2].max() > TRACK_PX or g[:, 2].max() > TRACK_MM:
            raise AssertionError(f"realtime_demo CoMs, {name}: {gaps[name]} "
                                 f"(bound {TRACK_PX} px, {TRACK_MM} mm)")
    demo_cpu_mm = float(np.abs(runs["host"]["joints"][:TOOLS_CPU_FRAMES]
                               - runs["host cpu"]["joints"]).max())
    if demo_cpu_mm > JOINTS_CPU_MM:
        raise AssertionError(f"realtime_demo joints card vs CPU {demo_cpu_mm}"
                             f" mm (tol {JOINTS_CPU_MM})")
    card = gpu_name_and_power()
    row["demo"] = {name: {
        "detect_ms_median": float(np.median(r["timings"]["detect_ms"])),
        "infer_ms_median": float(np.median(r["timings"]["infer_ms"])),
        "infer_ms_mean": float(np.mean(r["timings"]["infer_ms"])),
        "crop_launches": r["launches"], "avi_frames": r["avi"]["movi"],
        "wall_s": r["wall_s"], "line": r["line"]}
        for name, r in runs.items()}
    row["demo_com_gaps"] = gaps
    row["demo_joints_card_vs_cpu_mm"] = demo_cpu_mm
    for name in ("host", "device"):
        d = row["demo"][name]
        log(f"realtime_demo {name} route ({card}): {TOOLS_FRAMES} frames at "
            f"ch {TOOLS_CH}, detect_ms_median {d['detect_ms_median']}, "
            f"infer_ms_median {d['infer_ms_median']}, crop_normalize "
            f"launches {d['crop_launches']}, AVI frames {d['avi_frames']}, "
            f"wall {d['wall_s']:.1f} s")
    log(f"realtime_demo: CoM gaps {json.dumps(gaps)}, host route joints "
        f"card vs CPU {demo_cpu_mm:.3g} mm (tol {JOINTS_CPU_MM})")

    # (b) re-evaluation of the CLI phase's estimate3 snapshots; both runs
    # evaluate the same datasets, made once
    doc = yaml.safe_load(Path(cli_cfg).read_text())
    doc["train"]["snapshot_prefix"] = str(cli_prefix)
    eval_cfg = out_dir / Path(cli_cfg).name
    eval_cfg.write_text(yaml.safe_dump(doc))
    made, make_datasets = {}, C.make_datasets

    def datasets_once(config):
        if "ds" not in made:
            made["ds"] = make_datasets(config)
        return made["ds"]

    pat = re.compile(r"checkpoint (\S+) \(iteration (\d+)\): Mean err: "
                     r"([0-9.]+) mm, Max over 40mm: ([0-9.]+) %")
    evals, norm_by_path = {}, {}
    for device in (dev, cpu):
        zero_norm_launches(N)
        t0 = time.perf_counter()
        with unittest.mock.patch.object(C, "make_datasets", datasets_once), \
                unittest.mock.patch.object(tempfile, "tempdir",
                                           str(out_dir)):
            _, out = printed(EC.main, [
                "--config", str(eval_cfg), "--frac", "0.5", "--batch-size",
                str(CLI_BATCH), "--device", device_flag(device)])
        torch.cuda.synchronize()
        evals[device.type] = {"lines": pat.findall(out),
                              "wall_s": time.perf_counter() - t0}
        if device == dev:
            norm_by_path["tools eval_checkpoints"] = norm_launches(N)
    want = sorted(p.name for p in Path(cli_prefix).parent.glob(
        "pre_est_gen_*.npz"))
    got, ref = evals[dev.type]["lines"], evals["cpu"]["lines"]
    if [f for f, *_ in got] != want or [f for f, *_ in ref] != want or \
            not want:
        raise AssertionError(f"eval_checkpoints: lines {got} / {ref}, "
                             f"snapshots {want}")
    eval_gaps = [abs(float(g[2]) - float(r[2])) for g, r in zip(got, ref)]
    if max(eval_gaps) > TOOLS_EVAL_MM or any(
            not math.isfinite(float(g[2])) for g in got):
        raise AssertionError(f"eval_checkpoints card vs CPU {got} / {ref} "
                             f"(tol {TOOLS_EVAL_MM} mm)")
    row["eval_checkpoints"] = {
        "snapshots": want, "card": got, "cpu": ref,
        "mean_err_gap_mm": eval_gaps,
        "wall_s": {k: v["wall_s"] for k, v in evals.items()}}
    log(f"eval_checkpoints ({card}): {len(want)} snapshots, card {got}, "
        f"CPU {ref}, mean error gaps {eval_gaps} mm (tol {TOOLS_EVAL_MM})")

    # (c) the parity gate on the seeded serving weights
    pkl = {net: out_dir / name for net, name in (
        ("dis", "pre_dis_00000001.pkl"), ("vae", "pre_vae_2.50_00000001.pkl"))}
    for net, path in pkl.items():
        torch.save({k[len(net) + 1:]: v for k, v in sd.items()
                    if k.startswith(net + ".")}, path)
    gate_pat = re.compile(r"parity_gate: mean err ([0-9.]+) mm")

    def gate(device, *extra, vae=None):
        with contextlib.chdir(out_dir):
            rc, out = printed(PG.main, [
                "--config", str(real_cfg), "--dis", str(pkl["dis"]),
                "--vae", str(vae or pkl["vae"]), "--device",
                device_flag(device), *extra])
        errs = [float(e) for e in gate_pat.findall(out)]
        return rc, out, errs

    t0 = time.perf_counter()
    zero_norm_launches(N)
    rc_missing, out_missing, _ = gate(dev, vae=out_dir / "absent.pkl")
    rc_cpu, _, cpu_err = gate(cpu)
    if len(cpu_err) != 1 or not math.isfinite(cpu_err[0]):
        raise AssertionError(f"parity_gate on the CPU: errors {cpu_err}")
    rc_pass, out_pass, pass_err = gate(dev, "--expect", f"{cpu_err[0]!r}")
    rc_fail, out_fail, fail_err = gate(
        dev, "--expect", f"{cpu_err[0] + TOOLS_GATE_OFF_MM!r}")
    torch.cuda.synchronize()
    norm_by_path["tools parity_gate (2 runs on the card)"] = \
        norm_launches(N)
    # the mode-3 evaluation regresses with dis and decodes with vae: the
    # generator, and so every norm kernel, stays idle
    if any(v for c in norm_by_path.values() for v in c.values()):
        raise AssertionError(f"tools: norm launches {norm_by_path}")
    gate_s = time.perf_counter() - t0
    gate_gap = max((abs(e - cpu_err[0]) for e in pass_err + fail_err),
                   default=None)
    if (rc_missing, rc_cpu, rc_pass, rc_fail) != (2, 0, 0, 1) or \
            not out_missing.startswith("MISSING checkpoints") or \
            "-> PASS" not in out_pass or "-> FAIL" not in out_fail or \
            len(pass_err) != 1 or len(fail_err) != 1 or \
            gate_gap > TOOLS_EVAL_MM:
        raise AssertionError(f"parity_gate: return codes {rc_missing}, "
                             f"{rc_cpu}, {rc_pass}, {rc_fail}; errors CPU "
                             f"{cpu_err}, card {pass_err} / {fail_err}")
    row["parity_gate"] = {"return_codes": {"missing": rc_missing,
                                           "cpu": rc_cpu, "expect cpu":
                                           rc_pass, "expect +1 mm": rc_fail},
                          "mean_err_mm": {"cpu": cpu_err[0],
                                          "card": pass_err[0]},
                          "gap_mm": gate_gap, "wall_s": gate_s}
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"parity_gate ({card}): return codes {row['parity_gate']['return_codes']}"
        f", mean error card {pass_err[0]} vs CPU {cpu_err[0]} mm (tol "
        f"{TOOLS_EVAL_MM}), {gate_s:.1f} s; tools phase {row['phase_s']:.1f} s")
    return row, launches, norm_by_path


def gpu_name_and_power():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lsps_tpu_torch.config import load_config
    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.ops.kernels.warp import crop_normalize
    from lsps_tpu_torch.serve.detect import device_detect_batch

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    cam = Camera.nyu()
    hyp = load_config(str(Path(__file__).resolve().parent / "exps"
                          / "nnyu.yaml")).hyperparameters
    kernels = {"crop_normalize": crop_normalize,
               "device_detect_batch": device_detect_batch}

    # host seconds by phase: the script's time limit is shared by all
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    phase_build()
    mark("build")
    warp_rows, warp_err = phase_warp(torch, dev, cam)
    warp_err = max(warp_err, phase_warp_random(torch, dev, cam))
    mark("warp")
    sd = seeded_state_dict(hyp, seed=0)
    launches, loaded_launches, _ = phase_serve(torch, dev, hyp, sd, kernels)
    com_gap = phase_com(torch, dev, cam)
    detect_rows, detect_gap = phase_detect(torch, dev, cam)
    timing = phase_timing(torch, dev, hyp, sd)
    mark("serve, com, detect, serve timing")
    track_row, track_launches, track_data = phase_track(torch, dev, hyp, sd)
    mark("track")
    plots_row = phase_plots(torch, dev, track_data)
    mark("plots")
    resize_row = phase_resize(torch, dev, hyp, sd, track_data)
    del track_data
    mark("resize")
    common_row = phase_common_net(torch, dev)
    mark("common_net")
    norm_errs = phase_norm(torch, dev)
    log("norm max |kernel - plain|: float32 "
        f"{norm_errs[torch.float32]}, bfloat16 {norm_errs[torch.bfloat16]}")
    train_sd = seeded_state_dict(hyp, seed=1,
                                 nets=("dis", "gen", "vae", "map"))
    train_launches, trainer, train_checks = phase_train(torch, dev, hyp,
                                                        train_sd)
    aug_rows = phase_augment(torch, dev)
    raw_launches, raw_checks = phase_raw_step(torch, dev, hyp, train_sd)
    bf16_launches, bf16_checks = phase_bf16(torch, dev, hyp, train_sd)
    remat_launches, remat_checks = phase_remat(torch, dev, hyp, train_sd)
    scan_launches, scan_checks = phase_scan_ckpt(torch, dev, hyp, train_sd,
                                                 raw_launches)
    mark("norm, train, augment, raw, bf16, remat, scan")
    norm_rows = phase_norm_timing(torch, dev)
    train_rows = phase_train_timing(torch, dev, hyp, trainer)
    del trainer
    raw_rows = phase_raw_timing(torch, dev, hyp, train_sd)
    mark("norm, train and raw timing")
    cli_rows, cli_tmp, cli_cfg, cli_prefix = phase_cli(torch, dev, raw_rows)
    mark("cli")
    real_rows, real_launches, real_tmp, real_cfg = phase_realdata(
        torch, dev, raw_rows)
    mark("realdata")
    tools_row, tools_launches, tools_norm = phase_tools(
        torch, dev, sd, cli_cfg, cli_prefix, real_cfg, cli_tmp)
    shutil.rmtree(real_tmp)
    mark("tools")
    est, daemon_row = phase_daemon(torch, dev, cli_cfg, cli_prefix,
                                   cli_tmp)
    export_launches, export_rows = phase_export(
        torch, dev, est, cli_tmp, serve_config(cli_cfg, cli_prefix))
    del est
    walk_launches, walk_row = phase_walk(torch, dev, cli_cfg, cli_prefix,
                                         cli_tmp)
    mark("daemon, export, walk")
    dp_row, dp_launches, dp_crop_launches = phase_dp(
        torch, dev, hyp, train_sd, sd, cli_cfg, cli_prefix, cli_tmp)
    mark("data parallel")
    shutil.rmtree(cli_tmp)
    path_launches = {"pretrain_update_raw": raw_launches,
                     "pretrain_update bfloat16": bf16_launches,
                     "pretrain_update remat": remat_launches,
                     f"pretrain_scan raw K={SCAN_K}": scan_launches}
    for r in cli_rows:
        path_launches[f"cli {r['run']} ({r['iterations']} iterations)"] = \
            r["launches"]
    path_launches[f"cli latent_walk --steps {WALK_STEPS}"] = walk_launches
    path_launches.update(real_launches)
    path_launches.update(tools_norm)
    path_launches.update(dp_launches)

    log("warp timing " + json.dumps(warp_rows))
    log("detect timing " + json.dumps(detect_rows))
    log("serve timing " + json.dumps(timing))
    log("norm timing " + json.dumps(norm_rows))
    log("train timing " + json.dumps(train_rows))
    log("train checks " + json.dumps(train_checks))
    log("augment timing " + json.dumps(aug_rows))
    log("raw, bf16 and scan timing " + json.dumps(raw_rows))
    log("cli phase " + json.dumps(cli_rows))
    log("realdata phase " + json.dumps(
        {**real_rows, "card": gpu_name_and_power()}))
    log("serving surface " + json.dumps(
        {"com_sweep_worst_z_ulps": com_gap, "daemon": daemon_row,
         "export": export_rows, "latent_walk": walk_row,
         "card": gpu_name_and_power()}))
    log("data-parallel phase " + json.dumps(dp_row))
    log("tools phase " + json.dumps(
        {**tools_row, "card": gpu_name_and_power()}))
    log("tracking phase " + json.dumps(
        {**track_row, "card": gpu_name_and_power()}))
    log("plots phase " + json.dumps(
        {**plots_row, "card": gpu_name_and_power()}))
    log("resize phase " + json.dumps(
        {**resize_row, "card": gpu_name_and_power()}))
    log("common_net phase " + json.dumps(
        {**common_row, "card": gpu_name_and_power()}))
    log("training path checks " + json.dumps(
        {"raw": raw_checks, "bf16": bf16_checks, "remat": remat_checks,
         "scan_ckpt": scan_checks, "launches_by_path": path_launches,
         "card": gpu_name_and_power()}))

    def warp_row(entry, b=32):
        return next(r for r in warp_rows if r["entry"] == entry
                    and r["batch"] == b and r["frames"] == "f32")

    log("library_ms: null for crop_normalize and its loaded-index entry: "
        "no single PyTorch call gathers, clamps and normalizes a crop; "
        "null for detect_coms: no single PyTorch call detects")
    log("library_ms: F.instance_norm for in_act_forward (timed at slope "
        "None, the function it computes; ms_slope_none beside it); null "
        "for in_act_backward, in_res_forward and in_res_backward: no "
        "single PyTorch call computes them")
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "timed_by")
    main_row, loaded_row = warp_row("crop_normalize"), warp_row(
        "warp_normalize")
    rows = [{
        "name": "crop_normalize", "route": "cuda",
        "source": "lsps_tpu_torch/csrc/warp.cu",
        "replaces": "lsps_tpu/ops/pallas/warp.py:42 and :124",
        "launches": launches["crop_normalize"],
        "max_abs_err": warp_err, **{k: main_row[k] for k in keys},
        "library_ms": None,
        # this slice's path: one launch per replica of a sharded call
        "launches_data_parallel": dp_crop_launches,
        "at": "batch 32 float32 frames, 128x128 crops",
        "ms_by_batch": {b: warp_row("crop_normalize", b)["ms"]
                        for b in WARP_BATCHES},
        "bound_ms_by_batch": {b: warp_row("crop_normalize", b)["bound_ms"]
                              for b in WARP_BATCHES},
        # the frames cold in L2, as in serving
        "cold_ms_by_batch": {b: warp_row("crop_normalize", b)["cold_ms"]
                             for b in WARP_BATCHES},
        # launches on each serving path, each read around its own run:
        # one per estimator call, dispatched daemon batch or call of an
        # exported program
        "launches_by_path": {
            "serve phase (predict_frames, predict_raw)":
                launches["crop_normalize"],
            "daemon (micro-batched)": daemon_row["crop_normalize_launches"],
            **{f"exported {k} program": v
               for k, v in export_launches.items()
               if k != "artifact daemon"},
            "artifact daemon": export_launches["artifact daemon"],
            f"sharded serving, {DP_WORLD} replicas on the card (1 call)":
                dp_crop_launches,
            **{f"host tracking: {k}": v for k, v in track_launches.items()},
            **{f"tools: {k}": v for k, v in tools_launches.items()},
            "plots: the card's crop of frame 0": plots_row["crop_launches"]},
        # ms per call of the exported programs beside the live call
        "exported_ms_per_call": {
            k: {"ms": r["ms_per_call"], "live_ms": r["live_ms_per_call"],
                "batch": r["batch"]} for k, r in export_rows.items()},
        # the same kernel with its indices read from memory: the
        # gather-only check, off the main path
        "loaded_indices": {"name": "warp_normalize",
                           "launches_on_main_path": loaded_launches,
                           **{k: loaded_row[k] for k in keys}},
    }]
    detect_row = {r["batch"]: r for r in detect_rows}
    rows.append({
        "name": "detect_coms", "route": "cuda",
        "source": "lsps_tpu_torch/csrc/detect.cu",
        "replaces": "none: lsps_tpu/serve/detect_jax.py is XLA ops, no "
                    "Pallas kernel",
        "launches": launches["device_detect_batch"],
        "kernels_per_call_by_batch": {b: r["kernels_per_call"]
                                      for b, r in detect_row.items()},
        "max_z_gap_ulps": detect_gap,
        "at": "uint16 640x480 frames (the serving cells'), sweep hands",
        "ms_by_batch": {b: r["ms"] for b, r in detect_row.items()},
        "cold_ms_by_batch": {b: r["cold_ms"] for b, r in detect_row.items()},
        # two reads of the frames at the published 3.35 TB/s
        "bound_ms_by_batch": {b: r["bound_ms"]
                              for b, r in detect_row.items()},
        "plain_ms_by_batch": {b: r["plain_ms"]
                              for b, r in detect_row.items()},
        "library_ms": None,
    })
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
            # this slice's path: rank 0 of the two-rank trainer run
            "launches_data_parallel": dp_launches[
                f"dp trainer rank 0 of {DP_WORLD} ({DP_STEPS} "
                "pretrain_update_raw)"][name],
            "at": f"{tuple(r['shape'])} float32 (the batch-"
                  f"{hyp['batch_size']} training path)",
            # launches on this slice's paths, each read around its own
            # run, and the kernel's device ms per bfloat16 batch-32 step
            "launches_by_path": {p: n[name]
                                 for p, n in path_launches.items()},
            "bf16_step_ms": next(
                r[f"{name}_ms"] for r in raw_rows
                if r["update"] == "pretrain_update"
                and r["dtype"] == "bfloat16"
                and r["batch"] == hyp["batch_size"]),
        })
    log("phase seconds " + json.dumps(
        {name: t - prev for (_, prev), (name, t) in zip(marks, marks[1:])}))
    log(json.dumps({"kernels": rows}))
    log(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--detect"]:
        import torch

        from lsps_tpu_torch.data.camera import Camera

        torch.cuda.set_device(0)
        phase_build()
        rows, _ = phase_detect(torch, torch.device("cuda:0"), Camera.nyu())
        log("detect timing " + json.dumps(rows))
        log(gpu_name_and_power())
        sys.exit(0)
    if sys.argv[1:2] == ["--dp-cards"]:
        import torch

        torch.cuda.set_device(0)
        sys.exit(phase_dp_cards(torch, torch.device("cuda:0")))
    sys.exit(main())
