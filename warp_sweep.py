"""Sweep the crop-warp kernel's build parameters on one CUDA card.

    python3 warp_sweep.py

Run from the root of the repository, on a machine with a CUDA card, nvcc
and PyTorch built for CUDA.  Builds ``lsps_tpu_torch/csrc/warp.cu`` once
for each block shape (rows per thread x threads per block), through its
``LSPS_WARP_*`` macros, all builds started together; checks each build's
``crop_normalize`` bit-equal to the plain version at batch 32; then times
it on float32 frames (``chip_smoke.warp_batch``) at batch 1, 32 and 256:
the kernel's device ms from torch.profiler,

* warm: the same frames every call, as ``chip_smoke.py`` times the kernel
  (at batch 256 the sectors a crop touches, ~31 MB, fit in the 50 MB L2);
* cold: the calls rotate over copies of the frames
  (``chip_smoke.rotating``), so that each call's frames were last read
  more than L2's size ago, as in serving, where every call brings new
  frames.

Prints one JSON line per build and the card's name and power limit.  The
package builds the kernel with the shape the sweep chose (PERF.md holds
the table).
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys
import unittest.mock
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import (WARP_BATCHES, gpu_name_and_power, kernel_device_ms,
                        log, rotating, same_bits, warp_batch)

ROWS = (1, 2, 4, 8, 16)
THREADS = (128, 256, 512)


def variants():
    return [(rpt, threads) for rpt in ROWS for threads in THREADS]


def defines(rpt, threads):
    return (f"LSPS_WARP_ROWS_PER_THREAD={rpt}",
            f"LSPS_WARP_THREADS={threads}")


def load(path):
    from lsps_tpu_torch.ops.kernels import warp as WK

    lib = ctypes.CDLL(str(path))
    for name, argtypes in WK._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def kernel_ms(torch, fn, iters):
    ms = kernel_device_ms(torch, fn, "crop_warp_kernel", iters)
    if not ms:
        raise RuntimeError("the profiler saw no crop_warp_kernel")
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("warp_sweep: no CUDA device", file=sys.stderr)
        return 2
    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.ops.kernels import build
    from lsps_tpu_torch.ops.kernels import warp as WK

    dev = torch.device("cuda:0")
    cam = Camera.nyu()
    with ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(lambda v: build.compile_source(
            "warp", defines(*v)), variants()))
    log(f"built {len(paths)} variants of warp.cu")

    inputs = {}
    for b in WARP_BATCHES:
        frames, coms, cubes = (torch.from_numpy(a).to(dev)
                               for a in warp_batch(b, seed=100 + b))
        inputs[b] = (frames, rotating(frames), coms, cubes)
    frames, _, coms, cubes = inputs[32]
    want, want_M = WK.crop_normalize_reference(frames, coms, cubes, cam.fx,
                                               cam.fy)

    for (rpt, threads), path in zip(variants(), paths):
        lib = load(path)
        row = {"rows_per_thread": rpt, "threads": threads}
        with unittest.mock.patch.object(WK, "_library", lambda: lib):
            crops, Ms = WK.crop_normalize(frames, coms, cubes, cam.fx,
                                          cam.fy)
            torch.cuda.synchronize()
            if not (same_bits(torch, crops, want)
                    and same_bits(torch, Ms, want_M)):
                raise AssertionError(f"variant {row} != plain version")
            for b, (ft, (n, turn), c, cu) in inputs.items():
                row[f"B{b}_warm_ms"] = kernel_ms(torch, functools.partial(
                    WK.crop_normalize, ft, c, cu, cam.fx, cam.fy), 20)
                row[f"B{b}_cold_ms"] = kernel_ms(
                    torch, lambda: WK.crop_normalize(next(turn), c, cu,
                                                     cam.fx, cam.fy),
                    max(20, n))
        log("sweep " + json.dumps(row))
    log(gpu_name_and_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
