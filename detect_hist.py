"""Compare the two histograms of the CoM detection on one CUDA card.

    python3 detect_hist.py

Run from the root of the repository, on a machine with a CUDA card, nvcc
and PyTorch built for CUDA.  ``serve/detect.py`` counts the interior
pixels of each depth slice with ``_slice_counts``, a scatter-add into a
tensor of fixed size; ``torch.bincount(bins, minlength=size)`` counts the
same.  For each of the two, on the card, at the nnyu widths with random
weights from a seed and float32 hand frames (``chip_smoke.hand_frames``):

* export: the symbolic-batch uint16 raw program (``serve.export``, traced
  on its example batch of 2), run at batch 3, 2 and 1: whether its CoMs
  equal the live ``predict_raw``'s and its joints' largest gap, or the
  error the batch raised;
* time: ``predict_raw`` at batch 1, 32 and 256, the two histograms in
  turns (bincount, scatter-add, scatter-add, bincount), ms per call on the
  host clock (``chip_smoke.host_ms``, each call ending in a synchronize),
  then the device ms per call from torch.profiler.  The CoMs of the two
  must be equal.

Prints one JSON line per histogram, then the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from chip_smoke import (CUBE_MM, gpu_name_and_power, hand_frames, host_ms,
                        log, phase_build, profile_kernels, seeded_state_dict)

BATCHES = (1, 32, 256)
EXPORT_BATCHES = (3, 2, 1)
ITERS = 20
TURNS = ("bincount", "scatter_add_", "scatter_add_", "bincount")


def bincount_counts(bins, size):
    import torch

    return torch.bincount(bins, minlength=size)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("detect_hist: no CUDA device", file=sys.stderr)
        return 2
    from lsps_tpu_torch.config import load_config
    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.serve import detect
    from lsps_tpu_torch.serve import export as E
    from lsps_tpu_torch.serve.inference import PoseEstimator

    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build()
    hyp = load_config(str(Path(__file__).resolve().parent / "exps"
                          / "nnyu.yaml")).hyperparameters
    est = PoseEstimator(hyp, seeded_state_dict(hyp, seed=0),
                        camera=Camera.nyu(), device=dev)
    frames, _ = hand_frames(8, np.random.RandomState(5))
    n = max(BATCHES)
    f = torch.from_numpy(np.tile(frames, (n // 8, 1, 1))).to(dev)
    u16 = f.round().to(torch.uint16)
    cu = torch.full((n, 3), CUBE_MM, device=dev)
    hists = {"scatter_add_": detect._slice_counts,
             "bincount": bincount_counts}
    rows = {k: {"histogram": k, "export": {}, "ms": {}, "device_ms": {}}
            for k in hists}
    try:
        for name, fn in hists.items():
            detect._slice_counts = fn
            ep, _ = E.export_pose_program(est, batch=None, raw=True,
                                          frame_dtype=torch.uint16)
            program = ep.module()
            for b in EXPORT_BATCHES:
                try:
                    with torch.no_grad():
                        j, c = program(u16[:b], cu[:b])
                except Exception as e:
                    rows[name]["export"][b] = {
                        "error": f"{type(e).__name__}: "
                                 f"{str(e).splitlines()[0]}"}
                    continue
                wj, wc = est.predict_raw(u16[:b], cu[:b], return_coms=True)
                rows[name]["export"][b] = {
                    "coms_equal": bool(torch.equal(c, wc)),
                    "joints_max_abs_mm": float((j - wj).abs().max())}
        for b in BATCHES:
            coms = {}
            for name in TURNS:
                detect._slice_counts = hists[name]
                rows[name]["ms"].setdefault(b, []).append(host_ms(
                    torch, lambda: est.predict_raw(f[:b], cu[:b]), ITERS))
                coms[name] = est.predict_raw(f[:b], cu[:b],
                                             return_coms=True)[1]
            if not torch.equal(coms["bincount"], coms["scatter_add_"]):
                raise AssertionError(f"batch {b}: the histograms give "
                                     f"other CoMs")
            for name, fn in hists.items():
                detect._slice_counts = fn
                rows[name]["device_ms"][b] = profile_kernels(
                    torch, lambda: est.predict_raw(f[:b], cu[:b]))[1]
    finally:
        detect._slice_counts = hists["scatter_add_"]
    for row in rows.values():
        log(json.dumps(row))
    log(gpu_name_and_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
