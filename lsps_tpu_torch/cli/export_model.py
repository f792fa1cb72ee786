"""Export a trained experiment as a deployable ``torch.export`` artifact.

    python -m lsps_tpu_torch.cli.export_model --config exps/nnyu.yaml \
        --est --frac 0.9 --out pose.pt2 [--batch 8 | --symbolic] [--raw] \
        [--bf16] [--device 0|cpu]

The port's counterpart of ``lsps_tpu/cli/export_model.py``: the estimator
is built from the experiment's snapshots as the daemon builds it
(``serve.server.build_estimator``) and its serving program is written as a
PyTorch ``.pt2`` with the weights in it (``serve/export.py``).  The
program runs on the device it was exported on.  ``--platforms`` has no
counterpart and is refused.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export a trained LSPS model to a torch.export artifact")
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--frac", type=float, default=0.0)
    p.add_argument("--est", action="store_true")
    p.add_argument("--idx", type=int, default=-1)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--batch", type=int, default=1,
                   help="static batch size of the exported program")
    p.add_argument("--symbolic", action="store_true",
                   help="symbolic batch dimension (one artifact, any "
                        "batch size)")
    p.add_argument("--raw", action="store_true",
                   help="export the raw-detection program (frames, cubes)"
                        " -> (joints, coms): CoM detection on the device")
    p.add_argument("--frame-shape", type=str, default="480,640")
    p.add_argument("--platforms", type=str, default=None,
                   help="not supported: a torch.export artifact runs on "
                        "the device it was exported on (--device)")
    p.add_argument("--device", "--gpu", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    opts = p.parse_args(argv)
    if opts.platforms is not None:
        p.error("--platforms has no counterpart in the port: the artifact "
                "runs on the device it was exported on; choose it with "
                "--device")

    from lsps_tpu_torch.cli.common import device_of
    from lsps_tpu_torch.serve.export import (export_pose_program,
                                             save_pose_program)
    from lsps_tpu_torch.serve.server import build_estimator

    est = build_estimator(opts.config, frac=opts.frac, est=opts.est,
                          idx=opts.idx, bf16=opts.bf16,
                          device=device_of(opts))
    h, w = (int(x) for x in opts.frame_shape.split(","))
    exported = export_pose_program(
        est, batch=None if opts.symbolic else opts.batch,
        frame_shape=(h, w), raw=opts.raw)
    save_pose_program(opts.out, exported)
    print(f"wrote {opts.out} ({os.path.getsize(opts.out)} bytes, "
          f"device={exported[1]['device']})")


if __name__ == "__main__":
    main(sys.argv[1:])
