"""The live deployment path as a demo, on the port.

The counterpart of ``scripts/realtime_demo.py``: a hand rendered by
``render_hand_depth`` drifts through a stream of NYU-camera depth frames;
each frame is detected, cropped and normalized on the card, regressed to a
pose, and rendered with its skeleton (``utils/viz.vis_pair``) into a video.

* host route (the default): ``HandDetector.detect`` on the first frame,
  then ``refine_com_iterative(com, 3, cube)`` from the last CoM, then
  ``PoseEstimator.predict_frame`` (one ``crop_normalize`` launch a frame);
* ``--device-detect``: ``PoseEstimator.predict_raw(..., return_coms=True)``,
  the CoM detected on the card in the same call.

Usage: ``python -m lsps_tpu_torch.scripts.realtime_demo --frames 32 --out
demo.avi`` (on CUDA device 0; ``--device cpu`` for the CPU).  The nets
have the widths of ``default_hyperparameters(reg_dim=108, ch=--ch)`` and
random weights drawn from a generator seeded with ``SEED`` (the JAX script
draws its own with ``jax.random.PRNGKey(0)``).  The last line is the JAX
script's JSON line, with its keys.

The video is an uncompressed AVI (``utils/viz.EvalVideoWriter``), where
the JAX script writes XVID through cv2: the card's machine has no cv2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch import nn

from lsps_tpu_torch.cli.common import device_of
from lsps_tpu_torch.config import default_hyperparameters
from lsps_tpu_torch.data.augment import normalize
from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.data.detector import HandDetector
from lsps_tpu_torch.data.synthetic import make_pose_basis, render_hand_depth
from lsps_tpu_torch.models import build_model
from lsps_tpu_torch.ops.layers import reset_parameters
from lsps_tpu_torch.serve.inference import PoseEstimator
from lsps_tpu_torch.utils import viz
from lsps_tpu_torch.utils.skeleton import NYU_BONES, NYU_COLOR_IDX

FPS = 25
REFINE_ITERS = 3
SEED = 0


def seeded_weights(hyp, seed: int):
    """``dis.*`` and ``vae.*`` drawn by ``ops.layers.reset_parameters``
    from a generator seeded with ``seed``."""
    nets = nn.ModuleDict({k: build_model(hyp[k]) for k in ("dis", "vae")})
    reset_parameters(nets, torch.Generator().manual_seed(int(seed)))
    return nets.state_dict()


def run(est: PoseEstimator, n_frames: int, device_detect: bool = False,
        timings=None):
    """The demo's loop: yields ``(com, joints, image)`` per frame, the CoM
    (u, v, z) the crop used, the (J, 3) joints in mm and the (128, 128, 3)
    BGR frame of the video.  ``timings``, a dict, gets the lists
    ``detect_ms`` and ``infer_ms`` (host clock, each call's result on the
    host; on ``--device-detect`` detection is inside ``infer_ms`` and
    ``detect_ms`` is 0)."""
    cam = est.camera
    gen = np.random.RandomState(3)
    basis = make_pose_basis(36, np.random.RandomState(7))
    cube = np.array([300.0, 300.0, 300.0], np.float32)
    timings = {} if timings is None else timings
    detect_ms = timings.setdefault("detect_ms", [])
    infer_ms = timings.setdefault("infer_ms", [])
    com = None
    for t in range(n_frames):
        # a hand drifting through the scene
        com3d = np.array([40 * np.sin(t / 6.0), 30 * np.cos(t / 9.0),
                          750 + 60 * np.sin(t / 5.0)], np.float32)
        dpt, _ = render_hand_depth(cam, com3d, 36, gen, pose_basis=basis)

        if device_detect:
            t0 = time.perf_counter()
            joints, coms = est.predict_raw(dpt[None], cube[None],
                                           return_coms=True)
            joints = joints[0].cpu().numpy()
            com = coms[0].cpu().numpy()
            infer_ms.append((time.perf_counter() - t0) * 1e3)
            detect_ms.append(0.0)
            hd = HandDetector(dpt, cam.fx, cam.fy)  # the crop to draw on
        else:
            t0 = time.perf_counter()
            hd = HandDetector(dpt, cam.fx, cam.fy)
            if com is None:
                com, _ = hd.detect(size=tuple(cube))
            else:
                com = hd.refine_com_iterative(com, REFINE_ITERS, tuple(cube))
            detect_ms.append((time.perf_counter() - t0) * 1e3)

            t0 = time.perf_counter()
            joints = est.predict_frame(dpt, com, cube).cpu().numpy()
            infer_ms.append((time.perf_counter() - t0) * 1e3)

        # the crop with the predicted skeleton
        crop, M, com = hd.crop_area_3d(com=com, size=tuple(cube))
        com3d_est = cam.img_to_3d(np.asarray(com, np.float32))
        norm = normalize(crop.copy(), np.asarray(com, np.float32), cube)
        pose_norm = ((joints - com3d_est) / (cube[2] / 2.0)).reshape(-1)
        img = viz.vis_pair(cam, norm[None], pose_norm, M, com3d_est, cube,
                           NYU_COLOR_IDX, NYU_BONES)
        yield com, joints, img


def main(argv=None):
    p = argparse.ArgumentParser(description="LSPS live demo (PyTorch/CUDA)")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--out", type=str, default="./outputs/realtime_demo.avi")
    p.add_argument("--ch", type=int, default=64)
    p.add_argument("--device-detect", action="store_true",
                   help="detect the CoM on the card in the same call "
                        "(PoseEstimator.predict_raw) instead of on the host")
    p.add_argument("--device", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    opts = p.parse_args(argv)
    device = device_of(opts)

    hyp = default_hyperparameters(reg_dim=108, ch=opts.ch)
    est = PoseEstimator(hyp, seeded_weights(hyp, SEED),
                        camera=Camera.nyu(), device=device)

    vid = viz.EvalVideoWriter(opts.out, fps=FPS, size=(128, 128))
    timings = {}
    try:
        for _, _, img in run(est, opts.frames, opts.device_detect, timings):
            vid.write(img)
    finally:
        vid.release()
    print(json.dumps({
        "metric": "realtime_demo",
        "frames": opts.frames,
        "device_detect": bool(opts.device_detect),
        "detect_ms_median": round(float(np.median(timings["detect_ms"])), 2),
        "infer_ms_median": round(float(np.median(timings["infer_ms"])), 3),
        "out": opts.out,
    }))


if __name__ == "__main__":
    main(sys.argv[1:])
