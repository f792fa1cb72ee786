"""Latent-walk generative sampler CLI, on the port.

The port's counterpart of ``lsps_tpu/cli/latent_walk.py``: resume the
experiment's latest snapshots, encode the first two test crops into the
shared latent space (the first through domain A's encoder, the second
through domain B's), interpolate, and decode the path through both domain
decoders (``serve.inference.latent_walk``, the generator in eval mode),
writing a video of the walk and a PNG strip of its domain-A frames.

Usage: ``python -m lsps_tpu_torch.cli.latent_walk --config
exps/synth.yaml --steps 16 --out walk.avi`` (on CUDA device 0;
``--device cpu`` for the CPU).

The video is an uncompressed AVI (``utils/viz.EvalVideoWriter``) and the
strip ``<out>_strip.png`` is written by ``utils/viz.write_png``, where the
JAX CLI writes XVID through cv2: the card's machine has no cv2.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from lsps_tpu_torch.cli import common as C
from lsps_tpu_torch.serve.inference import eval_mode, latent_walk
from lsps_tpu_torch.utils import viz

FPS = 8


def _gray(x: np.ndarray) -> np.ndarray:
    """(H, W, 1) in [-1, 1] -> uint8 (H, W), as the JAX CLI scales it."""
    return ((x[..., 0] + 1) * 127.5).astype("uint8")


def main(argv=None):
    parser = C.base_parser("LSPS latent walk (PyTorch/CUDA)")
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--out", type=str, default="walk.avi")
    parser.add_argument("--idx", type=int, default=-1)
    opts = parser.parse_args(argv)
    device = C.device_of(opts)

    config = C.load_experiment(opts)
    trainer = C.make_trainer(config, sch_interval=1000, device=device,
                             init_seed=opts.seed, seed=opts.seed)
    it = trainer.resume(config.snapshot_prefix, idx=opts.idx)
    if it == 0:
        print("warning: no checkpoint found, walking an untrained model")

    _, _, dataset_test = C.make_datasets(config)
    i0, i1 = 0, min(1, len(dataset_test) - 1)
    gen = trainer.gen
    dtype = next(gen.parameters()).dtype
    img0, img1 = (torch.from_numpy(np.transpose(dataset_test[i][0],
                                                (1, 2, 0))[None])
                  .to(device=device, dtype=dtype) for i in (i0, i1))
    with eval_mode(gen), torch.no_grad():
        z0, z1 = gen.encode(img0, img1)
    out_a, out_b = latent_walk(gen, z0[0], z1[0], steps=opts.steps)
    out_a = out_a.float().cpu().numpy()
    out_b = out_b.float().cpu().numpy()

    h, w = out_a.shape[1:3]
    vid = viz.EvalVideoWriter(opts.out, fps=FPS, size=(2 * w, h))
    for a, b in zip(out_a, out_b):
        vid.write(np.repeat(np.hstack([_gray(a), _gray(b)])[..., None], 3,
                            2))
    vid.release()
    viz.write_png(os.path.splitext(opts.out)[0] + "_strip.png",
                  np.hstack([_gray(a) for a in out_a]))
    print(f"wrote {opts.out} ({opts.steps} steps)")


if __name__ == "__main__":
    main(sys.argv[1:])
