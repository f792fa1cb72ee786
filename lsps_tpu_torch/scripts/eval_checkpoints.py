"""Evaluate saved estimate-mode checkpoints (mean mm error and accuracy),
on the port.

The counterpart of ``scripts/eval_checkpoints.py``: re-runs the depth
CLI's test-set evaluation (``cli.depth_train.evaluate_estimation``,
reference depth_train.py:185-253) over each ``est_gen`` snapshot of an
experiment, oldest first, after loading the VAE of ``2 + frac`` (modes 3
and 4) or of ``frac``.  One line per checkpoint, in the JAX script's
wording.

Usage: ``python -m lsps_tpu_torch.scripts.eval_checkpoints --config
exps/synth_step.yaml --frac 0.9 --bf16`` (on CUDA device 0; ``--device
cpu`` for the CPU).  The evaluation's video and images go to a fresh
temporary directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from lsps_tpu_torch.cli import common as C
from lsps_tpu_torch.cli.depth_train import evaluate_estimation
from lsps_tpu_torch.data.loader import get_data_loader
from lsps_tpu_torch.train.checkpoint import get_model_list


def est_checkpoints(dirname: str):
    """The ``est_gen`` snapshot files of ``dirname``, oldest first."""
    files = []
    i = 0
    while True:
        try:
            f = get_model_list(dirname, "est_gen", i)
        except IndexError:
            break
        if f is None or f in files:
            break
        files.append(f)
        i += 1
    return files


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--frac", type=float, default=0.9)
    p.add_argument("--mode-idx", type=int, default=3)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--batch-size", type=int, default=32,
                   help="training batch size of the run (test batch is "
                        "32x this, as in the CLI)")
    p.add_argument("--device", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    opts = p.parse_args(argv)
    opts.seed = 1
    opts.max_iterations = None
    device = C.device_of(opts)

    Evaluation, color_idx, bones = C.select_eval(opts.config)
    config = C.load_experiment(opts)
    _, dataset_b, dataset_test = C.make_datasets(config)
    trainer = C.make_trainer(config, sch_interval=100, device=device,
                             init_seed=opts.seed, seed=opts.seed)

    vae_frac = 2 + opts.frac if opts.mode_idx in (3, 4) else opts.frac
    if not trainer.load_vae(config.snapshot_prefix, vae_frac):
        raise SystemExit("no VAE checkpoint for frac "
                         f"{vae_frac:.2f} under {config.snapshot_prefix}")
    if 0.0 < opts.frac < 1.0:
        dataset_b.set_nmax(opts.frac)

    test_loader = get_data_loader(dataset_test, opts.batch_size * 32,
                                  shuffle=False, device=device)
    image_dir = tempfile.mkdtemp(prefix="eval_ckpt_")

    dirname = os.path.dirname(config.snapshot_prefix) or "."
    files = est_checkpoints(dirname)
    if not files:
        raise SystemExit(f"no est_gen checkpoints under {dirname}")

    is_nyu = "nyu" in opts.config
    for i, f in enumerate(files):
        # in place: each snapshot overlays the gen and dis the last left
        it = trainer.resume(config.snapshot_prefix, idx=i, est=True)
        err, acc = evaluate_estimation(
            trainer, test_loader, dataset_b.di, Evaluation, color_idx,
            bones, image_dir, opts.mode_idx, is_nyu)
        print(f"checkpoint {os.path.basename(f)} (iteration {it}): "
              f"Mean err: {err:.4f} mm, Max over 40mm: {acc:.2f} %",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
