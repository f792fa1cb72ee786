"""Pose-VAE training CLI (README step 1), on the port.

The loop of ``lsps_tpu/cli/pose_train.py`` (reference: src/pose_train.py:
63-190): trains ``poseVAE`` on sampled 3D poses from domain A (synth) and
a fraction of domain B (real), with a periodic reconstruction-error eval,
a skeleton image and fraction-keyed VAE snapshots, at the same cadences.
``--steps-per-call`` K (auto: 8) runs K steps per ``trainer.vae_scan``
call.  The draws come from the trainer's generator, seeded with
``--seed`` + 7 (``cli/common.py``).  ``--mesh-data N`` trains on N ranks
started by ``python -m torch.distributed.run --nproc-per-node N``: the VAE
batch (``concat(labels_a, labels_b)`` when ``--frac`` > 0) is one global
batch split evenly over the ranks; rank 0 prints, evaluates and writes.

Usage: ``python -m lsps_tpu_torch.cli.pose_train --config exps/nnyu.yaml
--frac 0.1 --log ./logs`` (on CUDA device 0; ``--device cpu`` for the
CPU).  ``LSPS_AUGMENT`` does not apply: the pose loaders yield poses.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from lsps_tpu_torch.cli import common as C
from lsps_tpu_torch.data.loader import get_data_loader
from lsps_tpu_torch.utils import viz
from lsps_tpu_torch.utils.logging import (IMAGE_EXT, MetricsWriter,
                                          prepare_snapshot_and_image_folder,
                                          profile_trace, write_loss)

MAX_EPOCHS = 100000
POSE_MAX_ITERATIONS = 200000  # pose_train.py:82


def main(argv=None):
    parser = C.base_parser("LSPS pose VAE training (PyTorch/CUDA)")
    opts = parser.parse_args(argv)
    runner = C.make_mesh_runner(opts, "pose_train")
    try:
        with C.rank_output(runner):
            _train(opts, runner)
    finally:
        if runner is not None:
            runner.close()


def _train(opts, runner):
    """The training loop; ``runner`` is the ``MeshRunner`` of
    ``--mesh-data``, or None."""
    device = C.device_of(opts) if runner is None else runner.mesh.device
    main_rank = runner is None or runner.is_main

    Evaluation, color_idx, bones = C.select_eval(opts.config)
    config = C.load_experiment(opts)
    hyp = config.hyperparameters

    batch_size = opts.batch_size or hyp["batch_size_pose"]
    max_iterations = (opts.max_iterations or POSE_MAX_ITERATIONS)
    frac = opts.frac
    if runner is not None:
        # the VAE batch is concat(labels_a, labels_b) when frac > 0
        # (pose_train.py:125-130): that is the batch the ranks split
        runner.check_batch(
            2 * batch_size if frac > 0.0 else batch_size,
            what="vae batch size" if frac > 0.0 else "batch size")

    dataset_a, dataset_b, dataset_test = C.make_datasets(config)
    trainer = C.make_trainer(config, sch_interval=opts.sch_interval or 1000,
                             device=device, init_seed=opts.seed,
                             seed=opts.seed + 7,
                             mesh=None if runner is None else runner.mesh)
    iterations = 0

    dataset_a.pose_only = True
    dataset_b.pose_only = True
    if 0.0 < frac < 1.0:
        dataset_b.set_nmax(frac)
    di_b = dataset_b.di

    dataset_a.sample_poses()
    dataset_b.sample_poses()

    loader_a = get_data_loader(dataset_a, batch_size, shuffle=True,
                               seed=opts.seed, device=device)
    loader_b = get_data_loader(dataset_b, batch_size, shuffle=True,
                               seed=opts.seed + 1, device=device)
    test_loader = get_data_loader(dataset_test, 64, shuffle=True,
                                  seed=opts.seed + 2, device=device)

    image_dir = None
    writer = C.NoMetrics()
    if main_rank:
        writer = MetricsWriter(os.path.join(
            opts.log, os.path.splitext(os.path.basename(opts.config))[0]))
        image_dir, _ = prepare_snapshot_and_image_folder(
            config.snapshot_prefix, iterations,
            config.image_save_iterations)

    if min(len(dataset_a), len(dataset_b)) < batch_size:
        raise ValueError(
            f"batch_size {batch_size} exceeds dataset sizes "
            f"({len(dataset_a)}, {len(dataset_b)}); every batch would be "
            "skipped")

    # K steps per trainer.vae_scan call; chunks may END on (never
    # straddle) the eval/snapshot cadences
    steps_per_call = C.resolve_steps_per_call(opts, auto=8)
    state_cadences = (10 * config.image_save_iterations,
                      4 * config.snapshot_save_iterations)

    if runner is not None:
        print(runner.describe("the VAE batch split over the ranks"))
    print(f"using {frac:.2f} percent of the labeled real data")
    start = time.time()
    pending = []
    n_plan = 0
    with profile_trace(opts.profile_dir if main_rank else None):
        for ep in range(MAX_EPOCHS):
            for labels_a, labels_b in zip(iter(loader_a), iter(loader_b)):
                if (labels_a.shape[0] != batch_size
                        or labels_b.shape[0] != batch_size):
                    continue
                labels = labels_a
                if frac > 0.0:
                    labels = np.concatenate([labels_a, labels_b], 0)

                host_mets = mets = None
                if steps_per_call > 1:
                    if not pending:
                        n_plan = C.chunk_len(iterations, steps_per_call,
                                             state_cadences,
                                             max_iterations)
                    if n_plan == steps_per_call:
                        pending.append(labels)
                        if len(pending) < n_plan:
                            continue
                        mets, _ = trainer.vae_scan(np.stack(pending))
                        pending = []
                        n_done = n_plan
                    else:
                        # within K steps of a cadence boundary: single
                        # steps until re-aligned
                        metrics, _ = trainer.vae_update(labels)
                        n_done = 1
                else:
                    metrics, _ = trainer.vae_update(labels)
                    n_done = 1

                for j in range(n_done):
                    if (iterations + 1) % config.display == 0:
                        if mets is not None:
                            if host_mets is None:
                                host_mets = C.host_metrics(mets)
                            metrics = {k: v[j]
                                       for k, v in host_mets.items()}
                        write_loss(iterations, max_iterations, metrics,
                                   writer, time.time() - start)
                        start = time.time()

                    if main_rank and (iterations + 1) % (
                            10 * config.image_save_iterations) == 0:
                        _evaluate(trainer, test_loader, di_b, Evaluation,
                                  color_idx, bones, image_dir)

                    if (iterations + 1) % (4
                                           * config.snapshot_save_iterations
                                           ) == 0:
                        trainer.save_vae(config.snapshot_prefix, iterations,
                                         2 + frac)

                    iterations += 1
                    if iterations >= max_iterations:
                        writer.close()
                        return


def _evaluate(trainer, test_loader, di_b, Evaluation, color_idx, bones,
              image_dir):
    """Reconstruction-error eval (pose_train.py:143-182): decode(mu) on
    test poses, mm error against gt, skeleton grid image."""
    gt3d, joints = [], []
    img2sav = None
    shown = 0
    vae = trainer.vae
    dtype = next(vae.parameters()).dtype
    for batch in test_loader:
        imgs, labels, com, trans, cube = batch[:5]
        with torch.no_grad():
            y = torch.as_tensor(labels).to(trainer.device, dtype)
            # decode(mu): deterministic reconstruction (pose_train.py:155)
            pred = vae.decode(vae.encode(y)[1]).float().cpu().numpy()
        n = labels.shape[0]
        for i in range(n):
            gt3d.append(labels[i].reshape(-1, 3) * (cube[i, 0] / 2.0)
                        + com[i])
            joints.append(pred[i].reshape(-1, 3) * (cube[i, 0] / 2.0)
                          + com[i])
        if shown < 8:
            real = viz.vis_pair(di_b.camera, imgs[0], labels[0], trans[0],
                                com[0], cube[0], color_idx, bones)
            est = viz.vis_pair(di_b.camera, imgs[0], pred[0], trans[0],
                               com[0], cube[0], color_idx, bones)
            col = np.vstack((real, est))
            img2sav = col if img2sav is None else np.hstack((img2sav, col))
            shown += 1
    if img2sav is not None:
        viz.write_png(os.path.join(image_dir, "_test" + IMAGE_EXT),
                      img2sav.astype("uint8"))
    hpe = Evaluation(np.array(gt3d), np.array(joints))
    print(f"Mean error: {hpe.getMeanError()}mm, "
          f"max error: {hpe.getMaxError()}mm")
    return hpe


if __name__ == "__main__":
    main(sys.argv[1:])
