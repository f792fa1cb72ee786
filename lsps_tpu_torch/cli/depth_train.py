"""Depth training CLI (README steps 2-3), on the port.

The loop of ``lsps_tpu/cli/depth_train.py`` (reference: src/depth_train.py:
63-265), at the same cadences, in two modes:

* ``--mode pretrain``: the adversarial dual-domain VAE-GAN, one
  ``pretrain_update`` (dis then gen) per iteration (batch 1 unless
  ``--batch-size``), with the collapse guard (``--reseed-on-collapse``,
  ``--rescue-on-collapse``);
* ``--mode estimateN`` (N in 0/1/3/4/5): posterior-regression training
  through ``post_update``, with a periodic test-set eval (mean mm error,
  % frames within 40 mm, ``gen.avi``, ``_test.png``).

With ``LSPS_AUGMENT`` unset or ``host`` the loaders yield images made
per sample on the host, with ``native`` images made per batch by the C++
host library, with ``jax`` images made on the trainer's device; with
``step`` they yield warp parameters and the image work runs inside the step
(``*_raw``).  ``--steps-per-call`` K runs K
steps per ``pretrain_scan`` / ``post_scan`` call (auto: 1).  The draws
come from the trainer's generator, seeded with the attempt's seed + 13
(``cli/common.py``).  Images are PNG where the JAX package writes JPEG;
the video is an uncompressed AVI.

``--mesh-data N`` trains on N ranks, one process each, as ``python -m
torch.distributed.run --nproc-per-node N -m lsps_tpu_torch.cli.depth_train
... --mesh-data N`` starts them: the batch size is the global batch, every
rank trains on its rows, the gradients all-reduce, the test batches are
padded to a multiple of N and their predictions gathered; rank 0 prints and
writes.

Usage: ``python -m lsps_tpu_torch.cli.depth_train --config exps/nnyu.yaml
--mode pretrain``; then ``--mode estimate3 --frac 0.1`` (on CUDA device
0; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from lsps_tpu_torch.cli import common as C
from lsps_tpu_torch.data.augment import denormalize
from lsps_tpu_torch.data.loader import get_data_loader
from lsps_tpu_torch.eval.handpose_evaluation import NYU_RESTRICTED_EVAL
from lsps_tpu_torch.utils import viz
from lsps_tpu_torch.utils.logging import (IMAGE_EXT, MetricsWriter,
                                          prepare_snapshot_and_image_folder,
                                          profile_trace, write_html,
                                          write_loss)

MAX_EPOCHS = 100000

# the threshold is re-exported here so that operators (and tests) can
# retune it at the CLI module
from lsps_tpu_torch.train.gan_health import (  # noqa: E402
    COLLAPSE_CHECK_ITER, FAKE_ACC_DOMINANT, RESEED_WINDOW_FRAC,
    CollapseGuard, RescueController, gan_health_note, overfit_note)


def main(argv=None):
    parser = C.base_parser("LSPS depth VAE-GAN / estimation training "
                           "(PyTorch/CUDA)")
    parser.add_argument("--mode", type=str, required=True,
                        help="pretrain | estimate{0,1,3,4,5}")
    parser.add_argument("--idx", type=int, default=-1,
                        help="pretrain checkpoint index to load")
    parser.add_argument("--reseed-on-collapse", type=int, default=0,
                        metavar="N",
                        help="pretrain only: if the collapse guard "
                        "detects a discriminator-dominant basin, abort "
                        "and restart with a fresh seed, up to N times "
                        "(default 0 = advisory only)")
    parser.add_argument("--collapse-check-iter", type=int,
                        default=COLLAPSE_CHECK_ITER,
                        help="iteration from which the collapse guard "
                        "may trigger")
    parser.add_argument("--collapse-reseed-until", type=float,
                        default=RESEED_WINDOW_FRAC, metavar="FRAC",
                        help="reseed only when the guard triggers within "
                        "the first FRAC of the schedule; later triggers "
                        "stay advisory")
    parser.add_argument("--rescue-on-collapse", type=int, default=0,
                        metavar="N",
                        help="pretrain only: when the collapse guard "
                        "triggers in the early window, freeze the "
                        "discriminator and run generator-only updates "
                        "for --rescue-iters iterations (up to N rescue "
                        "phases) before falling back to the reseed/"
                        "advisory action (default 0 = off)")
    parser.add_argument("--rescue-iters", type=int, default=500,
                        metavar="K",
                        help="length of one generator-only rescue phase")
    opts = parser.parse_args(argv)
    runner = C.make_mesh_runner(opts, "depth_train")
    try:
        with C.rank_output(runner):
            _attempts(opts, runner)
    finally:
        if runner is not None:
            runner.close()


def _attempts(opts, runner):
    """The pretrain attempts (one, or more under the collapse guard's
    reseed); under a mesh every rank takes each attempt together."""
    attempts = max(0, opts.reseed_on_collapse) + 1
    for attempt in range(attempts):
        # a fresh deterministic seed per attempt (9973 is a prime stride)
        seed = opts.seed + 9973 * attempt
        if attempt:
            print(f"collapse guard: restarting pretrain with seed {seed} "
                  f"(attempt {attempt + 1}/{attempts})")
        guard = _run(opts, seed, can_reseed=attempt + 1 < attempts,
                     is_restart=attempt > 0, runner=runner)
        if guard is None:
            return
        print(f"collapse guard: pretrain aborted at iteration "
              f"{guard.triggered_at} (windowed fake acc "
              f"{guard.triggered_fake:.2f} >= {guard.threshold:.2f})")
        # release the aborted attempt's trainer and its device memory
        # before the next attempt builds its own
        import gc
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _discard_attempt_snapshots(orbax_store, attempt_snaps, attempt_orbax):
    """Delete the snapshots a guard-aborted pretrain attempt saved.

    The aborted attempt's weights are a collapsed basin being abandoned;
    leaving them on disk would poison both the in-process reseed (if it
    passed ``--resume 1``) and any later resume of this experiment.
    Only files written by this attempt are touched.  Under a mesh rank 0
    calls it and the other ranks wait at a barrier."""
    import shutil

    nets = ("gen", "dis", "map", "optg", "optd")
    for prefix, it in attempt_snaps:
        for net in nets:
            path = f"{prefix}_{net}_{it:08d}.npz"
            if os.path.exists(path):
                os.remove(path)
    if orbax_store is not None and attempt_orbax:
        orbax_store.wait()
        for step in attempt_orbax:
            path = os.path.join(orbax_store.directory,
                                f"state_{step:08d}")
            if os.path.isdir(path):
                shutil.rmtree(path)
    if attempt_snaps or attempt_orbax:
        print(f"collapse guard: discarded {len(attempt_snaps)} snapshot "
              f"set(s) and {len(attempt_orbax)} orbax step(s) saved by "
              f"the aborted attempt")


def _run(opts, seed, can_reseed=False, is_restart=False, runner=None):
    """One full training run.  Returns None on completion; in pretrain
    with ``can_reseed`` the run aborts and returns its CollapseGuard as
    soon as the guard detects the discriminator-dominant basin.

    ``is_restart`` marks a collapse-guard reseed attempt: the
    ``--resume 1`` snapshot restore is skipped, and the aborted attempt
    deletes the snapshots it saved.  Each attempt builds its own trainer
    (fresh weights and a fresh generator from its seed), so nothing of an
    aborted attempt's state reaches the next.  ``runner``: the
    ``MeshRunner`` of ``--mesh-data``, or None."""
    estimate = "estimate" in opts.mode
    mode_idx = int(opts.mode[-1]) if estimate else -1
    device = C.device_of(opts) if runner is None else runner.mesh.device
    mesh = None if runner is None else runner.mesh
    main_rank = runner is None or runner.is_main

    Evaluation, color_idx, bones = C.select_eval(opts.config)
    config = C.load_experiment(opts)
    hyp = config.hyperparameters

    # batch sizes (depth_train.py:85-86): estimate uses the config batch
    # size, pretrain 1 (UNIT-style); --batch-size overrides both
    batch_size = opts.batch_size or (hyp["batch_size"] if estimate else 1)
    test_batch_size = batch_size * 32
    max_iterations = hyp["max_iterations"]
    frac = opts.frac

    if runner is not None:
        runner.check_batch(batch_size)
    dataset_a, dataset_b, dataset_test = C.make_datasets(config)
    trainer = C.make_trainer(config,
                             sch_interval=opts.sch_interval
                             or (100 if estimate else 1000),
                             device=device, init_seed=seed, seed=seed + 13,
                             mesh=mesh)
    di_b = dataset_b.di

    # optional full-state checkpoints (the JAX package's orbax store)
    orbax_store = None
    if opts.orbax_dir:
        from lsps_tpu_torch.train.checkpoint import FullStateStore

        orbax_store = FullStateStore(opts.orbax_dir)

    iterations = 0
    if opts.resume == 1 and is_restart:
        print("collapse guard: skipping --resume restore on the reseed "
              "attempt (a fresh basin must start from fresh weights)")
    if opts.resume == 1 and not is_restart:
        if orbax_store is not None and orbax_store.latest_step() is not None:
            iterations = orbax_store.restore(trainer)
            print(f"Resumed full state from orbax step {iterations}")
        else:
            iterations = trainer.resume(config.snapshot_prefix, idx=-1,
                                        load_opt=True)

    # the VAE snapshot is a hard dependency of estimate3/4
    # (depth_train.py:118-124)
    try:
        vae_frac = 2 + frac if (estimate and mode_idx in (3, 4)) else frac
        if not trainer.load_vae(config.snapshot_prefix, vae_frac):
            print("Failed to load the parameters of vae")
    except Exception as e:
        print(f"Failed to load the parameters of vae ({e})")

    if estimate:
        if opts.idx != 0:
            trainer.resume(config.snapshot_prefix, idx=opts.idx,
                           est=mode_idx == 5)
        if 0.0 < frac < 1.0:
            dataset_b.set_nmax(frac)
    if runner is not None:
        # every rank read the same snapshots: hold them to rank 0's bits
        trainer.sync_replicas()

    loader_a = get_data_loader(dataset_a, batch_size, shuffle=True,
                               seed=seed, device=device)
    loader_b = get_data_loader(dataset_b, batch_size, shuffle=True,
                               seed=seed + 1, device=device)
    test_loader = get_data_loader(dataset_test, test_batch_size,
                                  shuffle=False, device=device)

    image_dir = snap_dir = None
    writer = C.NoMetrics()
    if main_rank:
        writer = MetricsWriter(os.path.join(
            opts.log, os.path.splitext(os.path.basename(opts.config))[0]))
        image_dir, snap_dir = prepare_snapshot_and_image_folder(
            config.snapshot_prefix, iterations,
            config.image_save_iterations)

    if min(len(dataset_a), len(dataset_b)) < batch_size:
        raise ValueError(
            f"batch_size {batch_size} exceeds dataset sizes "
            f"({len(dataset_a)}, {len(dataset_b)}); every batch would be "
            "skipped (cf. reference depth_train.py:143-144)")

    # fused-in-step augment (LSPS_AUGMENT=step): the loader yields warp
    # parameters and the image work runs inside the training step
    raw_a = bool(getattr(loader_a, "raw", False))
    raw_b = bool(getattr(loader_b, "raw", False))
    if raw_a != raw_b:
        # one dataset declined the 'step' augment, so its loader yields
        # images: the other must too (a step takes two raw tuples or two
        # image batches, never a mix)
        (loader_a if raw_a else loader_b).disable_raw()
        print("LSPS_AUGMENT=step: only one train dataset supports "
              "fused-in-step augmentation; using in-loader augmented "
              "images for both")
    raw_mode = raw_a and raw_b
    if raw_mode:
        print("augmentation fused into the training step "
              "(LSPS_AUGMENT=step)")
    if runner is not None:
        print(runner.describe(f"global batch {batch_size * 2} images/step"))

    # K steps per pretrain_scan / post_scan call (a Python loop over the
    # single steps); near a cadence boundary that K does not divide the
    # loop takes single steps until re-aligned
    steps_per_call = C.resolve_steps_per_call(opts, auto=1)
    chunk_cadences = (config.image_display_iterations,
                      config.image_save_iterations,
                      config.snapshot_save_iterations)

    print(f"using {frac:.2f} percent of the labeled real data")
    best_err, best_acc = 100.0, 0.0
    # the guard's window doubles as the gan_health_note acc tail; its
    # abort action is gated on can_reseed at the trigger site below
    guard = None if estimate else CollapseGuard(
        threshold=FAKE_ACC_DOMINANT,
        check_iter=opts.collapse_check_iter)
    rescue = None
    if not estimate and opts.rescue_on_collapse > 0:
        if steps_per_call > 1:
            print("collapse rescue: --rescue-on-collapse requires the "
                  "single-step loop (gen-only phases switch the update "
                  "per iteration); ignoring")
        else:
            rescue = RescueController(opts.rescue_on_collapse,
                                      phase_iters=opts.rescue_iters)
    err_history = []  # (iteration, mean mm err) per eval, overfit_note
    # snapshots written by this attempt, deleted if the guard aborts it
    attempt_snaps = []  # (prefix, it) pairs
    attempt_orbax = []  # full-state step numbers
    start = time.time()
    pending = []
    n_plan = 0
    with profile_trace(opts.profile_dir if main_rank else None):
        for ep in range(MAX_EPOCHS):
            for batch_a, batch_b in zip(iter(loader_a), iter(loader_b)):
                in_a, labels_a = batch_a[0], batch_a[1]
                in_b, labels_b = batch_b[0], batch_b[1]
                if (labels_a.shape[0] != batch_size
                        or labels_b.shape[0] != batch_size):
                    continue
                if not raw_mode:
                    # NCHW (1, H, W) sample layout -> the trainer's NHWC
                    in_a = np.transpose(in_a, (0, 2, 3, 1))
                    in_b = np.transpose(in_b, (0, 2, 3, 1))

                host_mets = mets = None
                scanned = False
                if steps_per_call > 1:
                    if not pending:
                        n_plan = C.chunk_len(iterations, steps_per_call,
                                             chunk_cadences,
                                             max_iterations)
                    if n_plan == steps_per_call:
                        pending.append((in_a, labels_a, in_b, labels_b))
                        if len(pending) < n_plan:
                            continue
                        xs_a = C.stack_inputs([p[0] for p in pending])
                        xs_b = C.stack_inputs([p[2] for p in pending])
                        ls_a = np.stack([p[1] for p in pending])
                        ls_b = np.stack([p[3] for p in pending])
                        # viz outputs only if the chunk ends on an image
                        # cadence (chunk_len allows no mid-chunk one)
                        end = iterations + n_plan
                        need_viz = (
                            end % config.image_display_iterations == 0
                            or end % config.image_save_iterations == 0)
                        if not estimate:
                            mets, outs = trainer.pretrain_scan(
                                xs_a, ls_a, xs_b, ls_b, raw=raw_mode,
                                with_viz=need_viz)
                        else:
                            mets, outs = trainer.post_scan(
                                xs_a, ls_a, xs_b, ls_b, raw=raw_mode,
                                mode=mode_idx, with_viz=need_viz)
                        if not need_viz:
                            images_a = images_b = None
                        elif raw_mode:
                            # the last step's augmented images
                            outs, images_a, images_b = outs
                        else:
                            images_a = pending[-1][0]
                            images_b = pending[-1][2]
                        pending = []
                        n_done = n_plan
                        scanned = True

                if not scanned:
                    n_done = 1
                    # viz outputs only on the image cadences
                    need_viz = (
                        (iterations + 1) % config.image_display_iterations
                        == 0
                        or (iterations + 1) % config.image_save_iterations
                        == 0)
                    if (rescue is not None
                            and rescue.in_phase(iterations + 1)):
                        # collapse-rescue phase: generator-only step, the
                        # discriminator (parameters and moments) frozen
                        if raw_mode:
                            metrics, outs = trainer.gen_update_raw(
                                in_a, labels_a, in_b, labels_b,
                                with_viz=need_viz)
                        else:
                            metrics, outs = trainer.gen_update(
                                in_a, labels_a, in_b, labels_b)
                    elif raw_mode and not estimate:
                        metrics, outs = trainer.pretrain_update_raw(
                            in_a, labels_a, in_b, labels_b,
                            with_viz=need_viz)
                    elif raw_mode:
                        metrics, outs = trainer.post_update_raw(
                            in_a, labels_a, in_b, labels_b, mode=mode_idx,
                            with_viz=need_viz)
                    elif not estimate:
                        metrics, outs = trainer.pretrain_update(
                            in_a, labels_a, in_b, labels_b,
                            with_viz=need_viz)
                    else:
                        metrics, outs = trainer.post_update(
                            in_a, labels_a, in_b, labels_b, mode=mode_idx,
                            with_viz=need_viz)
                    if not need_viz:
                        images_a = images_b = None
                    elif raw_mode:
                        # raw updates also return the augmented images
                        outs, images_a, images_b = outs
                    else:
                        images_a, images_b = in_a, in_b

                for j in range(n_done):
                    # the 10-panel strip, only on the image cadences (in
                    # a scanned chunk these land on its last step only)
                    if main_rank and (
                            (iterations + 1)
                            % config.image_display_iterations == 0
                            or (iterations + 1)
                            % config.image_save_iterations == 0):
                        assembled = trainer.assemble_outputs(
                            images_a, images_b, outs)
                    else:
                        assembled = None

                    if (iterations + 1) % config.display == 0:
                        if mets is not None:
                            if host_mets is None:
                                host_mets = C.host_metrics(mets)
                            step_metrics = {k: v[j]
                                            for k, v in host_mets.items()}
                        else:
                            step_metrics = metrics
                        write_loss(iterations, max_iterations,
                                   step_metrics, writer,
                                   time.time() - start)
                        start = time.time()
                        if (guard is not None
                                and "dis_fake_acc" in step_metrics
                                and guard.observe(
                                    iterations + 1,
                                    float(step_metrics["dis_true_acc"]),
                                    float(step_metrics["dis_fake_acc"]))):
                            msg = (f"collapse guard: discriminator-"
                                   f"dominant basin detected at "
                                   f"iteration {iterations + 1} "
                                   f"(windowed fake acc "
                                   f"{guard.triggered_fake:.2f})")
                            in_window = ((iterations + 1) <=
                                         opts.collapse_reseed_until
                                         * max_iterations)
                            if (rescue is not None
                                    and not rescue.exhausted
                                    and in_window):
                                end = rescue.start(guard, iterations + 1)
                                print(msg + f"; rescue phase "
                                      f"{rescue.phases_used}/"
                                      f"{rescue.budget}: freezing the "
                                      f"discriminator for gen-only "
                                      f"updates through iteration {end}")
                            elif can_reseed and in_window:
                                print(msg)
                                writer.close()
                                if main_rank:
                                    _discard_attempt_snapshots(
                                        orbax_store, attempt_snaps,
                                        attempt_orbax)
                                if runner is not None:
                                    runner.mesh.barrier()
                                return guard
                            elif can_reseed:
                                done = (iterations + 1) / max_iterations
                                print(msg + "; continuing (past the "
                                      f"reseed window at {done:.0%}"
                                      " of schedule — late borderline "
                                      "dominance is measured-benign, "
                                      "docs/BENCHMARKS.md)")
                            else:
                                print(msg + "; continuing (no "
                                      "--reseed-on-collapse budget)")

                    if main_rank and (
                            (iterations + 1)
                            % config.image_display_iterations == 0):
                        viz.save_image_strip(
                            assembled,
                            os.path.join(image_dir, "gen" + IMAGE_EXT))

                    if (iterations + 1) % config.image_save_iterations == 0:
                        if not estimate and main_rank:
                            viz.save_image_strip(
                                assembled,
                                os.path.join(
                                    image_dir,
                                    f"gen_{iterations + 1:08d}{IMAGE_EXT}"))
                            write_html(os.path.join(snap_dir, "index.html"),
                                       iterations + 1,
                                       config.image_save_iterations,
                                       image_dir)
                        elif estimate:
                            err, acc = evaluate_estimation(
                                trainer, test_loader, di_b, Evaluation,
                                color_idx, bones, image_dir, mode_idx,
                                "nyu" in opts.config, runner)
                            best_err = min(best_err, err)
                            best_acc = max(best_acc, acc)
                            err_history.append((iterations + 1, err))
                            print(f"------------ Mean err: {err:.4f} "
                                  f"({best_err:.4f}) mm, Max over 40mm: "
                                  f"{acc:.2f} ({best_acc:.2f}) %")

                    if (iterations + 1) % config.snapshot_save_iterations \
                            == 0:
                        prefix = (config.snapshot_prefix + "_est"
                                  if estimate else config.snapshot_prefix)
                        trainer.save(prefix, iterations)
                        attempt_snaps.append((prefix, iterations + 1))
                        if orbax_store is not None:
                            orbax_store.save(trainer, iterations + 1)
                            attempt_orbax.append(iterations + 1)

                    iterations += 1
                    if iterations >= max_iterations:
                        writer.close()
                        note = (overfit_note(err_history) if estimate
                                else gan_health_note(
                                    guard.tail,
                                    threshold=FAKE_ACC_DOMINANT))
                        if note:
                            print(note)
                        return None


def evaluate_estimation(trainer, test_loader, di_b, Evaluation, color_idx,
                        bones, image_dir, mode_idx, nyu_protocol,
                        runner=None):
    """Test-set eval (depth_train.py:185-253): regress the posterior
    (``regress_a`` in mode 0, ``regress_b`` otherwise), decode the pose,
    mm metrics, and the video and grid artifacts.  Under a mesh
    (``runner``) each test batch is padded to a multiple of the world,
    every rank regresses and decodes its rows, the predictions are
    gathered and trimmed on every rank, and rank 0 writes the
    artifacts."""
    main_rank = runner is None or runner.is_main
    gt3d, joints = [], []
    img2sav = None
    vid = (viz.EvalVideoWriter(os.path.join(image_dir, "gen.avi"))
           if main_rank else None)
    regress = trainer.dis.regress_a if mode_idx == 0 \
        else trainer.dis.regress_b
    dtype = next(trainer.dis.parameters()).dtype

    first_dpt_mm = first_trans = None
    for tit, batch in enumerate(iter(test_loader)):
        imgs, labels, com, trans, cube = batch[:5]
        if tit == 0 and main_rank:
            # the first frame's metric-mm depth crop for the 3D point-cloud
            # artifact (the inverse of dataset_hand2.py:27-31; background
            # -> 0, which depth_to_pcl drops)
            d = np.asarray(imgs[0, 0], np.float32)
            mm = denormalize(d, np.asarray(com[0]), np.asarray(cube[0]))
            mm[d >= 0.99] = 0.0
            first_dpt_mm, first_trans = mm, np.asarray(trans[0])
        x = np.transpose(imgs, (0, 2, 3, 1))
        if runner is not None:
            (x,), n_valid = runner.place_padded(x)
        with torch.no_grad():
            _, post, _ = regress(torch.as_tensor(x).to(trainer.device,
                                                       dtype))
            pred = trainer.vae.decode(post)
            if runner is not None:
                pred = runner.mesh.gather_rows(pred, n_valid)
            pred = pred.float().cpu().numpy()

        n = labels.shape[0]
        gt_pose = labels.reshape(n, -1, 3)
        pr_pose = pred.reshape(n, -1, 3)

        if tit < 20 and main_rank:
            for i in range(0, n, 4):
                real = viz.vis_pair(di_b.camera, imgs[i],
                                    gt_pose[i].reshape(-1), trans[i],
                                    com[i], cube[i], color_idx, bones)
                est = viz.vis_pair(di_b.camera, imgs[i],
                                   pr_pose[i].reshape(-1), trans[i],
                                   com[i], cube[i], color_idx, bones)
                vid.write_pair(real, est)
            if tit < 8:
                col = np.vstack((real, est))
                img2sav = col if img2sav is None else np.hstack(
                    (img2sav, col))

        if nyu_protocol:  # 14-joint protocol (depth_train.py:231-234)
            gt_pose = gt_pose[:, NYU_RESTRICTED_EVAL]
            pr_pose = pr_pose[:, NYU_RESTRICTED_EVAL]
        for i in range(n):
            gt3d.append(gt_pose[i] * (cube[i, 0] / 2.0) + com[i])
            joints.append(pr_pose[i] * (cube[i, 0] / 2.0) + com[i])

    if img2sav is not None:
        viz.write_png(os.path.join(image_dir, "_test" + IMAGE_EXT),
                      img2sav.astype("uint8"))
    if vid is not None:
        vid.release()

    hpe = Evaluation(np.array(gt3d), np.array(joints))
    mean_err = hpe.getMeanError()
    over_40 = 100.0 * hpe.getNumFramesWithinMaxDist(40) / len(gt3d)
    # the first test frame's point cloud and skeletons (reference
    # plotResult3D, handpose_evaluation.py:488-620)
    if first_dpt_mm is not None:
        hpe.subfolder = image_dir
        try:
            hpe.plotResult3D(first_dpt_mm, first_trans, gt3d[0], joints[0],
                             filename="_test3d", camera=di_b.camera,
                             niceColors=True)
        except Exception as e:
            print(f"3D plot skipped: {e}")
    return mean_err, over_40


if __name__ == "__main__":
    main(sys.argv[1:])
