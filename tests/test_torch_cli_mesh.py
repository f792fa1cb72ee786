"""Data-parallel training through the port's CLIs (``--mesh-data 2``).

Counterpart of ``test_cli_mesh.py``'s seven tests, on two gloo ranks on
the CPU: each rank is ``python -m lsps_tpu_torch.cli.<cli> ... --device
cpu --mesh-data 2`` with the environment ``torch.distributed.run`` gives
its workers (``torch_dist.run_ranks``, one deadline that kills both).
The single-process runs they are held against run in this process at the
same global batch.  Metrics within ``RTOL`` / ``ATOL``: float32 convs and
means over half the rows on each rank, then the ranks' mean (a
reduction-order difference, ~5e-7 relative after three steps); eval
errors within ``MM`` (printed to four decimals).

Beyond the JAX package's tests: K=2 scan chunks under two ranks, and the
collapse guard triggering at the same iteration on both ranks (each
rank's guard sees the ranks' averaged accuracies), which then restart
the attempt together.
"""

import json
import os
import re
from contextlib import redirect_stdout
from io import StringIO

import numpy as np
import pytest
import torch

import lsps_tpu_torch.cli.common as C
import lsps_tpu_torch.cli.depth_train as depth_train
import lsps_tpu_torch.cli.pose_train as pose_train
from helpers import make_synth_cfg, read_metrics
from lsps_tpu_torch.parallel import DataMesh
from torch_dist import check_ranks, run_ranks

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
MM = 1e-3
DEPTH_KEYS = ("dis_loss", "gen_total_loss", "gen_ad_loss")


def _cfg(tmp, tag, n_frames=10, **kw):
    return make_synth_cfg(tmp, tag, ch=4, n_frames=n_frames,
                          snapshot_iters=kw.pop("snapshot_iters", 2),
                          image_iters=kw.pop("image_iters", 2), **kw)


def _mesh(cli, argv, env=None, ok=True):
    ranks = run_ranks(["-m", f"lsps_tpu_torch.cli.{cli}", *argv, "--device",
                       "cpu", "--mesh-data", "2"], env=env, timeout=150)
    return check_ranks(ranks) if ok else ranks


def _single(module, argv):
    out = StringIO()
    with redirect_stdout(out):
        module.main(argv + ["--device", "cpu"])
    return out.getvalue()


def _same_metrics(got, want, keys):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for rg, rw in zip(got, want):
        for k in keys:
            np.testing.assert_allclose(rg[k], rw[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {rw['step']}: {k}")


def _depth_pair(tmp_path, tag, extra, env=None, monkeypatch=None,
                **cfg_kw):
    """The same run on two ranks and in one process; their metrics and
    rank 0's / the single run's standard output."""
    runs = {}
    for kind in ("single", "mesh"):
        cfg = _cfg(tmp_path, f"{tag}_{kind}", **cfg_kw)
        log = str(tmp_path / f"logs_{tag}_{kind}")
        argv = ["--config", cfg, "--log", log, *extra]
        if kind == "mesh":
            out = _mesh("depth_train", argv, env=env)[0].stdout
        else:
            for k, v in (env or {}).items():
                monkeypatch.setenv(k, v)
            out = _single(depth_train, argv)
        runs[kind] = (read_metrics(log, cfg), out)
    return runs


def test_depth_pretrain_mesh_cli_matches_single(tmp_path, monkeypatch):
    """depth_train --mode pretrain --mesh-data 2 reproduces the
    single-process losses at the same global batch; rank 0 alone writes
    the snapshots and the metrics."""
    runs = _depth_pair(tmp_path, "pre", ["--mode", "pretrain",
                                         "--max-iterations", "3",
                                         "--batch-size", "4"],
                       monkeypatch=monkeypatch)
    assert len(runs["mesh"][0]) == 3
    _same_metrics(runs["mesh"][0], runs["single"][0], DEPTH_KEYS)
    assert "data-parallel over 2 ranks (gloo" in runs["mesh"][1]
    files = os.listdir(tmp_path / "pre_mesh")
    assert any(f.startswith("pre_gen_00000002") for f in files), files


def test_depth_estimate3_mesh_cli_with_sharded_eval(tmp_path, monkeypatch):
    """estimate3 on two ranks with the sharded eval: a test set of 11
    frames is padded to 12, each rank regresses 6, the gather trims to 11;
    the eval errors and losses are the single process's."""
    runs = _depth_pair(tmp_path, "est", ["--mode", "estimate3", "--frac",
                                         "0.9", "--idx", "0",
                                         "--max-iterations", "2",
                                         "--batch-size", "4"],
                       monkeypatch=monkeypatch, n_frames=11)
    _same_metrics(runs["mesh"][0], runs["single"][0],
                  ("dis_reg_loss", "dis_total_loss"))
    errs = {k: [float(x) for x in re.findall(
        r"Mean err: ([0-9.]+) .*Max over 40mm: ([0-9.]+)", out)[0]]
        for k, (_, out) in runs.items()}
    np.testing.assert_allclose(errs["mesh"], errs["single"], rtol=0, atol=MM)
    images = tmp_path / "est_mesh" / "images"
    assert (images / "gen.avi").is_file() and (images / "_test.png").is_file()


def test_pose_train_mesh_cli_matches_single(tmp_path):
    """pose_train --mesh-data 2: the VAE batch split over the ranks."""
    runs = {}
    for kind in ("single", "mesh"):
        cfg = _cfg(tmp_path, f"p_{kind}")
        log = str(tmp_path / f"logs_p_{kind}")
        argv = ["--config", cfg, "--frac", "0.5", "--log", log,
                "--max-iterations", "4", "--batch-size", "4"]
        if kind == "mesh":
            _mesh("pose_train", argv)
        else:
            _single(pose_train, argv)
        runs[kind] = read_metrics(log, cfg)
    assert len(runs["mesh"]) == 4
    _same_metrics(runs["mesh"], runs["single"], ("vae_total_loss",))


def test_pose_train_mesh_checks_concatenated_batch(tmp_path):
    """With frac > 0 the VAE batch is concat(labels_a, labels_b), 2 *
    batch rows, so --batch-size 1 --mesh-data 2 is a valid run."""
    cfg = _cfg(tmp_path, "pconcat")
    log = str(tmp_path / "logs_pconcat")
    _mesh("pose_train", ["--config", cfg, "--frac", "0.5", "--log", log,
                         "--max-iterations", "2", "--batch-size", "1"])
    assert len(read_metrics(log, cfg)) == 2


def test_depth_pretrain_mesh_plus_step_augment(tmp_path, monkeypatch):
    """--mesh-data 2 with LSPS_AUGMENT=step: each rank augments its rows
    of the raw tuples inside the step; the single run's losses."""
    runs = _depth_pair(tmp_path, "step", ["--mode", "pretrain",
                                          "--max-iterations", "2",
                                          "--batch-size", "4"],
                       env={"LSPS_AUGMENT": "step"}, monkeypatch=monkeypatch)
    assert "LSPS_AUGMENT=step" in runs["mesh"][1]
    assert len(runs["mesh"][0]) == 2
    _same_metrics(runs["mesh"][0], runs["single"][0], DEPTH_KEYS)


def test_depth_pretrain_mesh_scan_chunks(tmp_path, monkeypatch):
    """--steps-per-call 2 on two ranks: each step of a stacked (K, B, ...)
    chunk trains on the ranks' rows of axis 1."""
    runs = _depth_pair(tmp_path, "scan", ["--mode", "pretrain",
                                          "--max-iterations", "4",
                                          "--batch-size", "4",
                                          "--steps-per-call", "2"],
                       monkeypatch=monkeypatch, snapshot_iters=1000,
                       image_iters=1000)
    assert len(runs["mesh"][0]) == 4
    _same_metrics(runs["mesh"][0], runs["single"][0], DEPTH_KEYS)


def test_mesh_indivisible_batch_raises(tmp_path):
    cfg = _cfg(tmp_path, "indiv")
    ranks = _mesh("depth_train", ["--config", cfg, "--mode", "pretrain",
                                  "--log", str(tmp_path / "logs"),
                                  "--max-iterations", "1", "--batch-size",
                                  "3"], ok=False)
    for r in ranks:
        assert r.returncode != 0
        assert "batch size 3 (the global batch) is not divisible by the " \
               "data-mesh size 2" in r.stderr


GUARD_SHIM = r"""
import json, os, sys
import lsps_tpu_torch.cli.depth_train as D
D.FAKE_ACC_DOMINANT = 0.0  # every window dominant: the guard triggers
seen = []
class Guard(D.CollapseGuard):
    def observe(self, iteration, true_acc, fake_acc):
        hit = super().observe(iteration, true_acc, fake_acc)
        seen.append([iteration, true_acc, fake_acc, hit])
        return hit
D.CollapseGuard = Guard
try:
    D.main(sys.argv[2:])
finally:
    with open(os.path.join(sys.argv[1], "guard%s.json" % os.environ["RANK"]),
              "w") as f:
        json.dump(seen, f)
"""


def test_collapse_guard_triggers_on_both_ranks_together(tmp_path):
    """The guard sees the ranks' averaged accuracies, so both ranks
    trigger at the same iteration, discard the aborted attempt's
    snapshots (rank 0 deletes, both wait) and restart together."""
    cfg = _cfg(tmp_path, "guard")
    ranks = check_ranks(run_ranks(
        ["-c", GUARD_SHIM, str(tmp_path), "--config", cfg, "--mode",
         "pretrain", "--log", str(tmp_path / "logs"), "--max-iterations",
         "6", "--batch-size", "4", "--reseed-on-collapse", "1",
         "--collapse-check-iter", "2", "--collapse-reseed-until", "1.0",
         "--device", "cpu", "--mesh-data", "2"], timeout=150))
    seen = [json.loads((tmp_path / f"guard{r}.json").read_text())
            for r in range(2)]
    assert seen[0] == seen[1]
    hits = [row[0] for row in seen[0] if row[3]]
    assert hits == [5, 5]  # the first attempt aborts, the second goes on
    assert "collapse guard: restarting pretrain with seed" in ranks[0].stdout
    assert "discarded 2 snapshot set(s)" in ranks[0].stdout
    assert ranks[1].stdout == ""  # only rank 0 prints


def test_mesh_runner_validation(monkeypatch):
    class Opts:
        mesh_data = 0
        device = "cpu"

    assert C.make_mesh_runner(Opts()) is None
    with pytest.raises(ValueError, match="need >= 2"):
        C.MeshRunner(1, on_cuda=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    launch = ("python -m torch.distributed.run --nproc-per-node 2 -m "
              "lsps_tpu_torch.cli.pose_train ... --mesh-data 2")
    with pytest.raises(ValueError, match=re.escape(launch)):
        C.MeshRunner(2, on_cuda=False, cli="pose_train")
    with pytest.raises(ValueError, match="--nproc-per-node N"):
        C.MeshRunner(-1, on_cuda=False)
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="WORLD_SIZE is 3"):
        C.MeshRunner(2, on_cuda=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="need >= 2"):
        C.MeshRunner(-1, on_cuda=False)
    # a runner over a given mesh: rank 1 of 4
    mr = C.MeshRunner(4, on_cuda=False, mesh=DataMesh(1, 4, "cpu"))
    assert mr.n_data == 4 and not mr.is_main
    mr.check_batch(8)
    with pytest.raises(ValueError, match="not divisible"):
        mr.check_batch(6)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    (xl,), n = mr.place_padded(x)
    assert n == 6
    np.testing.assert_array_equal(xl, x[2:4])
    (xl,), n = C.MeshRunner(4, on_cuda=False,
                            mesh=DataMesh(3, 4, "cpu")).place_padded(x)
    np.testing.assert_array_equal(xl, x[[5, 5]])  # the last row repeated
