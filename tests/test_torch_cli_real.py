"""The port's training CLIs for real, on the CPU.

``exps/synth.yaml`` at tiny widths and a few iterations (``--device
cpu``): the files ``pose_train``, ``depth_train --mode pretrain`` and
``--mode estimate3`` write, snapshots that the JAX package's trainer
loads through its own ``resume`` and ``load_vae``, ``--steps-per-call
4`` leaving the snapshots of 1 bit for bit, the full-state store behind
``--orbax-dir``, and the collapse guard's in-process reseed leaving what
a fresh run from the reseeded seed leaves.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from helpers import make_synth_cfg, read_metrics
from test_torch_cli import _cfg

import lsps_tpu_torch.cli.depth_train as pdepth
import lsps_tpu_torch.cli.pose_train as ppose

torch.set_num_threads(1)


def _real(module, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        module.main(argv + ["--device", "cpu"])
    return out.getvalue()


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _snapshots(directory):
    return {n: _npz(directory / n) for n in sorted(os.listdir(directory))
            if n.endswith(".npz")}


REAL_CADENCES = dict(display=2, image_display_iterations=4,
                     image_save_iterations=4, snapshot_save_iterations=4)


@pytest.fixture(scope="module")
def real_runs(tmp_path_factory):
    """pose_train, pretrain and estimate3 of the port for real (tiny
    widths, a few iterations), then pretrain again at --steps-per-call 4.
    Returns the directory and each run's stdout."""
    tmp = tmp_path_factory.mktemp("real")
    cfg = _cfg(tmp, "run", **REAL_CADENCES)
    log = ["--config", cfg, "--log", str(tmp / "logs")]
    outs = {
        "pose": _real(ppose, log + ["--frac", "0.5", "--max-iterations",
                                    "40", "--batch-size", "8"]),
        "pretrain": _real(pdepth, log + ["--mode", "pretrain",
                                         "--max-iterations", "8",
                                         "--batch-size", "2"]),
        "estimate3": _real(pdepth, log + ["--mode", "estimate3",
                                          "--frac", "0.5",
                                          "--max-iterations", "4",
                                          "--batch-size", "2"]),
        "pretrain_spc4": _real(pdepth, log + [
            "--mode", "pretrain", "--max-iterations", "8", "--batch-size",
            "2", "--steps-per-call", "4", "--snapshot-prefix",
            str(tmp / "spc4" / "pre")]),
        "pretrain_spc1": _real(pdepth, log + [
            "--mode", "pretrain", "--max-iterations", "8", "--batch-size",
            "2", "--steps-per-call", "1", "--snapshot-prefix",
            str(tmp / "spc1" / "pre")]),
    }
    return tmp, cfg, outs


def test_real_runs_write_their_files(real_runs):
    tmp, cfg, outs = real_runs
    run = tmp / "run"
    names = set(os.listdir(run))
    assert {"pre_vae_2.50_00000016.npz", "pre_vae_2.50_00000032.npz",
            "index.html"} <= names
    for net in ("gen", "dis", "map", "optg", "optd"):
        assert {f"pre_{net}_00000004.npz", f"pre_{net}_00000008.npz",
                f"pre_est_{net}_00000004.npz"} <= names
    images = set(os.listdir(run / "images"))
    assert {"_test.png", "gen.png", "gen_00000004.png", "gen_00000008.png",
            "gen.avi"} <= images
    rows = read_metrics(str(tmp / "logs"), cfg)
    assert any("vae_total_loss" in r for r in rows)
    assert any("dis_fake_acc" in r and "gen_total_loss" in r for r in rows)
    assert any("dis_reg_loss" in r for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert "Mean error:" in outs["pose"]
    assert "Loading pretrained VAE parameters" in outs["estimate3"]
    assert "Resume from iteration 8" in outs["estimate3"]
    assert "------------ Mean err:" in outs["estimate3"]
    # the gallery of a pretrain run (estimate3 rewrote the one above)
    html = (tmp / "spc1" / "index.html").read_text()
    assert "gen_00000008.png" in html and ".jpg" not in html


def test_real_snapshots_load_into_the_jax_trainer(real_runs):
    """The port's snapshots through the JAX trainer's own resume and
    load_vae, against the same files through the port's."""
    from lsps_tpu.config import NetConfig as JaxConfig
    from lsps_tpu.train.trainer import LSPSTrainer as JaxTrainer
    import jax

    from lsps_tpu_torch.config import NetConfig
    from lsps_tpu_torch.train import LSPSTrainer
    from lsps_tpu_torch.train.checkpoint import flatten, net_arrays
    from lsps_tpu_torch.train.trainer import fresh_state_dict

    tmp, cfg, _ = real_runs
    prefix = str(tmp / "run" / "pre")
    jt = JaxTrainer(JaxConfig(cfg).hyperparameters)
    state = jt.init_state(jax.random.PRNGKey(0))
    state, it = jt.resume(state, prefix, idx=-1, load_opt=True)
    state, ok = jt.load_vae(state, prefix, 2.5)
    assert it == 8 and ok
    hyp = NetConfig(cfg).hyperparameters
    pt = LSPSTrainer(hyp, fresh_state_dict(hyp, 1), device="cpu")
    assert pt.resume(prefix, load_opt=True) == 8
    assert pt.load_vae(prefix, 2.5)
    for net in ("gen", "dis", "map", "vae"):
        want = flatten(jax.device_get(state["params"][net]))
        got = net_arrays(pt.nets[net])
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(state["opt"]["gen"][1].count) == pt.gen_opt.count == 8


def test_real_steps_per_call_leaves_the_same_snapshots(real_runs):
    tmp, _, outs = real_runs
    a, b = _snapshots(tmp / "spc1"), _snapshots(tmp / "spc4")
    assert sorted(a) == sorted(b) and len(a) == 10
    for name in a:
        assert a[name].keys() == b[name].keys()
        for k in a[name]:
            np.testing.assert_array_equal(a[name][k], b[name][k],
                                          err_msg=f"{name} {k}")


def test_full_state_store_resumes_the_full_state(tmp_path):
    """``--orbax-dir``'s store: a restored trainer equals the saved one in
    nets, optimizers (moments and both counts), draw generator and step,
    and takes the same next step; then the CLI resumes from it."""
    from lsps_tpu_torch.config import NetConfig
    from lsps_tpu_torch.train import LSPSTrainer
    from lsps_tpu_torch.train.checkpoint import FullStateStore
    from lsps_tpu_torch.train.trainer import fresh_state_dict

    cfg = _cfg(tmp_path, "orbax", **REAL_CADENCES)
    hyp = NetConfig(cfg).hyperparameters
    rs = np.random.RandomState(0)
    batch = [rs.uniform(-1, 1, (2, 128, 128, 1)).astype(np.float32),
             rs.uniform(-0.3, 0.3, (2, 108)).astype(np.float32)] * 2
    a = LSPSTrainer(hyp, fresh_state_dict(hyp, 3), device="cpu", seed=5)
    a.pretrain_update(*batch, with_viz=False)
    a.vae_update(batch[1])
    store = FullStateStore(str(tmp_path / "full"))
    store.save(a, 2)
    b = LSPSTrainer(hyp, fresh_state_dict(hyp, 4), device="cpu", seed=6)
    assert store.latest_step() == 2 and store.restore(b) == 2
    assert b.step == a.step
    for x, y in zip(a.nets.state_dict().values(),
                    b.nets.state_dict().values()):
        assert torch.equal(x, y)
    for name in ("dis_opt", "gen_opt", "vae_opt"):
        oa, ob = getattr(a, name), getattr(b, name)
        assert (oa.count, oa.sched_count) == (ob.count, ob.sched_count)
        assert all(torch.equal(x, y) for x, y in zip(oa.mu + oa.nu,
                                                     ob.mu + ob.nu))
    ma, _ = a.pretrain_update(*batch, with_viz=False)
    mb, _ = b.pretrain_update(*batch, with_viz=False)
    assert all(torch.equal(ma[k], mb[k]) for k in ma if k.endswith("loss"))

    log = ["--config", cfg, "--log", str(tmp_path / "logs"), "--mode",
           "pretrain", "--batch-size", "2", "--orbax-dir",
           str(tmp_path / "cli_full")]
    _real(pdepth, log + ["--max-iterations", "4"])
    assert os.listdir(tmp_path / "cli_full") == ["state_00000004"]
    out = _real(pdepth, log + ["--max-iterations", "6", "--resume", "1"])
    assert "Resumed full state from orbax step 4" in out
    assert sorted(os.listdir(tmp_path / "cli_full")) == ["state_00000004"]


def test_real_reseed_leaks_nothing_into_the_next_attempt(tmp_path,
                                                         monkeypatch):
    """A reseeded attempt (threshold forced to -1, so attempt 1 aborts)
    leaves the snapshots a fresh run from the reseeded seed leaves, bit
    for bit: nothing of the aborted attempt's trainer, generator or
    loaders reaches the next."""
    monkeypatch.setattr(pdepth, "FAKE_ACC_DOMINANT", -1.0)
    cfg = make_synth_cfg(tmp_path, "reseed_real", snapshot_iters=6,
                         display=1)
    common = ["--config", cfg, "--log", str(tmp_path / "logs"), "--mode",
              "pretrain", "--max-iterations", "6", "--batch-size", "2"]
    out = _real(pdepth, common + [
        "--reseed-on-collapse", "1", "--collapse-check-iter", "1",
        "--collapse-reseed-until", "1",
        "--snapshot-prefix", str(tmp_path / "reseeded" / "pre")])
    assert "restarting pretrain with seed 33428" in out
    monkeypatch.setattr(pdepth, "FAKE_ACC_DOMINANT", 2.0)
    _real(pdepth, common + ["--seed", str(23455 + 9973),
                            "--snapshot-prefix",
                            str(tmp_path / "fresh" / "pre")])
    a = _snapshots(tmp_path / "reseeded")
    b = _snapshots(tmp_path / "fresh")
    assert sorted(a) == sorted(b) and len(a) == 5
    for name in a:
        for k in a[name]:
            np.testing.assert_array_equal(a[name][k], b[name][k],
                                          err_msg=f"{name} {k}")
