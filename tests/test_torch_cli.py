"""The port's training CLIs drive the trainer as the JAX package's do.

1. With a recording stand-in for the trainer in both packages'
   ``cli.common.make_trainer`` (the trainer's methods, fixed metrics and
   outputs, nothing compiled) and the two eval functions stubbed, the
   port's ``pose_train`` / ``depth_train`` make the same trainer calls as
   the JAX package's: method, iteration, chunk length, bit-equal inputs
   (stacked chunks included), the same save / save_vae / resume /
   load_vae arguments and eval iterations, under ``LSPS_AUGMENT`` step
   and jax and at ``--steps-per-call`` 1 and 4.
2. The collapse guard's wiring, as ``tests/test_collapse_guard.py`` holds
   the JAX package's, with both CLIs driven into the dominant basin from
   the same inputs: the same calls, the same snapshot sets discarded, the
   same files left, the same guard messages and the same seed per
   attempt.

The CLIs for real are ``tests/test_torch_cli_real.py``.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import yaml

from helpers import make_synth_cfg, read_metrics

import lsps_tpu.cli.common as jcommon
import lsps_tpu.cli.depth_train as jdepth
import lsps_tpu.cli.pose_train as jpose
import lsps_tpu_torch.cli.common as pcommon
import lsps_tpu_torch.cli.depth_train as pdepth
import lsps_tpu_torch.cli.pose_train as ppose

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMINANT = 0.99  # a discriminator-dominant fake accuracy


def _cfg(tmp, tag, frames_a=8, **train):
    """exps/synth.yaml with small datasets and the given cadences."""
    with open(os.path.join(REPO, "exps", "synth.yaml")) as f:
        doc = yaml.safe_load(f)
    doc["train"].update(train)
    doc["train"]["snapshot_prefix"] = str(tmp / tag / "pre")
    for name, n in (("train_a", frames_a), ("train_b", 8), ("test_b", 4)):
        doc["train"]["datasets"][name]["n_frames"] = n
        doc["train"]["datasets"][name]["sample_poses"] = 300
    hyp = doc["train"]["hyperparameters"]
    hyp["gen"]["ch"] = hyp["dis"]["ch"] = 4
    path = tmp / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(doc))
    return str(path)


# cadences that let chunks of 4 align, and fire within 25 iterations
POSE_CADENCES = dict(display=2, image_display_iterations=3,
                     image_save_iterations=2, snapshot_save_iterations=3)
DEPTH_CADENCES = dict(display=2, image_display_iterations=4,
                      image_save_iterations=8, snapshot_save_iterations=12)


# ---------------------------------------------------------------------------
# the recording stand-ins
# ---------------------------------------------------------------------------

def _host(x):
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _metrics(method, fake_acc):
    if method.startswith("vae"):
        return {"vae_total_loss": 1.5, "vae_lr": 1e-3}
    if method.startswith("post"):
        return {"dis_reg_loss": 0.5, "dis_total_loss": 0.6, "dis_lr": 1e-4}
    gen = {"gen_total_loss": 2.0, "gen_lr": 1e-4}
    if method.startswith("gen"):
        return gen
    return {"dis_loss": 1.0, "dis_true_acc": 0.7, "dis_fake_acc": fake_acc,
            "dis_lr": 1e-4, **gen}


class Recorder:
    """Logs each trainer call as (method, iteration, chunk length,
    options, inputs) and each save/load and eval as (name, iteration,
    arguments).  ``tensors`` makes the metrics torch tensors (the port's
    kind)."""

    def __init__(self, tmp, fake_acc=0.5, tensors=False):
        self.tmp = str(tmp)
        self.calls, self.trainers, self.init_seeds = [], [], []
        self.done = 0
        self.fake_acc = fake_acc
        self.tensors = tensors

    def rel(self, prefix):
        return os.path.relpath(str(prefix), self.tmp)

    def step(self, method, inputs, kw, k=None):
        opts = {key: kw[key] for key in ("with_viz", "mode", "raw",
                                         "feat_mat") if key in kw}
        self.calls.append((method, self.done, k or 1, opts,
                           [_host(x) for x in inputs]))
        self.done += k or 1
        met = _metrics(method, self.fake_acc)
        if k is not None:
            met = {key: (torch.full((k,), v) if self.tensors
                         else np.full(k, v, np.float32))
                   for key, v in met.items()}
        elif self.tensors:
            met = {key: torch.tensor(v) for key, v in met.items()}
        return met

    def event(self, name, *args):
        self.calls.append((name, self.done, args))

    def save(self, prefix, iterations):
        """Log a save and write its empty snapshot files, so that the
        collapse guard has an attempt's files to discard."""
        self.event("save", self.rel(prefix), iterations)
        for net in ("gen", "dis", "map", "optg", "optd"):
            open(f"{prefix}_{net}_{iterations + 1:08d}.npz", "wb").close()

    def outputs(self, labels, raw, with_viz):
        if not with_viz:
            return None
        b = len(labels) if np.ndim(labels) == 2 else labels.shape[1]
        outs = tuple(np.zeros((b, 128, 128, 1), np.float32)
                     for _ in range(8))
        if raw:
            img = np.zeros((b, 128, 128, 1), np.float32)
            return outs, img, img
        return outs

    def eval_stub(self, value):
        def stub(trainer, *args, **kw):
            self.event("eval")
            return value
        return stub


class JaxStandIn:
    """The JAX trainer's surface: (state, ...) in, (state, ...) out."""

    def __init__(self, rec):
        self.rec = rec

    def init_state(self, key):
        # PRNGKey(seed) is the raw pair (0, seed)
        self.rec.init_seeds.append(int(np.asarray(key)[-1]))
        return {"step": 0}

    def vae_update(self, state, y, rng):
        return state, self.rec.step("vae_update", [y], {}), None

    def vae_scan(self, state, ys, keys):
        return state, self.rec.step("vae_scan", [ys], {}, len(ys)), None

    def _image(self, name, state, xa, la, xb, lb, raw_out, k=None, **kw):
        met = self.rec.step(name, [xa, la, xb, lb], kw, k)
        return state, met, self.rec.outputs(la, raw_out,
                                            kw.get("with_viz", True))

    def pretrain_update(self, state, xa, la, xb, lb, rng, **kw):
        return self._image("pretrain_update", state, xa, la, xb, lb, False,
                           **kw)

    def pretrain_update_raw(self, state, xa, la, xb, lb, rng, **kw):
        return self._image("pretrain_update_raw", state, xa, la, xb, lb,
                           True, **kw)

    def gen_update(self, state, xa, la, xb, lb, rng, **kw):
        return self._image("gen_update", state, xa, la, xb, lb, False, **kw)

    def gen_update_raw(self, state, xa, la, xb, lb, rng, **kw):
        return self._image("gen_update_raw", state, xa, la, xb, lb, True,
                           **kw)

    def post_update(self, state, xa, la, xb, lb, rng, **kw):
        return self._image("post_update", state, xa, la, xb, lb, False,
                           **kw)

    def post_update_raw(self, state, xa, la, xb, lb, rng, **kw):
        return self._image("post_update_raw", state, xa, la, xb, lb, True,
                           **kw)

    def pretrain_scan(self, state, xa, la, xb, lb, keys, **kw):
        return self._image("pretrain_scan", state, xa, la, xb, lb,
                           kw.get("raw", False), len(la), **kw)

    def post_scan(self, state, xa, la, xb, lb, keys, **kw):
        return self._image("post_scan", state, xa, la, xb, lb,
                           kw.get("raw", False), len(la), **kw)

    @staticmethod
    def assemble_outputs(images_a, images_b, outs):
        return np.zeros((1, 128, 1280, 1), np.float32)

    def save(self, state, prefix, iterations):
        self.rec.save(prefix, iterations)

    def save_vae(self, state, prefix, iterations, frac):
        self.rec.event("save_vae", self.rec.rel(prefix), iterations, frac)

    def resume(self, state, prefix, idx=-1, load_opt=False, est=False):
        self.rec.event("resume", self.rec.rel(prefix), idx, load_opt, est)
        return state, 0

    def load_vae(self, state, prefix, frac):
        self.rec.event("load_vae", self.rec.rel(prefix), frac)
        return state, True


class PortStandIn:
    """The port trainer's surface: in place, (metrics, outputs) out."""

    device = torch.device("cpu")

    def __init__(self, rec, **kw):
        self.rec = rec
        self.made_with = kw

    def vae_update(self, y):
        return self.rec.step("vae_update", [y], {}), None

    def vae_scan(self, ys):
        return self.rec.step("vae_scan", [ys], {}, len(ys)), None

    def _image(self, name, xa, la, xb, lb, raw_out, k=None, **kw):
        met = self.rec.step(name, [xa, la, xb, lb], kw, k)
        return met, self.rec.outputs(la, raw_out, kw.get("with_viz", True))

    def pretrain_update(self, xa, la, xb, lb, **kw):
        return self._image("pretrain_update", xa, la, xb, lb, False, **kw)

    def pretrain_update_raw(self, xa, la, xb, lb, **kw):
        return self._image("pretrain_update_raw", xa, la, xb, lb, True,
                           **kw)

    def gen_update(self, xa, la, xb, lb, **kw):
        return self._image("gen_update", xa, la, xb, lb, False, **kw)

    def gen_update_raw(self, xa, la, xb, lb, **kw):
        return self._image("gen_update_raw", xa, la, xb, lb, True, **kw)

    def post_update(self, xa, la, xb, lb, **kw):
        return self._image("post_update", xa, la, xb, lb, False, **kw)

    def post_update_raw(self, xa, la, xb, lb, **kw):
        return self._image("post_update_raw", xa, la, xb, lb, True, **kw)

    def pretrain_scan(self, xa, la, xb, lb, **kw):
        return self._image("pretrain_scan", xa, la, xb, lb,
                           kw.get("raw", False), len(la), **kw)

    def post_scan(self, xa, la, xb, lb, **kw):
        return self._image("post_scan", xa, la, xb, lb,
                           kw.get("raw", False), len(la), **kw)

    @staticmethod
    def assemble_outputs(images_a, images_b, outs):
        return torch.zeros((1, 128, 1280, 1))

    def save(self, prefix, iterations):
        self.rec.save(prefix, iterations)

    def save_vae(self, prefix, iterations, frac):
        self.rec.event("save_vae", self.rec.rel(prefix), iterations, frac)

    def resume(self, prefix, idx=-1, load_opt=False, est=False):
        self.rec.event("resume", self.rec.rel(prefix), idx, load_opt, est)
        return 0

    def load_vae(self, prefix, frac):
        self.rec.event("load_vae", self.rec.rel(prefix), frac)
        return True


def _own(root, argv):
    """argv with the run's own log directory and snapshot prefix under
    ``root``."""
    return argv + ["--log", str(root / "logs"),
                   "--snapshot-prefix", str(root / "out" / "pre")]


def _record_discards(monkeypatch, module, rec):
    """Log each snapshot set the collapse guard discards, then discard."""
    discard = module._discard_attempt_snapshots

    def logged(store, snaps, orbax_steps):
        rec.event("discard", tuple((rec.rel(p), it) for p, it in snaps),
                  tuple(orbax_steps))
        return discard(store, snaps, orbax_steps)

    monkeypatch.setattr(module, "_discard_attempt_snapshots", logged)


def _run_jax(monkeypatch, tmp, module, argv, fake_acc=0.5):
    rec = Recorder(tmp, fake_acc=fake_acc)
    monkeypatch.setattr(jcommon, "make_trainer",
                        lambda *a, **k: JaxStandIn(rec))
    if module is jpose:
        monkeypatch.setattr(jpose, "_evaluate", rec.eval_stub(None))
    else:
        monkeypatch.setattr(jdepth, "evaluate_estimation",
                            rec.eval_stub((10.0, 50.0)))
        _record_discards(monkeypatch, jdepth, rec)
    out = io.StringIO()
    with redirect_stdout(out):
        module.main(argv)
    rec.stdout = out.getvalue()
    return rec


def _run_port(monkeypatch, tmp, module, argv, fake_acc=0.5):
    rec = Recorder(tmp, fake_acc=fake_acc, tensors=True)

    def make(*args, **kw):
        t = PortStandIn(rec, **kw)
        rec.trainers.append(t)
        return t

    monkeypatch.setattr(pcommon, "make_trainer", make)
    if module is ppose:
        monkeypatch.setattr(ppose, "_evaluate", rec.eval_stub(None))
    else:
        monkeypatch.setattr(pdepth, "evaluate_estimation",
                            rec.eval_stub((10.0, 50.0)))
        _record_discards(monkeypatch, pdepth, rec)
    out = io.StringIO()
    with redirect_stdout(out):
        module.main(argv)
    rec.stdout = out.getvalue()
    return rec


def _same_calls(got, want):
    assert [c[:4] if len(c) == 5 else c for c in got] == \
        [c[:4] if len(c) == 5 else c for c in want]
    for g, w in zip(got, want):
        if len(g) == 5:
            for i, (a, b) in enumerate(zip(g[4], w[4])):
                for x, y in zip(a if isinstance(a, tuple) else (a,),
                                b if isinstance(b, tuple) else (b,)):
                    assert x.dtype == y.dtype and x.shape == y.shape, \
                        (g[:3], i, x.dtype, y.dtype, x.shape, y.shape)
                    np.testing.assert_array_equal(x, y, err_msg=str(g[:3]))


@pytest.mark.parametrize("spc", ["1", "4"])
def test_pose_train_drives_the_trainer_as_jax(spc, tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, "pose", **POSE_CADENCES)
    argv = ["--config", cfg, "--max-iterations", "25", "--frac", "0.5",
            "--steps-per-call", spc]
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    want = _run_jax(monkeypatch, jax_root, jpose, _own(jax_root, argv))
    got = _run_port(monkeypatch, port_root, ppose,
                    _own(port_root, argv) + ["--device", "cpu"])
    _same_calls(got.calls, want.calls)
    names = [c[0] for c in got.calls]
    assert names.count("eval") == 1 and names.count("save_vae") == 2
    assert ("vae_scan" in names) == (spc == "4")
    assert got.trainers[0].made_with["seed"] == 23455 + 7
    assert got.trainers[0].made_with["init_seed"] == 23455


@pytest.mark.parametrize("augment", ["step", "jax"])
@pytest.mark.parametrize("spc", ["1", "4"])
@pytest.mark.parametrize("mode", ["pretrain", "estimate3"])
def test_depth_train_drives_the_trainer_as_jax(mode, spc, augment,
                                               tmp_path, monkeypatch):
    monkeypatch.setenv("LSPS_AUGMENT", augment)
    # both loaders as long as each other (--frac 0.5 halves domain B): a
    # loader abandoned mid-epoch by zip has drawn augment parameters for
    # as many batches as its prefetch thread got to, in either package
    cfg = _cfg(tmp_path, "depth", frames_a=8 if mode == "pretrain" else 4,
               **DEPTH_CADENCES)
    argv = ["--config", cfg, "--mode", mode, "--max-iterations", "25",
            "--batch-size", "2", "--steps-per-call", spc]
    if mode == "pretrain":
        argv += ["--resume", "1"]
    else:
        argv += ["--idx", "0", "--frac", "0.5"]
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    want = _run_jax(monkeypatch, jax_root, jdepth, _own(jax_root, argv))
    got = _run_port(monkeypatch, port_root, pdepth,
                    _own(port_root, argv) + ["--device", "cpu"])
    _same_calls(got.calls, want.calls)
    names = [c[0] for c in got.calls]
    assert names.count("save") == 2 and names.count("load_vae") == 1
    assert names.count("resume") == (mode == "pretrain")
    assert names.count("eval") == (3 if mode == "estimate3" else 0)
    suffix = "_raw" if augment == "step" else ""
    step = "pretrain" if mode == "pretrain" else "post"
    assert f"{step}_update{suffix}" in names
    assert (f"{step}_scan" in names) == (spc == "4")
    assert got.trainers[0].made_with["seed"] == 23455 + 13
    # the image strips, as PNG
    images = os.listdir(port_root / "out" / "images")
    assert "gen.png" in images
    assert not [n for n in images if n.endswith(".jpg")]


# ---------------------------------------------------------------------------
# the collapse guard's wiring (tests/test_collapse_guard.py:81-280)
# ---------------------------------------------------------------------------

GUARD_LINES = ("collapse guard", "rescue phase")


def _guard_lines(out):
    return [line for line in out.splitlines()
            if any(key in line for key in GUARD_LINES)]


def _snapshot_files(root, tag):
    return sorted(os.listdir(root / tag))


def _guard_run(tmp_path, monkeypatch, tag, *extra, snapshot_iters=1000,
               max_it="8"):
    """The port's and the JAX package's depth_train in the dominant basin,
    each under its own root, held against each other call for call;
    returns the port's config and record."""
    monkeypatch.setenv("LSPS_AUGMENT", "step")
    recs, cfgs = {}, {}
    for name, module, run in (("jax", jdepth, _run_jax),
                              ("port", pdepth, _run_port)):
        root = tmp_path / name
        root.mkdir()
        cfgs[name] = make_synth_cfg(root, tag, snapshot_iters=snapshot_iters)
        argv = ["--config", cfgs[name], "--mode", "pretrain",
                "--log", str(root / "logs"), "--max-iterations", max_it,
                "--batch-size", "4", *extra]
        if name == "port":
            argv += ["--device", "cpu"]
        recs[name] = run(monkeypatch, root, module, argv, fake_acc=DOMINANT)
    want, got = recs["jax"], recs["port"]
    _same_calls(got.calls, want.calls)
    assert _guard_lines(got.stdout) == _guard_lines(want.stdout)
    assert (_snapshot_files(tmp_path / "port", tag)
            == _snapshot_files(tmp_path / "jax", tag))
    # each attempt builds its own trainer from the JAX CLI's attempt seed
    assert [t.made_with["init_seed"] for t in got.trainers] == \
        want.init_seeds
    assert [t.made_with["seed"] for t in got.trainers] == \
        [s + 13 for s in want.init_seeds]
    return cfgs["port"], got


def test_cli_reseed_on_collapse(tmp_path, monkeypatch):
    _, rec = _guard_run(tmp_path, monkeypatch, "collapse",
                        "--reseed-on-collapse", "1",
                        "--collapse-check-iter", "1",
                        "--collapse-reseed-until", "1")
    out = rec.stdout
    assert "collapse guard: discriminator-dominant basin detected" in out
    assert "pretrain aborted at iteration 5" in out
    assert "restarting pretrain with seed" in out
    assert "continuing (no --reseed-on-collapse budget)" in out
    assert out.count("restarting pretrain") == 1
    # each attempt builds its own trainer from its own seed
    seeds = [(t.made_with["init_seed"], t.made_with["seed"])
             for t in rec.trainers]
    assert seeds == [(23455, 23455 + 13),
                     (23455 + 9973, 23455 + 9973 + 13)]


def test_cli_reseed_skips_resume_and_discards_aborted_snapshots(
        tmp_path, monkeypatch):
    _, rec = _guard_run(tmp_path, monkeypatch, "reseed_resume",
                        "--resume", "1", "--reseed-on-collapse", "1",
                        "--collapse-check-iter", "1",
                        "--collapse-reseed-until", "1", snapshot_iters=3)
    out = rec.stdout
    assert "pretrain aborted at iteration 5" in out
    assert "discarded 1 snapshot set(s)" in out
    assert "skipping --resume restore on the reseed attempt" in out
    assert [c for c in rec.calls if c[0] == "resume"] == [
        ("resume", 0, ("reseed_resume/pre", -1, True, False))]
    assert [c for c in rec.calls if c[0] == "discard"] == [
        ("discard", 5, ((("reseed_resume/pre", 3),), ()))]
    # attempt 2 saved its own set at 3 after the discard
    snap_dir = tmp_path / "port" / "reseed_resume"
    assert os.path.exists(snap_dir / "pre_gen_00000003.npz")
    assert os.path.exists(snap_dir / "pre_gen_00000006.npz")
    saves = [c[2][1] for c in rec.calls if c[0] == "save"]
    assert saves == [2, 2, 5]  # attempt 1 at 3; attempt 2 at 3 and 6


def test_cli_late_trigger_stays_advisory(tmp_path, monkeypatch):
    _, rec = _guard_run(tmp_path, monkeypatch, "late_trigger",
                        "--reseed-on-collapse", "1",
                        "--collapse-check-iter", "1")
    out = rec.stdout
    assert "collapse guard: discriminator-dominant basin detected" in out
    assert "past the reseed window at 62%" in out
    assert "restarting pretrain" not in out
    assert "pretrain aborted" not in out
    assert len(rec.trainers) == 1


def test_cli_rescue_on_collapse(tmp_path, monkeypatch):
    cfg, rec = _guard_run(tmp_path, monkeypatch, "rescue",
                          "--rescue-on-collapse", "1", "--rescue-iters",
                          "3", "--collapse-check-iter", "1",
                          "--collapse-reseed-until", "1", max_it="16")
    out = rec.stdout
    assert ("rescue phase 1/1: freezing the discriminator for gen-only "
            "updates through iteration 8") in out
    assert "continuing (no --reseed-on-collapse budget)" in out
    assert "restarting pretrain" not in out
    # the generator-only steps are iterations 6..8 (0-based 5..7)
    assert [c[1] for c in rec.calls if c[0].startswith("gen_update")] == \
        [5, 6, 7]
    by_step = {r["step"]: r for r in read_metrics(
        str(tmp_path / "port" / "logs"), cfg)}
    for step in (6, 7, 8):
        assert "dis_loss" not in by_step[step], by_step[step]
        assert "gen_total_loss" in by_step[step]
    for step in (5, 9, 16):
        assert "dis_loss" in by_step[step]


def test_cli_rescue_tried_before_reseed(tmp_path, monkeypatch):
    _, rec = _guard_run(tmp_path, monkeypatch, "rescue_then_reseed",
                        "--rescue-on-collapse", "1", "--rescue-iters", "2",
                        "--reseed-on-collapse", "1",
                        "--collapse-check-iter", "1",
                        "--collapse-reseed-until", "1", max_it="16")
    out = rec.stdout
    assert "rescue phase 1/1" in out
    assert "restarting pretrain with seed" in out
    assert out.count("rescue phase 1/1") == 2
    assert len(rec.trainers) == 2


def test_cli_estimate_overfit_note_wiring(tmp_path, monkeypatch):
    cfg = make_synth_cfg(tmp_path, "overfit")
    seen = {}

    def fake_note(hist, **kw):
        seen["hist"] = list(hist)
        return "NOTE: synthetic overfit advisory"

    monkeypatch.setattr(pdepth, "overfit_note", fake_note)
    rec = _run_port(monkeypatch, tmp_path, pdepth, [
        "--config", cfg, "--device", "cpu", "--mode", "estimate1",
        "--idx", "0", "--log", str(tmp_path / "logs"),
        "--max-iterations", "2", "--batch-size", "4"])
    assert "NOTE: synthetic overfit advisory" in rec.stdout
    assert "hist" in seen


def test_cli_device_flag(monkeypatch):
    opts = pcommon.base_parser("x").parse_args(["--config", "c"])
    assert opts.device == "0"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        pcommon.device_of(opts)
    opts.device = "cpu"
    assert pcommon.device_of(opts) == torch.device("cpu")
    # --mesh-data N outside a launch of N ranks names the launch
    opts.mesh_data = 2
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run "
                       "--nproc-per-node 2"):
        pcommon.make_mesh_runner(opts)
