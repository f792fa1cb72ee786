"""The port's tools (``lsps_tpu_torch/scripts/``) against the repository's
JAX scripts, on the CPU.

The JAX scripts (``scripts/realtime_demo.py``, ``scripts/eval_checkpoints.py``,
``scripts/parity_gate.py``) run unmodified: each test calls their ``main``
with ``argv`` (or ``sys.argv``) set, and catches what they print, write and
build through ``monkeypatch``.

* ``realtime_demo`` at ``--ch 8 --frames 4`` on both routes: the JAX
  script's ``cv2.VideoWriter`` records its frames, its ``PoseEstimator``
  records its params and each call's CoM and joints; the params go through
  ``weights.from_jax_params`` into the port's ``run``.  Host route: CoMs
  bit for bit (both detectors are float64 numpy and equal,
  ``tests/test_torch_host_detect.py``), joints within ``FRAMES_MM``
  (``tests/test_torch_serve.py``).  Device route: CoMs u and v equal, z
  within ``COM_Z_ULPS`` float32 ulps (``tests/test_torch_detect.py``),
  joints within ``raw_joint_tolerance``.  Frames: the pixels drawn in
  neither (gray, B = G = R: no skeleton colour is gray) within
  ``BACKGROUND_LEVELS`` of each other (a CoM z a few ulps apart moves a
  normalized depth across a uint8 step), and the drawn pixels overlapping
  by at least ``DRAWN_OVERLAP``, as ``tests/test_torch_eval_utils.py``
  holds ``vis_pair``'s strokes to cv2's.
* ``eval_checkpoints`` on a copy of ``exps/synth.yaml``: two ``est_gen``
  snapshot sets and a VAE snapshot from seeded weights; each printed mean
  error within ``ERR_MM`` of the JAX script's (printed to 1e-4 mm; float32
  convs summed in another order) and each accuracy equal as printed; both
  exit messages.
* ``parity_gate`` on an NYU mini-dataset (``test_torch_importers.write_nyu``)
  and reference-layout ``.pkl`` files of the dis and VAE
  (``test_full_model_torch_parity``'s nets, the reference's key spelling):
  the same printed error (``ERR_MM``), return codes 0 and 1 around it with
  the same PASS / FAIL lines, and 2 with the same report for a missing
  file and a missing dataset root.
"""

import importlib.util
import io
import json
import os
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import yaml

import cv2
import lsps_tpu.serve.inference as jinference
from lsps_tpu_torch.config import NetConfig, default_hyperparameters
from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.scripts import eval_checkpoints as peval
from lsps_tpu_torch.scripts import parity_gate as pgate
from lsps_tpu_torch.scripts import realtime_demo as pdemo
from lsps_tpu_torch.serve.inference import PoseEstimator
from lsps_tpu_torch.train import LSPSTrainer
from lsps_tpu_torch.train.trainer import fresh_state_dict
from lsps_tpu_torch.weights import from_jax_params
from test_full_model_torch_parity import TorchPoseVAE, TorchSharedDis
from test_torch_detect import assert_coms_match
from test_torch_importers import write_nyu
from test_torch_serve import FRAMES_MM, raw_joint_tolerance

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_CH, DEMO_FRAMES = 8, 4
BACKGROUND_LEVELS = 1
DRAWN_OVERLAP = 0.9
ERR_MM = 1e-3
GATE_CH = 4
DEMO_KEYS = {"metric", "frames", "device_detect", "detect_ms_median",
             "infer_ms_median", "out"}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue()


# ---------------------------------------------------------------------------
# realtime_demo
# ---------------------------------------------------------------------------

def _run_jax_demo(monkeypatch, tmp_path, device_detect):
    rec = {"frames": [], "coms": [], "joints": []}

    class Recorder:
        def __init__(self, *args, **kw):
            pass

        def write(self, img):
            rec["frames"].append(np.array(img))

        def release(self):
            pass

    class Recording(jinference.PoseEstimator):
        def __init__(self, hyp, params, **kw):
            rec["params"] = params
            super().__init__(hyp, params, **kw)

        def predict_frame(self, frame, com, cube):
            joints = super().predict_frame(frame, com, cube)
            rec["coms"].append(np.asarray(com))
            rec["joints"].append(np.asarray(joints))
            return joints

        def predict_raw(self, *args, **kw):
            joints, coms = super().predict_raw(*args, **kw)
            rec["coms"].append(np.asarray(coms[0]))
            rec["joints"].append(np.asarray(joints[0]))
            return joints, coms

    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    monkeypatch.setattr(jinference, "PoseEstimator", Recording)
    argv = ["--ch", str(DEMO_CH), "--frames", str(DEMO_FRAMES),
            "--out", str(tmp_path / "jax.avi")]
    _, out = _printed(_jax_script("realtime_demo").main,
                      argv + (["--device-detect"] if device_detect else []))
    rec["line"] = json.loads(out.strip().splitlines()[-1])
    return rec


def _drawn(img):
    return (img != img[..., :1]).any(-1)


@pytest.mark.parametrize("device_detect", [False, True],
                         ids=["host", "device_detect"])
def test_realtime_demo_matches_jax(device_detect, monkeypatch, tmp_path):
    want = _run_jax_demo(monkeypatch, tmp_path, device_detect)
    hyp = default_hyperparameters(reg_dim=108, ch=DEMO_CH)
    est = PoseEstimator(hyp, from_jax_params(want["params"]),
                        camera=Camera.nyu(), device="cpu")
    got = list(pdemo.run(est, DEMO_FRAMES, device_detect))
    assert len(got) == len(want["frames"]) == DEMO_FRAMES
    assert set(want["line"]) == DEMO_KEYS
    coms = np.stack([c for c, _, _ in got])
    joints = np.stack([j for _, j, _ in got])
    want_coms = np.stack(want["coms"])
    if device_detect:
        assert_coms_match(coms.astype(np.float32), want_coms)
        tol = raw_joint_tolerance(want_coms)
    else:
        np.testing.assert_array_equal(coms, want_coms)
        tol = FRAMES_MM
    gap = np.abs(joints - np.stack(want["joints"]))
    assert np.all(gap <= tol), (gap / tol).max()
    for (_, _, img), ref in zip(got, want["frames"]):
        assert img.shape == ref.shape == (128, 128, 3)
        assert img.dtype == ref.dtype == np.uint8
        dp, dj = _drawn(img), _drawn(ref)
        bg = ~dp & ~dj
        assert np.abs(img.astype(int) - ref)[bg].max() <= BACKGROUND_LEVELS
        assert dj.sum() > 100
        assert (dp & dj).sum() / max(dp.sum(), dj.sum()) >= DRAWN_OVERLAP


def test_realtime_demo_main_writes_the_video_and_the_jax_line(tmp_path):
    out = tmp_path / "demo" / "port.avi"
    _, printed = _printed(pdemo.main, [
        "--ch", str(DEMO_CH), "--frames", "3", "--out", str(out),
        "--device", "cpu", "--device-detect"])
    line = json.loads(printed.strip().splitlines()[-1])
    assert set(line) == DEMO_KEYS
    assert line["metric"] == "realtime_demo" and line["frames"] == 3
    assert line["device_detect"] is True and line["detect_ms_median"] == 0
    cap = cv2.VideoCapture(str(out))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    assert len(frames) == 3 and frames[0].shape == (128, 128, 3)
    # the same weights, CoMs and frames as the loop on those weights
    hyp = default_hyperparameters(reg_dim=108, ch=DEMO_CH)
    est = PoseEstimator(hyp, pdemo.seeded_weights(hyp, pdemo.SEED),
                        camera=Camera.nyu(), device="cpu")
    for f, (_, _, img) in zip(frames, pdemo.run(est, 3, True)):
        np.testing.assert_array_equal(f, img)


def test_tools_need_the_card_unless_told(monkeypatch, tmp_path):
    """With no card, each tool raises unless ``--device cpu`` is given;
    the parity gate's report of missing files comes first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdemo.main(["--ch", str(DEMO_CH), "--frames", "1",
                    "--out", str(tmp_path / "x.avi")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peval.main(["--config", os.path.join(REPO, "exps", "synth.yaml")])
    pkl = tmp_path / "a.pkl"
    pkl.write_bytes(b"")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pgate.main(["--config", os.path.join(REPO, "exps", "synth.yaml"),
                    "--dis", str(pkl), "--vae", str(pkl)])


# ---------------------------------------------------------------------------
# eval_checkpoints
# ---------------------------------------------------------------------------

CKPT_LINE = re.compile(r"checkpoint (\S+) \(iteration (\d+)\): Mean err: "
                       r"([0-9.]+) mm, Max over 40mm: ([0-9.]+) %")


def _synth_config(tmp_path, prefix):
    with open(os.path.join(REPO, "exps", "synth.yaml")) as f:
        doc = yaml.safe_load(f)
    doc["train"]["snapshot_prefix"] = str(prefix)
    path = tmp_path / f"synth_{prefix.parent.name}.yaml"
    path.write_text(yaml.safe_dump(doc))
    return str(path)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """Two estimate-mode snapshot sets (iterations 10 and 20) and the VAE
    of frac 2.9, from seeded weights, under ``full/``; only the VAE under
    ``vae_only/``; nothing under ``empty/``."""
    base = tmp_path_factory.mktemp("eval_ckpt")
    prefixes = {k: base / k / "pre" for k in ("full", "vae_only", "empty")}
    hyp = NetConfig(_synth_config(base, prefixes["full"])).hyperparameters
    for it, seed in ((9, 1), (19, 2)):
        t = LSPSTrainer(hyp, fresh_state_dict(hyp, seed), device="cpu")
        t.save(str(prefixes["full"]) + "_est", it, save_opt=False)
    for k in ("full", "vae_only"):
        t.save_vae(str(prefixes[k]), 19, 2.9)
    prefixes["empty"].parent.mkdir()
    return base, prefixes


def _eval_both(monkeypatch, tmp_path, cfg):
    def mkdtemp(prefix=""):
        path = tmp_path / prefix
        path.mkdir(exist_ok=True)
        return str(path)

    monkeypatch.setattr("tempfile.mkdtemp", mkdtemp)
    argv = ["--config", cfg, "--frac", "0.9", "--batch-size", "2"]
    monkeypatch.setattr(sys, "argv", ["eval_checkpoints.py"] + argv)
    out = {}
    for name, fn, args in (("jax", _jax_script("eval_checkpoints").main, ()),
                           ("port", peval.main,
                            (argv + ["--device", "cpu"],))):
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                fn(*args)
        except SystemExit as e:
            out[name] = ("exit", str(e.code))
            continue
        out[name] = ("lines", CKPT_LINE.findall(buf.getvalue()))
    return out["jax"], out["port"]


def test_eval_checkpoints_matches_jax(snapshots, monkeypatch, tmp_path):
    base, prefixes = snapshots
    want, got = _eval_both(monkeypatch, tmp_path,
                           _synth_config(base, prefixes["full"]))
    assert want[0] == got[0] == "lines"
    assert len(want[1]) == len(got[1]) == 2
    for (wf, wi, we, wa), (gf, gi, ge, ga) in zip(want[1], got[1]):
        assert (gf, gi, ga) == (wf, wi, wa)
        assert abs(float(ge) - float(we)) <= ERR_MM
    assert [f for f, *_ in got[1]] == ["pre_est_gen_00000010.npz",
                                       "pre_est_gen_00000020.npz"]
    assert got[1][0][2] != got[1][1][2]


@pytest.mark.parametrize("case", ["vae_only", "empty"])
def test_eval_checkpoints_exit_messages(case, snapshots, monkeypatch,
                                        tmp_path):
    base, prefixes = snapshots
    want, got = _eval_both(monkeypatch, tmp_path,
                           _synth_config(base, prefixes[case]))
    assert want[0] == got[0] == "exit"
    assert got[1] == want[1]
    assert got[1].startswith("no est_gen checkpoints under" if
                             case == "vae_only" else "no VAE checkpoint")


# ---------------------------------------------------------------------------
# parity_gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """An NYU mini-dataset, ``exps/nnyu.yaml`` at dis width ``GATE_CH``
    with its roots there (a config each, with its own cache), and the
    reference nets' state_dicts as the reference names its files."""
    base = tmp_path_factory.mktemp("parity_gate")
    root = write_nyu(str(base / "nyu"), n_train=2, n_test=6)
    with open(os.path.join(REPO, "exps", "nnyu.yaml")) as f:
        doc = yaml.safe_load(f)
    hyp = doc["train"]["hyperparameters"]
    hyp["gen"]["ch"] = hyp["dis"]["ch"] = GATE_CH
    configs = {}
    for pkg in ("jax", "port"):
        for spec in doc["train"]["datasets"].values():
            spec["root"] = root
            spec["cacheDir"] = str(base / pkg / "cache")
        path = base / pkg / "nnyu.yaml"
        path.parent.mkdir()
        path.write_text(yaml.safe_dump(doc))
        configs[pkg] = str(path)
    torch.manual_seed(0)
    d, v = hyp["dis"], hyp["vae"]
    dis = TorchSharedDis(GATE_CH, d["n_front_layer"], d["n_shared_layer"],
                         d["post_dim"])
    vae = TorchPoseVAE(v["input_dim"], v["z_dim"], v["h_dim"])
    files = {"dis": str(base / "pre_dis_00500000.pkl"),
             "vae": str(base / "pre_vae_2.90_00500000.pkl")}
    torch.save(dis.state_dict(), files["dis"])
    torch.save(vae.state_dict(), files["vae"])
    assert any(".model." in k for k in dis.state_dict())
    return configs, files, base


def _gate_both(monkeypatch, tmp_path, configs, files, *extra):
    monkeypatch.chdir(tmp_path)
    jax_main = _jax_script("parity_gate").main
    out = {}
    for pkg, fn, dev in (("jax", jax_main, []),
                         ("port", pgate.main, ["--device", "cpu"])):
        out[pkg] = _printed(fn, ["--config", configs[pkg], "--dis",
                                 files["dis"], "--vae", files["vae"],
                                 *extra, *dev])
    return out["jax"], out["port"]


GATE_ERR = re.compile(r"parity_gate: mean err ([0-9.]+) mm, ([0-9.]+)% "
                      r"within 40 mm")


def test_parity_gate_matches_jax(gate, monkeypatch, tmp_path):
    configs, files, _ = gate
    (wrc, wout), (grc, gout) = _gate_both(monkeypatch, tmp_path, configs,
                                          files)
    assert wrc == grc == 0
    (we, wa), = GATE_ERR.findall(wout)
    (ge, ga), = GATE_ERR.findall(gout)
    assert abs(float(ge) - float(we)) <= ERR_MM and ga == wa
    assert "leaves kept from template" not in wout
    assert os.path.isfile(tmp_path / "outputs" / "parity_gate" / "gen.avi")
    # --expect at the JAX error, then 1 mm away: the gate's two answers
    for expect, rc, verdict in ((float(we), 0, "PASS"),
                                (float(we) + 1.0, 1, "FAIL")):
        (wrc, wout), (grc, gout) = _gate_both(
            monkeypatch, tmp_path, configs, files, "--expect", str(expect))
        assert wrc == grc == rc
        assert f"-> {verdict} (tolerance 0.5 mm)" in gout
        assert f"-> {verdict} (tolerance 0.5 mm)" in wout


@pytest.mark.parametrize("case", ["checkpoint", "dataset"])
def test_parity_gate_reports_what_is_missing(case, gate, monkeypatch,
                                             tmp_path):
    configs, files, base = gate
    if case == "checkpoint":
        files = dict(files, vae=str(base / "absent_vae.pkl"))
    else:
        configs = {}
        for pkg in ("jax", "port"):
            doc = yaml.safe_load(open(gate[0][pkg]))
            doc["train"]["datasets"]["test_b"]["root"] = str(base / "none")
            path = tmp_path / pkg / "nnyu.yaml"
            path.parent.mkdir()
            path.write_text(yaml.safe_dump(doc))
            configs[pkg] = str(path)
    (wrc, wout), (grc, gout) = _gate_both(monkeypatch, tmp_path, configs,
                                          files)
    assert wrc == grc == 2
    assert gout == wout
    assert gout.startswith("MISSING checkpoints" if case == "checkpoint"
                           else "MISSING dataset")
