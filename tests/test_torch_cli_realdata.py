"""The port's training CLIs on the real-data configs, against the JAX
package's.

``exps/nnyu.yaml`` and ``exps/nicvl.yaml`` with their dataset roots pointed
at the NYU and ICVL mini-datasets of ``tests/test_torch_importers.py``
(``dataset_hand_NYU``, ``dataset_hand_NYU_test``, ``dataset_hand_ICVL``,
``dataset_hand_ICVL_test``), at tiny widths and short cadences, with each
package's datasets caching into a directory of its own.  With the
recording stand-in trainers of ``tests/test_torch_cli.py``, the port's
``pose_train`` and ``depth_train`` (pretrain and estimate3) make the JAX
CLIs' calls with bit-equal inputs, with ``LSPS_AUGMENT`` unset (``host``
in both packages) and under ``native``.  Both training loaders of a run
hold the same number of batches, so that no loader is abandoned mid-epoch
(see ``tests/test_torch_cli.py``).
"""

import os

import pytest
import torch
import yaml

from test_torch_cli import (DEPTH_CADENCES, POSE_CADENCES, REPO, _own,
                            _run_jax, _run_port, _same_calls)
from test_torch_importers import write_icvl, write_nyu

import lsps_tpu.cli.depth_train as jdepth
import lsps_tpu.cli.pose_train as jpose
import lsps_tpu_torch.cli.depth_train as pdepth
import lsps_tpu_torch.cli.pose_train as ppose

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """NYU: 7 usable real and 8 synth training frames (4 batches of 2
    each); ICVL: 8 original training frames."""
    base = tmp_path_factory.mktemp("cli_realdata")
    return {"nyu": write_nyu(str(base / "nyu"), n_train=8, n_test=4),
            "icvl": write_icvl(str(base / "icvl"), n_train=8, n_test=3),
            "base": base}


def _config(roots, name, pkg, **train):
    """``exps/<name>.yaml`` at tiny widths, its roots at the
    mini-datasets, its caches under the package's own directory; written
    as ``<pkg>/<name>.yaml`` (the CLIs pick the evaluation by the name)."""
    with open(os.path.join(REPO, "exps", f"{name}.yaml")) as f:
        doc = yaml.safe_load(f)
    doc["train"].update(train)
    hyp = doc["train"]["hyperparameters"]
    hyp["gen"]["ch"] = hyp["dis"]["ch"] = 4
    for spec in doc["train"]["datasets"].values():
        kind = "icvl" if "ICVL" in spec["class_name"] else "nyu"
        spec["root"] = roots[kind]
        spec["cacheDir"] = str(roots["base"] / pkg / "cache")
        if spec.get("sample_poses"):
            spec["sample_poses"] = 300
    path = roots["base"] / pkg / f"{name}.yaml"
    path.parent.mkdir(exist_ok=True)
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def _both(roots, tmp_path, monkeypatch, name, jax_module, port_module,
          argv, cadences):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    want = _run_jax(monkeypatch, jax_root, jax_module, _own(
        jax_root, ["--config", _config(roots, name, "jax", **cadences)]
        + argv))
    got = _run_port(monkeypatch, port_root, port_module, _own(
        port_root, ["--config", _config(roots, name, "port", **cadences)]
        + argv + ["--device", "cpu"]))
    _same_calls(got.calls, want.calls)
    return got


@pytest.mark.parametrize("augment", ["unset", "native"])
@pytest.mark.parametrize("mode", ["pretrain", "estimate3"])
@pytest.mark.parametrize("name", ["nnyu", "nicvl"])
def test_depth_train_on_the_real_configs_drives_the_trainer_as_jax(
        roots, name, mode, augment, tmp_path, monkeypatch):
    monkeypatch.delenv("LSPS_NATIVE", raising=False)
    if augment == "unset":
        monkeypatch.delenv("LSPS_AUGMENT", raising=False)
    else:
        monkeypatch.setenv("LSPS_AUGMENT", augment)
    argv = ["--mode", mode, "--max-iterations", "10", "--batch-size", "2"]
    if mode == "estimate3":
        argv += ["--idx", "0"]
    got = _both(roots, tmp_path, monkeypatch, name, jdepth, pdepth, argv,
                DEPTH_CADENCES)
    names = [c[0] for c in got.calls]
    step = "pretrain_update" if mode == "pretrain" else "post_update"
    assert names.count(step) == 10 and f"{step}_raw" not in names
    evals = 10 // DEPTH_CADENCES["image_save_iterations"]
    assert names.count("eval") == (evals if mode == "estimate3" else 0)
    # the image items of the real datasets reached the trainer
    xa, la, xb, lb = next(c[4] for c in got.calls if c[0] == step)
    joints = 36 if name == "nnyu" else 16
    assert xa.shape == xb.shape == (2, 128, 128, 1)
    assert la.shape == lb.shape == (2, joints * 3)


@pytest.mark.parametrize("name", ["nnyu", "nicvl"])
def test_pose_train_on_the_real_configs_drives_the_trainer_as_jax(
        roots, name, tmp_path, monkeypatch):
    got = _both(roots, tmp_path, monkeypatch, name, jpose, ppose,
                ["--max-iterations", "25", "--frac", "0.5"], POSE_CADENCES)
    names = [c[0] for c in got.calls]
    assert names.count("eval") == 1
    joints = 36 if name == "nnyu" else 16
    y = next(c[4][0] for c in got.calls if c[0].startswith("vae"))
    assert y.shape[-1] == joints * 3
