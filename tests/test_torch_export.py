"""AOT export of the port's serving programs (``serve/export.py``,
``cli/export_model.py``) through ``torch.export``, on the CPU.

Programs are exported from a port ``PoseEstimator`` on the JAX package's
weights (through ``from_jax_params``), saved, loaded back and run.  An
exported program computes what the live estimator computes on the same
batch, so its outputs EQUAL the live estimator's (a static program pads a
request to its batch: it equals the live estimator on the same padded
chunks).  Against the JAX estimator: with-CoM joints within 1e-3 mm
(bit-equal crops; float32 convs summed in another order), raw-path joints
within ``test_torch_serve.raw_joint_tolerance``, the bound derived from the
detected CoMs' (``test_torch_detect``).  Also: uint16 programs refuse
fractional millimetres, a foreign file is refused, the export CLI works
from snapshots the JAX trainer wrote (and refuses ``--platforms``), and
the daemon serves an artifact.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

import jax

from lsps_tpu.config import default_hyperparameters
from lsps_tpu.data.camera import Camera
from lsps_tpu.data.synthetic import render_hand_depth
from lsps_tpu.models import build_model
from lsps_tpu.serve.inference import PoseEstimator as JaxEstimator
from lsps_tpu_torch.data.camera import Camera as PortCamera
from lsps_tpu_torch.serve import export as E
from lsps_tpu_torch.serve import server as pserver
from lsps_tpu_torch.serve.inference import PoseEstimator
from lsps_tpu_torch.weights import from_jax_params
from test_torch_serve import raw_joint_tolerance

torch.set_num_threads(1)

HYP = default_hyperparameters(reg_dim=108, small=True)
HYP["dis"]["ch"] = 4
HYP["gen"]["ch"] = 4
FRAMES_MM = 1e-3
# the ICVL camera's 320 x 240 frames: a quarter of the pixels of NYU's
CAM = Camera.icvl()
W, H = CAM.depth_map_size


def _batch(n, seed=7):
    cam = CAM
    gen = np.random.RandomState(seed)
    frames, coms = [], []
    for i in range(n):
        com3d = np.array([20.0 * i, -10.0 * i, 450.0 + 30 * i], np.float32)
        frames.append(render_hand_depth(cam, com3d, 36, gen)[0])
        coms.append(cam.to_img(com3d))
    return (np.round(np.stack(frames)).astype(np.float32),
            np.stack(coms).astype(np.float32),
            np.full((n, 3), 300.0, np.float32))


@pytest.fixture(scope="module")
def pair():
    kd, kv = jax.random.split(jax.random.PRNGKey(0))
    params = {"dis": build_model(HYP["dis"]).init(kd),
              "vae": build_model(HYP["vae"]).init(kv)}
    return (JaxEstimator(HYP, params, camera=CAM),
            PoseEstimator(HYP, from_jax_params(params),
                          camera=PortCamera.icvl(), device="cpu"))


# (batch, raw, frame dtype) of the artifacts the tests share
KINDS = {"static2": (2, False, torch.float32),
         "symbolic": (None, False, torch.float32),
         "raw_static2": (2, True, torch.float32),
         "raw_symbolic_u16": (None, True, torch.uint16)}


@pytest.fixture(scope="module")
def artifacts(pair, tmp_path_factory):
    """Each kind exported, saved and loaded back once: {name: (path,
    ArtifactPoseEstimator)}."""
    _, est = pair
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for name, (batch, raw, dtype) in KINDS.items():
        path = str(root / f"{name}.pt2")
        E.save_pose_program(path, E.export_pose_program(
            est, batch=batch, frame_shape=(H, W), raw=raw,
            frame_dtype=dtype))
        out[name] = (path, E.ArtifactPoseEstimator(path))
    return out


def _chunks(fn, n, bucket, *arrays):
    """``fn`` over ``bucket``-sized chunks, the last padded with its last
    row, trimmed: what a static artifact computes."""
    outs = []
    for s in range(0, n, bucket):
        chunk = [a[s:s + bucket] for a in arrays]
        k = len(chunk[0])
        chunk = [np.concatenate([a, np.repeat(a[-1:], bucket - k, 0)])
                 for a in chunk]
        out = fn(*chunk)
        outs.append(tuple(o[:k] for o in out) if isinstance(out, tuple)
                    else out[:k])
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


@pytest.mark.parametrize("name,sizes", [("static2", (2, 5, 3)),
                                        ("symbolic", (3, 1))])
def test_frames_artifact_roundtrip(pair, artifacts, name, sizes):
    """Saved and loaded, the with-CoM program answers several batch sizes
    (a static one by padded chunks) equal to the live estimator, and
    within 1e-3 mm of the JAX estimator."""
    jest, est = pair
    art = artifacts[name][1]
    assert art.bucket == KINDS[name][0] and art.n_joints == 36
    assert not art.raw and getattr(art, "predict_raw", None) is None
    frames, coms, cubes = _batch(max(sizes))
    for n in sizes:
        got = art.predict_frames(frames[:n], coms[:n], cubes[:n])
        if art.bucket is None:
            live = est.predict_frames(frames[:n], coms[:n], cubes[:n])
        else:
            live = _chunks(est.predict_frames, n, art.bucket, frames[:n],
                           coms[:n], cubes[:n])
        assert isinstance(got, torch.Tensor) and got.shape == (n, 36, 3)
        assert torch.equal(got, live)
        np.testing.assert_allclose(
            got.numpy(), jest.predict_frames(frames[:n], coms[:n],
                                             cubes[:n]),
            rtol=0, atol=FRAMES_MM)
    with pytest.raises(ValueError, match="frame shape"):
        art.predict_frames(frames[:, :64, :64], coms, cubes)
    assert art.predict_frames(frames[:0], coms[:0], cubes[:0]).shape == \
        (0, 36, 3)
    with pytest.raises(ValueError, match="raw-detection"):
        artifacts["raw_static2"][1].predict_frames(frames, coms, cubes)


@pytest.mark.parametrize("name", ["raw_static2", "raw_symbolic_u16"])
def test_raw_artifact_roundtrip_and_bucketing(pair, artifacts, name):
    """The raw program (detection inside): joints and CoMs equal the live
    ``predict_raw`` (a static one on padded chunks), also at batch 1,
    cubes default to 300 mm, and the joints sit within the derived bound of
    the JAX estimator's."""
    jest, est = pair
    art = artifacts[name][1]
    assert art.raw and art.bucket == KINDS[name][0]
    frames, _, cubes = _batch(3, seed=11)
    u16 = frames.astype(np.uint16)
    src = u16 if art.frame_dtype == torch.uint16 else frames
    got_j, got_c = art.predict_raw(src, cubes, return_coms=True)
    if art.bucket is None:
        live_j, live_c = est.predict_raw(src, cubes, return_coms=True)
    else:
        live_j, live_c = _chunks(
            lambda f, c: est.predict_raw(f, c, return_coms=True), 3,
            art.bucket, src, cubes)
    assert torch.equal(got_j, live_j) and torch.equal(got_c, live_c)
    assert torch.equal(art.predict_raw(src), got_j)
    want_j, want_c = jest.predict_raw(frames, cubes, return_coms=True)
    assert np.all(np.abs(got_j.numpy() - want_j)
                  <= raw_joint_tolerance(want_c, CAM))
    # a batch of one, under the symbolic program's example batch of 2
    one = (est.predict_raw(src[:1], cubes[:1]) if art.bucket is None
           else _chunks(est.predict_raw, 1, art.bucket, src[:1], cubes[:1]))
    assert torch.equal(art.predict_raw(src[:1], cubes[:1]), one)
    empty = art.predict_raw(src[:0], cubes[:0])
    assert empty.shape == (0, 36, 3)


def test_uint16_artifact_refuses_fractional_mm(artifacts):
    art = artifacts["raw_symbolic_u16"][1]
    frames, _, cubes = _batch(1, seed=4)
    # whole millimetres in float32 are taken, and give the uint16 answer
    assert torch.equal(art.predict_raw(frames, cubes),
                       art.predict_raw(frames.astype(np.uint16), cubes))
    for bad in (frames + 0.5, np.where(frames > 0, -1.0, frames),
                np.where(frames > 0, np.nan, frames), frames + 70000.0):
        with pytest.raises(ValueError, match="not representable"):
            art.predict_raw(bad.astype(np.float32), cubes)


@pytest.mark.parametrize("content", [b"not an export", b""])
def test_load_rejects_foreign_file(tmp_path, content):
    p = tmp_path / "junk.pt2"
    p.write_bytes(content)
    with pytest.raises(ValueError, match="not an LSPS export"):
        E.load_pose_program(str(p))


def test_load_rejects_untagged_export(pair, tmp_path):
    """A valid ``torch.export`` file without the format tag is refused."""
    _, est = pair
    ep, _ = E.export_pose_program(est, batch=1, frame_shape=(H, W))
    p = str(tmp_path / "untagged.pt2")
    torch.export.save(ep, p)
    with pytest.raises(ValueError, match="format None"):
        E.load_pose_program(p)


def _snapshots(tmp_path):
    from lsps_tpu.train.trainer import LSPSTrainer

    prefix = str(tmp_path / "out" / "pre")
    trainer = LSPSTrainer(dict(HYP))
    state = trainer.init_state(jax.random.PRNGKey(2))
    trainer.save(state, prefix, 99)
    trainer.save_vae(state, prefix, 99, 2.0)
    cfg = tmp_path / "exp.yaml"
    cfg.write_text(yaml.safe_dump({"train": {
        "snapshot_prefix": prefix, "snapshot_save_iterations": 100,
        "image_save_iterations": 100, "image_display_iterations": 100,
        "display": 10, "hyperparameters": dict(HYP), "datasets": {}}}))
    return str(cfg), state


def test_export_model_cli_from_jax_snapshots(tmp_path):
    """snapshots -> artifact -> joints, from the config alone; within 1e-3
    mm of a JAX estimator on the saved weights.  ``--platforms`` is
    refused."""
    from lsps_tpu_torch.cli import export_model

    cfg, state = _snapshots(tmp_path)
    art_path = str(tmp_path / "pose.pt2")
    export_model.main(["--config", cfg, "--out", art_path, "--batch", "1",
                       "--device", "cpu", "--frame-shape", f"{H},{W}"])
    art = E.ArtifactPoseEstimator(art_path)
    assert art.bucket == 1 and art.device.type == "cpu"
    frames, coms, cubes = _batch(2, seed=5)
    # no dataset names the ICVL class: build_estimator takes the NYU camera
    want = JaxEstimator(dict(HYP), state["params"],
                        camera=Camera.nyu()).predict_frames(frames, coms,
                                                            cubes)
    np.testing.assert_allclose(
        art.predict_frames(frames, coms, cubes).numpy(), want, rtol=0,
        atol=FRAMES_MM)
    with pytest.raises(SystemExit):
        export_model.main(["--config", cfg, "--out", art_path,
                           "--platforms", "tpu,cpu", "--device", "cpu"])


def test_daemon_serves_artifacts(pair, artifacts):
    """``serve.server`` in ``--artifact`` mode: a with-CoM artifact answers
    /healthz and two batch sizes over npz; a raw one answers raw JSON and
    refuses CoMs with a 400, as the JAX daemon does."""
    jest, est = pair
    frames, coms, cubes = _batch(3)
    opts = pserver.parser().parse_args(["--artifact",
                                        artifacts["static2"][0],
                                        "--device", "cpu"])
    ps, httpd = pserver.make_server(pserver.load_estimator(opts, None),
                                    port=0)
    raw_ps, raw_httpd = pserver.make_server(artifacts["raw_static2"][1],
                                            port=0, batch_window_ms=5.0)
    for h in (httpd, raw_httpd):
        threading.Thread(target=h.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    raw_url = f"http://127.0.0.1:{raw_httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz") as r:
            assert json.load(r)["joints"] == 36
        for n in (3, 1):
            buf = io.BytesIO()
            np.savez(buf, frames=frames[:n], coms=coms[:n], cubes=cubes[:n])
            req = urllib.request.Request(url + "/predict_npz",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req) as r:
                joints = np.load(io.BytesIO(r.read()))["joints"]
            np.testing.assert_allclose(
                joints, jest.predict_frames(frames[:n], coms[:n],
                                            cubes[:n]),
                rtol=0, atol=FRAMES_MM)
        req = urllib.request.Request(
            raw_url + "/predict",
            data=json.dumps({"frames": frames[:2].tolist()}).encode(),
            method="POST")
        with urllib.request.urlopen(req) as r:
            resp = json.load(r)
        assert resp["detected"] == [True, True]
        assert np.array_equal(np.asarray(resp["joints"], np.float32),
                              est.predict_raw(frames[:2]).numpy())
        bad = urllib.request.Request(
            raw_url + "/predict",
            data=json.dumps({"frames": frames[:1].tolist(),
                             "coms": coms[:1].tolist()}).encode(),
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400
        assert ps.batches == 2 and raw_ps.batches == 1
    finally:
        for h in (httpd, raw_httpd):
            h.shutdown()
            h.server_close()
        raw_ps.batcher.close()
