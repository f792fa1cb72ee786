"""The port's serving daemon (``lsps_tpu_torch.serve.server``) against the
JAX package's, on the CPU.

1. ``MicroBatcher`` on the stub estimator of
   ``tests/test_serve_microbatch.py``: coalescing, padding, groups, the hard
   cap with carry-over, chunking, the non-power-of-two cap, error fan-out,
   per-item retries, abandoned items and the accept backlog.  Where a
   scenario is deterministic (a parked dispatcher driven by hand), the JAX
   package's batcher runs it too and both make the same estimator calls.
2. Both daemons on ephemeral ports over the same weights (the port's
   through ``from_jax_params``), answering the same JSON, npz (whole-mm
   uint16) and raw requests, a failed detection and missing cubes
   included; the port's daemon micro-batches.  Joints agree within 1e-3 mm
   on the with-CoM path (bit-equal crops; float32 convs summed in another
   order) and within the derived raw-path bound of
   ``test_torch_serve.py`` on the raw path; ``detected`` is equal; both
   answer 400 to the same bad requests.
3. ``build_estimator`` from ``.npz`` snapshots the JAX trainer wrote, with
   its two refusals (no VAE matched; no checkpoint).
"""

import io
import json
import socket
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
from lsps_tpu.serve import server as jserver
from lsps_tpu.serve.detect_jax import device_detect_batch as jax_detect
from lsps_tpu.serve.inference import PoseEstimator as JaxEstimator
from lsps_tpu_torch.data.camera import Camera as PortCamera
from lsps_tpu_torch.serve import server as pserver
from lsps_tpu_torch.serve.inference import PoseEstimator
from lsps_tpu_torch.weights import from_jax_params
from test_torch_serve import raw_joint_tolerance

torch.set_num_threads(1)

HYP = default_hyperparameters(reg_dim=108, small=True)
HYP["dis"]["ch"] = 4
HYP["gen"]["ch"] = 4
FRAMES_MM = 1e-3


# ---------------------------------------------------------------------------
# 1. the micro-batcher
# ---------------------------------------------------------------------------

class _StubEstimator:
    """Records each call's batch; joint 0 x = the frame's mean, y = the
    CoM's u, so that scattering is checkable.  A gate holds the FIRST
    dispatch open while more requests queue."""

    n_joints = 4

    def __init__(self, gate=None):
        self.calls = []
        self.gate = gate
        self.fail = False

    def predict_frames(self, frames, coms, cubes):
        self.calls.append(frames.shape[0])
        if self.gate is not None and len(self.calls) == 1:
            self.gate.wait(10.0)
        if self.fail:
            raise RuntimeError("injected estimator failure")
        out = np.zeros((frames.shape[0], 4, 3), np.float32)
        out[:, 0, 0] = frames.reshape(frames.shape[0], -1).mean(axis=1)
        out[:, 0, 1] = coms[:, 0]
        return out


def _serve_threads(server, requests):
    results = [None] * len(requests)
    errors = [None] * len(requests)

    def run(i, req):
        try:
            results[i] = server.predict(*req)
        except Exception as e:  # noqa: BLE001 - asserted by callers
            errors[i] = e

    ts = [threading.Thread(target=run, args=(i, r))
          for i, r in enumerate(requests)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    return results, errors


def _wait(cond):
    for _ in range(500):
        if cond():
            return
        threading.Event().wait(0.01)


def _req(fill, u=0.0, shape=(8, 8)):
    return (np.full((1, *shape), fill, np.float32),
            np.array([[u, 0, 700]], np.float32),
            np.full((1, 3), 300.0, np.float32))


def test_bucket_powers_of_two():
    ns = (1, 2, 3, 4, 5, 7, 8, 9, 64, 65)
    assert [pserver._bucket(n) for n in ns] == \
        [jserver._bucket(n) for n in ns] == [1, 2, 4, 4, 8, 8, 8, 16, 64, 128]


def test_coalesce_pad_and_scatter():
    """5 concurrent 1-frame requests: the first dispatches alone, the four
    others queue behind it and coalesce into ONE call of 4; each gets its
    own frame's answer."""
    gate = threading.Event()
    est = _StubEstimator(gate=gate)
    server = pserver.PoseServer(est, batch_window_ms=0.0, max_batch=64)
    try:
        reqs = [_req(float(i), 10.0 * i) for i in range(5)]
        out = {}
        t1 = threading.Thread(
            target=lambda: out.update(first=_serve_threads(server, reqs[:1])))
        t1.start()
        _wait(lambda: est.calls)
        assert est.calls == [1]
        t2 = threading.Thread(
            target=lambda: out.update(rest=_serve_threads(server, reqs[1:])))
        t2.start()
        _wait(lambda: server.batcher._q.qsize() >= 4)
        gate.set()
        t1.join(timeout=30)
        t2.join(timeout=30)
        results = out["first"][0] + out["rest"][0]
        assert all(e is None for e in out["first"][1] + out["rest"][1])
        assert est.calls == [1, 4]
        for i, (joints, detected) in enumerate(results):
            assert detected is None and joints.shape == (1, 4, 3)
            np.testing.assert_allclose(joints[0, 0, :2], [i, 10.0 * i],
                                       rtol=1e-6)
    finally:
        server.batcher.close()


def test_pad_to_bucket_and_mixed_shapes():
    """3 frames dispatch as a padded bucket of 4, the pad trimmed; requests
    of other frame shapes in one window never share a call."""
    est = _StubEstimator()
    batcher = pserver.MicroBatcher(
        lambda f, c, k: (est.predict_frames(f, c, k), None),
        window_ms=200.0, max_batch=64)
    try:
        frames = np.stack([np.full((8, 8), float(i), np.float32)
                           for i in range(3)])
        joints, _ = batcher.submit(frames, np.zeros((3, 3), np.float32),
                                   np.full((3, 3), 300.0, np.float32))
        assert est.calls == [4] and joints.shape == (3, 4, 3)
        np.testing.assert_allclose(joints[:, 0, 0], [0.0, 1.0, 2.0])
    finally:
        batcher.close()

    gate = threading.Event()
    est = _StubEstimator(gate=gate)
    server = pserver.PoseServer(est, batch_window_ms=50.0, max_batch=64)
    try:
        reqs = [_req(5.0, 1.0), _req(7.0, 2.0, (6, 6)), _req(9.0, 3.0)]
        out = {}
        t = threading.Thread(
            target=lambda: out.update(r=_serve_threads(server, reqs)))
        t.start()
        _wait(lambda: est.calls)
        gate.set()
        t.join(timeout=30)
        results, errors = out["r"]
        assert all(e is None for e in errors)
        for (joints, _), want in zip(results, (5.0, 7.0, 9.0)):
            np.testing.assert_allclose(joints[0, 0, 0], want, rtol=1e-6)
        assert sum(est.calls) == 3 and len(est.calls) >= 2
    finally:
        server.batcher.close()


def test_error_propagates_to_every_waiter():
    est = _StubEstimator()
    est.fail = True
    server = pserver.PoseServer(est, batch_window_ms=20.0, max_batch=64)
    try:
        results, errors = _serve_threads(server,
                                         [_req(float(i)) for i in range(3)])
        assert all(r is None for r in results)
        assert all(isinstance(e, RuntimeError) for e in errors)
    finally:
        server.batcher.close()


def test_accept_backlog_absorbs_a_burst():
    """64 connections to a server that never accepts are all queued by
    the listen backlog (the default of 5 would refuse most)."""
    assert pserver.PoseHTTPServer.request_queue_size >= 128

    class _Nop:
        pass

    httpd = pserver.PoseHTTPServer(("127.0.0.1", 0), _Nop)
    port = httpd.server_address[1]
    socks, ok = [], 0
    try:
        for _ in range(64):
            s = socket.socket()
            s.settimeout(2.0)
            try:
                s.connect(("127.0.0.1", port))
                ok += 1
            except OSError:
                pass
            socks.append(s)
        assert ok == 64
    finally:
        for s in socks:
            s.close()
        httpd.server_close()


def _stopped_batcher(mod, run_group, max_batch):
    """A batcher of ``mod`` whose dispatcher thread is parked, so that the
    test drives ``_collect`` / ``_round`` / ``_dispatch`` itself."""
    b = mod.MicroBatcher(run_group, window_ms=0.0, max_batch=max_batch)
    b._stop = True
    b._thread.join(timeout=5.0)
    b._stop = False
    return b


def _pending(mod, n, fill=0.0, coms=True):
    return mod._Pending(np.full((n, 8, 8), fill, np.float32),
                        np.tile(np.array([[fill, 0, 700]], np.float32),
                                (n, 1)) if coms else None,
                        np.full((n, 3), 300.0, np.float32))


def _poison_group(calls):
    def run_group(frames, coms, cubes):
        calls.append(frames.shape[0])
        if (frames == 666.0).any():
            raise RuntimeError("poison frame")
        out = np.zeros((frames.shape[0], 4, 3), np.float32)
        out[:, 0, 0] = frames.reshape(frames.shape[0], -1).mean(axis=1)
        return out, None
    return run_group


def _scenario(mod, name):
    """One parked-dispatcher scenario on ``mod``'s batcher; returns what
    the test compares: the estimator calls and the items' outcomes."""
    calls = []
    run = _poison_group(calls)
    if name == "hard_cap_carries_overflow":
        b = _stopped_batcher(mod, run, max_batch=4)
        i3, i2 = _pending(mod, 3, 1.0), _pending(mod, 2, 2.0)
        b._q.put(i3)
        b._q.put(i2)
        first = b._collect()
        carried = b._carry is i2
        second = b._collect()
        return {"first": [it is i3 for it in first], "carried": carried,
                "second": [it is i2 for it in second],
                "carry_after": b._carry is None}
    if name in ("oversize_chunks_to_cap", "non_pow2_cap"):
        n, cap = (10, 4) if name == "oversize_chunks_to_cap" else (6, 6)
        b = _stopped_batcher(mod, run, max_batch=cap)
        item = _pending(mod, n)
        item.frames[:, 0, 0] = np.arange(n)
        b._dispatch([item])
        np.testing.assert_allclose(item.joints[:, 0, 0],
                                   item.frames.reshape(n, -1).mean(axis=1),
                                   rtol=1e-6)
        return {"calls": calls, "shape": item.joints.shape}
    items = {"lone_failure": [666.0],
             "abandoned_dropped": [1.0, 2.0],
             "group_failure_retries": [1.0, 666.0, 2.0]}[name]
    b = _stopped_batcher(mod, run, max_batch=8)
    its = [_pending(mod, 1, f) for f in items]
    if name == "abandoned_dropped":
        its[0].abandoned = True
    for it in its:
        b._q.put(it)
    b._round()
    return {"calls": calls,
            "errors": [type(it.error).__name__ if it.error else None
                       for it in its],
            "joints": [None if it.joints is None else
                       float(it.joints[0, 0, 0]) for it in its],
            "set": [it.event.is_set() for it in its]}


@pytest.mark.parametrize("name,want_calls", [
    ("hard_cap_carries_overflow", None),
    ("oversize_chunks_to_cap", [4, 4, 2]),
    ("non_pow2_cap", [4, 2]),
    ("lone_failure", [1]),
    ("abandoned_dropped", [1]),
    ("group_failure_retries", [4, 1, 1, 1]),
])
def test_dispatcher_rules_match_jax(name, want_calls):
    """The hard cap leaves the overflowing item for the next round; an
    oversize request runs as chunks of the largest power of two <= the
    cap; a lone failing item is not retried; abandoned items are dropped;
    after a group fails each item is retried alone and only the poison
    one errors.  The JAX batcher makes the same calls with the same
    outcomes."""
    got = _scenario(pserver, name)
    assert got == _scenario(jserver, name)
    if want_calls is not None:
        assert got["calls"] == want_calls
    if name == "hard_cap_carries_overflow":
        assert got == {"first": [True], "carried": True, "second": [True],
                       "carry_after": True}
    if name == "group_failure_retries":
        assert got["errors"] == [None, "RuntimeError", None]
        assert got["joints"] == [1.0, None, 2.0] and all(got["set"])


# ---------------------------------------------------------------------------
# 2. both daemons over HTTP
# ---------------------------------------------------------------------------

def _serve(ps):
    httpd = pserver.PoseHTTPServer(("127.0.0.1", 0), ps.handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def daemons():
    kd, kv = jax.random.split(jax.random.PRNGKey(0))
    params = {"dis": build_model(HYP["dis"]).init(kd),
              "vae": build_model(HYP["vae"]).init(kv)}
    jps = jserver.PoseServer(JaxEstimator(HYP, params, camera=Camera.nyu()))
    pps = pserver.PoseServer(
        PoseEstimator(HYP, from_jax_params(params),
                      camera=PortCamera.nyu(), device="cpu"),
        batch_window_ms=25.0)
    (jh, jurl), (ph, purl) = _serve(jps), _serve(pps)
    yield jurl, purl, pps
    for h in (jh, ph):
        h.shutdown()
        h.server_close()
    pps.batcher.close()


def _hands(n, seed=7):
    cam = Camera.nyu()
    gen = np.random.RandomState(seed)
    frames, coms = [], []
    for i in range(n):
        com3d = np.array([25.0 * i - 20.0, 12.0 * i, 720.0 + 35.0 * i],
                         np.float32)
        frames.append(render_hand_depth(cam, com3d, 36, gen)[0])
        coms.append(cam.to_img(com3d))
    return (np.round(np.stack(frames)).astype(np.float32),
            np.stack(coms).astype(np.float32))


def _post(url, path, body, npz=False):
    data = body if npz else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method="POST")
    with urllib.request.urlopen(req) as r:
        raw = r.read()
    return dict(np.load(io.BytesIO(raw))) if npz else json.loads(raw)


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_daemons_answer_alike(daemons):
    """The same JSON, npz and raw requests to both daemons, the port's
    concurrently (micro-batched); with-CoM joints within 1e-3 mm, raw
    joints within the derived bound, ``detected`` equal, strict JSON."""
    jurl, purl, pps = daemons
    frames, coms = _hands(3)
    cubes = np.full((3, 3), 300.0, np.float32)
    blank = np.zeros_like(frames[:1])
    u16 = frames.astype(np.uint16)
    reqs = [
        ("/predict", {"frames": frames[:2].tolist(),
                      "coms": coms[:2].tolist(),
                      "cubes": cubes[:2].tolist()}, False),
        ("/predict", {"frames": frames[2:].tolist(),
                      "coms": coms[2:].tolist()}, False),  # cubes: 300
        ("/predict_npz", _npz(frames=u16, coms=coms, cubes=cubes), True),
        ("/predict", {"frames": frames[1:].tolist()}, False),       # raw
        ("/predict", {"frames": np.concatenate([frames[:1],
                                                blank]).tolist()},
         False),                                                    # raw
        ("/predict_npz", _npz(frames=u16[:2]), True),               # raw
    ]
    want = [_post(jurl, p, b, z) for p, b, z in reqs]
    got = [None] * len(reqs)

    def run(i):
        got[i] = _post(purl, *reqs[i])

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    raw_frames = [frames[1:], np.concatenate([frames[:1], blank]), u16[:2]]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None
        gj, wj = np.asarray(g["joints"]), np.asarray(w["joints"])
        assert gj.shape == wj.shape and np.isfinite(gj).all()
        det = g.get("detected")
        assert np.array_equal(np.asarray(det), np.asarray(w.get("detected")))
        if det is None:
            np.testing.assert_allclose(gj, wj, rtol=0, atol=FRAMES_MM)
        else:
            f = raw_frames[i - 3]
            tol = raw_joint_tolerance(jax_detect(
                f, np.full((len(f), 3), 300.0, np.float32), Camera.nyu().fx,
                Camera.nyu().fy))
            assert np.all(np.abs(gj - wj) <= tol), (i, np.abs(gj - wj).max())
    # the failed detection: detected false, joints zeroed
    assert got[4]["detected"] == [True, False]
    assert np.all(np.asarray(got[4]["joints"])[1] == 0.0)
    with urllib.request.urlopen(purl + "/healthz") as r:
        h = json.load(r)
    assert h["ok"] is True and h["joints"] == 36 and h["microbatch"] is True
    assert h["batches"] == pps.batches > 0


def _status(url, path, body=None, headers=()):
    import http.client

    host, port = url.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        if body is None and not headers:
            conn.request("GET", path)
        else:
            conn.putrequest("POST", path, skip_accept_encoding=True)
            for k, v in headers:
                conn.putheader(k, v)
            conn.endheaders(body)
        r = conn.getresponse()
        r.read()
        return r.status
    finally:
        conn.close()


def _bad(kind):
    if kind == "content_length":
        return "/predict", None, (("Content-Length", "not-a-number"),)
    body = {"shape": {"frames": [[1.0, 2.0]], "coms": [[0, 0, 1]],
                      "cubes": [[300, 300, 300]]},
            "coms": {"frames": np.zeros((1, 6, 6)).tolist(),
                     "coms": [[1, 2]]},
            "cubes": {"frames": np.zeros((2, 6, 6)).tolist(),
                      "cubes": [[300, 300, 300]]},
            "no_frames": {"coms": [[0, 0, 1]]},
            "json": None}[kind]
    data = b"{not json" if body is None else json.dumps(body).encode()
    return "/predict", data, (("Content-Length", str(len(data))),)


@pytest.mark.parametrize("kind", ["shape", "coms", "cubes", "no_frames",
                                  "json", "content_length"])
def test_bad_requests_400_alike(daemons, kind):
    jurl, purl, _ = daemons
    path, body, headers = _bad(kind)
    assert _status(purl, path, body, headers) == \
        _status(jurl, path, body, headers) == 400


def test_unknown_paths_404_and_raw_without_detection_400(daemons):
    jurl, purl, _ = daemons
    assert _status(purl, "/nope") == _status(jurl, "/nope") == 404

    class NoRaw:
        n_joints = 36

    frames, _ = _hands(1)
    for mod in (pserver, jserver):
        with pytest.raises(ValueError, match="no on-device detection"):
            mod.PoseServer(NoRaw()).predict(frames, None, None)


# ---------------------------------------------------------------------------
# 3. build_estimator from the JAX trainer's snapshots
# ---------------------------------------------------------------------------

def _experiment(tmp_path, with_vae):
    from lsps_tpu.train.trainer import LSPSTrainer

    prefix = str(tmp_path / "outputs" / "pre")
    trainer = LSPSTrainer(dict(HYP))
    state = trainer.init_state(jax.random.PRNGKey(1))
    trainer.save(state, prefix, 99)
    if with_vae:
        trainer.save_vae(state, prefix, 99, 2 + 0.5)
    cfg = {"train": {"snapshot_prefix": prefix,
                     "snapshot_save_iterations": 100,
                     "image_save_iterations": 100,
                     "image_display_iterations": 100, "display": 10,
                     "hyperparameters": dict(HYP), "datasets": {}}}
    path = tmp_path / "exp.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), state


def test_build_estimator_from_jax_snapshots(tmp_path):
    """The port's daemon serves the JAX trainer's snapshots: the joints of
    both packages' ``build_estimator`` agree within 1e-3 mm."""
    cfg, state = _experiment(tmp_path, with_vae=True)
    est = pserver.build_estimator(cfg, frac=0.5, device="cpu")
    assert isinstance(est, PoseEstimator) and est.device.type == "cpu"
    frames, coms = _hands(2, seed=3)
    cubes = np.full((2, 3), 300.0, np.float32)
    want = JaxEstimator(dict(HYP), state["params"],
                        camera=Camera.nyu()).predict_frames(frames, coms,
                                                            cubes)
    np.testing.assert_allclose(est.predict_frames(frames, coms,
                                                  cubes).numpy(),
                               want, rtol=0, atol=FRAMES_MM)
    with pytest.raises(RuntimeError, match="no est checkpoint"):
        pserver.build_estimator(cfg, frac=0.5, est=True, device="cpu")


def test_build_estimator_refuses_missing_vae(tmp_path):
    cfg, _ = _experiment(tmp_path, with_vae=False)
    for mod, kw in ((pserver, {"device": "cpu"}), (jserver, {})):
        with pytest.raises(RuntimeError, match="VAE checkpoint"):
            mod.build_estimator(cfg, frac=0.5, **kw)
    assert pserver.build_estimator(cfg, frac=0.5, allow_missing_vae=True,
                                   device="cpu") is not None


def test_main_requires_config_or_artifact(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        pserver.main(["--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserver.main(["--config", "exps/synth.yaml"])
