"""The serving daemon: metric joints over HTTP, from snapshots or an
exported artifact, with dynamic micro-batching.

The port's counterpart of ``lsps_tpu/serve/server.py``; the HTTP surface,
the request validation and the micro-batcher are the same, in numpy and
the standard library:

    python -m lsps_tpu_torch.serve.server --config exps/nnyu.yaml \
        [--frac 0.9] [--est] [--port 8642] [--bf16] [--device 0|cpu] \
        [--batch-window-ms 2 --max-batch 64]
    python -m lsps_tpu_torch.serve.server --artifact pose.pt2

Endpoints:

* ``GET  /healthz``  -> ``{"ok": true, "joints": J, "batches": N,
  "microbatch": bool}``
* ``POST /predict``  -> body JSON ``{"frames": [[...]], "coms": [[u,v,z]],
  "cubes": [[x,y,z]]}`` (one entry per frame); response ``{"joints":
  [[[x,y,z], ...], ...]}`` in metric mm.  Without ``coms`` (and
  optionally ``cubes``, default 300 mm) the CoM is detected on the device
  (``predict_raw``) and the response also carries ``"detected": [bool,
  ...]``: frames where no depth slice qualified get zeroed joints and
  ``false``.
* ``POST /predict_npz`` -> body = an ``.npz`` stream with ``frames`` and
  optional ``coms`` and ``cubes``; response an ``.npz`` with ``joints``
  (and ``detected`` on the raw path).

The estimator (``serve.inference.PoseEstimator`` or
``serve.export.ArtifactPoseEstimator``) returns tensors on its device; the
daemon turns them into numpy inside its lock, at its edge.  The estimator
call is serialized by that lock: one call on the card at a time.
``--batch-window-ms W`` coalesces concurrent requests into one call
padded to a power-of-two bucket (``MicroBatcher``).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

DEFAULT_CUBE_MM = 300.0


class PoseHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog of 128: socketserver's
    default of 5 lets the kernel refuse a burst of concurrent clients
    before the handler runs."""

    request_queue_size = 128


def _camera_for(config):
    """The intrinsics of the dataset the snapshots were trained on: the
    ICVL and MSRA dataset classes use the Intel camera, everything else
    (NYU, the synthetic generator) the Kinect one."""
    from lsps_tpu_torch.data.camera import Camera

    classes = " ".join(str(d.get("class_name", ""))
                       for d in config.datasets.values())
    return (Camera.icvl() if ("ICVL" in classes or "MSRA" in classes)
            else Camera.nyu())


def build_estimator(config_path: str, frac: float = 0.0, est: bool = False,
                    idx: int = -1, bf16: bool = False, camera=None,
                    allow_missing_vae: bool = False, device=None):
    """A ``PoseEstimator`` from an experiment config and its snapshot
    checkpoints: the latest ``pre_*`` set (with ``est``, ``pre_est_*``)
    and the VAE keyed by ``2 + frac``, as ``pose_train`` saves it.
    Refuses to serve random weights: no VAE matched (unless
    ``allow_missing_vae``), or no checkpoint (iteration 0).  ``device``
    is the card unless one is named."""
    import torch

    from lsps_tpu_torch import resolve_device
    from lsps_tpu_torch.cli import common as C
    from lsps_tpu_torch.config import NetConfig
    from lsps_tpu_torch.serve.inference import PoseEstimator

    device = resolve_device(device)
    config = NetConfig(config_path)
    trainer = C.make_trainer(config, sch_interval=1000, device=device,
                             init_seed=0, seed=0)
    if not trainer.load_vae(config.snapshot_prefix, 2 + frac):
        # vae.decode is the last stage of every prediction: a random VAE
        # answers garbage while /healthz reports ok
        msg = (f"no VAE checkpoint matched "
               f"{config.snapshot_prefix}_vae_{2 + frac:.2f}_*")
        if not allow_missing_vae:
            raise RuntimeError(
                msg + " (pass --allow-missing-vae to serve anyway)")
        print(f"warning: {msg}; serving with random-init VAE",
              file=sys.stderr)
    it = trainer.resume(config.snapshot_prefix, idx=idx, est=est)
    if it == 0:
        raise RuntimeError(
            f"no {'est ' if est else ''}checkpoint found under "
            f"{config.snapshot_prefix!r}")
    print(f"serving checkpoint at iteration {it}", file=sys.stderr)
    state = {f"{net}.{k}": v for net in ("dis", "vae")
             for k, v in trainer.nets[net].state_dict().items()}
    return PoseEstimator(config.hyperparameters, state,
                         camera=camera or _camera_for(config),
                         dtype=torch.bfloat16 if bf16 else torch.float32,
                         device=device)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _Pending:
    """One in-flight request inside the micro-batcher."""

    __slots__ = ("frames", "coms", "cubes", "event", "joints", "detected",
                 "error", "abandoned")

    def __init__(self, frames, coms, cubes):
        self.frames, self.coms, self.cubes = frames, coms, cubes
        self.event = threading.Event()
        self.joints = self.detected = self.error = None
        self.abandoned = False  # submit() timed out; drop, don't compute


def _bucket(n: int) -> int:
    """Next power of two >= n: a coalesced batch takes one of log2 shapes
    (the padded shapes a static-batch artifact or a tuned library call
    sees)."""
    b = 1
    while b < n:
        b <<= 1
    return b


class MicroBatcher:
    """Dynamic request coalescing for the daemon.

    A dispatcher thread takes the first pending request, keeps collecting
    for up to ``window_ms`` (or until ``max_batch`` frames), groups
    compatible requests (same frame shape and dtype, same path: with CoMs
    or raw), concatenates each group, pads it to the next power of two,
    runs it as one estimator call and hands each request its slice.

    ``window_ms=0`` coalesces only what queued while the previous call
    ran.  ``max_batch`` is a hard cap: an item that would pass it leads
    the next round, and a single larger request runs as chunks of the
    largest power of two <= ``max_batch``, so that no call, padding
    included, exceeds it.  After a group fails, each of its items is
    retried alone once, so that one bad request fails only itself; a lone
    item is not retried.  Items whose submitter timed out are dropped."""

    def __init__(self, run_group, window_ms: float = 2.0,
                 max_batch: int = 64):
        self._run_group = run_group   # (frames, coms|None, cubes) -> ...
        self.window = window_ms / 1e3
        self.max_batch = int(max_batch)
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._carry: "_Pending | None" = None  # overflow from _collect
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lsps-microbatch")
        self._thread.start()

    def submit(self, frames, coms, cubes, timeout: float = 300.0):
        """Enqueue one validated request and wait for its slice of the
        coalesced result: ``(joints, detected|None)``."""
        item = _Pending(frames, coms, cubes)
        self._q.put(item)
        if not item.event.wait(timeout):
            item.abandoned = True
            raise RuntimeError("micro-batch dispatch timed out")
        if item.error is not None:
            raise item.error
        return item.joints, item.detected

    def close(self):
        self._stop = True
        self._thread.join(timeout=5.0)

    # dispatcher internals ------------------------------------------------
    def _collect(self):
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                return []
        batch, n = [first], first.frames.shape[0]
        deadline = time.monotonic() + self.window
        while n < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                # remaining <= 0 still drains what is already queued
                item = (self._q.get_nowait() if remaining <= 0
                        else self._q.get(timeout=remaining))
            except queue.Empty:
                break
            if n + item.frames.shape[0] > self.max_batch:
                self._carry = item  # leads the next round
                break
            batch.append(item)
            n += item.frames.shape[0]
        return batch

    def _loop(self):
        while not self._stop:
            self._round()

    def _round(self):
        """One collect -> group -> dispatch cycle (the loop's body, apart
        so that tests can drive it)."""
        batch = [it for it in self._collect() if not it.abandoned]
        groups = {}
        for item in batch:
            key = (item.frames.shape[1:], item.frames.dtype.str,
                   item.coms is None)
            groups.setdefault(key, []).append(item)
        for items in groups.values():
            try:
                self._dispatch(items)
            except Exception as e:
                if len(items) == 1:
                    items[0].error = e
                else:
                    for it in items:
                        try:
                            self._dispatch([it])
                        except Exception as e2:
                            # an exception of its own per waiter: handler
                            # threads re-raise them concurrently
                            it.error = e2
            finally:
                for it in items:
                    it.event.set()

    def _dispatch(self, items):
        frames = np.concatenate([it.frames for it in items])
        cubes = np.concatenate([it.cubes for it in items])
        coms = (None if items[0].coms is None
                else np.concatenate([it.coms for it in items]))
        n = frames.shape[0]
        cap = _bucket(self.max_batch)
        if cap > self.max_batch:
            cap >>= 1
        js, ds = [], []
        for s in range(0, n, cap):
            f, c = frames[s:s + cap], cubes[s:s + cap]
            m = None if coms is None else coms[s:s + cap]
            pad = _bucket(f.shape[0]) - f.shape[0]
            if pad:  # repeat the last frame; the results are trimmed
                f = np.concatenate([f, np.repeat(f[-1:], pad, 0)])
                c = np.concatenate([c, np.repeat(c[-1:], pad, 0)])
                if m is not None:
                    m = np.concatenate([m, np.repeat(m[-1:], pad, 0)])
            j, d = self._run_group(f, m, c)
            js.append(j[:min(cap, n - s)])
            if d is not None:
                ds.append(d[:min(cap, n - s)])
        joints = np.concatenate(js)
        detected = np.concatenate(ds) if ds else None
        off = 0
        for it in items:
            k = it.frames.shape[0]
            it.joints = joints[off:off + k]
            if detected is not None:
                it.detected = detected[off:off + k]
            off += k


class PoseServer:
    """The estimator, the request counter and the HTTP handler.

    ``estimator`` is anything with ``predict_frames`` (and, for raw
    requests, ``predict_raw``): a live ``PoseEstimator`` or an
    ``ArtifactPoseEstimator``.  ``batch_window_ms`` (not None) turns on
    micro-batching; ``max_batch`` caps its coalesced frames.  ``batches``
    counts the estimator calls."""

    def __init__(self, estimator, batch_window_ms: float = None,
                 max_batch: int = 64):
        self.est = estimator
        self.lock = threading.Lock()
        self.batches = 0
        self.n_joints = int(estimator.n_joints)
        self.batcher = (MicroBatcher(self._run_group, batch_window_ms,
                                     max_batch)
                        if batch_window_ms is not None else None)

    def _run_group(self, frames, coms, cubes):
        """One locked estimator call on either path, its outputs in numpy;
        the raw path flags failed detections and zeroes their joints."""
        if coms is None:
            with self.lock:
                joints, det_coms = self.est.predict_raw(frames, cubes,
                                                        return_coms=True)
                joints, det_coms = _host(joints), _host(det_coms)
                self.batches += 1
            # a zero CoM (no qualifying depth slice) gives NaN or
            # degenerate joints, and json.dumps would write literal NaN
            detected = det_coms[:, 2] > 0
            joints = np.where(detected[:, None, None], joints, 0.0)
            return joints, detected
        with self.lock:
            joints = _host(self.est.predict_frames(frames, coms, cubes))
            self.batches += 1
        return joints, None

    def predict(self, frames, coms, cubes):
        """``coms=None`` selects the raw path (the CoM detected on the
        device).  Returns ``(joints, detected)``: ``detected`` is a bool
        per frame on the raw path (False: zeroed joints) and None on the
        with-CoM path.  ``cubes`` default to 300 mm on both paths; uint16
        frames (sensor millimetres) pass through as uint16."""
        frames = np.asarray(frames)
        if frames.dtype != np.uint16:
            frames = np.asarray(frames, np.float32)
        if frames.ndim != 3:
            raise ValueError(f"frames {frames.shape}: want (B, H, W)")
        if cubes is None:
            cubes = np.full((frames.shape[0], 3), DEFAULT_CUBE_MM,
                            np.float32)
        cubes = np.asarray(cubes, np.float32)
        if cubes.shape != (frames.shape[0], 3):
            raise ValueError(f"cubes {cubes.shape}: want "
                             f"({frames.shape[0]}, 3)")
        if coms is None:
            if getattr(self.est, "predict_raw", None) is None:
                raise ValueError(
                    "this estimator has no on-device detection (a "
                    "with-CoM artifact); supply 'coms'")
        else:
            coms = np.asarray(coms, np.float32)
            if coms.shape != (frames.shape[0], 3):
                raise ValueError(
                    f"shapes: frames {frames.shape} (want B,H,W), coms "
                    f"{coms.shape} (want B,3)")
        if self.batcher is not None:
            return self.batcher.submit(frames, coms, cubes)
        return self._run_group(frames, coms, cubes)

    def handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            timeout = 60           # slow clients release their threads
            MAX_BODY = 256 << 20   # refuse absurd request bodies

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code, body: bytes, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code, msg):
                self._send(code, json.dumps({"error": msg}).encode())

            def do_GET(self):
                if self.path != "/healthz":
                    return self._error(404, "not found")
                self._send(200, json.dumps(
                    {"ok": True, "joints": server.n_joints,
                     "batches": server.batches,
                     "microbatch": server.batcher is not None}).encode())

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    return self._error(400, "malformed Content-Length")
                if n > self.MAX_BODY:
                    return self._error(413,
                                       f"body {n} bytes > {self.MAX_BODY}")
                body = self.rfile.read(n)
                try:
                    if self.path == "/predict":
                        req = json.loads(body)
                        joints, detected = server.predict(
                            req["frames"], req.get("coms"),
                            req.get("cubes"))
                        resp = {"joints": joints.tolist()}
                        if detected is not None:
                            resp["detected"] = detected.tolist()
                        self._send(200, json.dumps(resp).encode())
                    elif self.path == "/predict_npz":
                        data = np.load(io.BytesIO(body))
                        joints, detected = server.predict(
                            data["frames"],
                            data["coms"] if "coms" in data.files else None,
                            data["cubes"] if "cubes" in data.files else None)
                        buf = io.BytesIO()
                        if detected is not None:
                            np.savez(buf, joints=joints, detected=detected)
                        else:
                            np.savez(buf, joints=joints)
                        self._send(200, buf.getvalue(),
                                   ctype="application/octet-stream")
                    else:
                        self._error(404, "not found")
                except (ValueError, KeyError, TypeError) as e:
                    # a malformed request (json.JSONDecodeError is a
                    # ValueError)
                    self._error(400, f"{type(e).__name__}: {e}")
                except Exception as e:  # a server fault: 500, stay up
                    self._error(500, f"{type(e).__name__}: {e}")

        return Handler


def make_server(estimator, port: int = 8642, host: str = "127.0.0.1",
                batch_window_ms: float = None, max_batch: int = 64):
    """A bound ``PoseHTTPServer`` over a ``PoseServer`` (port 0: an
    ephemeral one); returns ``(pose_server, httpd)``."""
    ps = PoseServer(estimator, batch_window_ms=batch_window_ms,
                    max_batch=max_batch)
    return ps, PoseHTTPServer((host, port), ps.handler())


def serve_forever(estimator, port: int = 8642, host: str = "127.0.0.1",
                  batch_window_ms: float = None, max_batch: int = 64):
    _, httpd = make_server(estimator, port, host, batch_window_ms,
                           max_batch)
    extra = (f" (micro-batching: window {batch_window_ms} ms, "
             f"max {max_batch} frames)" if batch_window_ms is not None
             else "")
    print(f"serving on http://{host}:{port}{extra}", file=sys.stderr)
    httpd.serve_forever()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LSPS pose serving daemon "
                                            "(PyTorch/CUDA)")
    p.add_argument("--config", default=None,
                   help="experiment config (serving from its snapshots); "
                        "not needed with --artifact")
    p.add_argument("--artifact", default=None,
                   help="serve a saved torch.export artifact "
                        "(cli.export_model output) instead of snapshots; "
                        "a static-batch artifact pads to its batch")
    p.add_argument("--frac", type=float, default=0.0)
    p.add_argument("--est", action="store_true",
                   help="load the pre_est_* regression checkpoints")
    p.add_argument("--idx", type=int, default=-1)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--port", type=int, default=8642)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--allow-missing-vae", action="store_true",
                   help="serve even if no VAE checkpoint matches "
                        "(predictions will be garbage; debug only)")
    p.add_argument("--batch-window-ms", type=float, default=None,
                   help="enable dynamic micro-batching: coalesce "
                        "concurrent requests for up to this many ms into "
                        "one padded-to-bucket call (0 = only what is "
                        "already queued)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="micro-batching: max coalesced frames per call")
    p.add_argument("--device", "--gpu", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    return p


def load_estimator(opts, p: argparse.ArgumentParser):
    """The estimator the parsed flags name."""
    from lsps_tpu_torch.cli.common import device_of

    device = device_of(opts)
    if opts.artifact:
        from lsps_tpu_torch.serve.export import ArtifactPoseEstimator

        est = ArtifactPoseEstimator(opts.artifact, device=device)
        print(f"serving artifact {opts.artifact} "
              f"(bucket={est.bucket or 'symbolic'}, "
              f"joints={est.n_joints})", file=sys.stderr)
        return est
    if opts.config:
        return build_estimator(opts.config, frac=opts.frac, est=opts.est,
                               idx=opts.idx, bf16=opts.bf16,
                               allow_missing_vae=opts.allow_missing_vae,
                               device=device)
    p.error("one of --config or --artifact is required")


def main(argv=None):
    p = parser()
    opts = p.parse_args(argv)
    serve_forever(load_estimator(opts, p), port=opts.port, host=opts.host,
                  batch_window_ms=opts.batch_window_ms,
                  max_batch=opts.max_batch)


if __name__ == "__main__":
    main(sys.argv[1:])
