"""Metrics logging and run artifacts.

The port's copy of ``lsps_tpu/utils/logging.py`` (reference:
src/common.py:19-80): snapshot and image folders, the HTML gallery,
``write_loss``, which logs every loss, accuracy and learning-rate entry
of an update's metrics, and ``StepTimer``, steps per second by window.
Metrics go to ``metrics.jsonl`` only (the JAX package's fallback when
tensorboardX is missing; the card's machine has none).
``profile_trace`` wraps ``torch.profiler`` and writes a Chrome trace into
``--profile-dir``.

``span(name)`` is a ``lsps.<name>`` range in a torch.profiler trace, on
the clock of the kernels and copies: the trace attributes each kernel to
the span it was launched in, and each idle gap of the card to the span
the host was in.  A span records only while a profiler records (the
``--profile-dir`` trace, a benchmark's profiled window) and only on the
thread that opens it; at any other time, and while ``torch.export`` or
``torch.compile`` traces, it is one shared no-op context.  The spans,
opened only on the thread that calls into the port:

* ``lsps.predict``: ``PoseEstimator.predict_frames`` and ``predict_raw``,
  the whole call (the joints stay on the device);
* ``lsps.h2d``: the estimator's frames copied to its device;
* ``lsps.detect``: ``RawProgram``'s CoM detection;
* ``lsps.crop``, ``lsps.regress``, ``lsps.decode``: ``FramesProgram``'s
  crop kernel, regressor, and pose decode with the denormalize;
* ``lsps.augment``: the trainer's fused augment of both raw batches,
  their copy to the device included;
* ``lsps.dis``, ``lsps.gen``: a discriminator and a generator update,
  forward, losses, backward and optimizer step;
* ``lsps.backward``: the gradients of an update (under remat with the
  recompute);
* ``lsps.optim``: the gradients' cast and the optimizer step (under a
  mesh with the all-reduce between them);
* ``lsps.loader_wait``: a ``DataLoader`` consumer's blocking wait on an
  empty prefetch queue (``data/loader.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

IMAGE_EXT = ".png"  # the JAX package writes .jpg through cv2


def prepare_snapshot_folder(snapshot_prefix: str) -> str:
    d = os.path.dirname(snapshot_prefix) or "."
    os.makedirs(d, exist_ok=True)
    return d


def prepare_image_folder(snapshot_directory: str) -> str:
    d = os.path.join(snapshot_directory, "images")
    os.makedirs(d, exist_ok=True)
    return d


def prepare_snapshot_and_image_folder(snapshot_prefix: str, iterations: int,
                                      image_save_iterations: int,
                                      all_size: int = 1536):
    snap = prepare_snapshot_folder(snapshot_prefix)
    img = prepare_image_folder(snap)
    write_html(os.path.join(snap, "index.html"), iterations + 1,
               image_save_iterations, img, all_size)
    return img, snap


def write_html(filename: str, iterations: int, image_save_iterations: int,
               image_directory: str, all_size: int = 1536) -> None:
    """Auto-refreshing gallery of the generated strips (common.py:37-69),
    linking the ``.png`` files the port writes."""
    current = f"{image_directory}/gen{IMAGE_EXT}"
    parts = [
        "<!DOCTYPE html><html><head>",
        "<title>LSPS-TPU training gallery</title>",
        '<meta content="1" http-equiv="refresh">',
        "</head><body>",
        "<h3>current</h3>",
        f'<p><a href="{current}">'
        f'<img src="{current}" style="width:{all_size}px">'
        "</a><br><p>",
    ]
    for j in range(iterations, image_save_iterations - 1, -1):
        if j % image_save_iterations == 0:
            img = f"{image_directory}/gen_{j:08d}{IMAGE_EXT}"
            parts.append(f"<h3>iteration [{j}]</h3>")
            parts.append(f'<p><a href="{img}"><img src="{img}" '
                         f'style="width:{all_size}px"></a><br><p>')
    parts.append("</body></html>")
    with open(filename, "w") as f:
        f.write("\n".join(parts))


def _scalar(v) -> float:
    """A metric (python number, numpy or torch scalar) as a float."""
    if hasattr(v, "detach"):
        v = v.detach().cpu()
    return float(np.asarray(v))


class MetricsWriter:
    """Scalar logger: one JSON object per ``write`` in
    ``<logdir>/metrics.jsonl``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = _scalar(v)
            except Exception:
                continue
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        self.jsonl.close()


def write_loss(iterations: int, max_iterations: int,
               metrics: Dict[str, float], writer: MetricsWriter,
               elapsed_time: float) -> None:
    """Reference-named loop hook (common.py:71-80): prints progress and
    logs every loss/acc metric."""
    print(f"Iteration: {iterations + 1:08d}/{max_iterations:08d} "
          f"{elapsed_time:.2f}s")
    writer.write(iterations + 1,
                 {k: v for k, v in metrics.items()
                  if "loss" in k or "acc" in k or k.endswith("_lr")})


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """``torch.profiler`` over the block (the CPU, and CUDA where there
    is a card), written as a Chrome trace ``trace.json`` into ``logdir``;
    a no-op when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``lsps.<name>`` range while a torch profiler records and nothing
    traces the program; else the shared no-op context."""
    if (not _autograd_profiler._is_profiler_enabled
            or torch.compiler.is_compiling()):
        return _NO_SPAN
    return torch.profiler.record_function("lsps." + name)


class StepTimer:
    """Step time and throughput by window: ``tick(n)`` counts steps,
    ``window()`` returns (seconds, steps per second) since the last window
    and starts the next."""

    def __init__(self):
        self.t0 = time.time()
        self.steps = 0

    def tick(self, n: int = 1) -> None:
        self.steps += n

    def window(self):
        dt = time.time() - self.t0
        sps = self.steps / dt if dt > 0 else 0.0
        self.t0 = time.time()
        self.steps = 0
        return dt, sps
