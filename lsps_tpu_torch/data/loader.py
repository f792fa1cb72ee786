"""Batch loader with a prefetch thread (host numpy).

The port's copy of ``lsps_tpu/data/loader.py``: a background thread builds
the next numpy batch while the device computes on the current one; a new
shuffle order each epoch, the final short batch included (the loops skip
it), mid-epoch resume (``iter_from``) and the shuffle state
(``get_state`` / ``set_state``).

``LSPS_AUGMENT`` selects the augment of the augmented training datasets,
as in the JAX package:

* ``host`` (the default): per-sample items (``dataset[i]``, the numpy
  warps of ``data/detector.py``), stacked into batches;
* ``native`` (also ``LSPS_NATIVE=1``): one call per batch into the port's
  build of the C++ host library (``lsps_tpu_torch/native``);
* ``jax``: the images are made in the loader thread, on the trainer's
  device (``data/augment.py``), and copied to the host before the batch is
  queued.  The name is the JAX package's, kept so that scripts run
  unchanged against either package;
* ``step``: the loader yields warp parameters only, and the image work
  runs inside the training step (the trainer's ``*_raw`` updates).

Three counters on the class total every loader of the process, as the
kernel wrappers' ``.launches`` do: ``DataLoader.batches``, the batches
handed to a consumer; ``DataLoader.stalls``, those of them that the
consumer found the queue empty for and waited on; ``DataLoader.busy_s``,
the producer threads' seconds inside the dataset call for those batches
(``perf_counter``).  The producer passes its seconds along with each
batch and the consuming thread adds them up, so no two threads write one
counter.  A consumer's wait on an empty queue is a ``lsps.loader_wait``
span while a torch profiler records (``utils/logging.py``); the producer
thread opens no span.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterator

import numpy as np

from lsps_tpu_torch.utils.logging import span

DEFAULT_AUGMENT = "host"
BACKENDS = ("host", "native", "jax", "step")
PREFETCH = 2  # batches the producer thread may run ahead


def _stack(samples):
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(np.stack([s[i] for s in samples]).astype(np.float32)
                     for i in range(len(first)))
    return np.stack(samples).astype(np.float32)


class DataLoader:
    """Iterate minibatches of stacked numpy arrays."""

    # process totals over every loader (module docstring)
    batches = 0
    stalls = 0
    busy_s = 0.0

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 seed: int = 0, fast: bool = False,
                 fast_backend: str = "step", device=None):
        """``fast``: one augment call per batch, through ``fast_backend``
        (``native``, ``jax`` or ``step``); else per-sample items.
        ``device``: where the ``jax`` backend makes its images (the
        trainer's); ``None`` is the card, and raises without one."""
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.device = device
        self._rng = np.random.RandomState(seed)
        # the batched augment: 'native' and 'jax' make images here, 'step'
        # leaves the image work to the training step (raw params only)
        self.fast = bool(fast and hasattr(dataset, "enable_fast_augment")
                         and dataset.enable_fast_augment(fast_backend,
                                                         device))
        self.raw = bool(self.fast and fast_backend == "step")

    def disable_raw(self) -> None:
        """Fall back from raw ('step') yields to images made in the
        loader ('jax').  The training CLIs call it when the peer loader
        cannot supply warp params, so that the step consumes images from
        both sides."""
        if not self.raw:
            return
        self.fast = bool(self.dataset.enable_fast_augment("jax",
                                                          self.device))
        self.raw = False

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    # -- input-pipeline checkpointing ------------------------------------
    def get_state(self) -> dict:
        """Shuffle-RNG state; restoring it resumes the exact epoch order
        sequence where training left off."""
        return {"rng_state": self._rng.get_state()}

    def set_state(self, state: dict) -> None:
        self._rng.set_state(state["rng_state"])

    def _epoch_order(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        return order

    def __iter__(self) -> Iterator:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator:
        """Iterate this epoch starting at ``start_batch`` (mid-epoch
        resume; the epoch permutation is drawn first either way so the
        RNG stream stays aligned)."""
        order = self._epoch_order()
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = object()
        cancel = threading.Event()  # set when the consumer abandons us

        def _put(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(start_batch, nb):
                    if cancel.is_set():
                        return
                    idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                    t0 = time.perf_counter()
                    if self.raw:
                        batch = self.dataset.raw_fast_batch(
                            [int(i) for i in idx])
                    elif self.fast:
                        batch = self.dataset.fast_batch(
                            [int(i) for i in idx])
                    else:
                        batch = _stack([self.dataset[int(i)] for i in idx])
                    if not _put((batch, time.perf_counter() - t0)):
                        return
            except Exception as e:  # surface worker errors to the consumer
                _put(e)
            finally:
                _put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item, stalled = q.get_nowait(), False
                except queue.Empty:
                    with span("loader_wait"):
                        item, stalled = q.get(), True
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                batch, busy = item
                DataLoader.batches += 1
                DataLoader.stalls += stalled
                DataLoader.busy_s += busy
                yield batch
        finally:
            # abandoned mid-epoch (zip with a shorter loader, early
            # return): unblock and retire the producer
            cancel.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def augment_backend() -> str:
    """The augment backend ``LSPS_AUGMENT`` names (``host`` when unset,
    ``native`` when unset and ``LSPS_NATIVE=1``)."""
    backend = os.environ.get("LSPS_AUGMENT", "").lower()
    if not backend and os.environ.get("LSPS_NATIVE", "0") == "1":
        backend = "native"
    backend = backend or DEFAULT_AUGMENT
    if backend not in BACKENDS:
        raise ValueError(
            f"LSPS_AUGMENT={backend!r} is not one of host|native|jax|step")
    return backend


def get_data_loader(dataset, batch_size: int, shuffle: bool,
                    seed: int = 0, device=None) -> DataLoader:
    """Reference-named factory (common.py:16-17), the augment backend from
    ``LSPS_AUGMENT`` (:func:`augment_backend`); ``device`` is where the
    ``jax`` backend makes its images (the trainer's): the card unless one is
    named, as for every entry point of the port."""
    backend = augment_backend()
    return DataLoader(dataset, batch_size, shuffle, seed=seed,
                      fast=backend != "host", fast_backend=backend,
                      device=device)


def get_dataset(conf: dict):
    """Registry-dispatch dataset factory (replaces exec at
    common.py:10-14)."""
    from lsps_tpu_torch.registry import lookup

    # import for the datasets' registration
    import lsps_tpu_torch.data.datasets  # noqa: F401
    import lsps_tpu_torch.data.synthetic  # noqa: F401

    return lookup("dataset", conf["class_name"])(conf)
