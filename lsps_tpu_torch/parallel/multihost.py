"""One process per rank over ``torch.distributed``.

The port's counterpart of ``lsps_tpu/parallel/multihost.py``.  Where the
JAX package joins the hosts of a TPU slice with ``jax.distributed``, the
port runs one process per rank, as ``torch.distributed.run`` starts them
(``python -m torch.distributed.run --nproc-per-node N ...``), and
:func:`initialize` builds the process group from the environment that
launcher sets: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.

The backend is decided from numbers before the group is made, never by
catching an error: NCCL when the ranks are on CUDA and each has a card of
its own, gloo on the CPU or when ranks share a card (NCCL refuses two
ranks on one GPU).

:func:`local_rows` is the counterpart of ``global_batch_from_host_shards``:
every rank holds the whole global batch (the same seeded loader runs on
each) and takes its contiguous block of rows.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# long enough for rank 0's snapshot writes (~46 s a compressed nnyu set)
# while the others wait at the barrier; short enough that a rank that died
# does not hold the rest for half an hour
TIMEOUT = datetime.timedelta(minutes=10)


def env_world() -> int:
    """``WORLD_SIZE`` as the launcher set it; 1 when it is unset."""
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def choose_backend(on_cuda: bool, local_world: int, n_cards: int) -> str:
    """``nccl`` when the ranks are on CUDA and each has a card of its own,
    else ``gloo`` (the CPU, or ranks that share a card)."""
    return "nccl" if on_cuda and 0 < local_world <= n_cards else "gloo"


def rank_device(on_cuda: bool, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:(LOCAL_RANK % device_count)``, or the
    CPU."""
    if not on_cuda:
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(backend: Optional[str] = None, on_cuda: bool = True,
               timeout: datetime.timedelta = TIMEOUT) -> Tuple[bool, str]:
    """Build the default process group from the launcher's environment.

    Returns ``(ok, reason)``: ``(False, "single-process")`` without
    touching anything when ``WORLD_SIZE`` is unset or 1 (so the same entry
    points work everywhere), ``(True, "initialized")`` on success, and
    ``(False, "<error>")``, logged and never swallowed silently, when the
    group cannot be made.  ``on_cuda`` says where the ranks compute: on
    the card by default (a ``RuntimeError`` without one, never a silent
    fall back to the CPU), the rank's card made current before any CUDA
    work; CPU ranks pass ``on_cuda=False``.  ``backend`` overrides the
    rule of :func:`choose_backend`.
    """
    if env_world() <= 1:
        return False, "single-process"
    if dist.is_initialized():
        return True, "initialized"
    if on_cuda and not torch.cuda.is_available():
        raise RuntimeError("initialize: no CUDA device for the ranks; pass "
                           "on_cuda=False for CPU ranks")
    try:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", env_world()))
        if on_cuda:
            torch.cuda.set_device(rank_device(True, local_rank))
        backend = backend or choose_backend(
            on_cuda, local_world, torch.cuda.device_count() if on_cuda else 0)
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return True, "initialized"
    except (ValueError, RuntimeError) as e:
        reason = f"{type(e).__name__}: {e}"
        log.warning("torch.distributed initialize failed: %s", reason)
        return False, reason


def local_rows(x, rank: int, world: int, axis: int = 0, segments: int = 1):
    """This rank's rows of a global array or tensor ``x`` along ``axis``.

    ``segments`` > 1 reads the axis as that many equal blocks laid end to
    end (the joint pass concatenates domain a's batch and domain b's) and
    takes the rank's rows of each, in order.  The axis must split evenly.
    """
    n = x.shape[axis]
    if n % (segments * world):
        raise ValueError(f"{n} rows on axis {axis} do not split into "
                         f"{segments} segment(s) over {world} ranks")
    seg, per = n // segments, n // (segments * world)
    lead = (slice(None),) * axis
    parts = [x[lead + (slice(s * seg + rank * per, s * seg + (rank + 1)
                             * per),)] for s in range(segments)]
    if segments == 1:
        return parts[0]
    if isinstance(x, torch.Tensor):
        return torch.cat(parts, axis)
    return np.concatenate(parts, axis)
