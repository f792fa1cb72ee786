"""Shared plumbing of the port's training CLIs.

The port's copy of ``lsps_tpu/cli/common.py``: the same flags and
defaults, the evaluation class by config name, the datasets, and the
chunk planner of ``--steps-per-call``.

Differences from the JAX package's CLIs:

* ``--device`` takes a CUDA index (the default 0) or ``cpu``; with no
  CUDA device a run needs ``--device cpu`` and never falls back quietly.
* The trainer starts from fresh weights drawn by
  ``train.trainer.fresh_state_dict`` from a generator seeded with the
  run's seed (the JAX package's distributions, not its draws).
* ``host_fold_in`` and ``fold_chain`` have no counterpart: the JAX CLIs
  fold one key per iteration, the port's draws (noise, dropout masks)
  come from the trainer's ``torch.Generator``, seeded with ``seed + 7``
  in ``pose_train`` and ``seed + 13`` in ``depth_train``, as the JAX
  CLIs seed their keys.  A scan chunk of K steps draws what K single
  steps draw.
* ``--mesh-data N`` runs one process per rank, as ``python -m
  torch.distributed.run --nproc-per-node N`` starts them (``MeshRunner``;
  the ranks' gradients all-reduce over NCCL or gloo, ``parallel/``).  The
  batch size is the global batch, split evenly over the N ranks, as in the
  JAX package's single-process mesh (its multi-process mode feeds a batch
  per host instead).  Every rank runs the same seeded loader and trains on
  its rows; rank 0 prints and writes the logs, images and snapshots.

``LSPS_AUGMENT`` selects the training augment as in the JAX package, with
``host`` when it is unset (``data/loader.py``).  The datasets of the
configs (``dataset_hand_NYU``, ``dataset_hand_ICVL``, their ``_test``
classes and the synthetic ones) are registered when the first dataset is
made.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from lsps_tpu_torch.config import NetConfig
from lsps_tpu_torch.eval import (HandposeEvaluation, ICVLHandposeEvaluation,
                                 NYUHandposeEvaluation)
from lsps_tpu_torch.registry import lookup
from lsps_tpu_torch.utils.skeleton import tables_for

# import for the trainer's registration
import lsps_tpu_torch.train.trainer  # noqa: F401

LAUNCH = ("python -m torch.distributed.run --nproc-per-node {n} -m "
          "lsps_tpu_torch.cli.{cli} ... --mesh-data {n}")


def _positive_int(value: str) -> int:
    """argparse type for flags where 0 would otherwise be silently
    replaced by a default through an ``x or default`` expression."""
    n = int(value)
    if n <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer, "
                                         f"got {n}")
    return n


def base_parser(description: str) -> argparse.ArgumentParser:
    """Flags mirroring the reference CLIs (pose_train.py:29-34,
    depth_train.py:26-34) and the JAX package's; ``--gpu`` is an alias
    of ``--device``."""
    p = argparse.ArgumentParser(
        description=description,
        epilog="LSPS_AUGMENT selects the training augment: host (the "
               "default: per-sample numpy warps in the loader), native "
               "(the C++ host library, one call per batch; also "
               "LSPS_NATIVE=1), jax (images made in the loader, on the "
               "trainer's device) or step (warp parameters from the "
               "loader, the image work inside the training step).")
    p.add_argument("--device", "--gpu", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    p.add_argument("--resume", type=int, default=0)
    p.add_argument("--frac", type=float, default=1.0,
                   help="fraction of real labels to use")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--log", type=str, default="./logs")
    p.add_argument("--seed", type=int, default=23455)
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="override config batch size")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace here")
    p.add_argument("--orbax-dir", type=str, default=None,
                   help="full-state checkpoints (nets + optimizers + draw "
                        "generator + step) for resume; the name is the JAX "
                        "package's, the files are torch.save's")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute for the conv-heavy updates (params/"
                        "losses stay f32); same as hyperparameters."
                        "compute_dtype: bfloat16")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel ranks: 0 = one process on one "
                        "device (default), N >= 2 = this process is one of "
                        "N ranks started by 'python -m "
                        "torch.distributed.run --nproc-per-node N -m "
                        "lsps_tpu_torch.cli.<cli> ... --mesh-data N', -1 = "
                        "all the launched ranks.  The batch size is the "
                        "global batch, split evenly over the ranks; rank r "
                        "trains on cuda:(LOCAL_RANK %% device_count) "
                        "(--device cpu: CPU ranks), and the gradients "
                        "all-reduce (NCCL with a card per rank, else "
                        "gloo)")
    p.add_argument("--steps-per-call", type=int, default=0,
                   help="train K steps per trainer call (the trainer's "
                        "*_scan: a Python loop over K pre-staged batches, "
                        "the same draws as K single steps); chunks clip "
                        "to the image/snapshot cadences.  1 = classic "
                        "loop; 0 = auto (8 for the pose step, 1 for the "
                        "depth steps, as in the JAX package)")
    p.add_argument("--snapshot-prefix", type=str, default=None,
                   help="override the config's snapshot_prefix (where "
                        "checkpoints are read/written)")
    p.add_argument("--sch-interval", type=_positive_int, default=None,
                   help="override the LR scheduler step interval "
                        "(reference: 1000 in pretrain/pose, 100 in "
                        "estimate, depth_train.py:154-164)")
    return p


def device_of(opts) -> torch.device:
    """The device ``--device`` names: ``cpu``, or CUDA device N."""
    if str(opts.device).lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return torch.device("cuda", int(opts.device))


def select_eval(config_path: str):
    """Evaluation class + skeleton tables by config name
    (pose_train.py:66-75)."""
    color_idx, bones = tables_for(os.path.basename(config_path))
    if "icvl" in config_path:
        return ICVLHandposeEvaluation, color_idx, bones
    if "nyu" in config_path:
        return NYUHandposeEvaluation, color_idx, bones
    return HandposeEvaluation, color_idx, bones


def load_experiment(opts):
    config = NetConfig(opts.config)
    if opts.max_iterations is not None:
        config.hyperparameters["max_iterations"] = opts.max_iterations
    if getattr(opts, "bf16", False):
        config.hyperparameters["compute_dtype"] = "bfloat16"
    if getattr(opts, "snapshot_prefix", None):
        config.snapshot_prefix = opts.snapshot_prefix
    return config


def make_datasets(config):
    from lsps_tpu_torch.data.loader import get_dataset

    ds_a = get_dataset(config.datasets["train_a"])
    ds_b = get_dataset(config.datasets["train_b"])
    ds_test = get_dataset(config.datasets["test_b"])
    return ds_a, ds_b, ds_test


def resolve_steps_per_call(opts, auto: int) -> int:
    """Resolve ``--steps-per-call`` (0 = auto) to a concrete chunk size:
    ``auto`` is the JAX package's default, 8 for the pose step and 1 for
    the depth steps."""
    return auto if opts.steps_per_call == 0 else max(1, opts.steps_per_call)


def make_trainer(config, sch_interval: int, device, init_seed: int,
                 seed: int, mesh=None):
    """The config's trainer on ``device``, from fresh weights drawn with
    ``init_seed``; its draws come from a generator seeded with
    ``seed``.  ``mesh``: this rank's ``parallel.DataMesh``, or None."""
    from lsps_tpu_torch.train.trainer import fresh_state_dict

    hyp = config.hyperparameters
    cls = lookup("trainer", hyp.get("trainer", "LSPSTrainer"))
    return cls(hyp, fresh_state_dict(hyp, init_seed),
               sch_interval=sch_interval, device=device, seed=seed,
               mesh=mesh)


class MeshRunner:
    """Data-parallel context of the training CLIs (``--mesh-data N``).

    The JAX package's ``MeshRunner`` lays one global batch over a device
    mesh in one process; here this process is one of N ranks, each started
    by ``torch.distributed.run``, with a process group made from the
    launcher's environment (``parallel.multihost.initialize``) and a
    ``parallel.DataMesh`` on ``cuda:(LOCAL_RANK % device_count)``, or on
    the CPU for CPU ranks.  The trainer takes the global batch and trains
    on the rank's rows; ``place`` / ``place_padded`` give the rank's rows
    of host arrays (the sharded eval).  ``mesh`` is an existing
    ``DataMesh`` (a caller that made its own group); ``close`` ends the
    group if this runner made it.
    """

    def __init__(self, n_data: int, on_cuda: bool, cli: str = "depth_train",
                 mesh=None):
        import torch.distributed as dist

        from lsps_tpu_torch.parallel import DataMesh, multihost

        world = os.environ.get("WORLD_SIZE")
        if n_data == -1 and world:
            n_data = int(world)
        if n_data < 2 and n_data != -1:
            raise ValueError(f"--mesh-data {n_data}: need >= 2 devices "
                             "(use 0 for the single-device path)")
        self._owns_group = False
        if mesh is None:
            if not world or int(world) != n_data:
                n = "N" if n_data == -1 else n_data
                raise ValueError(
                    f"--mesh-data {n_data} needs {n} ranks, one process "
                    f"each (WORLD_SIZE is {world or 'unset'}); launch: "
                    + LAUNCH.format(n=n, cli=cli))
            # a group the caller made outlives this runner
            self._owns_group = not dist.is_initialized()
            ok, reason = multihost.initialize(on_cuda=on_cuda)
            if not ok:
                raise RuntimeError(f"--mesh-data {n_data}: the process "
                                   f"group could not be made ({reason})")
            mesh = DataMesh.from_group(multihost.rank_device(
                on_cuda, int(os.environ.get("LOCAL_RANK", "0"))))
        self.n_data = mesh.world
        self.mesh = mesh

    def check_batch(self, batch_size: int, what: str = "batch size"):
        """The global batch must split evenly over the ranks; fail up
        front with a clear message."""
        if batch_size % self.n_data != 0:
            raise ValueError(
                f"{what} {batch_size} (the global batch) is not divisible "
                f"by the data-mesh size {self.n_data}")

    def place(self, *arrays):
        """This rank's rows of host batch arrays."""
        out = tuple(self.mesh.local_rows(a) for a in arrays)
        return out if len(out) > 1 else out[0]

    def place_padded(self, *arrays):
        """Pad the leading axis up to a multiple of the world (by repeating
        the last row) and take this rank's rows; returns ``(arrays,
        n_valid)``, for eval batches the world does not divide (the test
        set's final short batch).  ``DataMesh.gather_rows`` joins the
        results and trims them to ``n_valid``."""
        n = int(arrays[0].shape[0])
        pad = (-n) % self.n_data
        if pad:
            arrays = tuple(
                np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], 0)
                for a in arrays)
        out = self.place(*arrays)
        if len(arrays) == 1:
            out = (out,)
        return out, n

    @property
    def is_main(self) -> bool:
        return self.mesh.is_main

    def describe(self, what: str) -> str:
        """The CLI's "data-parallel over N ranks" line."""
        return (f"data-parallel over {self.n_data} ranks ({self.mesh.backend}"
                f", rank {self.mesh.rank} on {self.mesh.device}; {what})")

    def close(self) -> None:
        """End the process group this runner made."""
        import torch.distributed as dist

        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False


def make_mesh_runner(opts, cli: str = "depth_train"):
    """CLI hook: a MeshRunner when ``--mesh-data`` asks for one, else None
    (one process on one device)."""
    n = getattr(opts, "mesh_data", 0)
    if n == 0:
        return None
    return MeshRunner(n, on_cuda=str(opts.device).lower() != "cpu", cli=cli)


@contextlib.contextmanager
def rank_output(runner):
    """Inside the block only rank 0 (or a run with no mesh) prints: the
    other ranks' standard output goes to the null device."""
    if runner is None or runner.is_main:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


class NoMetrics:
    """The metrics writer of a rank other than 0: it writes nothing."""

    def write(self, step, metrics) -> None:
        pass

    def close(self) -> None:
        pass


def chunk_len(it, k, cadences, max_iterations):
    """Plan the next multi-step chunk: the longest n <= k such that no
    cadence boundary (a step whose completion satisfies
    ``(step + 1) % c == 0``) falls strictly inside steps
    ``[it, it + n)``; a boundary may only land on the chunk's last step,
    after which the caller runs its cadence work (images, snapshots,
    eval) with the chunk's final state and outputs.

    The CLIs scan only when the plan returns exactly ``k``; shorter plans
    near boundaries fall back to single steps until re-aligned.
    """
    n = max(1, int(k))
    for c in cadences:
        if c and c > 0:
            b = (it + c) // c * c - 1  # first step >= it ending on c
            n = min(n, b - it + 1)
    if max_iterations is not None:
        n = min(n, max_iterations - it)
    return max(n, 1)


def host_metrics(mets) -> dict:
    """A scan's stacked metrics (tensors on the trainer's device) as numpy
    arrays, for the display rows of its steps."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in mets.items()}


def stack_inputs(items):
    """Stack per-step inputs to a leading K axis (leaf by leaf for the
    raw-mode warp-parameter tuples)."""
    if isinstance(items[0], tuple):
        return tuple(np.stack([it[i] for it in items])
                     for i in range(len(items[0])))
    return np.stack(items)
