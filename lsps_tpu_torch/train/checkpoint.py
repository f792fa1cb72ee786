"""``.npz`` checkpoints that cross-load with the JAX package's.

Counterpart of ``lsps_tpu/train/checkpoint.py`` (``CheckpointManager``):
the same files, names and layouts, so that a snapshot saved by either
package loads in the other.

* ``<prefix>_{gen,dis,map}_%08d.npz``: one net's parameters;
  ``<prefix>_{optg,optd}_%08d.npz``: the gen + map and the dis optimizer;
  ``<prefix>_vae_%.2f_%08d.npz``: the pose VAE, keyed by the data
  fraction.  The number is ``iterations + 1``.  Estimate-mode snapshots
  carry ``est_`` in the prefix (``..._est_gen_...``).
* Each file is a flat ``np.savez_compressed`` of the JAX pytree's
  leaves keyed by path: ``encode_A/0/0/w``, HWIO conv kernels, ``(in,
  out)`` linears, ``wt`` ``(kh, kw, I, O)`` transposed kernels
  (``weights.to_jax_params``).  An optimizer file holds the optax chain's
  state: ``1/.count`` (Adam's count, int32), ``1/.mu/<path>``,
  ``1/.nu/<path>``, ``2/.count`` (the schedule's); the gen optimizer's
  paths start with ``gen/`` or ``map/``.
* Loading overlays the file on the module: a key the file lacks keeps
  its value, a shape that differs raises.
* Resume takes the lexicographically latest gen file, parses the
  iteration from its name, and loads optimizer files only from the same
  save (the matching step).  Saves write the gen file last, so that a
  save cut short leaves no gen marker and resume falls back to the last
  complete set.

:class:`FullStateStore` stands in for the JAX package's orbax store
(``OrbaxStateStore``, behind ``--orbax-dir``): the whole training state
of one step under ``<dir>/state_%08d/``, written synchronously with
``torch.save``.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from lsps_tpu_torch.weights import from_jax_params, to_jax_params

# (key in the optimizer's tree or None for the tree itself, module)
NetGroup = Sequence[Tuple[Optional[str], nn.Module]]


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a/0/w": array}, the JAX package's keys."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None:
        out[prefix[:-1]] = np.asarray(tree)
        return out
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> dict:
    """{"a/0/w": array} -> nested dicts (sequence slots keyed "0", "1",
    ...), which ``from_jax_params`` reads as it reads lists."""
    tree: dict = {}
    for key, a in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def save_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def get_model_list(dirname: str, key: str, idx: int = -1) -> Optional[str]:
    """The ``idx``-th file (by lexicographic order) in ``dirname`` whose
    name holds ``key`` and ends in ``.npz``, or None."""
    if not os.path.exists(dirname):
        return None
    models = sorted(
        os.path.join(dirname, f) for f in os.listdir(dirname)
        if os.path.isfile(os.path.join(dirname, f)) and key in f
        and f.endswith(".npz"))
    if not models:
        return None
    return models[idx]


def parse_iterations(filename: str) -> int:
    m = re.search(r"_(\d{8})\.npz$", filename)
    return int(m.group(1)) if m else 0


# ---------------------------------------------------------------------------
# nets and optimizers <-> flat arrays
# ---------------------------------------------------------------------------

def _overlay(tensors: List[torch.Tensor], names: List[str],
             state: Dict[str, torch.Tensor], what: str) -> None:
    """Copy ``state[name]`` into each tensor it names, in place."""
    with torch.no_grad():
        for t, name in zip(tensors, names):
            if name not in state:
                continue
            a = state[name]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {what} {name}: "
                                 f"{tuple(a.shape)} vs {tuple(t.shape)}")
            t.copy_(a.to(t.dtype))


def net_arrays(module: nn.Module) -> Dict[str, np.ndarray]:
    return flatten(to_jax_params(module))


def load_net(module: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Overlay a net's file on its parameters."""
    names, params = zip(*module.named_parameters())
    _overlay(list(params), list(names), from_jax_params(unflatten(flat)),
             "parameter")


def _groups(opt, nets: NetGroup):
    """(key, module, the optimizer's slice of index) per net."""
    i = 0
    for key, module in nets:
        n = len(list(module.parameters()))
        yield key, module, slice(i, i + n)
        i += n
    if i != len(opt.params):
        raise ValueError(f"the nets hold {i} parameters, the optimizer "
                         f"{len(opt.params)}")


def opt_arrays(opt, nets: NetGroup) -> Dict[str, np.ndarray]:
    """An ``AdamMultiStep`` as the optax chain's state ``(decayed
    weights, adam, schedule)``, flat."""
    mu, nu = {}, {}
    for key, module, sl in _groups(opt, nets):
        names = [n for n, _ in module.named_parameters()]
        for tree, moments in ((mu, opt.mu), (nu, opt.nu)):
            t = to_jax_params(module, dict(zip(names, moments[sl])))
            if key is None:
                tree.update(t)
            else:
                tree[key] = t
    flat = {"1/.count": np.asarray(opt.count, np.int32),
            "2/.count": np.asarray(opt.sched_count, np.int32)}
    flat.update(flatten(mu, "1/.mu/"))
    flat.update(flatten(nu, "1/.nu/"))
    return flat


def load_opt(opt, nets: NetGroup, flat: Dict[str, np.ndarray]) -> None:
    """Overlay an optimizer's file on ``opt``."""
    for slot, moments in (("mu", opt.mu), ("nu", opt.nu)):
        pre = f"1/.{slot}/"
        sub = unflatten({k[len(pre):]: v for k, v in flat.items()
                         if k.startswith(pre)})
        for key, module, sl in _groups(opt, nets):
            names = [n for n, _ in module.named_parameters()]
            tree = sub if key is None else sub.get(key, {})
            _overlay(moments[sl], names, from_jax_params(tree),
                     f"{slot} of")
    if "1/.count" in flat:
        opt.count = int(flat["1/.count"])
    if "2/.count" in flat:
        opt.sched_count = int(flat["2/.count"])


# ---------------------------------------------------------------------------
# the trainer's snapshot set
# ---------------------------------------------------------------------------

def save(trainer, snapshot_prefix: str, iterations: int,
         save_opt: bool = True) -> None:
    """gen/dis/map (and the two optimizers) of ``trainer``; gen last."""
    it = iterations + 1
    if save_opt:
        save_npz(f"{snapshot_prefix}_optg_{it:08d}.npz",
                 opt_arrays(trainer.gen_opt, trainer.gen_opt_nets))
        save_npz(f"{snapshot_prefix}_optd_{it:08d}.npz",
                 opt_arrays(trainer.dis_opt, trainer.dis_opt_nets))
    for net in ("map", "dis", "gen"):
        save_npz(f"{snapshot_prefix}_{net}_{it:08d}.npz",
                 net_arrays(trainer.nets[net]))


def save_vae(trainer, snapshot_prefix: str, iterations: int,
             frac: float) -> None:
    save_npz(f"{snapshot_prefix}_vae_{frac:.2f}_{iterations + 1:08d}.npz",
             net_arrays(trainer.vae))


def resume(trainer, snapshot_prefix: str, idx: int = -1,
           load_optimizers: bool = False, est: bool = False):
    """Load the latest gen/dis (and map, and with ``load_optimizers`` the
    optimizers of the same save) into ``trainer``.  Returns (iterations,
    whether both optimizer files were loaded)."""
    dirname = os.path.dirname(snapshot_prefix) or "."
    gen_key = "est_gen" if est else "gen"
    last = get_model_list(dirname, gen_key, idx)
    if last is None:
        return 0, False
    load_net(trainer.gen, load_npz(last))
    iterations = parse_iterations(last)
    dis_file = get_model_list(dirname, "est_dis" if est else "dis", idx)
    if dis_file:
        load_net(trainer.dis, load_npz(dis_file))
    opt_loaded = False
    if load_optimizers:
        # only from the save that wrote these parameters: an interrupted
        # save must not pair params at N with moments at M < N
        paths = {k: last.replace(f"_{gen_key}_", f"_{k}_")
                 for k in ("optg", "optd")}
        paths = {k: p for k, p in paths.items() if os.path.isfile(p)}
        try:
            if "optg" in paths:
                load_opt(trainer.gen_opt, trainer.gen_opt_nets,
                         load_npz(paths["optg"]))
            if "optd" in paths:
                load_opt(trainer.dis_opt, trainer.dis_opt_nets,
                         load_npz(paths["optd"]))
            opt_loaded = len(paths) == 2
            if not opt_loaded:
                print("-----No matching-step optimizer snapshot for "
                      f"{os.path.basename(last)}; optimizer state starts "
                      "fresh")
        except (OSError, ValueError, KeyError) as e:
            print(f"-----Failed to load optimizer parameters! ({e})")
    map_file = get_model_list(dirname, "map", idx)
    if map_file:
        try:
            load_net(trainer.map, load_npz(map_file))
        except (OSError, ValueError, KeyError) as e:
            print(f"-----Failed to load map parameters! ({e})")
    print(f"Resume from iteration {iterations}")
    return iterations, opt_loaded


def load_vae(trainer, snapshot_prefix: str, frac: float) -> bool:
    """Load the latest fraction-keyed VAE snapshot; whether one was
    found."""
    dirname = os.path.dirname(snapshot_prefix) or "."
    last = get_model_list(dirname, f"vae_{frac:.2f}")
    if last is None:
        return False
    load_net(trainer.vae, load_npz(last))
    print(f"Loading pretrained VAE parameters from {last}")
    return True


# ---------------------------------------------------------------------------
# full training state (the CLIs' --orbax-dir)
# ---------------------------------------------------------------------------

_OPTIMIZERS = ("dis_opt", "gen_opt", "vae_opt")


def full_state(trainer) -> dict:
    """Everything a run needs to go on: the four nets, the three
    optimizers (moments and both counts), the draw generator's state and
    the trainer's step count."""
    return {
        "nets": {k: v.detach().cpu()
                 for k, v in trainer.nets.state_dict().items()},
        "opt": {name: {"mu": [m.detach().cpu() for m in opt.mu],
                       "nu": [n.detach().cpu() for n in opt.nu],
                       "count": opt.count,
                       "sched_count": opt.sched_count}
                for name, opt in ((n, getattr(trainer, n))
                                  for n in _OPTIMIZERS)},
        "generator": trainer.generator.get_state(),
        "step": trainer.step,
    }


def load_full_state(trainer, state: dict) -> None:
    """Put a :func:`full_state` back into ``trainer``, in place."""
    trainer.nets.load_state_dict(state["nets"], strict=True)
    with torch.no_grad():
        for name in _OPTIMIZERS:
            opt, saved = getattr(trainer, name), state["opt"][name]
            for slot in ("mu", "nu"):
                for t, a in zip(getattr(opt, slot), saved[slot]):
                    t.copy_(a)
            opt.count = int(saved["count"])
            opt.sched_count = int(saved["sched_count"])
    trainer.generator.set_state(state["generator"])
    trainer.step = int(state["step"])


class FullStateStore:
    """One directory per saved step, ``<directory>/state_%08d/state.pt``:
    ``save(trainer, step)``, ``latest_step()``, ``restore(trainer)``,
    ``wait()``.  Saves are synchronous (``wait`` has nothing to join) and
    land by renaming a finished directory, so that a save cut short
    leaves no ``state_*`` entry.  Under a data-parallel trainer
    (``trainer.mesh``) rank 0 writes and every rank waits for it; every
    rank restores."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"state_{step:08d}")

    def save(self, trainer, step: int) -> None:
        mesh = getattr(trainer, "mesh", None)
        if mesh is None or mesh.is_main:
            self._write(trainer, step)
        if mesh is not None:
            mesh.barrier()

    def _write(self, trainer, step: int) -> None:
        path = self._path(step)
        tmp = path + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(full_state(trainer), os.path.join(tmp, "state.pt"))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.directory):
            m = re.match(r"state_(\d{8})$", d)
            if m and os.path.isdir(os.path.join(self.directory, d)):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, trainer, step: Optional[int] = None) -> Optional[int]:
        """Load step ``step`` (the latest if None) into ``trainer``;
        returns the step, or None if the store is empty."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state = torch.load(os.path.join(self._path(step), "state.pt"),
                           map_location="cpu", weights_only=True)
        load_full_state(trainer, state)
        return step
