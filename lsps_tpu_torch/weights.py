"""JAX parameter pytrees <-> state_dicts of the port's modules.

The inverse of ``lsps_tpu/train/torch_convert.py:to_state_dict``.  A key is
the pytree path with the leaf renamed (``model_B.0.0.weight``,
``Post.bias``, ``de_fc1.0.weight``, ...), because the port's modules nest
exactly as the JAX package's ``sequential`` lists do.  Per leaf:

* ``w`` 4-D (HWIO conv kernel)  -> OIHW: perm (3, 2, 0, 1)
* ``w`` 2-D ((in, out) linear)  -> (out, in)
* ``wt`` 4-D (kh, kw, I, O) transposed-conv kernel -> ConvTranspose2d's
  (I, O, kh, kw): perm (2, 3, 0, 1)
* ``b``                         -> as it is
* ``scale`` / ``shift`` (BatchNorm's affine) -> ``weight`` / ``bias``

The tree is nested dicts/lists of arrays; anything ``np.asarray`` reads
(numpy or JAX arrays) will do, and nothing of JAX is imported here.
``to_jax_params`` is the inverse: a module's tensors -> the JAX package's
pytree, which is also the layout of its ``.npz`` checkpoints.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn


def _walk(node: Any, path: List[str], out: Dict[str, torch.Tensor]) -> None:
    if isinstance(node, Mapping):
        for k, v in node.items():
            _walk(v, path + [str(k)], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, path + [str(i)], out)
    else:
        leaf = path[-1]
        a = np.array(node)  # a copy: the state_dict never aliases the tree
        if leaf == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif leaf == "w" and a.ndim == 2:
            a = a.T
        elif leaf == "wt" and a.ndim == 4:
            a = a.transpose(2, 3, 0, 1)
        elif leaf not in ("b", "scale", "shift"):
            raise ValueError(f"no rule for leaf {'/'.join(path)} "
                             f"with shape {a.shape}")
        name = "bias" if leaf in ("b", "shift") else "weight"
        out[".".join(path[:-1] + [name])] = torch.from_numpy(
            np.ascontiguousarray(a))


def from_jax_params(tree: Any) -> "OrderedDict[str, torch.Tensor]":
    """JAX param pytree -> state_dict that the port's modules load with
    ``strict=True``."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    _walk(tree, [], out)
    return out


def _to_jax(module: nn.Module, prefix: str,
            tensors: Mapping[str, torch.Tensor]) -> Any:
    own = [n for n, _ in module.named_parameters(recurse=False)]
    if own:
        node = {}
        for name in own:
            # a copy: the tree never aliases the module's tensors
            a = tensors[prefix + name].detach().cpu().numpy().copy()
            leaf_names = getattr(module, "jax_leaf_names", None)
            if leaf_names:
                node[leaf_names[name]] = a
            elif name == "bias":
                node["b"] = a
            elif isinstance(module, nn.ConvTranspose2d):
                node["wt"] = a.transpose(2, 3, 0, 1)
            elif a.ndim == 4:
                node["w"] = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                node["w"] = a.T
            else:
                raise ValueError(f"no rule for {prefix}{name} with shape "
                                 f"{a.shape}")
        return node
    kids = [(n, _to_jax(m, f"{prefix}{n}.", tensors))
            for n, m in module.named_children()]
    if isinstance(module, (nn.Sequential, nn.ModuleList)):
        return [t for _, t in kids]
    return dict(kids)


def to_jax_params(module: nn.Module,
                  tensors: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Any:
    """A module's parameters (or ``tensors``, keyed as its state_dict:
    Adam's moments, for example) -> the JAX package's pytree: dicts for
    named children, lists for ``nn.Sequential`` slots (``{}`` where a slot
    has no parameters), ``w`` HWIO / (in, out), ``wt`` (kh, kw, I, O),
    ``b``; numpy arrays (copies) in the tensors' dtype.
    ``from_jax_params(to_jax_params(m))`` is ``m.state_dict()``."""
    if tensors is None:
        tensors = module.state_dict()
    return _to_jax(module, "", tensors)
