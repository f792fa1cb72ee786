"""JAX parameter pytrees -> state_dicts of the port's modules.

The inverse of ``lsps_tpu/train/torch_convert.py:to_state_dict``.  A key is
the pytree path with the leaf renamed (``model_B.0.0.weight``,
``Post.bias``, ``de_fc1.0.weight``, ...), because the port's modules nest
exactly as the JAX package's ``sequential`` lists do.  Per leaf:

* ``w`` 4-D (HWIO conv kernel)  -> OIHW: perm (3, 2, 0, 1)
* ``w`` 2-D ((in, out) linear)  -> (out, in)
* ``wt`` 4-D (kh, kw, I, O) transposed-conv kernel -> ConvTranspose2d's
  (I, O, kh, kw): perm (2, 3, 0, 1)
* ``b``                         -> as it is

The tree is nested dicts/lists of arrays; anything ``np.asarray`` reads
(numpy or JAX arrays) will do, and nothing of JAX is imported here.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Mapping

import numpy as np
import torch


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
        elif leaf != "b":
            raise ValueError(f"no rule for leaf {'/'.join(path)} "
                             f"with shape {a.shape}")
        name = "bias" if leaf == "b" else "weight"
        out[".".join(path[:-1] + [name])] = torch.from_numpy(
            np.ascontiguousarray(a))


def from_jax_params(tree: Any) -> "OrderedDict[str, torch.Tensor]":
    """JAX param pytree -> state_dict that the port's modules load with
    ``strict=True``."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    _walk(tree, [], out)
    return out
