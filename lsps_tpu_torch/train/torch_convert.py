"""The reference's released PyTorch checkpoints <-> the port's modules.

The port's counterpart of ``lsps_tpu/train/torch_convert.py``.  The
reference ships ``.pkl`` state_dicts (``torch.save`` at its
``src/trainers/lsps_trainer.py:307-323``).  The port's modules already keep
PyTorch's layouts (OIHW convs, (out, in) linears, (I, O, kh, kw)
transposed convs), so nothing is transposed: a tensor is found by name
alone.  The reference wraps every primitive in a one-module Sequential
(``common_net.py``), so its key ``encode_A.3.model.0.weight`` is the
port's ``encode_A.3.0.weight`` once the ``model`` components are dropped.

Loading is strict: ``load_state_dict(strict=True)`` raises a
``RuntimeError`` that names a key missing from the file, one the module does
not have, or a shape that differs (the JAX package prints them and keeps its
template's leaf).  As with any ``load_state_dict``, the tensors that did
match may already be copied when it raises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn


def _normalize_torch_name(name: str) -> str:
    """Drop the reference's wrapper ``model`` path components."""
    return ".".join(p for p in name.split(".") if p != "model")


def convert_state_dict(state_dict: Mapping[str, Any]
                       ) -> "OrderedDict[str, torch.Tensor]":
    """A reference state_dict -> the port's key spelling (tensors as they
    are, on the CPU).  Two keys that map to one name raise ``ValueError``;
    missing and unexpected keys and shapes are ``load_state_dict``'s to
    check."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    for k, v in state_dict.items():
        name = _normalize_torch_name(k)
        if name in out:
            raise ValueError(f"two keys of the checkpoint map to {name!r}")
        out[name] = torch.as_tensor(v).detach().cpu()
    return out


def to_state_dict(module: nn.Module,
                  like: Optional[Mapping[str, Any]] = None
                  ) -> "OrderedDict[str, torch.Tensor]":
    """The other direction: a port module -> a reference-layout
    state_dict (copies on the CPU).  Keys are the port's names, or, with
    ``like`` (a state_dict of the reference's module), its spelling, so
    that ``ref.load_state_dict(to_state_dict(m, like=ref.state_dict()))``
    loads strictly."""
    out = OrderedDict((k, v.detach().cpu().clone())
                      for k, v in module.state_dict().items())
    if like is not None:
        spelled = {_normalize_torch_name(k): k for k in like}
        out = OrderedDict((spelled.get(k, k), v) for k, v in out.items())
    return out


def load_torch_checkpoint(path: str, module: nn.Module,
                          weights_only: bool = True) -> nn.Module:
    """Load a reference ``.pkl`` checkpoint into ``module`` strictly (in
    place, in the module's dtype and device); returns the module.

    The file is read with ``torch.load(weights_only=True)``, which unpickles
    tensors and containers only: the reference saves state_dicts.  A file
    that pickles a whole module needs the reference's classes importable
    and arbitrary unpickling, which runs code from the file: pass
    ``weights_only=False`` for such a file, and only for one you trust.
    """
    sd = torch.load(path, map_location="cpu", weights_only=weights_only)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    module.load_state_dict(convert_state_dict(sd), strict=True)
    return module
