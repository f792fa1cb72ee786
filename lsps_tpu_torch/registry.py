"""Name -> class registries of the PyTorch port.

The port keeps its own registry: the names ("SharedDis", "poseVAE", ...)
are the same as in the JAX package, and the two must not share one table.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRIES: Dict[str, Dict[str, object]] = {}


def register(kind: str, name: str | None = None) -> Callable:
    """Decorator: register a class/function under ``kind`` with ``name``."""

    def deco(obj):
        key = name or obj.__name__
        _REGISTRIES.setdefault(kind, {})[key] = obj
        return obj

    return deco


def lookup(kind: str, name: str):
    try:
        return _REGISTRIES[kind][name]
    except KeyError:
        known = sorted(_REGISTRIES.get(kind, {}))
        raise KeyError(
            f"No {kind!r} registered under {name!r}. Known: {known}"
        ) from None


def registered(kind: str) -> Dict[str, object]:
    """A copy of the ``kind`` table: name -> class or function."""
    return dict(_REGISTRIES.get(kind, {}))
