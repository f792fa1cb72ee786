"""Seeded weights, made on the device in two draws.

One standard-normal draw covers every parameter drawn from a normal
distribution and one uniform draw every parameter drawn from a uniform
one; each parameter is its slice, scaled.  The same seed gives the same
weights on the same device.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Sequence


def seed_for(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make(torch, specs: Sequence, seed: int, device,
         dtype=None) -> Dict[str, "torch.Tensor"]:
    """``{key: tensor}`` for the parameter ``specs`` of
    ``reference.nets``, drawn on ``device`` from ``seed``."""
    dtype = dtype or torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {s.key: math.prod(s.shape) for s in specs}
    total = {d: sum(sizes[s.key] for s in specs if s.dist == d)
             for d in ("normal", "uniform")}
    draws = {"normal": torch.randn(total["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(total["uniform"], generator=gen,
                                   device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for s in specs:
        n = sizes[s.key]
        x = draws[s.dist][at[s.dist]:at[s.dist] + n].view(s.shape)
        at[s.dist] += n
        if s.dist == "normal":
            x = x * s.scale
        else:
            x = (x * 2.0 - 1.0) * s.scale
        out[s.key] = x.to(dtype)
    return out
