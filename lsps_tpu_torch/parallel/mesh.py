"""Data parallelism over ``torch.distributed``: one rank per process.

The port's counterpart of ``lsps_tpu/parallel/mesh.py``.  Where the JAX
package lays one global batch over the ``data`` axis of a device mesh and
lets GSPMD insert the gradient all-reduce, the port runs one process per
rank (``parallel/multihost.py``), and a :class:`DataMesh` does by hand
what GSPMD did:

* every rank holds the whole global batch and takes its contiguous block
  of rows (:meth:`DataMesh.local_rows`);
* the gradients of a step are averaged over the ranks in one collective
  (:meth:`DataMesh.allreduce_mean_`).  Every loss of the trainer is a
  mean over the batch, so the mean of the ranks' gradients is the
  gradient of the global batch;
* the ranks start from rank 0's parameters, checked bit for bit
  (:meth:`DataMesh.broadcast_params_`);
* an eval batch padded to a multiple of the world comes back whole
  (:meth:`DataMesh.gather_rows`).

Random draws (noise, dropout masks) are made at the global shape from a
generator seeded alike on every rank and sliced to the rank's rows
(:class:`RowDraws`), so that N ranks draw what one process draws at the
global batch, as JAX's global ``jax.random`` draws under a mesh do.

Every collective is an ``all_reduce`` or a ``broadcast``, the two that
gloo supports for CUDA tensors, so the same code runs under NCCL (ranks
with a card each) and gloo (the CPU, or ranks sharing one card).

Not ported: ``tp_param_shardings`` / ``shard_state_tp`` (tensor
parallelism over a ``model`` axis; no CLI uses it), ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from lsps_tpu_torch.parallel import multihost

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _by_dtype(tensors: Sequence[torch.Tensor]
              ) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat_(tensors: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
    with torch.no_grad():
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of ``t`` as integers (NaN and -0.0 exact)."""
    return t.view(_BITS[t.element_size()]) if t.is_floating_point() else t


class DataMesh:
    """One rank of a data-parallel group: ``rank``, ``world``, the rank's
    ``device`` and the process ``group`` (None: the default group)."""

    def __init__(self, rank: int, world: int, device,
                 group: Optional[dist.ProcessGroup] = None):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.group = group

    @classmethod
    def from_group(cls, device, group: Optional[dist.ProcessGroup] = None
                   ) -> "DataMesh":
        """The mesh of an initialized process group, on ``device``."""
        return cls(dist.get_rank(group), dist.get_world_size(group), device,
                   group)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that prints and writes files."""
        return self.rank == 0

    def _src(self) -> int:
        return 0 if self.group is None else dist.get_global_rank(
            self.group, 0)

    def local_rows(self, x, axis: int = 0, segments: int = 1):
        """This rank's rows of ``x`` (``multihost.local_rows``)."""
        return multihost.local_rows(x, self.rank, self.world, axis, segments)

    def allreduce_mean_(self, tensors: Sequence[Optional[torch.Tensor]]
                        ) -> Sequence[Optional[torch.Tensor]]:
        """Average the non-None ``tensors`` over the ranks, in place: one
        flat buffer and one collective per dtype, then the sum divided by
        the world size."""
        for group in _by_dtype([t for t in tensors if t is not None]
                               ).values():
            flat = _flat(group)
            dist.all_reduce(flat, group=self.group)
            _unflat_(group, flat.div_(self.world))
        return tensors

    def _rank0(self, tensors: Sequence[torch.Tensor]):
        """[(tensors of one dtype, rank 0's flat copy of them)], and whether
        every rank held rank 0's bits."""
        pairs, same = [], True
        for group in _by_dtype(tensors).values():
            flat = _flat(group)
            ref = flat.clone()
            dist.broadcast(ref, src=self._src(), group=self.group)
            same = same and torch.equal(_bits(ref), _bits(flat))
            pairs.append((group, ref))
        flag = torch.tensor([0.0 if same else 1.0], device=self.device)
        dist.all_reduce(flag, group=self.group)
        return pairs, bool(flag.item() == 0.0)

    def same_across_ranks(self, tensors: Sequence[torch.Tensor]) -> bool:
        """Whether every rank holds ``tensors`` bit for bit as rank 0 does
        (the same answer on every rank)."""
        return self._rank0(list(tensors))[1]

    def broadcast_params_(self, tensors: Sequence[torch.Tensor]) -> bool:
        """Copy rank 0's ``tensors`` into every rank's, in place; returns
        whether every rank already held them bit for bit."""
        pairs, same = self._rank0(list(tensors))
        for group, ref in pairs:
            _unflat_(group, ref)
        return same

    def gather_rows(self, local: torch.Tensor, n_valid: int) -> torch.Tensor:
        """The global rows ``[:n_valid]`` from every rank's block ``local``
        (the rows of ``local_rows`` over a batch padded to a multiple of
        the world), on every rank.  One all-reduce of a zero-filled global
        buffer into which each rank writes its block."""
        b = local.shape[0]
        out = local.new_zeros((b * self.world, *local.shape[1:]))
        out[self.rank * b:(self.rank + 1) * b] = local
        dist.all_reduce(out, group=self.group)
        return out[:n_valid]

    def barrier(self) -> None:
        """Wait on the host until every rank is here."""
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self.group)
        t.item()


class RowDraws:
    """The draw source of one rank's step: each draw is made at the global
    shape from ``generator`` (seeded alike on every rank) and the rank's
    rows are returned.  ``rows`` is the rank's batch; a draw of ``k *
    rows`` rows holds ``k`` segments laid end to end (the joint pass draws
    for a and b concatenated), each sliced on its own.  Passed where a
    module takes a ``generator`` (``ops.layers.draw_normal`` /
    ``draw_uniform``)."""

    def __init__(self, generator: torch.Generator, mesh: DataMesh,
                 rows: int):
        self.generator, self.mesh, self.rows = generator, mesh, int(rows)

    def _draw(self, fn, shape, **kw) -> torch.Tensor:
        n = shape[0]
        if n % self.rows:
            raise ValueError(f"a draw of {n} rows is not a whole number of "
                             f"segments of {self.rows} local rows")
        k = n // self.rows
        full = fn((k * self.rows * self.mesh.world, *shape[1:]),
                  generator=self.generator, **kw)
        return self.mesh.local_rows(full, segments=k)

    def normal(self, shape, dtype, device) -> torch.Tensor:
        return self._draw(torch.randn, shape, dtype=dtype, device=device)

    def uniform(self, shape, device) -> torch.Tensor:
        return self._draw(torch.rand, shape, device=device)
