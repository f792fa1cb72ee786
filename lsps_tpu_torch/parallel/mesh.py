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

Tensor parallelism over a ``model`` axis (no CLI uses it, as in the JAX
package): :func:`make_mesh` lays the world's ranks out row-major as
``(n_data, n_model)`` with a process group per ``data`` row (its model
ranks) and per ``model`` column (its data ranks); the mesh's
:class:`DataMesh` runs on the column, so with ``n_model = 1`` it is the
data-parallel mesh above.  :func:`tp_param_shardings` is the JAX rule in
torch layouts: a conv kernel whose output channels divide over ``model``
and number at least ``min_out_ch`` is split along them (dim 0 of
``Conv2d``'s OIHW, dim 1 of ``ConvTranspose2d``'s IOHW), a 1-D vector of
that size too, a 2-D ``Linear`` weight never.  :func:`shard_state_tp`
keeps each model rank's slice of those tensors and wraps their layers so
that the forward is the replicated one: a layer with a split kernel
computes its block of output channels and gathers the blocks over the
model ranks (its input's gradient summed over them in the backward, the
gather's backward the rank's slice of the incoming gradient); a layer
whose only split tensors are vectors (a ``Linear`` bias, a norm's scale)
gathers them before use.  Every gather is an ``all_reduce`` of a
zero-filled buffer.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

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


class Mesh:
    """One rank's place in an ``(n_data, n_model)`` layout of the world:
    ``data_index`` (its row), ``model_index`` (its column), the process
    group of its row (``model_group``, the ranks that split one model)
    and its :class:`DataMesh` (``data``, over its column).  ``shape`` is
    ``{"data": n_data, "model": n_model}``, as a JAX mesh's."""

    def __init__(self, n_data: int, n_model: int, rank: int, device,
                 data_group: Optional[dist.ProcessGroup],
                 model_group: Optional[dist.ProcessGroup]):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.rank = int(rank)
        self.data_index, self.model_index = divmod(self.rank, int(n_model))
        self.device = torch.device(device)
        self.model_group = model_group
        self.data = DataMesh(self.data_index, n_data, self.device,
                             data_group)

    @property
    def n_model(self) -> int:
        return self.shape["model"]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None) -> Mesh:
    """This rank's :class:`Mesh` over the initialized process group (or a
    lone process): ranks ``r`` at ``(r // n_model, r % n_model)``.
    ``n_data`` defaults to ``world // n_model``; the layout must cover the
    world.  Every rank makes every row and column group, in one order.
    ``device`` defaults to this rank's card (``LOCAL_RANK``); pass
    ``"cpu"`` for CPU ranks."""
    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    n_model = int(n_model)
    n_data = world // n_model if n_data is None else int(n_data)
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} ranks, the world has {world}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass "
                               "device='cpu' for CPU ranks")
        device = multihost.rank_device(
            True, int(os.environ.get("LOCAL_RANK", rank)))
    rows = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    cols = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]
    model_group = data_group = None
    if on:
        # the default group where a row or column is the whole world, so
        # that n_model = 1 is the data-parallel mesh as it was
        for ranks in rows:
            g = dist.new_group(ranks) if len(ranks) < world else None
            if rank in ranks:
                model_group = g
        for ranks in cols:
            g = dist.new_group(ranks) if len(ranks) < world else None
            if rank in ranks:
                data_group = g
    return Mesh(n_data, n_model, rank, device, data_group, model_group)


def _sharded_dim(transposed: bool, shape, n_model: int,
                 min_out_ch: int) -> Optional[int]:
    """The JAX package's rule (``lsps_tpu/parallel/mesh.py:80-105``) in
    torch layouts: the output-channel dim of a 4-D kernel (1 for a
    ``transposed`` conv's IOHW, else 0), dim 0 of a 1-D vector, when it
    divides over ``n_model`` and is at least ``min_out_ch``; otherwise
    None."""
    if n_model <= 1:
        return None
    if len(shape) == 4:
        dim = 1 if transposed else 0
    elif len(shape) == 1:
        dim = 0
    else:
        return None
    size = shape[dim]
    return dim if size % n_model == 0 and size >= min_out_ch else None


def tp_param_shardings(mesh, module_or_state, min_out_ch: int = 512
                       ) -> Dict[str, Optional[int]]:
    """For each parameter name of a module, the dim that is split over the
    ``model`` axis of ``mesh`` (anything with ``shape["model"]``), or
    None.  An optimizer's moments take their parameter's entry.  A
    mapping of names to tensors (a state dict) reads every 4-D tensor as a
    ``Conv2d`` kernel: pass the module where transposed convs hold
    parameters."""
    n_model = int(mesh.shape["model"])
    if isinstance(module_or_state, nn.Module):
        out = {}
        for mname, m in module_or_state.named_modules():
            for pname, p in m.named_parameters(recurse=False):
                key = f"{mname}.{pname}" if mname else pname
                out[key] = _sharded_dim(isinstance(m, nn.ConvTranspose2d),
                                        p.shape, n_model, min_out_ch)
        return out
    return {k: _sharded_dim(False, t.shape, n_model, min_out_ch)
            for k, t in module_or_state.items()}


def _block(t: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size)


def _gather_blocks(local: torch.Tensor, dim: int, mesh: Mesh
                   ) -> torch.Tensor:
    """The model ranks' blocks of ``local`` laid side by side along
    ``dim``: one all-reduce of a zero-filled buffer (no autograd)."""
    n = mesh.n_model
    shape = list(local.shape)
    shape[dim] *= n
    out = local.new_zeros(shape)
    _block(out, dim, mesh.model_index, n).copy_(local)
    dist.all_reduce(out, group=mesh.model_group)
    return out


class _Gather(torch.autograd.Function):
    """Forward: the blocks of every model rank, gathered along ``dim``.
    Backward: this rank's block of the incoming gradient (every model rank
    holds the same downstream gradient, so no collective)."""

    @staticmethod
    def forward(ctx, local, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _gather_blocks(local, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        return (_block(grad, ctx.dim, m.model_index, m.n_model).contiguous(),
                None, None)


class _SumGradients(torch.autograd.Function):
    """Forward: the input as it is.  Backward: the gradient summed over the
    model ranks: each rank's block of output channels feeds back only its
    share of the input's gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.model_group)
        return grad, None


class _Swapped:
    """Within the block, ``module``'s parameters named in ``tensors`` read
    as those tensors (gathered copies that carry autograd to the
    shards)."""

    def __init__(self, module: nn.Module, tensors: Dict[str, torch.Tensor]):
        self.module, self.tensors = module, tensors

    def __enter__(self):
        self.saved = {n: self.module._parameters[n] for n in self.tensors}
        self.module._parameters.update(self.tensors)

    def __exit__(self, *exc):
        self.module._parameters.update(self.saved)


def _tp_forward(module: nn.Module, mesh: Mesh, dims: Dict[str, int]):
    """The replicated forward of ``module`` from its shards."""
    forward = module.forward
    kernel_dim = dims.get("weight")
    blocked = (isinstance(module, (nn.Conv2d, nn.ConvTranspose2d))
               and module.groups == 1 and kernel_dim is not None)

    def tp_forward(x, *args, **kw):
        if blocked:
            return _Gather.apply(forward(_SumGradients.apply(x, mesh), *args,
                                         **kw), 1, mesh)
        full = {n: _Gather.apply(module._parameters[n], d, mesh)
                for n, d in dims.items()}
        with _Swapped(module, full):
            return forward(x, *args, **kw)

    return tp_forward


def shard_state_tp(mesh: Mesh, module: nn.Module, min_out_ch: int = 512
                   ) -> Dict[str, Optional[int]]:
    """Keep this model rank's slice of every tensor ``tp_param_shardings``
    splits, in place, and wrap the layers that hold them (see the module
    docstring); returns the placement map.  A conv (``groups`` 1) with a
    split kernel computes its block of output channels; any other layer
    gathers its split tensors before use.  :func:`gather_state_dict`
    gives the replicated state dict back."""
    dims = tp_param_shardings(mesh, module, min_out_ch)
    by_module: Dict[str, Dict[str, int]] = {}
    for key, d in dims.items():
        if d is not None:
            mname, _, pname = key.rpartition(".")
            by_module.setdefault(mname, {})[pname] = d
    for mname, own in by_module.items():
        m = module.get_submodule(mname)
        for pname, d in own.items():
            p = m._parameters[pname]
            m._parameters[pname] = nn.Parameter(
                _block(p.detach(), d, mesh.model_index,
                       mesh.n_model).clone(),
                requires_grad=p.requires_grad)
        m.forward = _tp_forward(m, mesh, own)
    module._tp_dims = dims
    return dims


def gather_state_dict(mesh: Mesh, module: nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """The replicated state dict of a module that ``shard_state_tp`` split,
    on every rank: each split tensor's blocks gathered bit for bit (as
    integers, so -0.0 and NaN payloads cross unchanged)."""
    dims = getattr(module, "_tp_dims", {})
    out = {}
    for k, v in module.state_dict().items():
        d = dims.get(k)
        if d is None:
            out[k] = v.clone()
        else:
            out[k] = _gather_blocks(_bits(v.detach()), d, mesh).view(v.dtype)
    return out
