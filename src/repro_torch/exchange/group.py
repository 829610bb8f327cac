"""One mesh axis on ``torch.distributed``: the collectives model C and D use.

The reference runs SPMD inside ``shard_map`` over ``mesh[axis]`` and calls
``jax.lax`` collectives by axis name.  The port runs one process per rank:
a process group plus this process's rank in it plays the role of
``mesh[axis]``, and ``AxisGroup`` carries the collectives the reference
calls inside ``shard_map`` (``psum``/``pmax``/``pmin``, ``all_gather``,
``all_to_all``, ``ppermute``).

Every op runs on its tensor's own device.  The backend is whatever the
group was initialised with: NCCL for CUDA tensors, gloo for CPU tensors
(gloo also takes CUDA tensors for these ops, staging them through host
memory).  Nothing here moves a tensor to another device to suit a backend.

``all_to_all`` is differentiable (its own transpose carries the cotangent
back), as the reference's ``jax.lax.all_to_all`` is.

The model stack on a mesh differentiates through four more collectives,
in the explicit form of what the reference leaves to XLA.  Their
convention is Megatron's: a tensor replicated over a group carries the
whole gradient on every rank of it.

* ``reduce_from(group, t)``: forward sum over the group, backward identity
  (partial results, each rank's own, combined into a replicated one);
* ``copy_to(group, t)``: forward identity, backward sum (a replicated
  tensor entering work that the ranks split among them);
* ``gather_from(group, t, dim)``: forward concatenation of the ranks'
  blocks along ``dim``, backward this rank's block;
* ``split_to(group, t, dim)``: forward this rank's block, backward the
  concatenation.

``CollectiveCounter`` records the collectives this process makes while it
is open (``with CollectiveCounter() as c: ...``): each call adds its kind
and the bytes of its result on this rank, the convention of the
reference's dry-run, which reads each collective's result shape off the
optimized HLO (``repro/launch/dryrun.py:_line_bytes``).  The kinds are the
reference's five: ``all-reduce`` (``psum``, ``pmax``, ``pmin``),
``all-gather``, ``reduce-scatter``, ``all-to-all`` and
``collective-permute``; a ``broadcast`` (which the reference's steps do
not make) is recorded under its own name.  With no counter open nothing
is recorded.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVES", "AxisGroup", "CollectiveCounter", "as_axis_group", "copy_to",
           "gather_from", "reduce_from", "split_to"]

# the gather into one tensor (named all_gather_into_tensor before torch 2.13)
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
_OPEN: list = []  # the counters open now, innermost last


class CollectiveCounter:
    """Counts and result bytes of the collectives made while it is open,
    by kind (module docstring).  Counters nest: each open one records.

    >>> import torch.distributed as dist
    >>> dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    >>> with CollectiveCounter() as c:
    ...     _ = AxisGroup().psum(torch.zeros(4))
    >>> c.record()["bytes"]["all-reduce"], c.record()["counts"]["all-reduce"]
    (16, 1)
    >>> dist.destroy_process_group()
    """

    def __init__(self):
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.counts = dict.fromkeys(COLLECTIVES, 0)

    def __enter__(self) -> "CollectiveCounter":
        _OPEN.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _OPEN.remove(self)

    def record(self) -> dict:
        """``{"bytes", "counts", "total_bytes"}``, the reference dry-run's
        ``collectives`` record."""
        return {"bytes": dict(self.bytes), "counts": dict(self.counts),
                "total_bytes": sum(self.bytes.values())}


def _record(kind: str, result: torch.Tensor) -> None:
    if _OPEN:
        nbytes = result.numel() * result.element_size()
        for c in _OPEN:
            c.bytes[kind] = c.bytes.get(kind, 0) + nbytes
            c.counts[kind] = c.counts.get(kind, 0) + 1


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` over dim 0 of a (P, ...) tensor; self-transpose backward."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group: "AxisGroup") -> torch.Tensor:
        ctx.group = group
        src = t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group.group)
        _record("all-to-all", out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllToAll.apply(g, ctx.group), None


class AxisGroup:
    """A process group seen as one mesh axis: ``size`` ranks, this one ``rank``.

    ``group`` is a ``torch.distributed`` process group; ``None`` means the
    default (WORLD) group, which must already be initialised.

    >>> import torch.distributed as dist
    >>> dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    >>> g = AxisGroup()
    >>> g.size, g.rank, g.psum(torch.tensor([2, 3])).tolist()
    (1, 0, [2, 3])
    >>> g.all_to_all(torch.arange(4.0).view(1, 4)).tolist()
    [[0.0, 1.0, 2.0, 3.0]]
    >>> dist.destroy_process_group()
    """

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if t.dtype == torch.bool:
            raise TypeError("reduce a bool as an integer: not every backend reduces bool")
        out = t.clone()
        dist.all_reduce(out, op=op, group=self.group)
        _record("all-reduce", out)
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis (``jax.lax.psum``)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Maximum over the axis (``jax.lax.pmax``)."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        """Minimum over the axis (``jax.lax.pmin``)."""
        return self._reduce(t, dist.ReduceOp.MIN)

    def broadcast(self, t: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Rank ``root``'s ``t`` on every rank."""
        out = t.clone()
        src = root if self.group is None else dist.get_global_rank(self.group, root)
        dist.broadcast(out, src=src, group=self.group)
        _record("broadcast", out)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: shape ``(P, *t.shape)``
        (``jax.lax.all_gather``).  One gather into a single tensor, whose
        blocks along dim 0 NCCL and gloo both fill."""
        src = t.contiguous().reshape((1,) + tuple(t.shape))
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        _gather_into(out, src, group=self.group)
        _record("all-gather", out)
        return out

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks concatenated along ``dim`` in rank order
        (``jax.lax.all_gather(..., axis=dim, tiled=True)``)."""
        if self.size == 1:
            return t
        stacked = self.all_gather(t)
        if dim == 0:
            return stacked.reshape((-1,) + tuple(t.shape[1:]))
        shape = tuple(t.shape)
        return stacked.movedim(0, dim).reshape(shape[:dim] + (-1,) + shape[dim + 1:])

    def split(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (no communication)."""
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {self.size} ranks")
        return t.narrow(dim, self.rank * (n // self.size), n // self.size)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the ranks of ``t``, this rank's block of it along
        ``dim`` (``jax.lax.psum_scatter(..., tiled=True)``).  One
        ``all_to_all`` and a local sum, which NCCL and gloo both take."""
        if self.size == 1:
            return t
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {self.size} ranks")
        parts = torch.stack(t.chunk(self.size, dim=dim))
        src = parts.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        out = out.sum(dim=0)
        _record("reduce-scatter", out)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Row ``j`` of the result is row ``rank`` of what rank ``j`` sent:
        ``t`` is ``(P, row, ...)`` (``jax.lax.all_to_all`` with
        ``split_axis=0, concat_axis=0, tiled=False``)."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all needs a leading dim of {self.size}, got {tuple(t.shape)}")
        return _AllToAll.apply(t, self)

    def ppermute(self, t: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Send ``t`` along the ``(source, destination)`` pairs of ``perm``;
        a rank that no pair sends to gets zeros (``jax.lax.ppermute``).

        Built on ``all_to_all_single`` with split sizes (0 for every rank
        that is not a partner), which NCCL and gloo both take for CPU and
        CUDA tensors alike.
        """
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"perm {perm} is not a permutation")
        flat = t.contiguous().reshape(-1)
        numel = flat.numel()
        out = torch.empty(numel if src else 0, dtype=flat.dtype, device=flat.device)
        dist.all_to_all_single(
            out,
            flat if dst else flat[:0],
            output_split_sizes=[numel if [i] == src else 0 for i in range(self.size)],
            input_split_sizes=[numel if [j] == dst else 0 for j in range(self.size)],
            group=self.group,
        )
        _record("collective-permute", out)
        if not src:
            return torch.zeros_like(t)
        return out.view(t.shape)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return group.psum(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.psum(g), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.split(g, ctx.dim).contiguous(), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.split(t, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.group.gather(g.contiguous(), ctx.dim), None, None


def reduce_from(group: AxisGroup, t: torch.Tensor) -> torch.Tensor:
    """Sum over ``group``; the gradient passes through unchanged."""
    return t if group.size == 1 else _ReduceFrom.apply(t, group)


def copy_to(group: AxisGroup, t: torch.Tensor) -> torch.Tensor:
    """``t`` itself; its gradient is summed over ``group``."""
    return t if group.size == 1 else _CopyTo.apply(t, group)


def gather_from(group: AxisGroup, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim``; the gradient comes
    back as this rank's block."""
    return t if group.size == 1 else _GatherFrom.apply(t, group, dim)


def split_to(group: AxisGroup, t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim``; the gradient comes back
    concatenated over ``group``."""
    return t if group.size == 1 else _SplitTo.apply(t, group, dim)


def as_axis_group(mesh) -> AxisGroup:
    """The ``AxisGroup`` a ``mesh=`` argument names: an ``AxisGroup`` itself,
    or a ``ProcessGroup`` taken whole as the axis."""
    if isinstance(mesh, AxisGroup):
        return mesh
    if isinstance(mesh, dist.ProcessGroup):
        return AxisGroup(mesh)
    raise TypeError(f"mesh= takes an AxisGroup or a torch.distributed ProcessGroup, got {type(mesh)}")
