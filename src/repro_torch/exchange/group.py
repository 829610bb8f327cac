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
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["AxisGroup", "as_axis_group"]


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` over dim 0 of a (P, ...) tensor; self-transpose backward."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group: "AxisGroup") -> torch.Tensor:
        ctx.group = group
        src = t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group.group)
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

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: shape ``(P, *t.shape)``
        (``jax.lax.all_gather``).  The list form, which NCCL and gloo both
        take."""
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts)

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
        if not src:
            return torch.zeros_like(t)
        return out.view(t.shape)


def as_axis_group(mesh) -> AxisGroup:
    """The ``AxisGroup`` a ``mesh=`` argument names: an ``AxisGroup`` itself,
    or a ``ProcessGroup`` taken whole as the axis."""
    if isinstance(mesh, AxisGroup):
        return mesh
    if isinstance(mesh, dist.ProcessGroup):
        return AxisGroup(mesh)
    raise TypeError(f"mesh= takes an AxisGroup or a torch.distributed ProcessGroup, got {type(mesh)}")
