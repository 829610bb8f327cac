"""Public sort API (torch): ``sort(x)`` runs a sort plan.

Counterpart of ``repro/core/api.py``.  Precedence: ``strategy=`` >
``plan=`` > the default rule.  The reference's default rule first asks its
planner for a tuned plan; with no plan-cache file that lookup returns
nothing and the rule falls to model D (``"cluster"``) on a mesh and model B
(``"shared_hybrid"``) on one device, which is the rule this port applies
until the planner slice lands.  ``local_impl=`` / ``block_n=`` rewrite the
chosen plan's local-sort fields (``local_impl='kernel'`` routes every local
sort through the CUDA kernels).

``sort(x, mesh=group)`` runs on every rank of a process group (an
``AxisGroup`` or a ``ProcessGroup``), each with its shard ``x``, and
returns that rank's ``(slab, valid)`` block, as ``cluster_sort`` does.  The
reference's capacity learning through its planner is not ported yet: a
mesh call runs at the plan's ``capacity_factor`` unless the caller passes
one.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

from repro_torch.carry import as_tensor

__all__ = ["sort"]


def sort(
    x,
    *,
    mesh=None,
    axis: Optional[str] = None,
    strategy: Optional[str] = None,
    plan=None,
    local_impl: Optional[str] = None,
    block_n: Optional[int] = None,
    n_threads: int = 8,
    ascending: bool = True,
    device="cuda",
    **kwargs,
):
    """Sort the last axis of ``x`` using one of the paper's parallel models.

    With ``mesh=`` (``axis=`` is accepted for parity with the reference)
    each rank passes its shard and gets its ``(slab, valid)`` block.  A
    tensor is sorted where it lives; a numpy array or list is placed on
    ``device`` first.

    >>> import torch
    >>> sort(torch.tensor([3, 1, 2])).tolist()
    [1, 2, 3]
    >>> sort(torch.tensor([3, 1, 2], dtype=torch.int32), strategy="shared",
    ...      local_impl="kernel", n_threads=2).tolist()
    [1, 2, 3]
    """
    from repro_torch.engine.planner import plan_from_strategy, run_plan

    x = as_tensor(x, device)
    if strategy is not None:
        plan = plan_from_strategy(strategy, n_threads=n_threads)
    elif plan is None:
        plan = plan_from_strategy("cluster" if mesh is not None else "shared_hybrid",
                                  n_threads=n_threads)
    if local_impl is not None:
        plan = replace(plan, local_impl=local_impl)
    if block_n is not None:
        plan = replace(plan, block_n=block_n)
    return run_plan(plan, x, mesh=mesh, axis=axis, ascending=ascending, **kwargs)
