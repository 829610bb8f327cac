"""Public sort API (torch): ``sort(x)`` runs a sort plan.

Counterpart of ``repro/core/api.py``.  Precedence: ``strategy=`` >
``plan=`` > the default planner's tuned plan for this (size, dtype, device)
cell > the paper's rule: model D (``"cluster"``) on a mesh, model B
(``"shared_hybrid"``) on one device.  ``local_impl=`` / ``block_n=``
rewrite the chosen plan's local-sort fields (``local_impl='kernel'`` routes
every local sort through the CUDA kernels).

``sort(x, mesh=group)`` runs on every rank of a process group (an
``AxisGroup`` or a ``ProcessGroup``), each with its shard ``x``, and
returns that rank's ``(slab, valid)`` block, as ``cluster_sort`` does.
Cluster runs close the capacity-learning loop through the default planner
(learned ``capacity_factor`` + telemetry), keyed by the global length (the
shard's times the group's size), unless ``capacity_factor=`` /
``telemetry=`` — or a full ``plan=`` — are passed.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

from repro_torch.carry import as_tensor
from repro_torch.tracing import span

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
    from repro_torch.engine.planner import run_plan

    with span("repro_torch.sort"):
        x = as_tensor(x, device)
        with span("repro_torch.plan"):
            plan = _choose_plan(x, mesh, strategy, plan, local_impl, block_n, n_threads, kwargs)
        return run_plan(plan, x, mesh=mesh, axis=axis, ascending=ascending, **kwargs)


def _choose_plan(x, mesh, strategy, plan, local_impl, block_n, n_threads, kwargs):
    """The plan ``sort`` runs; on a cluster plan with the loop on, the
    learned factor and the telemetry callback go into ``kwargs``."""
    from repro_torch.engine.planner import default_planner, plan_from_strategy
    from repro_torch.exchange import as_axis_group

    # the plan key's length is the global one: on a mesh each rank holds a
    # shard of the same length
    n = x.shape[-1] if mesh is None else x.shape[-1] * as_axis_group(mesh).size
    # an explicit plan= pins the full recipe, capacity_factor included, so it
    # neither reads nor mutates the learned table (strategy= keeps the loop on)
    pinned_plan = plan is not None and strategy is None
    if strategy is not None:
        plan = plan_from_strategy(strategy, n_threads=n_threads)
    elif plan is None:
        plan = default_planner().lookup(n, x.dtype, mesh, device=x.device)
        # with mesh= the return contract is cluster_sort's (slab, valid): only
        # an explicit strategy=/plan= may change it
        if mesh is not None and (plan is None or plan.strategy != "cluster"):
            plan = plan_from_strategy("cluster")
        elif plan is None:
            plan = plan_from_strategy("shared_hybrid", n_threads=n_threads)
    if local_impl is not None:
        plan = replace(plan, local_impl=local_impl)
    if block_n is not None:
        plan = replace(plan, block_n=block_n)
    if (
        plan.strategy == "cluster"
        and mesh is not None
        and not pinned_plan
        and "capacity_factor" not in kwargs
        and "telemetry" not in kwargs
    ):
        # close the loop: run at the learned factor and report this call's
        # telemetry; mode= is a hint that keeps a caller's mode authoritative
        kwargs.update(
            default_planner().cluster_kwargs(
                n, x.dtype, mesh, default=plan.capacity_factor, mode=kwargs.get("mode"),
                device=x.device,
            )
        )
    return plan
