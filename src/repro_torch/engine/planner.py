"""Sort plans — the plan core of ``repro/engine/planner.py`` (torch).

A ``SortPlan`` pins one concrete execution recipe (strategy, local sort impl,
thread count, capacity factor, partitioner mode, kernel tile width).
``run_plan`` executes it: ``'shared'`` (paper models A/B) on one device,
``'distributed_merge'`` (model C) and ``'cluster'`` (model D) across the
ranks of a process group.  The ``Planner`` with its autotune sweep and the
JSON plan cache are a later slice (ROADMAP Queue 1).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

import torch

from repro_torch.core.cluster_sort import cluster_sort
from repro_torch.core.distributed_sort import distributed_merge_sort
from repro_torch.core.shared_sort import shared_memory_sort
from repro_torch.exchange import partition_of

__all__ = [
    "SortPlan",
    "default_plan",
    "plan_from_strategy",
    "run_plan",
]

# strategy names: 'shared' covers paper models A/B (A = local_impl='merge',
# B = local_impl='xla'/'bitonic'/'kernel'); C and D keep their api.py names.


@dataclass(frozen=True)
class SortPlan:
    """One executable sort recipe; ``us_per_call`` records a tuned timing.

    ``block_n`` is the CUDA kernels' shared-memory tile width; it only
    matters for ``local_impl='kernel'``.  ``partition`` pins the cluster
    partition family (``"radix"`` or ``"sample"``); ``None`` means the family
    of ``mode``.

    >>> plan = SortPlan("shared", local_impl="kernel", block_n=512)
    >>> SortPlan.from_dict(plan.to_dict()) == plan
    True
    >>> SortPlan("cluster", mode="range").effective_partition()
    'radix'
    >>> SortPlan("cluster", mode="range", partition="sample").partitioner_mode()
    'sample'
    """

    strategy: str = "shared"
    local_impl: str = "xla"
    n_threads: int = 8
    capacity_factor: float = 2.0
    mode: str = "splitters"
    block_n: Optional[int] = None
    us_per_call: float = -1.0
    partition: Optional[str] = None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SortPlan":
        known = {k: d[k] for k in cls.__dataclass_fields__ if k in d}
        return cls(**known)

    def effective_partition(self) -> str:
        """The partition family this plan runs: the explicit ``partition``
        override if set, else ``mode``'s own family."""
        return self.partition or partition_of(self.mode)

    def partitioner_mode(self) -> str:
        """The concrete partitioner mode the plan executes: ``mode`` when it
        belongs to ``effective_partition``'s family, else that family's
        canonical mode (``"sample"`` / ``"radix"``)."""
        if self.partition is None or partition_of(self.mode) == self.partition:
            return self.mode
        return "sample" if self.partition == "sample" else "radix"


def plan_from_strategy(strategy: str, *, n_threads: int = 8) -> SortPlan:
    """Map the public api.py strategy names onto plans.

    >>> plan_from_strategy("shared_merge").local_impl
    'merge'
    >>> plan_from_strategy("shared").strategy
    'shared'
    """
    table = {
        "shared": SortPlan("shared", local_impl="xla", n_threads=n_threads),
        "shared_merge": SortPlan("shared", local_impl="merge", n_threads=n_threads),
        "shared_hybrid": SortPlan("shared", local_impl="xla", n_threads=n_threads),
        "distributed_merge": SortPlan("distributed_merge"),
        "cluster": SortPlan("cluster"),
    }
    if strategy not in table:
        raise ValueError(f"strategy must be one of {tuple(table)}")
    return table[strategy]


def default_plan(mesh=None) -> SortPlan:
    """The pre-autotune rule: model D on a mesh, model B on one device.

    >>> default_plan().strategy
    'shared'
    """
    return SortPlan("cluster") if mesh is not None else SortPlan("shared")


def run_plan(
    plan: SortPlan,
    x: torch.Tensor,
    *,
    mesh=None,
    axis: Optional[str] = None,
    ascending: bool = True,
    **kwargs,
):
    """Execute a plan on ``x`` where it lives.  Cluster plans return
    ``(slab, valid)`` like ``cluster_sort``; mesh plans take ``mesh=`` (an
    ``AxisGroup`` or a ``ProcessGroup``) and this rank's shard.

    >>> run_plan(SortPlan("shared"), torch.tensor([3, 1, 2])).tolist()
    [1, 2, 3]
    """
    if not ascending and plan.strategy == "cluster":
        raise ValueError(
            "the cluster strategy sorts ascending only; for descending "
            "distributed sorts use sort_kv(ascending=False)"
        )
    if plan.strategy == "shared":
        return shared_memory_sort(
            x,
            n_threads=plan.n_threads,
            local_impl=plan.local_impl,
            ascending=ascending,
            block_n=plan.block_n,
        )
    if plan.strategy not in ("distributed_merge", "cluster"):
        raise ValueError(f"unknown plan strategy {plan.strategy!r}")
    if mesh is None:
        raise ValueError(f"plan strategy {plan.strategy!r} requires mesh=")
    kwargs.setdefault("local_impl", plan.local_impl)
    kwargs.setdefault("block_n", plan.block_n)
    if plan.strategy == "distributed_merge":
        out = distributed_merge_sort(x, mesh, axis, **kwargs)
        return out if ascending else torch.flip(out, dims=(-1,))
    # partitioner_mode folds the plan's partition override in
    kwargs.setdefault("mode", plan.partitioner_mode())
    kwargs.setdefault("capacity_factor", plan.capacity_factor)
    return cluster_sort(x, mesh, axis, **kwargs)
