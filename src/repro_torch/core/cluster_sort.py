"""Paper model D: hybrid-memory sort — one-step MSD-Radix scatter, local sort.

Counterpart of ``repro/core/cluster_sort.py``, the framework's production
path:

  1. every rank computes each key's destination from its most significant
     digit/bits (or sample splitters) — ``radix.py``;
  2. one ``all_to_all`` ships every key to its destination rank — after
     this step key ranges are disjoint, so no inter-rank merge ever happens;
  3. each rank sorts what it received with the fast local sort
     (``local_impl='kernel'``: the hand-written bitonic kernels A, B, C).

A process group plays the role of ``mesh[axis]``: every rank calls
``cluster_sort`` with its own shard and gets back its own block of the
result (the reference's ``P(axis)`` in and out specs).  The exchange
machinery lives in ``repro_torch.exchange``; its names are re-exported here
as the reference does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.exchange import (  # noqa: F401  (re-exported, as the reference does)
    AxisGroup,
    ExchangeResult,
    as_axis_group,
    combine_exchange,
    partition_exchange,
    partition_of,
    run_with_capacity_retries,
    slab_geometry,
    slab_valid,
)
from repro_torch.tracing import span

from .radix import make_partitioner
from .seqsort import fast_local_sort

__all__ = [
    "ExchangeResult",
    "partition_exchange",
    "combine_exchange",
    "cluster_sort_local",
    "cluster_sort",
    "slab_geometry",
]


def cluster_sort_local(
    local: torch.Tensor,
    group: AxisGroup,
    *,
    capacity: int,
    partitioner: Callable[[torch.Tensor], torch.Tensor],
    n_buckets: int,
    local_impl: str = "xla",
    block_n: Optional[int] = None,
):
    """Model D on one rank.  ``local``: (m,) shard.  Returns (sorted_slab
    (n_buckets * capacity,), my_count (1,), peak, overflow): entries
    [0, my_count) of the slab are this rank's contiguous range of the
    globally sorted output; ``peak`` is the group-wide max per-(sender,
    bucket) element count, the signal capacity learning feeds on."""
    bucket = partitioner(local).to(torch.int32)
    with span("repro_torch.cluster.exchange", device=local):
        ex = partition_exchange(local, None, bucket, group, capacity=capacity,
                                n_buckets=n_buckets)
    flat = ex.recv_keys.reshape(-1)
    sorted_slab = fast_local_sort(flat, ascending=True, impl=local_impl, block_n=block_n)
    return (sorted_slab, *owned_count_and_peak(ex, group, n_buckets), ex.overflow)


def owned_count_and_peak(ex: ExchangeResult, group: AxisGroup, n_buckets: int):
    """(my_count (1,), peak): the group-wide count of the buckets this rank
    owns, and the group-wide max per-(sender, bucket) count."""
    global_counts = group.psum(ex.counts)  # (n_buckets,)
    owner = (torch.arange(n_buckets, dtype=torch.int32, device=ex.counts.device) * group.size) // n_buckets
    my_count = torch.where(owner == group.rank, global_counts, 0).sum().to(torch.int32)
    return my_count[None], group.pmax(ex.counts.max())


def cluster_sort(
    x: torch.Tensor,
    mesh,
    axis: Optional[str] = None,
    *,
    mode: str = "splitters",
    capacity_factor: float = 2.0,
    digits: int = 3,
    lo=0,
    hi=1,
    local_impl: str = "xla",
    block_n: Optional[int] = None,
    max_retries: int = 4,
    telemetry: Optional[Callable[..., None]] = None,
):
    """Sort across the ranks of ``mesh`` with the paper's cluster algorithm.

    ``mesh`` is an ``AxisGroup`` or a ``ProcessGroup``; ``axis`` names the
    mesh axis in the reference and is accepted here for parity (the group
    is the axis).  Every rank passes its shard ``x`` (1-D, the same length
    on every rank) and gets back ``(slab, valid)``: its block of the
    reference's ``(P*C_total,)`` slab, whose first ``valid.sum()`` entries
    are this rank's contiguous range of the sorted keys.  Retries with
    doubled capacity on overflow.  ``block_n`` tunes ``local_impl='kernel'``.

    ``telemetry`` is an optional callback invoked once per call (a failing
    one included) with keyword args ``m``, ``part_buckets``, ``capacity``,
    ``peak``, ``overflowed``, ``retries``, ``recompiles`` (always 0 here)
    and ``partition``.
    """
    group = as_axis_group(mesh)
    P_ = group.size
    m = x.shape[-1]
    part_buckets, n_buckets, cap = slab_geometry(mode, m, P_, capacity_factor)
    part = make_partitioner(mode, n_buckets=part_buckets, digits=digits, lo=lo, hi=hi, group=group)

    def run(c):
        return cluster_sort_local(x, group, capacity=c, partitioner=part, n_buckets=n_buckets,
                                  local_impl=local_impl, block_n=block_n)

    (slab,), my_count = run_with_capacity_retries(
        run,
        m=m,
        part_buckets=part_buckets,
        cap=cap,
        max_retries=max_retries,
        telemetry=telemetry,
        label="cluster_sort",
        partition=partition_of(mode),
    )
    return slab, slab_valid(slab.shape[0], my_count, 1)
