"""Key–value sorting: stable argsort, sort_kv, topk, and model D with a payload.

Counterpart of ``repro/engine/kv.py``.  On one device (``mesh=None``) every
call sorts the last axis, with any leading batch dims, through a stable
argsort and gathers by it: ``impl='xla'`` is ``torch.sort(stable=True)``,
``impl='kernel'`` the hand-written CUDA (key, rank) network; both return
int32 indices, as the reference's ``jnp.argsort`` does.  ``values`` is any
nest of dicts, lists and tuples (the reference's pytree) of tensors shaped
like the keys plus optional trailing dims.

With ``mesh=`` (an ``AxisGroup`` or a ``ProcessGroup``) the records ride
model D's exchange (``cluster_sort_kv``): every rank passes its shard and
gets back its valid prefix of the result, so the prefixes in rank order
are the reference's dense result, and no rank gathers the whole array.
Stability falls out of the slab layout: within a bucket, receive order is
(sender rank, slot), which is arrival order, so a stable local argsort of
the received slab is the global stable sort.  The mesh path closes the
capacity-learning loop by default: it runs at the default planner's learned
``capacity_factor`` for this (global size, dtype, group) cell and reports
its telemetry back (``capacity_factor=`` or ``telemetry=`` opt out).

Tensors run where they live; numpy arrays and lists are placed on
``device`` (default ``"cuda"``, which raises when there is no card).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils._pytree import tree_map

from repro_torch.carry import as_tensor
from repro_torch.core.cluster_sort import owned_count_and_peak
from repro_torch.core.merge import sort_image
from repro_torch.core.radix import make_partitioner
from repro_torch.exchange import (
    AxisGroup,
    as_axis_group,
    partition_exchange,
    partition_of,
    run_with_capacity_retries,
    slab_geometry,
    slab_valid,
)

__all__ = ["sort_kv", "sort_pairs", "argsort", "topk", "cluster_sort_kv"]


# torch has no bitwise NOT or gather for these: take them on the same bits as signed
_SIGNED_TWIN = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _rev_key(keys: torch.Tensor) -> torch.Tensor:
    """Order-reversing self-inverse bijection: negation for floats, bitwise
    NOT for ints (~x = -x-1 is strictly decreasing; even INT_MIN is safe;
    unsigned, ~x = MAX - x)."""
    if keys.dtype.is_floating_point:
        return -keys
    if keys.dtype in _SIGNED_TWIN:
        return (~keys.view(_SIGNED_TWIN[keys.dtype])).view(keys.dtype)
    return ~keys


def _order_keys(
    keys: torch.Tensor,
    *,
    ascending: bool,
    impl: str = "xla",
    block_n: Optional[int] = None,
) -> torch.Tensor:
    """Stable argsort along the last axis, either direction.

    Descending stability (ties keep original order) sorts the reversed-order
    key transform ascending.  ``impl='kernel'`` runs the kernels' stable
    (key, rank) network: the same permutation, NaN keys included (both rank
    floats on ``sort_image``).  The indices come as each route makes them
    (int64 from the library, int32 from the kernels): a caller that gathers
    takes them so, one that returns them casts to int32.
    """
    k = keys if ascending else _rev_key(keys)
    if impl == "kernel":
        from repro_torch.kernels.bitonic_sort.ops import DEFAULT_BLOCK_N, kernel_argsort

        return kernel_argsort(k, block_n=block_n or DEFAULT_BLOCK_N)
    if impl != "xla":
        raise ValueError(f"argsort impl must be 'xla' or 'kernel', got {impl!r}")
    # floats on their sort image: NaN of either sign last on every device
    return torch.sort(sort_image(k), dim=-1, stable=True).indices


def _gather_last(v: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Index ``v`` (shaped like keys + optional trailing dims) by ``order``."""
    extra = v.dim() - order.dim()
    idx = order.long().reshape(order.shape + (1,) * extra).expand(order.shape + v.shape[order.dim():])
    if v.dtype in _SIGNED_TWIN:
        return torch.gather(v.view(_SIGNED_TWIN[v.dtype]), order.dim() - 1, idx).view(v.dtype)
    return torch.gather(v, order.dim() - 1, idx)


# ------------------------------------------------------------- cluster path ---
def cluster_kv_local(
    local_keys: torch.Tensor,
    local_values: Any,
    group: AxisGroup,
    *,
    capacity: int,
    partitioner,
    n_buckets: int,
    compress: bool = False,
    local_impl: str = "xla",
):
    """Model D with a payload on one rank: exchange (key, value) records,
    stable-sort the slab (``local_impl`` as ``argsort``'s ``impl``).

    Returns (sorted_keys (n_buckets * capacity,), sorted_values nest,
    my_count (1,), peak, overflow).  Entries [0, my_count) are this rank's
    contiguous range of the global stable sort; the tail is sentinel/zero
    padding.
    """
    bucket = partitioner(local_keys).to(torch.int32)
    ex = partition_exchange(local_keys, local_values, bucket, group, capacity=capacity,
                            n_buckets=n_buckets, compress=compress)
    flat_k = ex.recv_keys.reshape(-1)
    # slab flat index = (sender, local bucket, slot): within one bucket this
    # is global arrival order, so a stable sort here is the global stable
    # sort (the library's or the kernels', in the role XLA's argsort plays
    # in the reference)
    order = _order_keys(flat_k, ascending=True, impl=local_impl).long()
    sorted_k = flat_k[order]
    sorted_v = tree_map(lambda v: v.reshape((flat_k.shape[0],) + v.shape[2:])[order], ex.recv_values)
    return (sorted_k, sorted_v, *owned_count_and_peak(ex, group, n_buckets), ex.overflow)


def cluster_sort_kv(
    keys: torch.Tensor,
    values: Any,
    mesh,
    axis: Optional[str] = None,
    *,
    mode: str = "splitters",
    capacity_factor: float = 2.0,
    digits: int = 3,
    lo=0,
    hi=1,
    compress: bool = False,
    local_impl: str = "xla",
    max_retries: int = 4,
    telemetry=None,
):
    """Distributed stable key–value sort (model D with a values payload).

    ``mesh`` is an ``AxisGroup`` or a ``ProcessGroup``; ``axis`` is accepted
    for parity with the reference (the group is the axis).  Every rank
    passes its shard of keys (1-D, the same length on every rank) and of
    each value, and gets back ``(slab_keys, slab_values, valid)``: its
    block of the reference's slabs, whose first ``valid.sum()`` records are
    this rank's contiguous range of the sorted records.  Retries with
    doubled capacity on overflow and reports telemetry as ``cluster_sort``
    does.  ``local_impl`` sorts each received slab: ``'xla'`` (the
    library's stable sort, the reference's only choice) or ``'kernel'``
    (the bitonic (key, rank) kernels at their default tile width).
    """
    group = as_axis_group(mesh)
    P_ = group.size
    m = keys.shape[-1]
    part_buckets, n_buckets, cap = slab_geometry(mode, m, P_, capacity_factor)
    # stable=True: the kv contract is a stable sort, so sample mode uses
    # arrival-order tie ids
    part = make_partitioner(mode, n_buckets=part_buckets, digits=digits, lo=lo, hi=hi,
                            group=group, stable=True)

    def run(c):
        return cluster_kv_local(keys, values, group, capacity=c, partitioner=part,
                                n_buckets=n_buckets, compress=compress, local_impl=local_impl)

    (slab_k, slab_v), my_count = run_with_capacity_retries(
        run,
        m=m,
        part_buckets=part_buckets,
        cap=cap,
        max_retries=max_retries,
        telemetry=telemetry,
        label="cluster_sort_kv",
        partition=partition_of(mode),
    )
    return slab_k, slab_v, slab_valid(slab_k.shape[0], my_count, 1)


# ---------------------------------------------------------------- front API ---
def sort_kv(
    keys,
    values,
    *,
    mesh=None,
    axis: Optional[str] = None,
    ascending: bool = True,
    compress: bool = False,
    impl: str = "xla",
    block_n: Optional[int] = None,
    device="cuda",
    **cluster_kw,
):
    """Stable sort of ``keys`` carrying a nest of ``values`` along; the
    values come back in the same structure.

    One device: any leading batch dims, sorts the last axis; ``impl=``
    picks the local argsort ('xla' or 'kernel', ``block_n`` = kernel tile
    width).  With ``mesh=`` (an ``AxisGroup`` or a ``ProcessGroup``;
    ``axis`` is accepted for parity with the reference): 1-D keys, model-D
    exchange of whole records (``compress=True`` ships float payloads as
    int8, ``cluster_kw`` go to ``cluster_sort_kv``); every rank passes its
    shard and gets back its valid prefix of the sorted records, at the
    default planner's learned capacity unless ``capacity_factor=`` or
    ``telemetry=`` is passed.

    >>> k, v = sort_kv(torch.tensor([3, 1, 2]), {"p": torch.tensor([0, 1, 2])})
    >>> v["p"].tolist()
    [1, 2, 0]
    """
    keys = as_tensor(keys, device)
    values = tree_map(lambda v: as_tensor(v, keys.device), values)
    if mesh is None:
        order = _order_keys(keys, ascending=ascending, impl=impl, block_n=block_n)
        return _gather_last(keys, order), tree_map(lambda v: _gather_last(v, order), values)
    if not ascending:
        # sort the order-reversed keys ascending so ties keep arrival order
        # (a flip of the ascending result would reverse them); decimal/range
        # bucketing assumes the untransformed key space, the data-adaptive
        # modes (splitters/sample/auto-ranged radix) don't care
        if cluster_kw.get("mode", "splitters") not in ("splitters", "sample", "radix"):
            raise ValueError(
                "descending distributed sort_kv needs a data-adaptive mode "
                "('splitters', 'sample', or 'radix')"
            )
        k, v = sort_kv(_rev_key(keys), values, mesh=mesh, axis=axis, compress=compress,
                       **cluster_kw)
        return _rev_key(k), v
    if "capacity_factor" not in cluster_kw and "telemetry" not in cluster_kw:
        # close the capacity-learning loop through the default planner, keyed
        # by the global length; an explicit capacity_factor= or telemetry=
        # opts out of the whole loop
        from .planner import default_planner

        n = keys.shape[-1] * as_axis_group(mesh).size
        cluster_kw.update(default_planner().cluster_kwargs(
            n, keys.dtype, mesh, mode=cluster_kw.get("mode"), device=keys.device))
    slab_k, slab_v, valid = cluster_sort_kv(keys, values, mesh, axis, compress=compress,
                                            **cluster_kw)
    n_valid = int(valid.sum())  # valid is a prefix
    return slab_k[:n_valid], tree_map(lambda a: a[:n_valid], slab_v)


def sort_pairs(keys, values, **kwargs):
    """(keys, values) -> (sorted_keys, aligned_values) for one payload tensor
    (or one nest of them).

    >>> k, v = sort_pairs(torch.tensor([2, 1]), torch.tensor([10, 20]))
    >>> v.tolist()
    [20, 10]
    """
    return sort_kv(keys, values, **kwargs)


def argsort(
    keys,
    *,
    mesh=None,
    axis: Optional[str] = None,
    ascending: bool = True,
    impl: str = "xla",
    block_n: Optional[int] = None,
    device="cuda",
    **cluster_kw,
):
    """Stable argsort (indices into the original tensor), matching
    ``np.argsort(kind='stable')``.  With ``mesh=`` every rank passes its
    shard and gets back its valid prefix of the global permutation (int32
    indices into the whole array: rank r's shard starts at r * m); the
    global index rides the exchange as the payload.

    >>> argsort(torch.tensor([30, 10, 20])).tolist()
    [1, 2, 0]
    """
    keys = as_tensor(keys, device)
    if mesh is None:
        return _order_keys(keys, ascending=ascending, impl=impl, block_n=block_n).to(torch.int32)
    m = keys.shape[-1]
    iota = as_axis_group(mesh).rank * m + torch.arange(m, dtype=torch.int32, device=keys.device)
    _, idx = sort_pairs(keys, iota, mesh=mesh, axis=axis, ascending=ascending, **cluster_kw)
    return idx


def topk(
    x,
    k: int,
    *,
    largest: bool = True,
    impl: str = "xla",
    block_n: Optional[int] = None,
    device="cuda",
):
    """Top-k (values, indices) along the last axis via the stable argsort.

    Ties go to the lowest index (``jax.lax.top_k``'s rule), for
    ``impl='kernel'`` too, since its (key, rank) comparator is stable.

    >>> vals, idx = topk(torch.tensor([1.0, 9.0, 4.0]), 2)
    >>> vals.tolist(), idx.tolist()
    ([9.0, 4.0], [1, 2])
    """
    x = as_tensor(x, device)
    top_idx = _order_keys(x, ascending=not largest, impl=impl, block_n=block_n)[..., :k].to(torch.int32)
    return _gather_last(x, top_idx), top_idx
