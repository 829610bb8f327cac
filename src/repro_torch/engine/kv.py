"""Key–value sorting on one device: stable argsort, sort_kv, topk (torch).

Counterpart of the local half of ``repro/engine/kv.py`` (``mesh=None``).
Every call sorts the last axis, with any leading batch dims, through a stable
argsort and gathers by it: ``impl='xla'`` is ``torch.sort(stable=True)``,
``impl='kernel'`` the hand-written CUDA (key, rank) network; both return
int32 indices, as the reference's ``jnp.argsort`` does.  ``values`` is any
nest of dicts, lists and tuples (the reference's pytree) of tensors shaped
like the keys plus optional trailing dims.  The mesh path (model D with a
payload) is a later slice: ``mesh=`` raises ``NotImplementedError``.

Tensors run where they live; numpy arrays and lists are placed on
``device`` (default ``"cuda"``, which raises when there is no card).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils._pytree import tree_map

from repro_torch.carry import as_tensor

__all__ = ["sort_kv", "sort_pairs", "argsort", "topk"]

_MESH_NOT_PORTED = "the mesh kv path is not ported yet: ROADMAP Queue 1 item 5"


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
    (key, rank) network: the same permutation (NaN keys aside).
    """
    k = keys if ascending else _rev_key(keys)
    if impl == "kernel":
        from repro_torch.kernels.bitonic_sort.ops import DEFAULT_BLOCK_N, kernel_argsort

        return kernel_argsort(k, block_n=block_n or DEFAULT_BLOCK_N)
    if impl != "xla":
        raise ValueError(f"argsort impl must be 'xla' or 'kernel', got {impl!r}")
    return torch.sort(k, dim=-1, stable=True).indices.to(torch.int32)


def _gather_last(v: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Index ``v`` (shaped like keys + optional trailing dims) by ``order``."""
    extra = v.dim() - order.dim()
    idx = order.long().reshape(order.shape + (1,) * extra).expand(order.shape + v.shape[order.dim():])
    if v.dtype in _SIGNED_TWIN:
        return torch.gather(v.view(_SIGNED_TWIN[v.dtype]), order.dim() - 1, idx).view(v.dtype)
    return torch.gather(v, order.dim() - 1, idx)


def sort_kv(
    keys,
    values,
    *,
    mesh=None,
    axis: Optional[str] = None,
    ascending: bool = True,
    impl: str = "xla",
    block_n: Optional[int] = None,
    device="cuda",
):
    """Stable sort of ``keys`` carrying a nest of ``values`` along; the
    values come back in the same structure.

    >>> k, v = sort_kv(torch.tensor([3, 1, 2]), {"p": torch.tensor([0, 1, 2])})
    >>> v["p"].tolist()
    [1, 2, 0]
    """
    if mesh is not None:
        raise NotImplementedError(_MESH_NOT_PORTED)
    keys = as_tensor(keys, device)
    values = tree_map(lambda v: as_tensor(v, keys.device), values)
    order = _order_keys(keys, ascending=ascending, impl=impl, block_n=block_n)
    return _gather_last(keys, order), tree_map(lambda v: _gather_last(v, order), values)


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
):
    """Stable argsort (indices into the original tensor), matching
    ``np.argsort(kind='stable')``.

    >>> argsort(torch.tensor([30, 10, 20])).tolist()
    [1, 2, 0]
    """
    if mesh is not None:
        raise NotImplementedError(_MESH_NOT_PORTED)
    keys = as_tensor(keys, device)
    return _order_keys(keys, ascending=ascending, impl=impl, block_n=block_n)


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
    top_idx = _order_keys(x, ascending=not largest, impl=impl, block_n=block_n)[..., :k]
    return _gather_last(x, top_idx), top_idx
