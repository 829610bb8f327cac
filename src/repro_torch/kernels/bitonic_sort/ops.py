"""Composition of the bitonic kernels: sort / argsort / kv-sort (torch).

Counterpart of ``repro/kernels/bitonic_sort/ops.py``.  ``kernel_sort(x)``
sorts the last axis of any length >= 1: it pads to the next power of two with
+sentinel keys, runs the tiled network, and slices the valid prefix back out.

  phase 1:  kernel A  (per-tile alternating-direction sort)
  stages k = 2*block_n .. n:
     j = k/2 .. block_n   : kernel C, one launch per substage
     j = block_n/2 .. 1   : kernel B (all of them in one pass, in registers)

Leading dims are rows of the kernel grid (the reference ``vmap``s its 1-D
kernels over them instead).  ``kernel_argsort`` runs the same network on
(key, rank) pairs — ranks never tie, so the permutation it returns (int32,
as the reference's) is the stable one.  ``kernel_sort_kv`` gathers any nest
of dicts, lists and tuples of payloads by it, as the reference's pytree.

Keys are float32, int32, float16 or bfloat16, which the kernels take, or
int8, uint8, int16, uint16 or uint32, which go through the int32 network by
an order-preserving map and come back in their own dtype, bit for bit.

``block_n`` is the tile width: a power of two, clamped to the padded length
(tiles above ``MAX_BLOCK_N`` are composed from launches at the cap).
``kernel_argsort`` ranks float keys on ``core.merge.sort_image`` (int32,
float16 and bfloat16 widened exactly): NaN of either sign is ``INT32_MAX``,
which a pad (the same key at a rank >= n) follows, so the first n ranks are
``impl='xla'``'s permutation.  ``kernel_sort`` gives NaN keys unspecified
output.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from repro_torch.core.bitonic import next_pow2, sentinel_for
from repro_torch.core.merge import sort_image

from .bitonic_sort import (
    MAX_BLOCK_N,
    block_merge,
    block_merge_kv,
    block_sort,
    block_sort_kv,
    global_stage,
    global_stage_kv,
)

__all__ = [
    "kernel_sort",
    "kernel_argsort",
    "kernel_sort_kv",
    "DEFAULT_BLOCK_N",
    "MAX_BLOCK_N",
]

DEFAULT_BLOCK_N = 1024


def _resolve_shape(n: int, block_n: int):
    """(padded length, effective block_n) for an arbitrary input length."""
    if block_n < 1 or block_n & (block_n - 1):
        raise ValueError(f"block_n={block_n} must be a power of two")
    np2 = next_pow2(max(n, 1))
    return np2, min(block_n, np2)


_INT32_SIGN = -(1 << 31)
# ranked on their int32 sort image by kernel_argsort
_FLOAT_KEYS = (torch.float32, torch.float16, torch.bfloat16)
# widened exactly: int32 keeps their order
_WIDENED = (torch.int8, torch.uint8, torch.int16, torch.uint16)


def _to_kernel_keys(x: torch.Tensor) -> torch.Tensor:
    """Keys in a dtype the kernels take, in the same order: narrow integers
    widened to int32, uint32 with its sign bit flipped and viewed as int32."""
    if x.dtype in _WIDENED:
        return x.to(torch.int32)
    if x.dtype == torch.uint32:
        return x.view(torch.int32) ^ _INT32_SIGN
    if x.dtype == torch.bool:
        raise TypeError("bool keys are not sorted: the reference's kernels reject them too")
    if x.dtype in (torch.int64, torch.uint64, torch.float64):
        raise TypeError(
            f"{x.dtype} keys are not sorted: the reference runs with JAX's default of 32-bit "
            "types (x64 off), so it has no 64-bit keys"
        )
    return x


def _from_kernel_keys(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``_to_kernel_keys``."""
    if dtype in _WIDENED:
        return y.to(dtype)
    if dtype == torch.uint32:
        return (y ^ _INT32_SIGN).view(torch.uint32)
    return y


def _padded_rows(x: torch.Tensor, block_n: int):
    """(effective block_n, kernel keys as contiguous (rows, padded length)),
    padded with the mapped largest value of ``x``'s own dtype.  The rows may
    be ``x``'s own storage; a CUDA view of it that does not start on 16 bytes
    is copied, since kernel A bulk-copies from 16-byte boundaries."""
    if x.dim() < 1:
        raise ValueError("expected at least one axis to sort")
    n = x.shape[-1]
    if n < 1:
        raise ValueError("need at least one element to sort")
    np2, block_n = _resolve_shape(n, block_n)
    rows = _to_kernel_keys(x.reshape(-1, n))
    if np2 != n:
        fill = _to_kernel_keys(sentinel_for(x.dtype, largest=True)).item()
        rows = torch.cat([rows, rows.new_full((rows.shape[0], np2 - n), fill)], dim=-1)
    rows = rows.contiguous()
    if rows.is_cuda and rows.data_ptr() % 16:
        rows = rows.clone()
    return block_n, rows


def _sort_rows(x: torch.Tensor, block_n: int) -> torch.Tensor:
    """The launch sequence of the reference's ``_pallas_sort_impl``."""
    n = x.shape[-1]
    x = block_sort(x, block_n)
    k = 2 * block_n
    while k <= n:
        j = k // 2
        while j >= block_n:
            x = global_stage(x, j, k)
            j //= 2
        x = block_merge(x, block_n, k)
        k *= 2
    return x


def _argsort_rows(x: torch.Tensor, block_n: int):
    """The launch sequence of the reference's ``_pallas_argsort_impl``."""
    n = x.shape[-1]
    r = torch.arange(n, dtype=torch.int32, device=x.device).expand(x.shape).contiguous()
    x, r = block_sort_kv(x, r, block_n)
    k = 2 * block_n
    while k <= n:
        j = k // 2
        while j >= block_n:
            x, r = global_stage_kv(x, r, j, k)
            j //= 2
        x, r = block_merge_kv(x, r, block_n, k)
        k *= 2
    return x, r


def kernel_sort(x: torch.Tensor, *, block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """Sort the last axis of ``x`` (any length >= 1) ascending through the
    tiled bitonic kernels.

    Pad keys can only displace *equal* (sentinel-valued) real keys, so the
    sliced prefix is always the sorted input.

    >>> kernel_sort(torch.tensor([3, 1, 2], dtype=torch.int32)).tolist()
    [1, 2, 3]
    """
    block_n, rows = _padded_rows(x, block_n)
    out = _sort_rows(rows, block_n)
    return _from_kernel_keys(out[:, : x.shape[-1]].reshape(x.shape), x.dtype)


def kernel_argsort(x: torch.Tensor, *, block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """Stable ascending argsort of the last axis (any length >= 1), int32.

    Matches ``np.argsort(kind='stable')``: pad entries (sentinel key, rank
    >= n) sort after every real element, even one equal to the sentinel.
    Float keys are ranked on their ``sort_image``: -0.0 ties +0.0, as the
    kernels' float compare has it, and NaN of either sign sorts last but
    before every pad, where a NaN key would let a pad rank in (every compare
    with NaN is false).

    >>> kernel_argsort(torch.tensor([30, 10, 20, 10], dtype=torch.int32)).tolist()
    [1, 3, 2, 0]
    """
    if x.dtype in _FLOAT_KEYS:
        x = sort_image(x)
    block_n, rows = _padded_rows(x, block_n)
    _, perm = _argsort_rows(rows, block_n)
    return perm[:, : x.shape[-1]].reshape(x.shape)


def kernel_sort_kv(keys: torch.Tensor, values, *, block_n: int = DEFAULT_BLOCK_N):
    """Stable key-value sort: 1-D keys, any nest of dicts, lists and tuples
    of (n, ...) payloads.

    Returns ``(sorted_keys, permuted_values)``, the values in their structure.

    >>> k, v = kernel_sort_kv(torch.tensor([2.0, 1.0, 2.0]), {"i": torch.tensor([0, 1, 2])})
    >>> k.tolist(), v["i"].tolist()
    ([1.0, 2.0, 2.0], [1, 0, 2])
    """
    if keys.dim() != 1:
        raise ValueError("kernel_sort_kv expects 1-D keys")
    perm = kernel_argsort(keys, block_n=block_n).long()
    return keys[perm], tree_map(lambda v: v[perm], values)
