"""Composition of the bitonic kernels: sort / argsort / kv-sort (torch).

Counterpart of ``repro/kernels/bitonic_sort/ops.py``.  ``kernel_sort(x)``
sorts the last axis of any length >= 1: it pads to the next power of two with
+sentinel keys, runs the tiled network, and slices the valid prefix back out.

  phase 1:  kernel A  (per-tile alternating-direction sort)
  stages k = 2*block_n .. n:
     j = k/2 .. block_n   : kernel C, up to GLOBAL_SPAN substages a pass, in
                            registers (``global_spans``)
     j = block_n/2 .. 1   : kernel B (all of them in one pass, in registers)

That launch sequence is ``bitonic_sort.sort_launches``, run by ``sort_rows``.
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
``kernel_argsort`` ranks float keys on ``keys.sort_image`` (int32,
float16 and bfloat16 widened exactly): NaN of either sign is ``INT32_MAX``,
which a pad (the same key at a rank >= n) follows, so the first n ranks are
``impl='xla'``'s permutation.  ``kernel_sort`` gives NaN keys unspecified
output.

``kernel_topk`` does not sort: kernel T (``bitonic_sort.topk_select``)
selects the k best keys of each row in one read of it, for the dtypes of
``kernel_sort`` and ``k <= SELECT_MAX_K`` (``topk_takes``).
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from repro_torch.exchange.slabs import sentinel_for
from repro_torch.keys import INT32_MAPPED, from_kernel_keys, sort_image, to_kernel_keys

from .bitonic_sort import KEY_DTYPES, MAX_BLOCK_N, SELECT_MAX_K, next_pow2, sort_rows, topk_select

__all__ = [
    "kernel_sort",
    "kernel_argsort",
    "kernel_sort_kv",
    "kernel_topk",
    "topk_takes",
    "DEFAULT_BLOCK_N",
    "MAX_BLOCK_N",
]

DEFAULT_BLOCK_N = 1024


def _resolve_shape(n: int, block_n: int):
    """(padded length, effective block_n) for an arbitrary input length."""
    if block_n < 1 or block_n & (block_n - 1):
        raise ValueError(f"block_n={block_n} must be a power of two")
    np2 = next_pow2(n)
    return np2, min(block_n, np2)


# ranked on their int32 sort image by kernel_argsort
_FLOAT_KEYS = (torch.float32, torch.float16, torch.bfloat16)


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
    rows = to_kernel_keys(x.reshape(-1, n))
    if np2 != n:
        fill = to_kernel_keys(sentinel_for(x.dtype, largest=True)).item()
        rows = torch.cat([rows, rows.new_full((rows.shape[0], np2 - n), fill)], dim=-1)
    rows = rows.contiguous()
    if rows.is_cuda and rows.data_ptr() % 16:
        rows = rows.clone()
    return block_n, rows


def kernel_sort(x: torch.Tensor, *, block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """Sort the last axis of ``x`` (any length >= 1) ascending through the
    tiled bitonic kernels.

    Pad keys can only displace *equal* (sentinel-valued) real keys, so the
    sliced prefix is always the sorted input.

    >>> kernel_sort(torch.tensor([3, 1, 2], dtype=torch.int32)).tolist()
    [1, 2, 3]
    """
    block_n, rows = _padded_rows(x, block_n)
    out, _ = sort_rows(rows, block_n)
    return from_kernel_keys(out[:, : x.shape[-1]].reshape(x.shape), x.dtype)


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
    _, perm = sort_rows(rows, block_n, ranked=True)
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


# the dtypes kernel_sort takes: the kernels' own and those to_kernel_keys maps
_TOPK_DTYPES = (*KEY_DTYPES, *INT32_MAPPED)


def topk_takes(x: torch.Tensor, k: int) -> bool:
    """Kernel T's rule, all seen in the input: keys of a dtype it takes, on
    CUDA or the CPU, with at least one axis of fewer than 2^31 keys, and
    1 <= k <= min(n, SELECT_MAX_K)."""
    return (x.dtype in _TOPK_DTYPES and x.device.type in ("cuda", "cpu") and x.dim() >= 1
            and 1 <= k <= min(x.shape[-1], SELECT_MAX_K) and x.shape[-1] < 1 << 31)


def kernel_topk(x: torch.Tensor, k: int, *, largest: bool = True) -> torch.Tensor:
    """Int32 indices of the k best keys along the last axis, best first:
    the largest (or smallest), NaN of either sign last, -0.0 tied with +0.0,
    ties to the lowest index, as ``engine.topk``'s stable argsort has them.
    Kernel T on CUDA tensors, its plain version on CPU ones; ``x`` as
    ``topk_takes`` has it.

    >>> kernel_topk(torch.tensor([1.0, 9.0, 4.0, 9.0]), 3).tolist()
    [1, 3, 2]
    """
    return topk_select(to_kernel_keys(x).contiguous(), k, largest)
