"""Vectorized bitonic sorting network in plain torch — the CPU oracle.

Counterpart of ``repro/core/bitonic.py``, bit for bit: the same ``>``
comparator, the same ``swap = gt == dir_up`` rule and the same substage
order, so even -0.0/+0.0 land where the reference puts them.  The hand-written
CUDA kernels in ``repro_torch/kernels/bitonic_sort`` must match this network
element for element.

All entry points work on the last axis and accept any leading batch dims.
Lengths are padded to the next power of two with sentinels.  ``values`` is a
tensor or a dict of tensors shaped like the keys.

Stability: a bitonic network is unstable; a lexicographic (key, original
rank) comparator restores it — ranks never tie, so the output is the unique
stable order.
"""
from __future__ import annotations

import torch

from repro_torch.exchange import sentinel_for
from repro_torch.kernels.bitonic_sort.bitonic_sort import next_pow2

__all__ = [
    "bitonic_sort",
    "bitonic_merge_pair",
    "bitonic_topk",
    "next_pow2",
    "sentinel_for",
]


def _map_values(fn, values):
    if values is None:
        return None
    if isinstance(values, dict):
        return {name: fn(v) for name, v in values.items()}
    return fn(values)


def _split(x: torch.Tensor, j: int):
    """(..., n) -> halves a, b of shape (..., n/(2j), j) paired at distance j."""
    *lead, n = x.shape
    x2 = x.reshape(*lead, n // (2 * j), 2, j)
    return x2[..., 0, :], x2[..., 1, :]


def _join(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    *lead, g, j = a.shape
    return torch.stack([a, b], dim=-2).reshape(*lead, g * 2 * j)


def _compare_exchange(keys, ranks, values, j: int, dir_up, *, ascending: bool):
    """One bitonic substage at partner distance ``j``.

    ``dir_up`` is a bool tensor over the n/(2j) groups: True sorts the group
    in comparator order, False in reverse.  ``ranks`` (optional) break ties.
    """
    ka, kb = _split(keys, j)
    gt = (ka > kb) if ascending else (ka < kb)  # "a after b" in final order
    if ranks is not None:
        ra, rb = _split(ranks, j)
        gt = gt | ((ka == kb) & (ra > rb))
    swap = gt == dir_up[:, None]
    keys = _join(torch.where(swap, kb, ka), torch.where(swap, ka, kb))
    if ranks is not None:
        ranks = _join(torch.where(swap, rb, ra), torch.where(swap, ra, rb))

    def ex(v):
        va, vb = _split(v, j)
        return _join(torch.where(swap, vb, va), torch.where(swap, va, vb))

    return keys, ranks, _map_values(ex, values)


def _network(keys, ranks, values, *, ascending: bool):
    """Full bitonic sort network on a power-of-two last axis."""
    n = keys.shape[-1]
    if n == 1:
        return keys, ranks, values
    log_n = n.bit_length() - 1
    for stage in range(1, log_n + 1):  # sorted block size 2**stage
        k = 1 << stage
        for sub in range(stage - 1, -1, -1):  # partner distance 2**sub
            j = 1 << sub
            g = n // (2 * j)
            # group m covers [m*2j, (m+1)*2j); its bitonic block is (m*2j)//k
            blk = (torch.arange(g, device=keys.device) * 2 * j) // k
            dir_up = blk % 2 == 0
            keys, ranks, values = _compare_exchange(
                keys, ranks, values, j, dir_up, ascending=ascending
            )
    return keys, ranks, values


def _merge_network(keys, ranks, values, *, ascending: bool):
    """Bitonic *merge* only: last axis must already be a bitonic sequence."""
    n = keys.shape[-1]
    log_n = n.bit_length() - 1
    for sub in range(log_n - 1, -1, -1):
        j = 1 << sub
        dir_up = torch.ones(n // (2 * j), dtype=torch.bool, device=keys.device)
        keys, ranks, values = _compare_exchange(
            keys, ranks, values, j, dir_up, ascending=ascending
        )
    return keys, ranks, values


def _pad_last(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    fill = x.new_full((*x.shape[:-1], pad), value)
    return torch.cat([x, fill], dim=-1)


def _sort_impl(keys, values, *, ascending: bool, stable: bool):
    n = keys.shape[-1]
    np2 = next_pow2(n)
    pad = np2 - n
    if pad:
        keys = _pad_last(keys, pad, sentinel_for(keys.dtype, largest=ascending).item())
        values = _map_values(lambda v: _pad_last(v, pad, 0), values)
    ranks = None
    if stable:
        ranks = torch.arange(np2, dtype=torch.int32, device=keys.device).expand(keys.shape)
    keys, _, values = _network(keys, ranks, values, ascending=ascending)
    if pad:
        keys = keys[..., :n]
        values = _map_values(lambda v: v[..., :n], values)
    return keys, values


def bitonic_sort(keys: torch.Tensor, values=None, *, ascending: bool = True,
                 stable: bool = False):
    """Sort ``keys`` along the last axis with a bitonic network.

    ``values`` (tensor or dict of tensors, same shape as keys) are permuted
    alongside.  Returns sorted keys, or ``(sorted_keys, permuted_values)``.

    >>> bitonic_sort(torch.tensor([3, 1, 2])).tolist()
    [1, 2, 3]
    """
    k, v = _sort_impl(keys, values, ascending=ascending, stable=stable)
    return k if values is None else (k, v)


def bitonic_merge_pair(a, b, va=None, vb=None, *, ascending: bool = True):
    """Merge two sorted tensors (equal pow2 last-axis length) into one:
    ``concat(a, reverse(b))`` is bitonic, so one merge network sorts it.

    >>> bitonic_merge_pair(torch.tensor([1, 4]), torch.tensor([2, 3])).tolist()
    [1, 2, 3, 4]
    """
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(f"length mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    n = a.shape[-1]
    if n & (n - 1):
        raise ValueError("bitonic_merge_pair requires power-of-two lengths")
    keys = torch.cat([a, torch.flip(b, dims=(-1,))], dim=-1)
    values = None
    if va is not None:
        if isinstance(va, dict):
            values = {name: torch.cat([va[name], torch.flip(vb[name], dims=(-1,))], dim=-1)
                      for name in va}
        else:
            values = torch.cat([va, torch.flip(vb, dims=(-1,))], dim=-1)
    keys, _, values = _merge_network(keys, None, values, ascending=ascending)
    return keys if va is None else (keys, values)


def bitonic_topk(x: torch.Tensor, k: int, *, largest: bool = True):
    """Top-k (values, int32 indices) via the stable bitonic network.

    >>> vals, idx = bitonic_topk(torch.tensor([1.0, 9.0, 4.0]), 2)
    >>> vals.tolist(), idx.tolist()
    ([9.0, 4.0], [1, 2])
    """
    idx = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device).expand(x.shape)
    keys, vals = _sort_impl(x, idx, ascending=not largest, stable=True)
    return keys[..., :k], vals[..., :k]
