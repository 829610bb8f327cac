"""Vectorized merge of sorted runs — the paper's "merge & sort function" (torch).

Counterpart of ``repro/core/merge.py``.  ``rank_merge_pairs`` places every
element of two sorted runs at its own index plus its rank in the other run
(``torch.searchsorted``: ``side='left'`` for run a, ``'right'`` for run b, so
left-run elements precede equal right-run elements — a *stable* merge),
inverts that permutation with ``scatter_`` and gathers by it.  Plain torch:
the reference, too, computes it outside any kernel.

``merge_adjacent`` is one round of the paper's bottom-up merge: runs of width
``w`` become runs of width ``2w``.  ``values`` is a dict of tensors shaped
like the keys.
"""
from __future__ import annotations

import torch

__all__ = ["rank_merge_pairs", "merge_adjacent", "merge_sorted_pair"]


def _invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """Invert a permutation given along the last axis."""
    iota = torch.arange(perm.shape[-1], dtype=perm.dtype, device=perm.device)
    return torch.empty_like(perm).scatter_(-1, perm, iota.expand(perm.shape))


def rank_merge_pairs(pairs: torch.Tensor, values: dict | None = None):
    """Merge (..., 2, w) sorted-run pairs into (..., 2w) stably.

    >>> rank_merge_pairs(torch.tensor([[1, 3], [2, 3]])).tolist()
    [1, 2, 3, 3]
    """
    a = pairs[..., 0, :].contiguous()
    b = pairs[..., 1, :].contiguous()
    w = a.shape[-1]
    iota = torch.arange(w, device=pairs.device)
    pos_a = iota + torch.searchsorted(b, a, side="left")
    pos_b = iota + torch.searchsorted(a, b, side="right")
    inv = _invert_perm(torch.cat([pos_a, pos_b], dim=-1))
    out = torch.gather(torch.cat([a, b], dim=-1), -1, inv)
    if values is None:
        return out
    merged = {}
    for name, v in values.items():
        merged[name] = torch.gather(torch.cat([v[..., 0, :], v[..., 1, :]], dim=-1), -1, inv)
    return out, merged


def merge_sorted_pair(a, b, va=None, vb=None):
    """Stable merge of two sorted tensors along the last axis (equal length).

    >>> merge_sorted_pair(torch.tensor([1, 4]), torch.tensor([2, 3])).tolist()
    [1, 2, 3, 4]
    """
    pairs = torch.stack([a, b], dim=-2)
    if va is None:
        return rank_merge_pairs(pairs)
    values = {name: torch.stack([va[name], vb[name]], dim=-2) for name in va}
    return rank_merge_pairs(pairs, values)


def merge_adjacent(x: torch.Tensor, width: int, values: dict | None = None):
    """One bottom-up merge round: sorted runs of ``width`` -> runs of ``2*width``.

    ``x``: (..., n) with n % (2*width) == 0 and each aligned ``width`` slice
    already sorted.

    >>> merge_adjacent(torch.tensor([3, 5, 1, 4]), 2).tolist()
    [1, 3, 4, 5]
    """
    *lead, n = x.shape
    if n % (2 * width):
        raise ValueError(f"length {n} is not a multiple of 2 * width = {2 * width}")
    pairs = x.reshape(*lead, n // (2 * width), 2, width)
    if values is None:
        return rank_merge_pairs(pairs).reshape(*lead, n)
    vals = {name: v.reshape(*lead, n // (2 * width), 2, width) for name, v in values.items()}
    merged, mvals = rank_merge_pairs(pairs, vals)
    return merged.reshape(*lead, n), {name: v.reshape(*lead, n) for name, v in mvals.items()}
