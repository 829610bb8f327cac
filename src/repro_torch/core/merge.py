"""Vectorized merge of sorted runs — the paper's "merge & sort function" (torch).

Counterpart of ``repro/core/merge.py``.  ``rank_merge_pairs`` places every
element of two sorted runs at its own index plus its rank in the other run
(``torch.searchsorted``: ``side='left'`` for run a, ``'right'`` for run b, so
left-run elements precede equal right-run elements — a *stable* merge),
inverts that permutation with ``scatter_`` and gathers by it.  Plain torch:
the reference, too, computes it outside any kernel.

Float runs are searched on ``keys.sort_image``, an order-preserving integer
image in which -0.0 equals +0.0 and every NaN equals every other and sorts
after ``+inf``: ``jnp.searchsorted``'s order, which ``torch.searchsorted``
does not share for NaN.  So runs holding NaN merge as the reference's do,
and the positions always form a permutation.

``merge_adjacent`` is one round of the paper's bottom-up merge: runs of width
``w`` become runs of width ``2w``.  ``values`` is a dict of tensors shaped
like the keys.  On the card, a keys-only round that kernel M takes
(``kernels/bitonic_sort``: ``merge_runs_takes``) is one launch of that
kernel, whose merge path takes the same order and tie rule and so gives the
same bits on sorted runs; every other round is ``rank_merge_pairs``, counted
on the card in the kernels' ``tally`` (``merge_round_counts``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitonic_sort.bitonic_sort import merge_runs, merge_runs_takes, tally
from repro_torch.keys import gather_bits, sort_image

__all__ = ["rank_merge_pairs", "merge_adjacent", "merge_sorted_pair", "sort_image", "gather_bits"]


def _invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """Invert a permutation given along the last axis (zero-filled, as the
    reference's ``jnp.zeros_like(p).at[p].set(i)``)."""
    iota = torch.arange(perm.shape[-1], dtype=perm.dtype, device=perm.device)
    return torch.zeros_like(perm).scatter_(-1, perm, iota.expand(perm.shape))


def rank_merge_pairs(pairs: torch.Tensor, values: dict | None = None):
    """Merge (..., 2, w) sorted-run pairs into (..., 2w) stably.

    >>> rank_merge_pairs(torch.tensor([[1, 3], [2, 3]])).tolist()
    [1, 2, 3, 3]
    """
    *lead, _, w = pairs.shape
    iota = torch.arange(w, device=pairs.device)
    ka = sort_image(pairs[..., 0, :]).contiguous()
    kb = sort_image(pairs[..., 1, :]).contiguous()
    pos_a = iota + torch.searchsorted(kb, ka, side="left")
    pos_b = iota + torch.searchsorted(ka, kb, side="right")
    inv = _invert_perm(torch.cat([pos_a, pos_b], dim=-1))
    # (..., 2, w) read as (..., 2w) is the two runs concatenated
    out = gather_bits(pairs.reshape(*lead, 2 * w), inv)
    if values is None:
        return out
    return out, {name: gather_bits(v.reshape(*lead, 2 * w), inv) for name, v in values.items()}


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
    if x.is_cuda:
        if values is None and merge_runs_takes(x.dtype, width):
            x = x.contiguous()
            return merge_runs(x.clone() if x.data_ptr() % 16 else x, width)
        tally["rank_merge_pairs"] += 1
    pairs = x.reshape(*lead, n // (2 * width), 2, width)
    if values is None:
        return rank_merge_pairs(pairs).reshape(*lead, n)
    vals = {name: v.reshape(*lead, n // (2 * width), 2, width) for name, v in values.items()}
    merged, mvals = rank_merge_pairs(pairs, vals)
    return merged.reshape(*lead, n), {name: v.reshape(*lead, n) for name, v in mvals.items()}
