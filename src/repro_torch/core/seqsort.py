"""Sequential sort models from paper Fig 1 (torch).

Counterpart of ``repro/core/seqsort.py``:

* Fig 1(a) recursive Merge sort      -> ``recursive_merge_sort_host`` (numpy),
  the paper's slow baseline.
* Fig 1(b) non-recursive Merge sort  -> ``nonrecursive_merge_sort``: bottom-up
  width-doubling rounds of vectorized stable rank-merges.
* Fig 1(c) recursive Quicksort       -> ``fast_local_sort``: the role "fastest
  available sequential sort" is played by torch's library sort (``'xla'``,
  the name the reference gives its platform sort) and by the hand-written
  bitonic kernels (``'kernel'``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bitonic_sort.ops import DEFAULT_BLOCK_N, kernel_sort
from repro_torch.keys import gather_bits, sort_image

from .bitonic import bitonic_sort, next_pow2, sentinel_for
from .merge import merge_adjacent

__all__ = [
    "recursive_merge_sort_host",
    "nonrecursive_merge_sort",
    "kernel_local_sort",
    "fast_local_sort",
    "LOCAL_SORTS",
]


def recursive_merge_sort_host(x: np.ndarray) -> np.ndarray:
    """Paper Fig 1(a), host-side reference implementation (numpy, recursive).

    >>> recursive_merge_sort_host(np.array([3, 1, 2])).tolist()
    [1, 2, 3]
    """
    x = np.asarray(x)
    if x.shape[-1] <= 2:
        return np.sort(x, axis=-1, kind="stable")
    mid = x.shape[-1] // 2
    left = recursive_merge_sort_host(x[..., :mid])
    right = recursive_merge_sort_host(x[..., mid:])
    out = np.empty_like(x)
    # vectorized two-list merge via ranks (same identity as merge.py)
    la = left.shape[-1]
    pos_a = np.arange(la) + _np_searchsorted(right, left, side="left")
    pos_b = np.arange(right.shape[-1]) + _np_searchsorted(left, right, side="right")
    np.put_along_axis(out, pos_a, left, axis=-1)
    np.put_along_axis(out, pos_b, right, axis=-1)
    return out


def _np_searchsorted(sorted_arr, query, side):
    flat_s = sorted_arr.reshape(-1, sorted_arr.shape[-1])
    flat_q = query.reshape(-1, query.shape[-1])
    out = np.stack(
        [np.searchsorted(s, q, side=side) for s, q in zip(flat_s, flat_q)]
    )
    return out.reshape(query.shape)


def nonrecursive_merge_sort(x: torch.Tensor, *, ascending: bool = True) -> torch.Tensor:
    """Paper Fig 1(b): bottom-up merge sort, each round fully vectorized.

    Pads to a power of two with sentinels; log2(n) rounds of
    ``merge_adjacent``.  Stable (the rank merge breaks ties left-first).

    >>> nonrecursive_merge_sort(torch.tensor([3, 1, 2])).tolist()
    [1, 2, 3]
    """
    n = x.shape[-1]
    np2 = next_pow2(n)
    if np2 != n:
        fill = x.new_full((*x.shape[:-1], np2 - n), sentinel_for(x.dtype, largest=True).item())
        x = torch.cat([x, fill], dim=-1)
    width = 1
    while width < np2:
        x = merge_adjacent(x, width)
        width *= 2
    x = x[..., :n]
    return x if ascending else torch.flip(x, dims=(-1,))


def kernel_local_sort(
    x: torch.Tensor, *, ascending: bool = True, block_n: int | None = None
) -> torch.Tensor:
    """Shape-safe wrapper over the hand-written bitonic kernels.

    Any last-axis length >= 1 and any leading batch dims (they become rows
    of the kernel grid); descending order flips the valid prefix after the
    ascending kernel, so pad sentinels never reach the front.  On a CPU
    tensor the kernels' plain versions run instead.

    >>> kernel_local_sort(torch.tensor([[3, 1], [0, 2]], dtype=torch.int32)).tolist()
    [[1, 3], [0, 2]]
    """
    out = kernel_sort(x, block_n=DEFAULT_BLOCK_N if block_n is None else block_n)
    return out if ascending else torch.flip(out, dims=(-1,))


def fast_local_sort(
    x: torch.Tensor,
    *,
    ascending: bool = True,
    impl: str = "xla",
    block_n: int | None = None,
) -> torch.Tensor:
    """The "sequential Quicksort" role: fastest single-worker sort available.

    impl='xla'     -> ``torch.sort(stable=True)`` (the platform's library
                      sort; stable, as ``jnp.sort`` is, so equal keys such
                      as -0.0 and +0.0 keep their order bit for bit; floats
                      sort on ``sort_image``, so NaN of either sign goes
                      last on every device, as in ``jnp.sort``)
    impl='bitonic' -> the branch-free network, plain torch
    impl='kernel'  -> the same network as hand-written CUDA kernels
                      (``block_n`` is the shared-memory tile width)
    impl='merge'   -> paper Fig 1(b) non-recursive merge sort

    NaN keys: only 'xla' orders NaN; the network impls leave output
    unspecified for NaN.

    >>> fast_local_sort(torch.tensor([3, 1, 2]), ascending=False).tolist()
    [3, 2, 1]
    """
    if impl == "xla":
        if x.dtype.is_floating_point:
            out = gather_bits(x, torch.sort(sort_image(x), dim=-1, stable=True).indices)
        else:
            out = torch.sort(x, dim=-1, stable=True).values
        return out if ascending else torch.flip(out, dims=(-1,))
    if impl == "bitonic":
        return bitonic_sort(x, ascending=ascending)
    if impl == "kernel":
        return kernel_local_sort(x, ascending=ascending, block_n=block_n)
    if impl == "merge":
        return nonrecursive_merge_sort(x, ascending=ascending)
    raise ValueError(f"unknown local sort impl {impl!r}")


LOCAL_SORTS = ("xla", "bitonic", "kernel", "merge")
