"""Paper models A & B: shared-memory parallel sort on one device (torch).

Counterpart of ``repro/core/shared_sort.py``.  The OpenMP "threads" of Fig 2
become T tiles of one device's tensor.  Phase 1 sorts every tile at once
(a batch of rows for the local sort); phase 2 runs the paper's binary merge
tree — log2(T) rounds, each merging adjacent sorted runs of width
n/T * 2^r in one vectorized ``merge_adjacent`` call.

Model A: local sort = non-recursive merge sort   (``local_impl='merge'``)
Model B: local sort = the "quicksort" role       (``'xla'``/``'bitonic'``/``'kernel'``)

torch has no ``searchsorted``, ``gather``, ``flip`` or ``where`` for uint16
and uint32, which the merge tree and the plain network need: those keys are
sorted as the kernels' order-preserving int32 image (``keys.to_kernel_keys``)
and mapped back, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.keys import from_kernel_keys, to_kernel_keys
from repro_torch.tracing import span

from .bitonic import next_pow2, sentinel_for
from .merge import merge_adjacent
from .seqsort import fast_local_sort

__all__ = ["shared_memory_sort"]


def shared_memory_sort(
    x: torch.Tensor,
    *,
    n_threads: int = 8,
    local_impl: str = "xla",
    ascending: bool = True,
    block_n: int | None = None,
) -> torch.Tensor:
    """Sort the last axis with the paper's shared-memory algorithm.

    ``n_threads`` must be a power of two (paper: "works with a power of two
    number of threads").  Any n is handled by sentinel padding.  ``block_n``
    is the kernels' tile width for ``local_impl='kernel'`` (ignored otherwise).

    >>> shared_memory_sort(torch.tensor([5, 3, 9, 1, 7]), n_threads=2).tolist()
    [1, 3, 5, 7, 9]
    >>> shared_memory_sort(torch.tensor([60000, 3, 9], dtype=torch.uint16),
    ...                    n_threads=2, ascending=False).tolist()
    [60000, 9, 3]
    """
    if n_threads & (n_threads - 1) or n_threads < 1:
        raise ValueError("n_threads must be a power of two (paper §3.2)")
    if x.dtype in (torch.uint16, torch.uint32):
        out = shared_memory_sort(to_kernel_keys(x), n_threads=n_threads, local_impl=local_impl,
                                 ascending=ascending, block_n=block_n)
        return from_kernel_keys(out, x.dtype)
    *lead, n = x.shape
    np2 = max(next_pow2(n), n_threads)
    if np2 != n:
        # pad with +sentinel; the ascending internal sort keeps pads at the end
        fill = x.new_full((*lead, np2 - n), sentinel_for(x.dtype, largest=True).item())
        x = torch.cat([x, fill], dim=-1)
    tile = np2 // n_threads

    # Phase 1 — every "thread" sorts its tile (Fig 2 step: call sorting function)
    tiles = x.reshape(*lead, n_threads, tile)
    tiles = fast_local_sort(tiles, ascending=True, impl=local_impl, block_n=block_n)
    x = tiles.reshape(*lead, np2)

    # Phase 2 — binary merge tree (Fig 2 steps a–d), one round per doubling
    width = tile
    while width < np2:
        with span("repro_torch.shared.merge", device=x):
            x = merge_adjacent(x, width)
        width *= 2
    x = x[..., :n]
    return x if ascending else torch.flip(x, dims=(-1,))
