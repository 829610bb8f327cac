"""Paper model C: distributed-memory parallel hybrid Quicksort and Merge sort.

Counterpart of ``repro/core/distributed_sort.py``.  MPI nodes are the ranks
of a process group; MPI send/recv is the group's ``ppermute``.  The schedule
is Fig 3 verbatim:

  1. every rank sorts its partition with the fast local sort ("Quicksort"),
  2. log2(P) rounds: rank ``i`` with ``i % 2^(r+1) == 2^r`` ships its whole
     buffer to rank ``i - 2^r``, which merges it into its own buffer,
  3. after the last round rank 0 holds the fully sorted data.

The paper's flaw is kept on purpose: every rank holds an n-sized buffer and
half the active ranks idle each round — the faithful distributed baseline
that model D (``cluster_sort.py``) beats.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.exchange import AxisGroup, as_axis_group

from .bitonic import sentinel_for
from .merge import merge_sorted_pair
from .seqsort import fast_local_sort

__all__ = ["distributed_merge_sort", "merge_tree_local"]


def merge_tree_local(
    local: torch.Tensor,
    group: AxisGroup,
    *,
    local_impl: str = "xla",
    block_n: Optional[int] = None,
) -> torch.Tensor:
    """Model C on one rank.  ``local``: (m,) shard of the global array.

    Returns this rank's (n,)-sized buffer; rank 0's is the sorted result,
    other ranks' tails are sentinels (the paper's idle nodes).
    """
    P_, idx = group.size, group.rank
    m = local.shape[-1]
    n = m * P_
    sent = sentinel_for(local.dtype, largest=True).item()

    # Fig 3 step 2: local "Quicksort"
    local = fast_local_sort(local, ascending=True, impl=local_impl, block_n=block_n)
    buf = torch.cat([local, local.new_full((n - m,), sent)])

    # Fig 3 steps 3-5: binary merge tree
    for r in range(P_.bit_length() - 1):
        d = 1 << r
        perm = [(i, i - d) for i in range(P_) if i % (2 * d) == d]
        received = group.ppermute(buf, perm)  # zeros if not a target
        if idx % (2 * d) == 0:  # only a receiver keeps the merge, so only it merges
            buf = merge_sorted_pair(buf, received)[..., :n]
    return buf


def distributed_merge_sort(
    x: torch.Tensor,
    mesh,
    axis: Optional[str] = None,
    *,
    local_impl: str = "xla",
    block_n: Optional[int] = None,
) -> torch.Tensor:
    """Sort across the ranks of ``mesh`` (an ``AxisGroup`` or a
    ``ProcessGroup``; ``axis`` is accepted for parity with the reference).

    Every rank passes its shard ``x`` (1-D, the same length on every rank)
    and gets back its (n,) buffer: rank 0's is the sorted array (the
    reference's ``out[:n]``).  Memory is O(n) per rank — the paper's
    design; use ``cluster_sort`` for the scalable path.  ``block_n`` tunes
    ``local_impl='kernel'``.
    """
    return merge_tree_local(x, as_axis_group(mesh), local_impl=local_impl, block_n=block_n)
