"""repro_torch.core — the paper's sort models on one device (torch).

Model A/B (shared memory) -> shared_sort.shared_memory_sort
Models C and D (mesh) are later slices (ROADMAP Queue 1).
"""
from .api import sort
from .bitonic import bitonic_merge_pair, bitonic_sort, bitonic_topk
from .merge import merge_adjacent, merge_sorted_pair, rank_merge_pairs
from .seqsort import (
    LOCAL_SORTS,
    fast_local_sort,
    kernel_local_sort,
    nonrecursive_merge_sort,
    recursive_merge_sort_host,
)
from .shared_sort import shared_memory_sort

__all__ = [
    "sort",
    "bitonic_sort",
    "bitonic_merge_pair",
    "bitonic_topk",
    "merge_adjacent",
    "merge_sorted_pair",
    "rank_merge_pairs",
    "shared_memory_sort",
    "nonrecursive_merge_sort",
    "recursive_merge_sort_host",
    "fast_local_sort",
    "kernel_local_sort",
    "LOCAL_SORTS",
]
