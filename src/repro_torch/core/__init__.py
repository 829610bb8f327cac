"""repro_torch.core — the paper's sort models (torch).

Model A/B (shared memory)  -> shared_sort.shared_memory_sort
Model C   (distributed)    -> distributed_sort.distributed_merge_sort
Model D   (cluster/hybrid) -> cluster_sort.cluster_sort  (production path)
Models C and D run on every rank of a process group (``AxisGroup``).
"""
from .api import sort
from .bitonic import bitonic_merge_pair, bitonic_sort, bitonic_topk
from .cluster_sort import (
    ExchangeResult,
    cluster_sort,
    combine_exchange,
    partition_exchange,
)
from .distributed_sort import distributed_merge_sort
from .merge import merge_adjacent, merge_sorted_pair, rank_merge_pairs
from .radix import (
    choose_splitters,
    decimal_msd_bucket,
    make_partitioner,
    range_bucket,
    splitter_bucket,
)
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
    "cluster_sort",
    "partition_exchange",
    "combine_exchange",
    "ExchangeResult",
    "distributed_merge_sort",
    "merge_adjacent",
    "merge_sorted_pair",
    "rank_merge_pairs",
    "shared_memory_sort",
    "nonrecursive_merge_sort",
    "recursive_merge_sort_host",
    "fast_local_sort",
    "kernel_local_sort",
    "LOCAL_SORTS",
    "choose_splitters",
    "decimal_msd_bucket",
    "range_bucket",
    "splitter_bucket",
    "make_partitioner",
]
