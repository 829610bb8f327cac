"""Partition-mode policy: which family (radix or sample) a partitioner mode
belongs to.  Counterpart of the mode table in ``repro/exchange/partition.py``;
the partitioners themselves arrive with the exchange slice.
"""
from __future__ import annotations

__all__ = ["PARTITION_MODES", "partition_of"]

# the two partition families the planner persists
PARTITION_MODES = ("radix", "sample")

_FAMILY = {
    "decimal": "radix",     # the paper's MSD decimal digit (static)
    "range": "radix",       # equal-width over a static [lo, hi) hint
    "radix": "radix",       # equal-width over the collective [min, max]
    "splitters": "sample",  # plain key-quantile splitters
    "sample": "sample",     # composite (key, id) splitters
}


def partition_of(mode: str) -> str:
    """Classify a partitioner mode name into its partition family.

    >>> [partition_of(m) for m in ("decimal", "range", "radix")]
    ['radix', 'radix', 'radix']
    >>> [partition_of(m) for m in ("splitters", "sample")]
    ['sample', 'sample']
    >>> partition_of("quantum")
    Traceback (most recent call last):
        ...
    ValueError: unknown partitioner mode 'quantum'
    """
    try:
        return _FAMILY[mode]
    except KeyError:
        raise ValueError(f"unknown partitioner mode {mode!r}") from None
