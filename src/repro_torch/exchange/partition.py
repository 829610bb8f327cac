"""Partition-mode policy: radix vs sample — skew-proof bucketing for the wire.

Counterpart of ``repro/exchange/partition.py``.  The paper's model D
assigns every key a destination from its most significant digit — a
**radix** partition: fast, stateless, and wrong for skewed key
distributions, where a hot digit overloads one bucket and the
fixed-capacity slabs overflow.  The remedy is samplesort: each shard
contributes a strided sample of its sorted keys, the gathered sample is
sorted, and its quantiles become splitters — a **sample** partition whose
buckets are balanced whatever the distribution.

* ``PARTITION_MODES`` / ``partition_of`` — every partitioner mode name
  classified into its family (``radix`` or ``sample``).
* ``radix_bucket_ids`` — equal-width buckets over the collectively observed
  ``[min, max]`` key range.
* ``sample_partition_ids`` — composite ``(key, id)`` splitters: ties are
  split by a per-element id, so even all-equal keys balance; ``stable=True``
  uses arrival-order ids, which keeps kv sorts stable.
* ``choose_splitters`` / ``splitter_bucket`` / ``splitters_from_sample`` —
  the plain key-splitter primitives.

Each function that takes a ``group`` (an ``AxisGroup``) runs on every rank of
it, on that rank's shard, as the reference's runs inside ``shard_map``.
Every result is bit-equal to the reference's: the float32 arithmetic keeps
its order, and the sorts are stable with -0.0 and +0.0 as equal keys, as
jax's are.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .group import AxisGroup

__all__ = [
    "PARTITION_MODES",
    "DEFAULT_OVERSAMPLE",
    "partition_of",
    "radix_bucket_ids",
    "sample_partition_ids",
    "choose_splitters",
    "splitter_bucket",
    "splitters_from_sample",
]

# the two partition families the planner persists
PARTITION_MODES = ("radix", "sample")

_FAMILY = {
    "decimal": "radix",     # the paper's MSD decimal digit (static)
    "range": "radix",       # equal-width over a static [lo, hi) hint
    "radix": "radix",       # equal-width over the collective [min, max]
    "splitters": "sample",  # plain key-quantile splitters
    "sample": "sample",     # composite (key, id) splitters
}

# sample size per shard = oversample * n_buckets; 16 keeps the splitter
# rank error well under half a mean bucket at the sizes the bench sweeps
DEFAULT_OVERSAMPLE = 16

_F32_TINY = float(np.finfo(np.float32).tiny)


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


def radix_bucket_ids(keys: torch.Tensor, n_buckets: int, group: AxisGroup) -> torch.Tensor:
    """Auto-ranged radix partition: equal-width buckets over the group-wide
    ``[min, max]`` of the keys, found with one ``pmin``/``pmax`` pair.

    Monotone: ``k1 <= k2`` implies ``bucket(k1) <= bucket(k2)``.  An
    all-equal range collapses into bucket 0; ±inf endpoints squash every
    finite key into one bucket (correct, maximally skewed).
    """
    kf = keys.to(torch.float32)
    lo = group.pmin(kf.min())
    hi = group.pmax(kf.max())
    span = torch.maximum(hi - lo, torch.tensor(_F32_TINY, dtype=torch.float32, device=kf.device))
    # a true float32 division, as jnp's: torch's int / tensor multiplies by a reciprocal
    scaled = (kf - lo) * torch.div(span.new_tensor(float(n_buckets)), span)
    # inf endpoints produce inf*0 / inf-inf NaNs; bucket 0 keeps the map
    # monotone for the finite keys (the pins below handle the infinities)
    scaled = torch.where(torch.isnan(scaled), 0.0, scaled)
    b = scaled.clamp(0, n_buckets - 1).to(torch.int32)
    b = torch.where(kf >= hi, n_buckets - 1, b)
    return torch.where(kf <= lo, 0, b).to(torch.int32)


def splitter_bucket(keys: torch.Tensor, splitters: torch.Tensor) -> torch.Tensor:
    """bucket = rank of key among B-1 sorted splitters (plain samplesort).

    >>> splitter_bucket(torch.tensor([5, 10, 25, 99]), torch.tensor([10, 20, 30])).tolist()
    [0, 1, 2, 3]
    """
    return torch.searchsorted(splitters, keys, right=True).to(torch.int32)


def splitters_from_sample(sample, n_buckets: int, *, unique: bool = False) -> torch.Tensor:
    """B-1 interior quantile splitters from a gathered key sample.

    ``sample`` is a tensor (used where it lives) or an array (a CPU tensor).
    ``unique=True`` also deduplicates, returning possibly fewer than
    ``n_buckets - 1`` splitters.  Deterministic.

    >>> splitters_from_sample(np.arange(100), 4).tolist()
    [25, 50, 75]
    >>> splitters_from_sample(np.array([7, 7, 7, 7, 9]), 4, unique=True).tolist()
    [7]
    """
    flat = torch.sort(torch.as_tensor(sample).reshape(-1), stable=True).values
    total = flat.shape[0]
    q = (torch.arange(1, n_buckets, device=flat.device) * total) // n_buckets
    spl = flat[q]
    return torch.unique(spl) if unique else spl


def choose_splitters(
    local_keys: torch.Tensor, n_buckets: int, group: AxisGroup, *, oversample: int = 8
) -> torch.Tensor:
    """Distributed quantile-splitter selection (samplesort).

    Every rank contributes ``oversample * n_buckets`` strided samples of its
    sorted shard; the all-gathered sample is sorted and B-1 quantiles
    become the splitters (the same on every rank).
    """
    m = local_keys.shape[-1]
    s = min(m, oversample * n_buckets)
    stride = max(1, m // s)
    local_sorted = torch.sort(local_keys, dim=-1, stable=True).values
    sample = local_sorted[..., ::stride][..., :s]
    return splitters_from_sample(group.all_gather(sample), n_buckets)


def _composite_splitters(
    local_keys: torch.Tensor,
    gid: torch.Tensor,
    n_buckets: int,
    group: AxisGroup,
    oversample: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(key, id) quantile splitters over the gathered composite sample."""
    m = local_keys.shape[-1]
    s = min(m, oversample * n_buckets)
    stride = max(1, m // s)
    order = torch.argsort(local_keys, stable=True)
    sk = local_keys[order][::stride][:s]
    sid = gid[order][::stride][:s]
    gk = group.all_gather(sk).reshape(-1)
    gi = group.all_gather(sid).reshape(-1)
    # composite order, key major and id minor: two stable sorts, the minor first
    pos = torch.argsort(gi, stable=True)
    pos = pos[torch.argsort(gk[pos], stable=True)]
    gk, gi = gk[pos], gi[pos]
    total = gk.shape[0]
    q = (torch.arange(1, n_buckets, device=gk.device) * total) // n_buckets
    return gk[q], gi[q]


def sample_partition_ids(
    local_keys: torch.Tensor,
    n_buckets: int,
    group: AxisGroup,
    *,
    oversample: int = DEFAULT_OVERSAMPLE,
    stable: bool = False,
) -> torch.Tensor:
    """Balanced bucket ids from composite ``(key, id)`` splitters.

    Every element carries a unique id, so a bucket boundary can land inside
    a tie run.  ``stable=False`` interleaves ids across ranks
    (``id = position * P + rank``), balance-optimal for keys-only sorts;
    ``stable=True`` uses arrival-order ids (``id = rank * m + position``),
    so tie order across buckets is arrival order and kv sorts stay stable.
    Monotone in key order.
    """
    P_, idx = group.size, group.rank
    m = local_keys.shape[-1]
    pos = torch.arange(m, dtype=torch.int32, device=local_keys.device)
    gid = idx * m + pos if stable else pos * P_ + idx
    spl_k, spl_id = _composite_splitters(local_keys, gid, n_buckets, group, oversample)
    k, i = local_keys[:, None], gid[:, None]
    above = (k > spl_k[None, :]) | ((k == spl_k[None, :]) & (i > spl_id[None, :]))
    return above.sum(dim=-1).to(torch.int32)
