"""One-step MSD-Radix bucketing (paper §3.4) and splitter modes (torch).

Counterpart of ``repro/core/radix.py``:

* ``decimal`` — the paper's scheme: bucket = most significant digit of a
  ``digits``-digit decimal key; 10 buckets.
* ``range`` — bucket = equal-width slice of a static [lo, hi) range.
* ``radix`` — ``range`` over the group-wide [min, max]
  (``repro_torch.exchange.partition.radix_bucket_ids``).
* ``splitters`` — sample quantile splitters (samplesort).
* ``sample`` — composite ``(key, id)`` splitters that split tie runs.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.exchange.group import AxisGroup
from repro_torch.exchange.partition import (  # noqa: F401  (re-exported, as the reference does)
    DEFAULT_OVERSAMPLE,
    choose_splitters,
    radix_bucket_ids,
    sample_partition_ids,
    splitter_bucket,
)

__all__ = [
    "decimal_msd_bucket",
    "range_bucket",
    "splitter_bucket",
    "choose_splitters",
    "make_partitioner",
]


def decimal_msd_bucket(keys: torch.Tensor, *, digits: int) -> torch.Tensor:
    """Paper mode: most significant digit of a ``digits``-digit decimal int.

    >>> decimal_msd_bucket(torch.tensor([7, 42, 999, 1000]), digits=3).tolist()
    [0, 0, 9, 9]
    """
    scale = 10 ** (digits - 1)
    return torch.clamp(torch.div(keys, scale, rounding_mode="floor"), 0, 9).to(torch.int32)


def range_bucket(keys: torch.Tensor, *, n_buckets: int, lo, hi) -> torch.Tensor:
    """Binary MSD generalization: equal-width buckets over a static [lo, hi).

    >>> range_bucket(torch.tensor([0, 3, 4, 7, 99]), n_buckets=2, lo=0, hi=8).tolist()
    [0, 0, 1, 1, 1]
    """
    kf = keys.to(torch.float32)
    # the reference's Python scalars become float32 before the arithmetic
    # (jax weak types), so they do here too
    lo32 = torch.tensor(lo, dtype=torch.float32, device=kf.device)
    width = torch.tensor(n_buckets / (hi - lo), dtype=torch.float32, device=kf.device)
    b = (kf - lo32) * width
    # the reference's float -> int32 conversion saturates, and torch's is
    # undefined out of range: clamp first, to values the clip below maps alike
    b = torch.nan_to_num(b, nan=0.0).clamp(-1, n_buckets)
    return torch.clamp(b.to(torch.int32), 0, n_buckets - 1)


def make_partitioner(
    mode: str,
    *,
    n_buckets: int,
    digits: int = 3,
    lo=0,
    hi=1,
    group: Optional[AxisGroup] = None,
    oversample: int = 8,
    stable: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return keys -> bucket_ids for the chosen MSD mode.

    ``group`` is the axis the data-adaptive modes (``radix``, ``splitters``,
    ``sample``) reduce or gather over.  ``stable`` only affects ``sample``
    mode: arrival-order tie ids, so a kv sort stays stable.

    >>> make_partitioner("decimal", n_buckets=10, digits=2)(torch.tensor([5, 57])).tolist()
    [0, 5]
    """
    if mode == "decimal":
        if n_buckets != 10:
            raise ValueError("decimal MSD implies exactly 10 buckets (paper §3.4)")
        return lambda k: decimal_msd_bucket(k, digits=digits)
    if mode == "range":
        return lambda k: range_bucket(k, n_buckets=n_buckets, lo=lo, hi=hi)
    if mode in ("radix", "splitters", "sample") and group is None:
        raise ValueError(f"{mode} mode needs the group it partitions over")
    if mode == "radix":
        return lambda k: radix_bucket_ids(k, n_buckets, group)
    if mode == "splitters":
        return lambda k: splitter_bucket(k, choose_splitters(k, n_buckets, group, oversample=oversample))
    if mode == "sample":
        # choose_splitters keeps its historic default; the composite sample
        # partition wants the larger DEFAULT_OVERSAMPLE unless overridden
        os_ = max(oversample, DEFAULT_OVERSAMPLE)
        return lambda k: sample_partition_ids(k, n_buckets, group, oversample=os_, stable=stable)
    raise ValueError(f"unknown partitioner mode {mode!r}")
