"""Slab and capacity math shared by model-D sort and MoE dispatch (torch).

Counterpart of ``repro/exchange/slabs.py``.  ``sentinel_for`` is also the
pad value of every sort in this package; the capacity formulas are plain
integer arithmetic and give the reference's numbers exactly.
"""
from __future__ import annotations

import torch

__all__ = [
    "expert_capacity",
    "sentinel_for",
    "slab_capacity",
    "slab_geometry",
    "slab_valid",
]


def sentinel_for(dtype: torch.dtype, *, largest: bool) -> torch.Tensor:
    """Value that sorts after (largest) / before (smallest) all real keys —
    what exchange slabs and sort paddings are filled with (a 0-d tensor).

    >>> int(sentinel_for(torch.int32, largest=True)) == torch.iinfo(torch.int32).max
    True
    >>> float(sentinel_for(torch.float32, largest=False))
    -inf
    """
    if dtype.is_floating_point:
        v = float("inf") if largest else float("-inf")
    elif dtype != torch.bool and not dtype.is_complex:
        info = torch.iinfo(dtype)
        v = info.max if largest else info.min
    else:
        raise TypeError(f"unsupported key dtype {dtype}")
    return torch.tensor(v, dtype=dtype)


def slab_capacity(m: int, buckets: int, capacity_factor: float) -> int:
    """Per-(sender, bucket) slab capacity — THE capacity formula.

    ``ceil(capacity_factor * m / buckets)``, clamped to ``[1, m]``; the
    1-slot floor wins for an empty sender (``m == 0``).

    >>> slab_capacity(1000, 8, 1.5)     # ceil(1500 / 8)
    188
    >>> slab_capacity(64, 4, 8.0)       # clamped to the loss-free bound m
    64
    >>> slab_capacity(64, 4, 0.001)     # floored at one slot
    1
    >>> slab_capacity(0, 8, 1.25)       # empty sender: floor beats the bound
    1
    """
    return max(1, min(m, -(-int(capacity_factor * m) // max(buckets, 1))))


def slab_geometry(mode: str, m: int, P_: int, capacity_factor: float):
    """Exchange geometry for model D: (part_buckets, n_buckets, capacity).

    ``part_buckets`` is 10 in the paper's decimal mode and ``P_`` otherwise;
    ``n_buckets`` rounds it up to a multiple of ``P_``.

    >>> slab_geometry("decimal", 1000, 4, 2.0)
    (10, 12, 200)
    >>> slab_geometry("splitters", 1000, 8, 1.5)
    (8, 8, 188)
    """
    part_buckets = 10 if mode == "decimal" else P_
    n_buckets = -(-part_buckets // P_) * P_
    return part_buckets, n_buckets, slab_capacity(m, part_buckets, capacity_factor)


def expert_capacity(tokens: int, top_k: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Per-(sender, expert) token capacity for MoE dispatch: the MoE keying
    of ``slab_capacity`` (``tokens * top_k`` assignments over experts).

    >>> expert_capacity(32, 2, 4, 2.0)      # ceil(2.0 * 64 / 4)
    32
    >>> expert_capacity(32, 2, 4, 0.01)     # floors at one slot
    1
    >>> expert_capacity(32, 2, 4, 8.0)      # clamped to tokens * top_k
    64
    >>> expert_capacity(0, 2, 8, 1.25)      # empty shard/microbatch: never 0
    1
    """
    return slab_capacity(tokens * top_k, n_experts, capacity_factor)


def slab_valid(total: int, counts: torch.Tensor, P_: int) -> torch.Tensor:
    """Validity mask over a gathered (P_ * C_total,) result slab.

    ``counts[p]`` is shard p's real element count; entries past it in shard
    p's ``C_total``-slot range are padding.

    >>> [bool(b) for b in slab_valid(4, torch.tensor([1, 2]), 2)]
    [True, False, True, True]
    """
    C_total = total // P_
    pos = torch.arange(total, device=counts.device) % C_total
    return pos < torch.repeat_interleave(counts, C_total)
