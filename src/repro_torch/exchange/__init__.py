"""repro_torch.exchange — the exchange layer's shared primitives.

slabs     : ``sentinel_for``, ``slab_capacity``, ``slab_geometry``,
            ``expert_capacity``, ``slab_valid``
partition : ``partition_of`` (mode → radix/sample family)

The wire itself (``partition_exchange`` on ``torch.distributed``), the retry
driver and telemetry are later slices (ROADMAP Queue 1).
"""
from .partition import PARTITION_MODES, partition_of
from .slabs import (
    expert_capacity,
    sentinel_for,
    slab_capacity,
    slab_geometry,
    slab_valid,
)

__all__ = [
    "expert_capacity",
    "partition_of",
    "sentinel_for",
    "slab_capacity",
    "slab_geometry",
    "slab_valid",
]
