"""repro_torch.exchange — the exchange layer on ``torch.distributed``.

One implementation of "bucket, cap, all-to-all, retry on overflow" for the
mesh sorts (model D, its kv twin) and, later, MoE dispatch.

group      : ``AxisGroup`` — a process group as one mesh axis, with the
             collectives the reference calls inside ``shard_map``
slabs      : ``sentinel_for``, ``slab_capacity``, ``slab_geometry``,
             ``expert_capacity``, ``slab_valid``
collective : ``partition_exchange`` / ``combine_exchange`` /
             ``ExchangeResult`` (one all_to_all each way, optional int8 wire)
retry      : ``run_with_capacity_retries``
telemetry  : ``ExchangeObservation`` / ``ExchangeTelemetry``
partition  : ``radix_bucket_ids``, ``sample_partition_ids``,
             ``choose_splitters``, ``splitter_bucket``,
             ``splitters_from_sample``, ``partition_of``
"""
from .collective import ExchangeResult, combine_exchange, partition_exchange
from .group import AxisGroup, as_axis_group
from .partition import (
    DEFAULT_OVERSAMPLE,
    PARTITION_MODES,
    choose_splitters,
    partition_of,
    radix_bucket_ids,
    sample_partition_ids,
    splitter_bucket,
    splitters_from_sample,
)
from .retry import run_with_capacity_retries
from .slabs import (
    expert_capacity,
    sentinel_for,
    slab_capacity,
    slab_geometry,
    slab_valid,
)
from .telemetry import ExchangeObservation, ExchangeTelemetry

__all__ = [
    "AxisGroup",
    "ExchangeObservation",
    "ExchangeResult",
    "ExchangeTelemetry",
    "as_axis_group",
    "choose_splitters",
    "combine_exchange",
    "expert_capacity",
    "partition_exchange",
    "partition_of",
    "radix_bucket_ids",
    "run_with_capacity_retries",
    "sample_partition_ids",
    "sentinel_for",
    "slab_capacity",
    "slab_geometry",
    "slab_valid",
    "splitter_bucket",
    "splitters_from_sample",
]
