"""repro_torch.engine — the sort-plan engine (serving-grade front end).

Counterpart of ``repro/engine``; exports its ``__all__`` name for name.

planner  : SortPlan + autotuner + persistent JSON plan cache; the candidate
           sweep covers local_impl='kernel' (the CUDA kernels) with a tuned
           block_n grid; folds learned capacity factors into cluster plans
adapt    : closed-loop tuning — ExchangeTelemetry + CapacityLearner turn
           observed model-D overflow into learned capacity factors, and
           DelayController adapts the async flush window to arrival rate
cache    : executable-cell cache with pow2 shape bucketing
kv       : sort_kv / argsort / sort_pairs / topk — records, not just keys
           (impl='kernel' runs the kernels' stable (key, rank) network)
service  : SortService — ragged numpy batches in, batched sorts on the
           service's device, numpy results out
queue    : AsyncSortService — async request queue that micro-batches
           individual submit_async calls across callers
frontend : SLO-aware multi-tenant serving front end — warmup of the whole
           plan-cache cell ladder, per-tenant weighted admission with EDF
           dispatch and reject-with-reason load shed, and a reproducible
           open-loop load harness
"""
from .adapt import (
    CapacityLearner,
    DelayController,
    ExchangeObservation,
    ExchangeTelemetry,
    LearnedCapacity,
    ManualClock,
)
from .cache import CompiledCache, size_bucket
from .kv import argsort, cluster_sort_kv, sort_kv, sort_pairs, topk
from .planner import (
    Planner,
    SortPlan,
    autotune,
    default_plan,
    default_planner,
    mesh_fingerprint,
    parse_plan_key,
    plan_from_strategy,
    plan_key,
    run_plan,
)
from .frontend import (
    LoadReport,
    ShedError,
    SortFrontend,
    Tenant,
    Ticket,
    WarmupReport,
    make_trace,
    run_load,
    warmup,
)
from .queue import AsyncSortService, QueueStats
from .service import ServiceStats, SortService

__all__ = [
    "CapacityLearner",
    "DelayController",
    "ExchangeObservation",
    "ExchangeTelemetry",
    "LearnedCapacity",
    "ManualClock",
    "CompiledCache",
    "size_bucket",
    "argsort",
    "cluster_sort_kv",
    "sort_kv",
    "sort_pairs",
    "topk",
    "Planner",
    "SortPlan",
    "autotune",
    "default_plan",
    "default_planner",
    "mesh_fingerprint",
    "parse_plan_key",
    "plan_from_strategy",
    "plan_key",
    "run_plan",
    "ServiceStats",
    "SortService",
    "AsyncSortService",
    "QueueStats",
    "LoadReport",
    "ShedError",
    "SortFrontend",
    "Tenant",
    "Ticket",
    "WarmupReport",
    "make_trace",
    "run_load",
    "warmup",
]
