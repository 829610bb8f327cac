"""repro_torch.engine.frontend — the SLO-aware multi-tenant serving front end.

Counterpart of ``repro/engine/frontend``.

warmup    : build every executable cell the plan cache names before
            traffic arrives, so first-request latency == steady-state
            latency (``warmup`` / ``WarmupReport`` / ``batch_bucket_ladder``)
scheduler : ``SortFrontend`` — per-tenant weighted admission over a bounded
            backlog, strict priority classes with EDF dispatch inside each,
            explicit reject-with-reason load shedding (``Tenant`` /
            ``Ticket`` / ``ShedError`` / ``BatchInfo``)
loadgen   : reproducible open-loop load (seeded Poisson arrivals, Zipfian
            size mix, tenant skew) with deterministic ``ManualClock``
            simulation and wall-clock replay, reporting p50/p95/p99 latency
            and goodput under overload (``make_trace`` / ``run_load`` /
            ``replay_wallclock`` / ``LoadReport``)

The pieces compose into the reference's serving story (its
docs/serving.md): warm the ladder, admit by contract, dispatch by deadline,
shed with a reason, and prove the whole thing with the load harness.
"""
from .loadgen import (
    Arrival,
    LoadReport,
    linear_service_time,
    make_trace,
    payload_for,
    replay_wallclock,
    run_load,
    zipf_shares,
)
from .scheduler import BatchInfo, ShedError, SortFrontend, Tenant, Ticket
from .warmup import WarmupReport, batch_bucket_ladder, warmup

__all__ = [
    "Arrival",
    "BatchInfo",
    "LoadReport",
    "ShedError",
    "SortFrontend",
    "Tenant",
    "Ticket",
    "WarmupReport",
    "batch_bucket_ladder",
    "linear_service_time",
    "make_trace",
    "payload_for",
    "replay_wallclock",
    "run_load",
    "warmup",
    "zipf_shares",
]
