"""Open-loop load harness: seeded Poisson/Zipf traffic, deterministic replay.

Counterpart of ``repro/engine/frontend/loadgen.py``: the same seed gives the
reference's trace and payloads byte for byte.

Measuring a serving frontend honestly requires *open-loop* load — arrivals
fire on their own schedule whether or not the server keeps up, so overload
actually builds a backlog instead of politely self-throttling (the
closed-loop trap).  This module generates reproducible open-loop traffic and
replays it against a ``SortFrontend`` in two modes:

* **Simulation** (``run_load``): the frontend runs on a ``ManualClock`` and
  a ``service_time`` cost model charges simulated seconds per dispatched
  batch.  Arrival times, sizes, payload bytes, scheduling decisions, sheds —
  every byte of the run is a deterministic function of the seed, which is
  what makes the p50/p95/p99 + goodput rows regression-gateable in CI.
* **Wall clock** (``replay_wallclock``): the same trace paced in real time
  against the real executables (dispatcher thread mode) — this is how the
  cost of a cold cache is measured against a warmed one.

Traces are per-tenant Poisson processes (exponential inter-arrivals) with a
Zipfian request-size mix over a pow2 ladder, and ``zipf_shares`` skews the
tenant rate split for the "one hot tenant" overload scenarios.  All
randomness flows through ``numpy.random.default_rng(seed)`` — same seed,
byte-for-byte same trace and payloads (tests/test_torch_frontend.py holds
them against the reference's).
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .scheduler import BatchInfo, ShedError, SortFrontend, Ticket

__all__ = [
    "Arrival",
    "LoadReport",
    "linear_service_time",
    "make_trace",
    "payload_for",
    "replay_wallclock",
    "run_load",
    "zipf_shares",
]

DEFAULT_SIZES = (256, 512, 1024, 2048, 4096)


@dataclass(frozen=True)
class Arrival:
    """One open-loop request: fires at ``t`` regardless of server state.

    >>> Arrival(t=0.25, tenant="web", size=1024, seq=3).size
    1024
    """

    t: float
    tenant: str
    size: int
    seq: int
    kind: str = "sort"


def zipf_shares(n: int, skew: float) -> Tuple[float, ...]:
    """Zipfian tenant shares: share_i ∝ (i+1)^-skew, normalized.

    ``skew=0`` is the uniform split; larger skew concentrates traffic on the
    first tenant — the "one hot tenant" overload shape.

    >>> [round(s, 3) for s in zipf_shares(3, 0.0)]
    [0.333, 0.333, 0.333]
    >>> shares = zipf_shares(3, 2.0)
    >>> shares[0] > 0.7 and abs(sum(shares) - 1.0) < 1e-12
    True
    """
    if n < 1:
        raise ValueError("need at least one tenant")
    raw = [(i + 1) ** -float(skew) for i in range(n)]
    total = sum(raw)
    return tuple(r / total for r in raw)


def make_trace(
    *,
    duration_s: float,
    rates: Dict[str, float],
    sizes: Sequence[int] = DEFAULT_SIZES,
    zipf_a: float = 1.2,
    seed: int = 0,
    kind: str = "sort",
) -> Tuple[Arrival, ...]:
    """Seeded open-loop trace: per-tenant Poisson arrivals, Zipfian sizes.

    ``rates`` maps tenant name -> mean arrivals/second; each tenant is an
    independent Poisson process (exponential inter-arrival times).  Request
    sizes are drawn from ``sizes`` with probability ∝ rank^-``zipf_a``
    (rank 1 = the first, most common size).  The merged trace is sorted by
    time with ``seq`` numbering arrival order — and it is a pure function of
    the arguments: same seed, byte-for-byte same trace.

    >>> tr = make_trace(duration_s=2.0, rates={"a": 5.0}, seed=7)
    >>> tr == make_trace(duration_s=2.0, rates={"a": 5.0}, seed=7)
    True
    >>> all(0 <= a.t <= 2.0 for a in tr)
    True
    """
    if duration_s <= 0:
        raise ValueError("duration_s must be positive")
    sizes = tuple(int(s) for s in sizes)
    ranks = np.arange(1, len(sizes) + 1, dtype=np.float64)
    probs = ranks ** -float(zipf_a)
    probs /= probs.sum()
    events: List[Arrival] = []
    # one independent, deterministically-derived stream per tenant, so adding
    # a tenant to the dict never perturbs another tenant's arrivals
    for tenant in sorted(rates):
        rate = float(rates[tenant])
        if rate < 0:
            raise ValueError(f"negative rate for tenant {tenant!r}")
        if rate == 0:
            continue
        # crc32, not hash(): str hashing is salted per process and would
        # break the same-seed byte-for-byte reproducibility contract
        rng = np.random.default_rng([seed, zlib.crc32(tenant.encode())])
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t > duration_s:
                break
            size = int(rng.choice(sizes, p=probs))
            events.append(Arrival(t=t, tenant=tenant, size=size, seq=0,
                                  kind=kind))
    events.sort(key=lambda a: (a.t, a.tenant))
    return tuple(
        Arrival(t=a.t, tenant=a.tenant, size=a.size, seq=i, kind=a.kind)
        for i, a in enumerate(events)
    )


def payload_for(arrival: Arrival, *, seed: int = 0,
                dtype=np.int32) -> np.ndarray:
    """The request's key array — reproducible per (seed, arrival.seq).

    >>> a = Arrival(t=0.0, tenant="t", size=8, seq=5)
    >>> bool((payload_for(a, seed=1) == payload_for(a, seed=1)).all())
    True
    """
    rng = np.random.default_rng([seed, arrival.seq])
    return rng.integers(0, 1_000_000, arrival.size).astype(dtype)


def linear_service_time(
    *, base_ms: float = 0.2, us_per_key: float = 0.05
) -> Callable[[BatchInfo], float]:
    """A batched-server cost model: fixed dispatch cost + per-key cost.

    The fixed term is what batching amortizes — exactly the paper's
    fixed-cost story — so under this model a coalesced batch of n requests
    is cheaper than n singleton dispatches.

    >>> m = linear_service_time(base_ms=1.0, us_per_key=0.0)
    >>> m(BatchInfo(n_requests=4, bucket=1024, kind="sort", tenants=()))
    0.001
    """
    def model(info: BatchInfo) -> float:
        return base_ms / 1e3 + info.n_requests * info.bucket * us_per_key / 1e6
    return model


@dataclass
class LoadReport:
    """Outcome of one replayed trace: tickets, sheds, and derived metrics.

    ``goodput`` is the fraction of *offered* requests (admission sheds
    included — open-loop honesty) that completed within their deadline;
    ``latency_percentiles`` covers completed requests only.

    >>> LoadReport(offered=4, tickets=[], sheds=[("t", "global_backlog")]
    ...            ).goodput()
    0.0
    """

    offered: int = 0
    tickets: List[Ticket] = field(default_factory=list)
    sheds: List[Tuple[str, str]] = field(default_factory=list)  # (tenant, reason)
    elapsed_s: float = 0.0

    def _done(self, tenant: Optional[str]):
        return [
            t for t in self.tickets
            if t.latency_s is not None and not t.future.exception()
            and (tenant is None or t.tenant == tenant)
        ]

    def latency_percentiles(
        self, ps: Sequence[int] = (50, 95, 99), tenant: Optional[str] = None
    ) -> Dict[int, float]:
        """{percentile: seconds} over completed requests' submit->done time."""
        lat = sorted(t.latency_s for t in self._done(tenant))
        if not lat:
            return {p: 0.0 for p in ps}
        return {
            p: lat[min(len(lat) - 1, round(p / 100 * (len(lat) - 1)))]
            for p in ps
        }

    def goodput(self, tenant: Optional[str] = None) -> float:
        """Fraction of offered requests that completed within deadline."""
        if tenant is None:
            offered = self.offered
        else:
            offered = sum(1 for t in self.tickets if t.tenant == tenant) + sum(
                1 for tn, _ in self.sheds if tn == tenant
            )
        if not offered:
            return 0.0
        good = sum(1 for t in self._done(tenant) if t.slo_met)
        return good / offered

    def shed_counts(self, tenant: Optional[str] = None) -> Dict[str, int]:
        """reason -> count (optionally for one tenant)."""
        out: Dict[str, int] = {}
        for tn, reason in self.sheds:
            if tenant is None or tn == tenant:
                out[reason] = out.get(reason, 0) + 1
        return out

    def derived(self, tenant: Optional[str] = None) -> str:
        """The bench's machine-readable summary fragment."""
        pct = self.latency_percentiles((50, 95, 99), tenant)
        return (
            f"p50_ms={pct[50] * 1e3:.3f};p95_ms={pct[95] * 1e3:.3f};"
            f"p99_ms={pct[99] * 1e3:.3f};goodput={self.goodput(tenant):.3f};"
            f"shed={sum(self.shed_counts(tenant).values())}"
        )


def run_load(
    frontend: SortFrontend,
    trace: Sequence[Arrival],
    *,
    clock,
    service_time: Callable[[BatchInfo], float],
    seed: int = 0,
    dtype=np.int32,
    drain: bool = True,
) -> LoadReport:
    """Replay an open-loop trace as a deterministic discrete-event simulation.

    ``clock`` must be the same ``ManualClock`` the frontend was built on;
    ``service_time`` charges simulated seconds per dispatched batch.  The
    loop alternates the two event sources in time order: the server pumps
    whenever it is free before the next arrival (its finish time advances
    the clock), and each arrival fires at its trace time no matter how
    deep the backlog is — that is what "open-loop" means, and it is why
    overload here produces real queueing delay, sheds, and goodput loss.

    Expired-in-queue requests shed by the scheduler resolve their tickets
    with ``ShedError('deadline')`` and are folded into the report's shed
    ledger alongside admission refusals.

    >>> from repro_torch.engine.adapt import ManualClock
    >>> from repro_torch.engine.frontend import SortFrontend, Tenant
    >>> clk = ManualClock()
    >>> fe = SortFrontend(tenants=[Tenant("t")], clock=clk, device="cpu")
    >>> tr = make_trace(duration_s=0.3, rates={"t": 20.0}, sizes=(64,), seed=3)
    >>> rep = run_load(fe, tr, clock=clk,
    ...                service_time=linear_service_time(base_ms=0.1))
    >>> rep.offered == len(tr) and 0.0 <= rep.goodput() <= 1.0
    True
    """
    report = LoadReport(offered=len(trace))
    free_at = clock()
    i = 0
    while i < len(trace) or (frontend.backlog() and drain):
        next_t = trace[i].t if i < len(trace) else float("inf")
        if frontend.backlog() and free_at <= next_t:
            if free_at > clock():
                clock.advance(free_at - clock())
            info = frontend.pump()
            if info is not None and info.n_requests:
                free_at = clock() + service_time(info)
            continue
        if i >= len(trace):
            break
        arr = trace[i]
        i += 1
        if arr.t > clock():
            clock.advance(arr.t - clock())
        free_at = max(free_at, clock())
        try:
            report.tickets.append(
                frontend.submit(arr.tenant, payload_for(arr, seed=seed,
                                                        dtype=dtype),
                                kind=arr.kind)
            )
        except ShedError as e:
            report.sheds.append((e.tenant, e.reason))
    # dispatch-time deadline sheds also live on tickets; mirror them into
    # the shed ledger so shed_counts sees both admission and expiry
    for t in report.tickets:
        exc = t.future.exception() if t.done() else None
        if isinstance(exc, ShedError):
            report.sheds.append((exc.tenant, exc.reason))
    report.elapsed_s = clock()
    return report


def replay_wallclock(
    frontend: SortFrontend,
    trace: Sequence[Arrival],
    *,
    seed: int = 0,
    dtype=np.int32,
    timeout_s: float = 120.0,
) -> LoadReport:
    """Replay a trace in real time against the real executables.

    The frontend must be running its dispatcher thread (``start()``).
    Arrival pacing sleeps until each trace time; latencies come from the
    frontend's (real) clock stamps.  A cold run's percentiles include the
    first use of each cell, a warmed run's do not.
    """
    report = LoadReport(offered=len(trace))
    t0 = time.perf_counter()
    for arr in trace:
        lag = arr.t - (time.perf_counter() - t0)
        if lag > 0:
            time.sleep(lag)
        try:
            report.tickets.append(
                frontend.submit(arr.tenant, payload_for(arr, seed=seed,
                                                        dtype=dtype),
                                kind=arr.kind)
            )
        except ShedError as e:
            report.sheds.append((e.tenant, e.reason))
    deadline = time.perf_counter() + timeout_s
    for t in report.tickets:
        try:
            t.future.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:
            pass  # sheds/errors are accounted below, not raised here
        exc = t.future.exception()
        if isinstance(exc, ShedError):
            report.sheds.append((exc.tenant, exc.reason))
    report.elapsed_s = time.perf_counter() - t0
    return report
