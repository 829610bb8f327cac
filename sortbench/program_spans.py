"""The program's own spans, as the per-layer metrics read them.

``repro_torch.tracing`` keeps the records of the latest profiler session
in memory: name, parent, call id, host start and end on
``time.perf_counter_ns``, and the device interval of a span timed with a
CUDA event pair.  The traced window is that session, so after a traced run
these are the window's spans.  A program without the module has none, and
every reader here then returns None.

The records and the profiler trace are on two clocks.  ``idle_split``
joins them once a call: call k's records are shifted by the offset between
the start of the k-th ``sb.call`` span in the trace and the start of the
k-th ``repro_torch.sort`` record.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

SORT = "repro_torch.sort"
READ = "repro_torch.retry.read"
CALL = "sb.call"

Interval = Tuple[float, float]


def records() -> Optional[list]:
    """The program's span records of the latest traced window (None where
    the program has no tracing module)."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.records()


def _closed(recs, names) -> list:
    return [r for r in recs or () if r.name in names and r.end_ns is not None]


def host_ms_per_call(recs, names: Sequence[str], calls: int) -> Optional[float]:
    """Host milliseconds a call inside the spans called ``names`` (spans
    that do not nest in one another), or None where there are none."""
    hits = _closed(recs, names)
    if not hits or not calls:
        return None
    return sum(r.end_ns - r.start_ns for r in hits) / 1e6 / calls


def device_ms_per_call(recs, name: str, calls: int) -> Optional[float]:
    """Device milliseconds a call inside the spans called ``name``, from
    their event pairs; None where there are none or one has no device
    interval (a span on the CPU)."""
    hits = _closed(recs, (name,))
    if not hits or not calls or any(r.device_ms is None for r in hits):
        return None
    return sum(r.device_ms for r in hits) / calls


def _idle_intervals(trace) -> List[Interval]:
    lo, hi = trace.window
    edges = [lo]
    for a, b in trace.busy_intervals():
        edges += [a, b]
    edges.append(hi)
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def _subtract(iv: Interval, cuts: List[Interval]) -> List[Interval]:
    """``iv`` less the sorted intervals ``cuts``."""
    out, at = [], iv[0]
    for a, b in cuts:
        if a > at:
            out.append((at, min(a, iv[1])))
        at = max(at, b)
    if at < iv[1]:
        out.append((at, iv[1]))
    return [(a, b) for a, b in out if b > a]


def _overlap(xs: List[Interval], ys: List[Interval]) -> float:
    """Total length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclass(frozen=True)
class IdleSplit:
    """A traced window's device-idle time split by the program's host path:
    ``inside_s`` while the host was inside ``repro_torch.sort`` but not in
    ``repro_torch.retry.read``, ``outside_s`` the rest; ``join_error_us``
    is the median of the start-anchored less the end-anchored offset."""

    inside_s: float
    outside_s: float
    join_error_us: float
    calls: int


def idle_split(trace, recs) -> Optional[IdleSplit]:
    """Split ``trace``'s idle time by the host path of ``recs``; None on a
    trace with no device operation, or when the ``sb.call`` spans and the
    root ``repro_torch.sort`` records differ in number."""
    if trace is None or not trace.ops or not recs:
        return None
    roots = sorted((r for r in _closed(recs, (SORT,)) if r.parent is None),
                   key=lambda r: r.start_ns)
    calls = sorted((s for s in trace.spans if s.name == CALL), key=lambda s: s.start)
    if not roots or len(roots) != len(calls):
        return None
    reads = {}
    for r in _closed(recs, (READ,)):
        reads.setdefault((r.thread, r.call), []).append(r)
    host, errors = [], []
    for root, span in zip(roots, calls):
        offset = span.start - root.start_ns / 1e3
        errors.append(offset - (span.end - root.end_ns / 1e3))
        cuts = sorted((r.start_ns / 1e3 + offset, r.end_ns / 1e3 + offset)
                      for r in reads.get((root.thread, root.call), ()))
        host += _subtract((root.start_ns / 1e3 + offset, root.end_ns / 1e3 + offset), cuts)
    idle = _idle_intervals(trace)
    inside = _overlap(idle, sorted(host))
    total = sum(b - a for a, b in idle)
    return IdleSplit(inside / 1e6, (total - inside) / 1e6, statistics.median(errors), len(roots))
