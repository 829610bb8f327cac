"""The reduction of a torch.profiler trace to what the per-layer metrics read.

The benchmark's own spans are ``torch.profiler.record_function`` ranges
named ``sb.<what>``, opened by the drivers around the calls they make into
each layer; ``sb.window`` covers the traced window.  ``collect`` keeps the
device operations (kernels, copies, fills) and the spans; a device
operation is attributed to the span the host was in when its runtime call
launched it.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "sb."
WINDOW = "sb.window"
TOP = 10  # entries a breakdown list keeps


@dataclass(frozen=True)
class Op:
    """One device operation: name, start and end (µs on the trace's clock)
    and the host time of its launch (None where the trace has none)."""

    name: str
    start: float
    end: float
    launched: Optional[float] = None

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float


@dataclass
class Trace:
    """Device operations and benchmark spans of one rank's traced window."""

    ops: List[Op] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)

    @property
    def window(self) -> Tuple[float, float]:
        w = [s for s in self.spans if s.name == WINDOW]
        if not w:
            raise ValueError("the trace holds no sb.window span")
        return w[0].start, w[0].end

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e6

    def busy_intervals(self, ops: Optional[List[Op]] = None) -> List[Tuple[float, float]]:
        """The union of the operations' ranges inside the window, sorted."""
        lo, hi = self.window
        merged: List[List[float]] = []
        for op in sorted(self.ops if ops is None else ops, key=lambda o: o.start):
            a, b = max(op.start, lo), min(op.end, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self, ops: Optional[List[Op]] = None) -> float:
        return sum(b - a for a, b in self.busy_intervals(ops)) / 1e6

    def idle_share(self) -> Optional[float]:
        """Percent of the window in which no device operation ran; None
        for a trace that holds no device operation."""
        if not self.ops:
            return None
        return (1.0 - self.busy_s() / self.window_s) * 100.0

    def innermost_span(self, t: float, spans: Optional[List[Span]] = None) -> Optional[str]:
        best = None
        for s in self.spans if spans is None else spans:
            if s.start <= t <= s.end and (best is None or s.end - s.start < best.end - best.start):
                best = s
        return None if best is None else best.name

    def ops_under(self, name: str) -> List[Op]:
        """The device operations launched while the host was inside a span
        called ``name``."""
        ranges = sorted((s.start, s.end) for s in self.spans if s.name == name)

        def inside(t):
            i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
            return i >= 0 and ranges[i][0] <= t <= ranges[i][1]

        return [op for op in self.ops if op.launched is not None and inside(op.launched)]

    def device_ops(self) -> List[List]:
        """The device operations that took most time, summed by name."""
        by_name: Dict[str, float] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + (op.end - op.start) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name, secs] for name, secs in top]

    def idle_gaps(self) -> List[List]:
        """Idle device time in the window, summed by the innermost benchmark
        span the host was in when each gap began."""
        lo, hi = self.window
        edges = [lo]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(hi)
        spans = [s for s in self.spans if s.name != WINDOW]
        by_span: Dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                label = self.innermost_span(a, spans) or "no span"
                by_span[label] = by_span.get(label, 0.0) + (b - a) / 1e6
        top = sorted(by_span.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name, secs] for name, secs in top]


def collect(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a ``Trace``.

    A device operation and the runtime call that launched it (``cuda*`` /
    ``cu*`` on the host) share a correlation id: the runtime call's start
    is the operation's launch time."""
    from torch.autograd import DeviceType

    launch_at: Dict[int, float] = {}
    device = []
    trace = Trace()
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        named = ev.name.startswith(SPAN_PREFIX)
        if ev.device_type == DeviceType.CUDA:
            # a span's range on the device is not an operation of its own
            if not named and not getattr(ev, "is_user_annotation", False):
                device.append(ev)
        elif named:
            trace.spans.append(Span(ev.name, start, end))
        elif ev.name.startswith("cu") and ev.id > 0:
            launch_at[ev.id] = start
    for ev in device:
        trace.ops.append(Op(ev.name, ev.time_range.start, ev.time_range.end, launch_at.get(ev.id)))
    return trace


class patched:
    """Wrap ``owner.<attr>`` in a span named ``name`` while open: the
    benchmark's span around a call the program makes into one of its layers
    (the attribute the calling module looks up)."""

    def __init__(self, owner, attr: str, name: str):
        self.owner, self.attr, self.name = owner, attr, name

    def __enter__(self) -> "patched":
        from torch.profiler import record_function

        real = self.real = getattr(self.owner, self.attr)
        name = self.name

        def wrapped(*args, **kwargs):
            with record_function(name):
                return real(*args, **kwargs)

        setattr(self.owner, self.attr, wrapped)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.owner, self.attr, self.real)


def profiler(device: str):
    """A torch.profiler over the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    return profile(activities=acts)
