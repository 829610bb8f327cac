"""Spans at the port's layer boundaries, on the profiler's own timeline.

Tracing is on exactly while a torch profiler runs (``torch.profiler.profile``
or ``torch.autograd.profiler.profile``); there is no flag of its own.  Off,
``span`` reads one attribute and hands back a shared no-op.  On, a span

- enters ``torch.profiler.record_function(name)``, so it sits in the
  profiler's trace beside the device operations it launched;
- appends a ``Record`` (name, parent, call id, thread, host start and end
  from ``time.perf_counter_ns``) to an in-memory list;
- with ``device=`` a tensor or ``torch.device`` on a card, records a
  ``torch.cuda.Event`` pair on that card's current stream: the span's
  device interval, from the stream reaching the span's start to finishing
  the work launched inside it.

``records()`` returns the records of the latest profiler session, with the
device intervals resolved on read.  The first span after a profiler starts
drops the previous session's records, so memory is bounded by one traced
window.  A root span (none open on its thread) starts a new call id on
that thread; the spans under it share it.

Every span name begins ``repro_torch.``.

>>> with span("repro_torch.doc"):        # no profiler: nothing is kept
...     pass
>>> span("repro_torch.doc") is span("repro_torch.other")
True
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Record", "records", "self_ns", "span"]


class Record:
    """One span of a traced window.  ``parent`` is the index of the
    enclosing span's record in ``records()`` (None for a root); ``end_ns``
    is None while the span is open; ``device_ms`` is the span's device
    interval in milliseconds (None without a card)."""

    __slots__ = ("name", "parent", "call", "thread", "start_ns", "end_ns", "device_ms",
                 "_events", "_session", "_index")

    def __init__(self, name: str, parent: Optional[int], call: int, session: int, index: int):
        self.name, self.parent, self.call = name, parent, call
        self.thread = threading.get_ident()
        self.start_ns: int = 0
        self.end_ns: Optional[int] = None
        self.device_ms: Optional[float] = None
        self._events = None
        self._session, self._index = session, index


class _Off:
    """The span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Thread(threading.local):
    def __init__(self):
        self.stack: List[Record] = []  # the open spans, innermost last
        self.calls = 0


class _Recorder:
    """The records of the latest profiler session."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: List[Record] = []
        self.starts = 0  # profiler starts seen since the hook went in
        self.session: Optional[int] = None  # the session ``records`` belong to
        self.hooked = False
        self.local = _Thread()

    def _hook(self) -> None:
        # torch exposes no session id: count the profiler's starts through
        # the module function its profiler calls at each start
        start = getattr(_profiler, "_run_on_profiler_start", None)
        if start is None:
            return

        def on_start():
            self.starts += 1
            start()

        _profiler._run_on_profiler_start = on_start

    def open(self, name: str) -> Record:
        with self.lock:
            if not self.hooked:
                self.hooked = True
                self._hook()
            if self.session != self.starts:
                self.session, self.records = self.starts, []
            local = self.local
            top = local.stack[-1] if local.stack else None
            if top is not None and top._session == self.session:
                parent, call = top._index, top.call
            else:
                local.calls += 1
                parent, call = None, local.calls
            rec = Record(name, parent, call, self.session, len(self.records))
            self.records.append(rec)
        local.stack.append(rec)
        return rec

    def close(self) -> None:
        self.local.stack.pop()


_RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "device", "rec", "fn")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.rec = rec = _RECORDER.open(self.name)
        dev = self.device
        if dev is not False and dev is not None:
            dev = dev.device if isinstance(dev, torch.Tensor) else torch.device(dev)
            if dev.type == "cuda":
                stream = torch.cuda.current_stream(dev)
                rec._events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True), stream)
                rec._events[0].record(stream)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec._events is not None:
            rec._events[1].record(rec._events[2])
        rec.end_ns = time.perf_counter_ns()
        _RECORDER.close()
        self.fn.__exit__(*exc)
        return False


def span(name: str, *, device=False):
    """A span named ``name`` (``repro_torch.<layer>``) around a ``with``
    block; ``device=`` a tensor or ``torch.device`` also times the block
    on that device's current stream when it is a card."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def records() -> List[Record]:
    """The records of the latest profiler session, in the order their
    spans began; device intervals of closed spans are resolved here (a
    wait for the card to reach each span's end)."""
    with _RECORDER.lock:
        if _RECORDER.session != _RECORDER.starts:
            # a profiler started since the last span: its session has none
            _RECORDER.session, _RECORDER.records = _RECORDER.starts, []
        recs = list(_RECORDER.records)
    for rec in recs:
        ev = rec._events
        if ev is not None and rec.end_ns is not None:
            ev[1].synchronize()
            rec.device_ms = ev[0].elapsed_time(ev[1])
            rec._events = None
    return recs


def self_ns(recs: List[Record], i: int) -> int:
    """Record ``i``'s host duration less the part of it its children
    cover (the layer's self time), in nanoseconds."""
    rec = recs[i]
    lo, hi = rec.start_ns, rec.end_ns
    kids = sorted((max(c.start_ns, lo), min(c.end_ns, hi)) for c in recs
                  if c.parent == i and c.end_ns is not None)
    covered, reach = 0, lo
    for a, b in kids:
        a = max(a, reach)
        if b > a:
            covered += b - a
            reach = b
    return hi - lo - covered
