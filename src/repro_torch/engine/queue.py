"""Async serving front door — cross-caller micro-batching over ``SortService``.

Counterpart of ``repro/engine/queue.py``; the dispatcher thread enters the
service's device before its first batch.

The sync ``SortService.submit`` only batches requests that arrive *in the
same call*, so callers must hand-assemble well-shaped batches to amortize
fixed costs — exactly the shape the paper says dominates parallel sort
throughput.  ``AsyncSortService`` moves that batching behind the API:
producers on any thread call ``submit_async`` with a single request and get
a ``concurrent.futures.Future``; one dispatcher thread coalesces requests
**across callers** into per-(kind, direction, length-bucket, dtype[, value
signature]) micro-batches under a ``max_batch`` / ``max_delay_ms`` policy and
executes each batch through ``SortService._run_group`` — the same
pad/plan/execute core the sync path uses, so the steady state builds no
new cell and every warmed cell is shared between both paths.

Backpressure is a bounded stdlib queue: ``maxsize`` caps admitted-but-unrun
requests; ``on_full='block'`` makes producers wait for room while
``on_full='reject'`` raises ``queue.Full`` at the call site.  ``drain()``
blocks until everything admitted has resolved; ``close()`` drains, stops the
dispatcher, and rejects later submits (also the context-manager exit path).

``QueueStats`` extends ``ServiceStats`` with queue-level telemetry: batch
fill ratio, coalesced-batch sizes, and rolling queue-latency percentiles.

Timing is injectable: every batching decision (enqueue stamps, flush
deadlines, queue latencies) reads the ``clock`` passed at construction
(``time.monotonic`` by default; ``repro_torch.engine.adapt.ManualClock`` in
tests), and passing ``min_delay_ms`` turns the fixed flush window into a
``DelayController``-adapted one — shrink when batches fill before the
deadline, grow when they flush sparse, always within
``[min_delay_ms, max_delay_ms]``.
"""
from __future__ import annotations

import queue as _stdqueue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from .adapt import DelayController
from .planner import Planner
from .service import ServiceStats, SortService

__all__ = ["AsyncSortService", "QueueStats"]


@dataclass
class QueueStats(ServiceStats):
    """``ServiceStats`` plus micro-batching telemetry for the async queue.

    ``fill_ratios`` / ``batch_sizes`` / ``queue_latency_s`` are rolling
    windows (bounded deques), so a long-lived service reports recent steady
    state rather than lifetime averages.

    >>> s = QueueStats()
    >>> s.observe_batch(n_requests=6, capacity=8, latencies=[0.002] * 6)
    >>> round(s.fill_ratio(), 2)
    0.75
    >>> s.latency_percentiles()[50]
    0.002
    """

    enqueued: int = 0
    rejected: int = 0
    coalesced_batches: int = 0
    coalesced_requests: int = 0
    fill_ratios: deque = field(default_factory=lambda: deque(maxlen=1024), repr=False)
    batch_sizes: deque = field(default_factory=lambda: deque(maxlen=1024), repr=False)
    queue_latency_s: deque = field(
        default_factory=lambda: deque(maxlen=8192), repr=False
    )
    # multi-tenant accounting (repro_torch.engine.frontend): every load-shed is
    # attributed to the tenant that suffered it and the reason it fired, and
    # every served request lands in its tenant's tally — overload debugging
    # starts from "who was shed, and why", not from a global counter
    shed: Dict[str, Dict[str, int]] = field(default_factory=dict, repr=False)
    tenant_served: Dict[str, int] = field(default_factory=dict, repr=False)

    def observe_shed(self, tenant: str, reason: str) -> None:
        """Attribute one load-shed to ``tenant`` with its ``reason``
        (``'tenant_backlog'`` / ``'global_backlog'`` / ``'deadline'``)."""
        self.rejected += 1
        per = self.shed.setdefault(tenant, {})
        per[reason] = per.get(reason, 0) + 1

    def shed_total(self, tenant: Optional[str] = None) -> int:
        """Total sheds — for one tenant, or across all tenants."""
        tenants = [tenant] if tenant is not None else list(self.shed)
        return sum(sum(self.shed.get(t, {}).values()) for t in tenants)

    def observe_batch(self, *, n_requests: int, capacity: int, latencies) -> None:
        """Record one executed micro-batch (size, fill vs ``max_batch``, and
        each member request's time-in-queue)."""
        self.coalesced_batches += 1
        self.coalesced_requests += n_requests
        self.batch_sizes.append(n_requests)
        self.fill_ratios.append(n_requests / capacity if capacity else 0.0)
        self.queue_latency_s.extend(latencies)

    def fill_ratio(self) -> float:
        """Mean batch-fill ratio (requests per batch / max_batch) over the
        rolling window; 0.0 before any batch has run."""
        if not self.fill_ratios:
            return 0.0
        return sum(self.fill_ratios) / len(self.fill_ratios)

    def latency_percentiles(self, ps=(50, 90, 99)) -> Dict[int, float]:
        """{percentile: seconds} over the rolling queue-latency window
        (time from ``submit_async`` to batch execution start)."""
        lat = sorted(self.queue_latency_s)
        if not lat:
            return {p: 0.0 for p in ps}
        return {
            p: lat[min(len(lat) - 1, round(p / 100 * (len(lat) - 1)))] for p in ps
        }


class _Request:
    """One admitted request riding the queue to its micro-batch."""

    __slots__ = ("key", "req", "val", "future", "t_enq")

    def __init__(self, key, req, val, t_enq):
        self.key = key
        self.req = req
        self.val = val
        self.future: Future = Future()
        self.t_enq = t_enq


class AsyncSortService:
    """Micro-batching async front door over a ``SortService``.

    Parameters
    ----------
    service:      the ``SortService`` to execute on (shares its executable
                  cache with sync callers); a fresh one on ``device`` by
                  default.
    max_batch:    flush a (kind, bucket, dtype) group as soon as it holds this
                  many requests.
    max_delay_ms: flush a group at latest this long after its *oldest* request
                  arrived — the latency bound a half-empty batch waits for.
    min_delay_ms: opt into the adaptive flush window: a ``DelayController``
                  moves the effective delay within
                  ``[min_delay_ms, max_delay_ms]`` from observed fill
                  (``None`` = fixed window, the prior behaviour).
    maxsize:      bound on admitted-but-unexecuted requests (0 = unbounded).
    on_full:      'block' stalls producers while the queue is full;
                  'reject' raises ``queue.Full`` at the ``submit_async`` site.
    start:        launch the dispatcher thread immediately (tests pass False
                  to stage traffic deterministically, then call ``start()``).
    clock:        monotonic time source for every batching decision — enqueue
                  stamps, flush deadlines, latencies, delay adaptation.
                  Inject ``repro_torch.engine.adapt.ManualClock`` to make
                  queue timing fully deterministic in tests.
    device:       the device of a fresh service (the card by default; a
                  CUDA device with no card raises).

    >>> import numpy as np
    >>> with AsyncSortService(max_batch=4, max_delay_ms=5.0, device="cpu") as svc:
    ...     futs = [svc.submit_async(np.array([3, 1, 2], np.int32))
    ...             for _ in range(4)]
    ...     sorted_first = [int(v) for v in futs[0].result()]
    >>> sorted_first
    [1, 2, 3]
    """

    def __init__(
        self,
        service: Optional[SortService] = None,
        *,
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        min_delay_ms: Optional[float] = None,
        maxsize: int = 1024,
        on_full: str = "block",
        start: bool = True,
        planner: Optional[Planner] = None,
        clock: Callable[[], float] = time.monotonic,
        device="cuda",
    ):
        if on_full not in ("block", "reject"):
            raise ValueError("on_full must be 'block' or 'reject'")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.service = (
            service if service is not None else SortService(planner=planner, device=device)
        )
        # widen the service's counters in place: _run_group keeps accounting
        # into the same object, so sync and async traffic share one ledger
        if not isinstance(self.service.stats, QueueStats):
            self.service.stats = QueueStats(**vars(self.service.stats))
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self._clock = clock
        self.delay: Optional[DelayController] = (
            None
            if min_delay_ms is None
            else DelayController(float(min_delay_ms), float(max_delay_ms), clock=clock)
        )
        self.on_full = on_full
        self._q: _stdqueue.Queue = _stdqueue.Queue(maxsize=maxsize)
        self._pending: Dict[tuple, List[_Request]] = {}
        self._deadlines: Dict[tuple, float] = {}
        self._outstanding = 0
        self._admitting = 0  # submits between their closed-check and their put
        self._done = threading.Condition()
        self._closed = False
        self._stop = threading.Event()
        self._started = False
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="AsyncSortService", daemon=True
        )
        if start:
            self.start()

    # ----------------------------------------------------------- lifecycle ---
    @property
    def stats(self) -> QueueStats:
        """The shared (sync + async) ``QueueStats`` ledger."""
        return self.service.stats

    def start(self) -> "AsyncSortService":
        """Launch the dispatcher thread (idempotent)."""
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    @property
    def delay_s(self) -> float:
        """The effective coalescing window: the controller's current value
        when adaptive, else the fixed ``max_delay_ms``."""
        return self.delay.delay_s if self.delay is not None else self.max_delay_s

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has resolved (or ``timeout``
        wall-clock seconds elapse — real time even under an injected clock,
        so a frozen test clock can't hang a drain forever). Returns True
        when fully drained."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._done:
            while self._outstanding > 0:
                wait = None if deadline is None else deadline - time.perf_counter()
                if wait is not None and wait <= 0:
                    return False
                self._done.wait(timeout=wait)
        return True

    def close(self, *, drain: bool = True) -> None:
        """Stop accepting requests; optionally drain, then join the
        dispatcher. Idempotent; later ``submit_async`` raises RuntimeError.

        The stop signal is raised *before* draining so the dispatcher flushes
        half-empty batches immediately instead of waiting out ``max_delay``.
        """
        with self._done:
            self._closed = True
            # wait for submits that passed the closed-check to land their
            # put — after this, the queue's contents are final and the
            # dispatcher (which only exits once the queue is empty) will
            # serve every admitted request before stopping
            while self._admitting > 0:
                self._done.wait()
        self._stop.set()
        if drain:
            self.start()  # a never-started service must still resolve backlog
            self.drain()
        if self._started:
            self._thread.join(timeout=30)
        # belt-and-braces: fail anything somehow still queued after the
        # dispatcher has exited rather than strand its future
        while True:
            try:
                item = self._q.get_nowait()
            except _stdqueue.Empty:
                break
            if item.future.set_running_or_notify_cancel():
                item.future.set_exception(RuntimeError("AsyncSortService is closed"))
            self._mark_done(1)

    def __enter__(self) -> "AsyncSortService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- submit ---
    def submit_async(
        self,
        keys: np.ndarray,
        *,
        kind: str = "sort",
        values: Optional[np.ndarray] = None,
        ascending: bool = True,
    ) -> Future:
        """Enqueue one 1-D request; returns a Future of the same per-request
        result ``SortService.submit`` would produce (sorted keys, argsort
        indices, or a (keys, values) pair for kind='sort_kv').

        Validation errors raise here, synchronously, on the caller's thread;
        execution errors resolve the Future exceptionally.  With
        ``on_full='reject'`` a full queue raises ``queue.Full``.
        """
        reqs, vals = self.service._validate(
            kind, [keys], [values] if values is not None else None
        )
        # snapshot the caller's buffers: the dispatcher pads them up to
        # max_delay_ms later, and an async caller may legitimately reuse or
        # mutate its array the moment submit_async returns
        req = np.array(reqs[0], copy=True)
        val = np.array(vals[0], copy=True) if vals is not None else None
        gk = self.service._group_key(req, val)
        item = _Request((kind, bool(ascending)) + gk, req, val, self._clock())
        # the closed-check and the admission counter are one atom with
        # respect to close(): close() flips _closed under this lock, then
        # waits for in-flight admissions to land their put before it lets
        # the dispatcher exit — so no put can strand behind a dead dispatcher
        with self._done:
            if self._closed:
                raise RuntimeError("AsyncSortService is closed")
            self._admitting += 1
            self._outstanding += 1
            self.stats.enqueued += 1
        try:
            self._q.put(item, block=self.on_full == "block")
        except _stdqueue.Full:
            with self._done:
                self._outstanding -= 1
                self.stats.enqueued -= 1
                self.stats.rejected += 1
            raise
        finally:
            with self._done:
                self._admitting -= 1
                self._done.notify_all()
        # re-stamp at admission: a producer that sat out a blocking put must
        # not carry a pre-expired flush deadline into the dispatcher (the
        # coalescing window starts when coalescing *can* start). Benign race:
        # if the dispatcher already grabbed the item, it saw the submit-time
        # stamp — a slightly early deadline, never a stuck one.
        item.t_enq = self._clock()
        # only admitted requests count as arrivals: rejected/closed submits
        # must not inflate the adaptive controller's rate estimate
        if self.delay is not None:
            self.delay.note_arrival()
        return item.future

    # ---------------------------------------------------------- dispatcher ---
    def _dispatch_loop(self) -> None:
        self.service._enter_device()
        poll = 0.05
        while not (self._stop.is_set() and self._q.empty() and not self._pending):
            wait = poll
            if self._pending:
                now = self._clock()
                wait = max(0.0, min(min(self._deadlines.values()) - now, poll))
            try:
                items = [self._q.get(timeout=wait)]
            except _stdqueue.Empty:
                items = []
            # drain everything already admitted before looking at deadlines:
            # requests that queued up while a batch was executing must join
            # one group, not flush as a string of expired singletons
            while True:
                try:
                    items.append(self._q.get_nowait())
                except _stdqueue.Empty:
                    break
            for item in items:
                group = self._pending.setdefault(item.key, [])
                group.append(item)
                # the deadline snapshots the *current* adaptive window when
                # the group opens, so one flush decision uses one delay value
                self._deadlines.setdefault(item.key, item.t_enq + self.delay_s)
                if len(group) >= self.max_batch:
                    self._flush(item.key, cause="full")
            now = self._clock()
            for key in [k for k, d in self._deadlines.items() if d <= now]:
                self._flush(key, cause="deadline")
            if self._stop.is_set() and self._q.empty():
                for key in list(self._pending):
                    self._flush(key, cause="close")
        for key in list(self._pending):  # safety: never strand a future
            self._flush(key, cause="close")

    def _flush(self, key: tuple, *, cause: str = "deadline") -> None:
        all_items = self._pending.pop(key, [])
        self._deadlines.pop(key, None)
        # a caller-cancelled future must neither run nor poison set_result
        items = [it for it in all_items if it.future.set_running_or_notify_cancel()]
        if len(items) < len(all_items):
            self._mark_done(len(all_items) - len(items))
        if not items:
            return
        if self.delay is not None and cause != "close":
            # adapt the window to what this flush revealed; lifecycle
            # flushes at close say nothing about the arrival process
            self.delay.observe_flush(
                n_requests=len(items),
                capacity=self.max_batch,
                deadline_hit=cause == "deadline",
            )
        kind, ascending = key[0], key[1]
        reqs = [it.req for it in items]
        vals = [it.val for it in items] if kind == "sort_kv" else None
        t_exec = self._clock()
        try:
            results = self.service._run_group(
                kind, key[2:], reqs, vals, ascending=ascending
            )
        except Exception as e:  # execution failure -> every member future
            for it in items:
                it.future.set_exception(e)
            self._mark_done(len(items))
            return
        with self.service._lock:
            self.stats.observe_batch(
                n_requests=len(items),
                capacity=self.max_batch,
                latencies=[t_exec - it.t_enq for it in items],
            )
        for it, res in zip(items, results):  # arrival order within the batch
            it.future.set_result(res)
        self._mark_done(len(items))

    def _mark_done(self, n: int) -> None:
        with self._done:
            self._outstanding -= n
            self._done.notify_all()
