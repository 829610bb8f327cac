"""SLO-aware multi-tenant scheduler over the batched sort service.

Counterpart of ``repro/engine/frontend/scheduler.py``; the dispatcher
thread enters the service's device before its first batch.

``AsyncSortService`` (repro_torch.engine.queue) batches well but treats every
caller identically: one FIFO, one flush window, block-or-reject
backpressure.  A serving front end shared by multiple tenants needs three
things that FIFO can't give:

* **priority classes** — an interactive tenant's requests must dispatch
  before a batch tenant's, full stop;
* **deadline-based dispatch** — within a priority class, the request
  closest to missing its SLO runs first (EDF, the classic optimal
  single-server policy for feasible deadline sets);
* **an explicit load-shed policy** — when the bounded backlog saturates,
  *somebody* must be told "no", immediately, with a reason, and the refusal
  must be attributed to the right tenant (``QueueStats.shed``) instead of
  silently inflating everyone's tail latency.

``SortFrontend`` implements exactly that on top of ``SortService``'s
group/pad/execute core: requests are admitted against per-tenant weighted
backlog bounds (each tenant's guaranteed slice of ``maxsize`` is
proportional to its weight), dispatch picks the most urgent pending request
(priority class, then earliest deadline, then arrival order) and coalesces
every compatible pending request — across tenants — into one executable
batch behind it.  Expired requests are shed at dispatch rather than
executed (configurable: serving paths that must answer every request pass
``shed_expired=False`` and count the SLO miss instead).

Like the rest of the engine, all timing flows through an injectable clock:
tests and the open-loop load harness (``repro_torch.engine.frontend.loadgen``)
drive dispatch deterministically on a ``ManualClock`` via ``pump()``;
production wraps the same core in a background dispatcher thread
(``start()`` / ``close()``).
"""
from __future__ import annotations

import math
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..queue import QueueStats
from ..service import SortService
from .warmup import WarmupReport, warmup

__all__ = ["Tenant", "ShedError", "Ticket", "BatchInfo", "SortFrontend"]

_INF = float("inf")


@dataclass(frozen=True)
class Tenant:
    """One tenant's serving contract.

    ``priority`` is a strict class (lower dispatches first); ``weight``
    apportions the bounded backlog — tenant i's guaranteed admission slice
    is ``ceil(weight_i / total_weight * maxsize)`` requests; ``slo_ms`` is
    the default deadline budget stamped on its requests at submit.

    >>> Tenant("interactive", weight=3.0, priority=0, slo_ms=50.0).name
    'interactive'
    """

    name: str
    weight: float = 1.0
    priority: int = 0
    slo_ms: Optional[float] = None
    max_backlog: Optional[int] = None  # explicit override of the weighted slice

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("tenant weight must be positive")
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError("slo_ms must be positive (or None for no SLO)")


class ShedError(RuntimeError):
    """A request the frontend refused (admission) or expired (dispatch).

    ``reason`` is machine-readable: ``'tenant_backlog'`` (the tenant's
    weighted backlog slice is full), ``'global_backlog'`` (the whole bounded
    backlog is full), or ``'deadline'`` (the request expired in queue before
    dispatch).  The same (tenant, reason) pair lands in
    ``QueueStats.shed`` so overload is attributable after the fact.

    >>> ShedError("batch", "tenant_backlog").reason
    'tenant_backlog'
    """

    def __init__(self, tenant: str, reason: str):
        super().__init__(f"request shed for tenant {tenant!r}: {reason}")
        self.tenant = tenant
        self.reason = reason


class Ticket:
    """One admitted request: a Future plus its SLO bookkeeping.

    ``result()`` / ``done()`` delegate to the underlying Future; ``t_submit``
    / ``t_done`` are stamps on the frontend's injected clock, so
    ``latency_s`` and ``slo_met`` are deterministic under ``ManualClock``.

    >>> import numpy as np
    >>> fe = SortFrontend(tenants=[Tenant("t")], start=False, device="cpu")
    >>> t = fe.submit("t", np.array([3, 1, 2], np.int32))
    >>> fe.poll()                      # one pumped batch
    1
    >>> [int(v) for v in t.result()], t.slo_met   # no SLO -> trivially met
    ([1, 2, 3], True)
    """

    __slots__ = ("tenant", "t_submit", "deadline", "t_done", "future")

    def __init__(self, tenant: str, t_submit: float, deadline: float):
        self.tenant = tenant
        self.t_submit = t_submit
        self.deadline = deadline  # absolute clock time; inf = no SLO
        self.t_done: Optional[float] = None
        self.future: Future = Future()

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout=timeout)

    def done(self) -> bool:
        return self.future.done()

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-resolution time on the frontend clock (None while
        pending or if the request was shed)."""
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def slo_met(self) -> bool:
        """Completed (not shed) at or before its deadline."""
        return (
            self.t_done is not None
            and not self.future.exception()
            and self.t_done <= self.deadline
        )


@dataclass(frozen=True)
class BatchInfo:
    """What one ``pump()`` dispatched: the load harness's cost-model input.

    >>> BatchInfo(n_requests=4, bucket=1024, kind="sort",
    ...           tenants=("a", "b")).n_requests
    4
    """

    n_requests: int
    bucket: int
    kind: str
    tenants: Tuple[str, ...]


class _Pending:
    __slots__ = ("tenant", "priority", "deadline", "seq", "sig", "req", "val",
                 "ticket")

    def __init__(self, tenant, priority, deadline, seq, sig, req, val, ticket):
        self.tenant = tenant
        self.priority = priority
        self.deadline = deadline
        self.seq = seq
        self.sig = sig  # (kind, ascending) + service group key
        self.req = req
        self.val = val
        self.ticket = ticket

    @property
    def urgency(self):
        return (self.priority, self.deadline, self.seq)


class SortFrontend:
    """Multi-tenant, SLO-aware front door over one ``SortService``.

    Parameters
    ----------
    service:      the ``SortService`` to execute on (shares its cell cache —
                  and hence its warmup — with every other path); a fresh one
                  on ``device`` by default.
    tenants:      the serving contracts; submits for unknown tenants raise.
    max_batch:    coalescing cap per dispatched batch.
    maxsize:      bound on admitted-but-undispatched requests across all
                  tenants; each tenant's guaranteed slice is its weighted
                  share (see ``Tenant``).
    shed_expired: shed requests whose deadline passed before dispatch
                  (``ShedError('deadline')`` on the ticket's future) instead
                  of executing them late.  Serving paths that must answer
                  every request pass False and count the SLO miss.
    clock:        monotonic time source for every admission/dispatch/SLO
                  decision (``ManualClock`` in tests and simulations).
    start:        launch the background dispatcher thread.  The default is
                  False: pump-driven operation (``pump()`` / ``poll()``) is
                  the deterministic mode the load harness and tests use.
    device:       the device of a fresh service (the card by default; a
                  CUDA device with no card raises).

    >>> import numpy as np
    >>> fe = SortFrontend(tenants=[Tenant("web", priority=0),
    ...                            Tenant("batch", priority=1)], device="cpu")
    >>> t1 = fe.submit("batch", np.array([2, 1], np.int32))
    >>> t2 = fe.submit("web", np.array([4, 3], np.int32))
    >>> fe.pump().tenants   # web's priority class leads; batch coalesces in
    ('web', 'batch')
    >>> [int(v) for v in t2.result()]
    [3, 4]
    """

    def __init__(
        self,
        service: Optional[SortService] = None,
        *,
        tenants: Sequence[Tenant],
        max_batch: int = 16,
        maxsize: int = 256,
        shed_expired: bool = True,
        clock=time.monotonic,
        start: bool = False,
        poll_interval_s: float = 0.002,
        device="cuda",
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.service = service if service is not None else SortService(device=device)
        if not isinstance(self.service.stats, QueueStats):
            # widen in place, same trick as AsyncSortService: one shared ledger
            self.service.stats = QueueStats(**vars(self.service.stats))
        self.tenants: Dict[str, Tenant] = {}
        for t in tenants:
            if t.name in self.tenants:
                raise ValueError(f"duplicate tenant {t.name!r}")
            self.tenants[t.name] = t
        if not self.tenants:
            raise ValueError("need at least one tenant")
        total_w = sum(t.weight for t in self.tenants.values())
        self._bounds = {
            t.name: (
                t.max_backlog
                if t.max_backlog is not None
                else max(1, math.ceil(t.weight / total_w * maxsize))
            )
            for t in self.tenants.values()
        }
        self.max_batch = int(max_batch)
        self.maxsize = int(maxsize)
        self.shed_expired = shed_expired
        self._clock = clock
        self._poll_s = poll_interval_s
        self._pending: List[_Pending] = []
        self._per_tenant: Dict[str, int] = {name: 0 for name in self.tenants}
        self._seq = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._closed = False
        self._started = False
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="SortFrontend", daemon=True
        )
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle ---
    @property
    def stats(self) -> QueueStats:
        """The shared service ledger (batches, sheds, per-tenant tallies)."""
        return self.service.stats

    def backlog(self, tenant: Optional[str] = None) -> int:
        """Admitted-but-undispatched requests (for one tenant, or all)."""
        with self._lock:
            if tenant is not None:
                return self._per_tenant[tenant]
            return len(self._pending)

    def tenant_backlog_bound(self, tenant: str) -> int:
        """The tenant's guaranteed admission slice of ``maxsize``."""
        return self._bounds[tenant]

    def warmup(self, **kwargs) -> WarmupReport:
        """Warm this frontend's service for its own batch ladder
        (``repro_torch.engine.frontend.warmup`` with ``max_batch`` defaulted to the
        scheduler's — every batch shape a pump can flush is warmed first)."""
        kwargs.setdefault("max_batch", self.max_batch)
        return warmup(self.service, **kwargs)

    def start(self) -> "SortFrontend":
        """Launch the background dispatcher thread (idempotent)."""
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop admission, drain the backlog, stop the dispatcher thread."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._work.notify_all()
        if self._started:
            self._thread.join(timeout=30)
        self.run_until_idle()  # pump-mode users: drain synchronously

    def __enter__(self) -> "SortFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- submit ---
    def submit(
        self,
        tenant: str,
        keys: np.ndarray,
        *,
        kind: str = "sort",
        values: Optional[np.ndarray] = None,
        ascending: bool = True,
        deadline: Optional[float] = None,
    ) -> Ticket:
        """Admit one request for ``tenant``; returns a ``Ticket``.

        ``deadline`` is an absolute time on the frontend clock; omitted, it
        defaults to ``now + tenant.slo_ms`` (or no deadline for tenants
        without an SLO).  Validation errors raise synchronously; admission
        refusals raise ``ShedError`` with the reason and are attributed to
        the tenant in ``QueueStats.shed``.
        """
        cfg = self.tenants.get(tenant)
        if cfg is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        reqs, vals = self.service._validate(
            kind, [keys], [values] if values is not None else None
        )
        req = np.array(reqs[0], copy=True)  # snapshot the caller's buffers
        val = np.array(vals[0], copy=True) if vals is not None else None
        sig = (kind, bool(ascending)) + self.service._group_key(req, val)
        now = self._clock()
        if deadline is None:
            deadline = now + cfg.slo_ms / 1e3 if cfg.slo_ms is not None else _INF
        with self._lock:
            if self._closed:
                raise RuntimeError("SortFrontend is closed")
            if len(self._pending) >= self.maxsize:
                self.stats.observe_shed(tenant, "global_backlog")
                raise ShedError(tenant, "global_backlog")
            if self._per_tenant[tenant] >= self._bounds[tenant]:
                self.stats.observe_shed(tenant, "tenant_backlog")
                raise ShedError(tenant, "tenant_backlog")
            ticket = Ticket(tenant, now, deadline)
            self._pending.append(
                _Pending(tenant, cfg.priority, deadline, self._seq, sig,
                         req, val, ticket)
            )
            self._seq += 1
            self._per_tenant[tenant] += 1
            self.stats.enqueued += 1
            self._work.notify_all()
        return ticket

    # ------------------------------------------------------------ dispatch ---
    def _shed_expired_locked(self, now: float) -> None:
        keep: List[_Pending] = []
        for p in self._pending:
            if p.deadline < now:
                self._per_tenant[p.tenant] -= 1
                self.stats.observe_shed(p.tenant, "deadline")
                p.ticket.t_done = now
                if p.ticket.future.set_running_or_notify_cancel():
                    p.ticket.future.set_exception(
                        ShedError(p.tenant, "deadline")
                    )
            else:
                keep.append(p)
        self._pending = keep

    def pump(self) -> Optional[BatchInfo]:
        """Dispatch the single most urgent batch; None if nothing is pending.

        Selection: shed expired requests (when ``shed_expired``), pick the
        pending request with the best ``(priority, deadline, arrival)``
        urgency, then coalesce every compatible pending request — same
        (kind, direction, length bucket, dtype) signature, any tenant — in
        urgency order up to ``max_batch``, and execute the batch through the
        service's shared pad/plan/execute core.
        """
        now = self._clock()
        with self._lock:
            if self.shed_expired:
                self._shed_expired_locked(now)
            if not self._pending:
                return None
            head = min(self._pending, key=lambda p: p.urgency)
            mates = sorted(
                (p for p in self._pending if p.sig == head.sig),
                key=lambda p: p.urgency,
            )[: self.max_batch]
            taken = set(id(p) for p in mates)
            self._pending = [p for p in self._pending if id(p) not in taken]
            for p in mates:
                self._per_tenant[p.tenant] -= 1

        kind, ascending = head.sig[0], head.sig[1]
        gk = head.sig[2:]
        reqs = [p.req for p in mates]
        vals = [p.val for p in mates] if kind == "sort_kv" else None
        live = [p for p in mates
                if p.ticket.future.set_running_or_notify_cancel()]
        if not live:
            return BatchInfo(0, gk[0], kind, ())
        try:
            results = self.service._run_group(
                kind, gk, reqs, vals, ascending=ascending
            )
        except Exception as e:
            t_done = self._clock()
            for p in live:
                p.ticket.t_done = t_done
                p.ticket.future.set_exception(e)
            return BatchInfo(len(live), gk[0], kind, tuple(p.tenant for p in live))
        t_done = self._clock()
        with self.service._lock:
            self.stats.observe_batch(
                n_requests=len(live),
                capacity=self.max_batch,
                latencies=[t_done - p.ticket.t_submit for p in live],
            )
            for p in live:
                self.stats.tenant_served[p.tenant] = (
                    self.stats.tenant_served.get(p.tenant, 0) + 1
                )
        by_id = {id(p): r for p, r in zip(mates, results)}
        for p in live:
            p.ticket.t_done = t_done
            p.ticket.future.set_result(by_id[id(p)])
        return BatchInfo(len(live), gk[0], kind, tuple(p.tenant for p in live))

    def poll(self) -> int:
        """Pump until nothing is dispatchable; returns batches executed."""
        n = 0
        while self.pump() is not None:
            n += 1
        return n

    run_until_idle = poll

    def _dispatch_loop(self) -> None:
        self.service._enter_device()
        while True:
            info = self.pump()
            if info is not None:
                continue
            with self._lock:
                if self._closed and not self._pending:
                    return
                if not self._pending:
                    # poll-bounded wait: deadline sheds need periodic wakeups
                    self._work.wait(timeout=self._poll_s)
