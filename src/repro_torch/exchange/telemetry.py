"""Exchange telemetry: the observation schema and the thread-safe ledger.

Counterpart of ``repro/exchange/telemetry.py``, kept as it is there: it
does no tensor work.  Every adaptive exchange call (model-D
``cluster_sort`` / ``cluster_sort_kv``) reports one ``ExchangeObservation``
per call (max observed per-(sender, bucket) count, overflow/retry/drop
events) into an ``ExchangeTelemetry`` ledger keyed by plan-cache cell,
from which the engine learns capacity factors.  In the port ``recompiles``
is always 0: nothing is compiled per capacity.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["ExchangeObservation", "ExchangeTelemetry"]


@dataclass(frozen=True)
class ExchangeObservation:
    """One exchange call's telemetry (sort or MoE dispatch).

    ``peak`` is the max per-(sender, bucket) element count observed across
    the mesh — the quantity slab capacity must cover.  ``required_factor``
    converts it back into the smallest ``capacity_factor`` whose
    ``slab_capacity`` would have fit the call without overflow.  For MoE
    dispatch the fields read: m = tokens x top_k assignments per sender,
    part_buckets = n_experts, peak = hottest expert's per-sender token
    count, and ``dropped`` counts tokens an overflowed attempt dropped
    (averted by the retry on the adaptive path, real output drops on the
    fixed-capacity path).

    >>> obs = ExchangeObservation(m=128, part_buckets=8, capacity=32,
    ...                           peak=48, overflowed=True, retries=1)
    >>> obs.required_factor()
    3.0
    >>> obs.peak_mean_ratio()              # 3x the mean bucket load: skewed
    3.0
    >>> obs.dropped, obs.dropped_averted   # sorts never drop; MoE may
    (0, 0)
    >>> obs.partition is None              # caller didn't tag the family
    True
    """

    m: int                  # per-shard element count
    part_buckets: int       # buckets the partitioner emits
    capacity: int           # slab capacity of the final (successful) attempt
    peak: int               # max per-(src, dst) bucket count seen
    overflowed: bool        # any attempt overflowed
    retries: int            # capacity-doubling retries this call paid
    recompiles: int = 0     # fresh executables those retries compiled
    dropped: int = 0        # elements the *served* output lost (MoE fixed /
    #                         retry-exhausted path: final attempt overflowed)
    dropped_averted: int = 0  # elements retried attempts would have lost
    #                           (recomputed loss-free, so not in the output)
    partition: Optional[str] = None  # partition family that produced the
    #                                  bucket ids ("radix"/"sample"); None for
    #                                  callers outside the policy (e.g. MoE,
    #                                  where the router is the partitioner)

    def required_factor(self) -> float:
        """Smallest ``capacity_factor`` that fits ``peak`` without overflow."""
        return self.peak * self.part_buckets / max(self.m, 1)

    def peak_mean_ratio(self) -> float:
        """Peak bucket load over the mean bucket load (``m / part_buckets``).

        The skew signal: 1.0 is a perfectly balanced partition, and the
        ``CapacityLearner`` promotes a persistently-radix key to the sample
        partition when this stays above its ``promote_ratio``.  Numerically
        identical to ``required_factor`` — capacity need *is* peak/mean —
        but named for what promotion decisions actually read.

        >>> ExchangeObservation(m=64, part_buckets=8, capacity=16, peak=8,
        ...                     overflowed=False, retries=0).peak_mean_ratio()
        1.0
        """
        return self.required_factor()


class ExchangeTelemetry:
    """Thread-safe ledger of exchange observations, keyed by plan-cache cell.

    Keeps a bounded rolling window of observations per key plus lifetime
    totals (calls, overflow events, retries, recompiles, dropped elements)
    so long-lived serving processes report recent behaviour and cumulative
    cost.

    >>> led = ExchangeTelemetry()
    >>> led.record("4096|int32|local/cpu", ExchangeObservation(
    ...     m=128, part_buckets=8, capacity=32, peak=48,
    ...     overflowed=True, retries=1))
    >>> led.last("4096|int32|local/cpu").retries
    1
    >>> led.overflow_events, led.total_retries, led.total_dropped
    (1, 1, 0)
    """

    def __init__(self, window: int = 256):
        self._window = window
        self._obs: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._subscribers: list = []
        self.calls = 0
        self.overflow_events = 0
        self.total_retries = 0
        self.total_recompiles = 0
        self.total_dropped = 0
        self.total_dropped_averted = 0

    def subscribe(self, fn) -> None:
        """Register ``fn(key, obs)`` to run after every ``record``.

        Subscribers run outside the ledger lock (they may read the ledger
        back).  This is how ``AnomalyMonitor.watch_exchange`` folds served
        MoE drops into the routing-collapse signal without the exchange
        layer importing the fault-tolerance layer.
        """
        with self._lock:
            self._subscribers.append(fn)

    def record(self, key: str, obs: ExchangeObservation) -> None:
        with self._lock:
            self._obs.setdefault(key, deque(maxlen=self._window)).append(obs)
            self.calls += 1
            self.overflow_events += int(obs.overflowed)
            self.total_retries += obs.retries
            self.total_recompiles += obs.recompiles
            self.total_dropped += obs.dropped
            self.total_dropped_averted += obs.dropped_averted
            subscribers = list(self._subscribers)
        for fn in subscribers:
            fn(key, obs)

    def last(self, key: str) -> Optional[ExchangeObservation]:
        """Most recent observation for ``key`` (None before any call)."""
        with self._lock:
            window = self._obs.get(key)
            return window[-1] if window else None

    def peak_factor(self, key: str) -> float:
        """Largest ``required_factor`` in ``key``'s rolling window (0.0 if
        the key has never been observed)."""
        with self._lock:
            window = self._obs.get(key, ())
            return max((o.required_factor() for o in window), default=0.0)

    def last_ratio(self, key: str) -> float:
        """Most recent ``peak_mean_ratio`` for ``key`` (0.0 before any call).

        The per-key skew signal promotion decisions read — exposed here so
        operators and tests observe it without touching learner internals.
        """
        obs = self.last(key)
        return obs.peak_mean_ratio() if obs is not None else 0.0

    def keys(self):
        with self._lock:
            return sorted(self._obs)
