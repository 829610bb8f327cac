"""Closed-loop adaptive tuning — learn knobs from observed runtime behaviour.

Counterpart of ``repro/engine/adapt.py``, kept as it is there: it does no
tensor work.  Two feedback loops, both deterministic and clock-injectable:

**Capacity learning** (model D).  Without it, every exchange call re-learns
slab capacity the hard way: overflow, double ``capacity_factor``, retry —
then throws the lesson away.  Here every call reports an
``ExchangeObservation`` (max observed per-(src, dst) bucket count,
overflow/retry events — the schema lives in ``repro_torch.exchange.telemetry``)
into an ``ExchangeTelemetry`` ledger keyed by plan-cache cell, and a
``CapacityLearner`` folds the history into a learned ``capacity_factor``:
jump to ``observed peak x safety margin`` the moment a call needs more than
the current factor, decay geometrically back toward the default while
traffic stays mild.  The ``Planner`` persists the learned factors through
its JSON plan cache, so a restarted serving process sizes slabs right on
its **first** call — zero overflow retries in steady state.

**Adaptive flush window** (async serving).  ``DelayController`` owns the
``AsyncSortService`` coalescing deadline: it tracks rolling arrival rate
and per-flush fill ratio, shrinks the window when batches fill before the
deadline (the queue is adding latency for no extra fill), and grows it when
deadline flushes run sparse (a longer wait would amortize better) — always
within ``[min_delay_ms, max_delay_ms]``.

Every decision consumes an injectable monotonic ``clock`` (``ManualClock``
for tests), so adaptation is reproducible step by step — no wall-clock
dependence anywhere in the loop.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Callable, Optional

from repro_torch.exchange import ExchangeObservation, ExchangeTelemetry  # noqa: F401
# ^ the observation schema + ledger live in the exchange layer; re-exported
#   here, as the reference does, for the learning loop's consumers

__all__ = [
    "CapacityLearner",
    "DelayController",
    "ExchangeObservation",
    "ExchangeTelemetry",
    "LearnedCapacity",
    "ManualClock",
]


class ManualClock:
    """Deterministic monotonic clock for tests and doctests.

    Inject it wherever a ``clock=`` is accepted; time only moves when the
    test calls ``advance``, so every timing decision replays exactly.

    >>> clock = ManualClock()
    >>> clock()
    0.0
    >>> clock.advance(1.5)
    1.5
    >>> clock()
    1.5
    """

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds (never backward)."""
        if dt < 0:
            raise ValueError("a monotonic clock cannot go backward")
        self.t += dt
        return self.t


@dataclass(frozen=True)
class LearnedCapacity:
    """One plan-cache cell's learned capacity state (persisted as JSON).

    >>> LearnedCapacity.from_dict(
    ...     LearnedCapacity(3.75, 3.0, 7).to_dict()).capacity_factor
    3.75
    """

    capacity_factor: float   # the factor the planner now hands out
    peak_factor: float       # largest required_factor ever observed (audit)
    observations: int        # how many calls fed this cell
    partition: Optional[str] = None  # promoted partition family ("sample"
    #                                  once skew promotion latches; None =
    #                                  follow the plan's own mode)
    skew_strikes: int = 0    # consecutive high-skew radix observations —
    #                          the promotion counter (resets on a calm call)
    calm_streak: int = 0     # consecutive calm sample-era observations on a
    #                          promoted cell — the slow probation counter
    #                          that eventually demotes it back to radix
    demotions: int = 0       # how many times this cell has been demoted —
    #                          a generation counter that makes demotion
    #                          survive merges with stale promoted entries

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "LearnedCapacity":
        return cls(
            capacity_factor=float(d["capacity_factor"]),
            peak_factor=float(d.get("peak_factor", 0.0)),
            observations=int(d.get("observations", 0)),
            partition=d.get("partition"),
            skew_strikes=int(d.get("skew_strikes", 0)),
            calm_streak=int(d.get("calm_streak", 0)),
            demotions=int(d.get("demotions", 0)),
        )

    def merge(self, other: "LearnedCapacity") -> "LearnedCapacity":
        """Combine two entries for the same cell from concurrent writers.

        The **more-informed lineage wins** the factor: lexicographic max on
        ``(observations, capacity_factor)``.  ``observations`` grows
        monotonically within one planner's lineage, so a writer always
        supersedes its *own* earlier persisted state — geometric decay back
        toward the default survives the merge instead of being pinned by a
        stale high-water entry.  Between genuinely concurrent writers the
        one that has seen more traffic wins, and at equal observation counts
        the higher (more conservative) factor does — under-provisioning is
        the expensive error.  ``peak_factor`` is a lifetime max by
        definition, and ``observations`` takes max rather than sum because
        concurrent counts share lineage through the persisted file — summing
        would double-count on every merge.  The partition state merges as a
        lexicographic max on ``(demotions, partition rank)`` where rank is
        ``None < "radix" < "sample"``: *within one demotion generation* the
        promotion latch is monotone — a concurrent writer that hasn't seen
        the skew yet can't demote a promoted cell — while an explicit
        calm-streak demotion bumps ``demotions`` and therefore wins over
        every stale promoted entry from the previous generation (a laggard
        writer re-saving its old ``partition="sample"`` cannot flap a
        demoted cell back).  ``skew_strikes``/``calm_streak`` take max for
        the same shared-lineage reason as ``observations``.  All components
        are commutative, associative, and idempotent, so any interleaving of
        rank saves converges to the same entry (property-tested in
        tests/test_plan_cache_concurrency.py for the reference, and held
        against it in tests/test_torch_adapt.py).

        >>> LearnedCapacity(3.0, 2.5, 4).merge(LearnedCapacity(2.0, 3.0, 9))
        ... # doctest: +NORMALIZE_WHITESPACE
        LearnedCapacity(capacity_factor=2.0, peak_factor=3.0, observations=9,
                        partition=None, skew_strikes=0, calm_streak=0,
                        demotions=0)
        >>> e = LearnedCapacity(3.0, 2.5, 9).merge(LearnedCapacity(2.0, 3.0, 9))
        >>> e.capacity_factor                    # tie on observations: higher
        3.0
        >>> LearnedCapacity(2.0, 2.0, 1, partition="sample").merge(
        ...     LearnedCapacity(9.0, 9.0, 9)).partition   # promotion latches
        'sample'
        >>> LearnedCapacity(2.0, 2.0, 9, demotions=1).merge(   # a demotion
        ...     LearnedCapacity(2.0, 2.0, 1, partition="sample")   # is a newer
        ... ).partition is None          # generation: stale promotion loses
        True
        """
        a, b = (self.observations, self.capacity_factor), (
            other.observations,
            other.capacity_factor,
        )
        win = self if a >= b else other
        rank = {None: 0, "radix": 1, "sample": 2}
        ps = (self.demotions, rank.get(self.partition, 0))
        po = (other.demotions, rank.get(other.partition, 0))
        if ps == po:  # same generation + family: counters share lineage
            part, demotions = self.partition, self.demotions
            strikes = max(self.skew_strikes, other.skew_strikes)
            calm = max(self.calm_streak, other.calm_streak)
        else:  # newer generation (or higher latch within it) wins outright
            src = self if ps > po else other
            part, demotions = src.partition, src.demotions
            strikes, calm = src.skew_strikes, src.calm_streak
        return LearnedCapacity(
            capacity_factor=win.capacity_factor,
            peak_factor=max(self.peak_factor, other.peak_factor),
            observations=max(self.observations, other.observations),
            partition=part,
            skew_strikes=strikes,
            calm_streak=calm,
            demotions=demotions,
        )


@dataclass(frozen=True)
class CapacityLearner:
    """Capacity-factor policy: jump up on pressure, decay toward default.

    For each observation the *target* factor is the observed requirement
    times ``margin`` (clamped to ``[default, max_factor]``).  A target at or
    above the current learned factor is adopted immediately — overflow costs
    a retry (and in the reference a recompile), so under-provisioning is the expensive error.
    A lower target decays the learned factor geometrically toward the
    default, never dropping below the target itself, so one burst of skew
    doesn't pin peak slab memory forever.

    Invariants (property-tested against the reference in
    tests/test_torch_adapt.py): the learned factor
    always stays within ``[default, max_factor]`` and never exceeds the
    largest ``target`` the history produced — it cannot oscillate past
    observed peak x margin.

    >>> lrn = CapacityLearner(margin=1.25, decay=0.5)
    >>> obs = ExchangeObservation(m=128, part_buckets=8, capacity=32,
    ...                           peak=48, overflowed=True, retries=1)
    >>> cf = lrn.update(2.0, obs, default=2.0)   # 3.0 required -> 3.75
    >>> cf
    3.75
    >>> calm = ExchangeObservation(m=128, part_buckets=8, capacity=60,
    ...                            peak=16, overflowed=False, retries=0)
    >>> lrn.update(cf, calm, default=2.0)        # halfway back toward 2.0
    2.875

    **Skew promotion** (radix -> sample partition).  Headroom absorbs skew
    but never removes it: a persistently skewed key distribution keeps a
    radix-partitioned cell's capacity factor pinned high forever.  The
    learner therefore also counts *consecutive* radix observations whose
    peak/mean bucket ratio exceeds ``promote_ratio``; at ``promote_after``
    strikes the planner latches the cell's learned ``partition`` to
    ``"sample"`` — subsequent calls partition by balanced composite
    splitters, the ratio drops to ~1, and the capacity factor decays back
    toward the default.  Sample-partition (and untagged, e.g. MoE)
    observations never accrue strikes; one calm radix call resets them.

    >>> skewed = ExchangeObservation(m=128, part_buckets=8, capacity=64,
    ...     peak=64, overflowed=True, retries=1, partition="radix")
    >>> s = lrn.promotion_strikes(0, skewed); s      # ratio 4.0 > 2.0
    1
    >>> lrn.should_promote(lrn.promotion_strikes(2, skewed))
    True
    >>> lrn.promotion_strikes(2, calm)               # untagged: unchanged
    2

    **Probation / demotion** (sample -> radix, slowly).  Promotion is no
    longer a one-way latch: ``calm_streak`` counts consecutive calm
    sample-era observations on a promoted cell, and once the streak
    outlasts ``demote_threshold`` (``demote_after`` doubled per prior
    demotion) the planner demotes the cell back to its radix-family plan —
    with the ``demotions`` generation counter bumped so the decision
    survives merges with stale promoted entries (see
    ``LearnedCapacity.merge``).  If the skew returns during probation, the
    normal three-strike promotion re-latches, now one generation up.
    """

    margin: float = 1.25
    decay: float = 0.5
    max_factor: float = 64.0
    snap_eps: float = 1e-3
    promote_ratio: float = 2.0
    promote_after: int = 3
    demote_ratio: float = 1.5
    demote_after: int = 32

    def target(self, obs: ExchangeObservation, *, default: float) -> float:
        """observed requirement x margin, clamped to [default, max_factor]."""
        return min(self.max_factor, max(default, obs.required_factor() * self.margin))

    def update(
        self, learned: float, obs: ExchangeObservation, *, default: float
    ) -> float:
        t = self.target(obs, default=default)
        if t >= learned:
            return t
        # geometric decay toward default, floored at the current target so a
        # steady skew level holds its learned factor instead of oscillating;
        # within snap_eps of the default the decay lands exactly on it, so
        # the walk terminates (and stops dirtying the persisted plan cache) —
        # guarded on t == default so the snap can never undershoot a target
        decayed = max(t, default + (learned - default) * self.decay)
        if t <= default and decayed - default < self.snap_eps:
            return default
        return decayed

    def promotion_strikes(self, strikes: int, obs: ExchangeObservation) -> int:
        """Fold one observation into the skew-strike counter.

        Only ``partition="radix"`` observations participate: a high-ratio
        one adds a strike, a calm one resets to zero (the skew must be
        *persistent* to promote).  Sample-partition and untagged
        observations pass the counter through unchanged — promotion is a
        judgement about radix behaviour, and e.g. MoE routing skew must not
        flip a sort cell's partition.  *Empty* observations (``m == 0``:
        an idle tick or a drained shard) also pass through — their
        ``peak_mean_ratio`` is 0.0 by construction, which says nothing
        about the distribution, so treating them as "calm" would reset
        the counter for a genuinely skewed cell.

        >>> lrn = CapacityLearner()
        >>> empty = ExchangeObservation(m=0, part_buckets=8, capacity=1,
        ...     peak=0, overflowed=False, retries=0, partition="radix")
        >>> lrn.promotion_strikes(2, empty)          # not evidence of calm
        2
        """
        if obs.partition != "radix" or obs.m == 0:
            return strikes
        if obs.peak_mean_ratio() > self.promote_ratio:
            return strikes + 1
        return 0

    def should_promote(self, strikes: int) -> bool:
        """True once the strike counter reaches ``promote_after``."""
        return strikes >= self.promote_after

    def calm_streak(self, streak: int, obs: ExchangeObservation) -> int:
        """Fold one observation into the slow probation counter.

        The promotion latch used to be one-way by design: once a cell ran
        the sample partition, nothing could ever send it back to the faster
        radix family even if the skew that caused the promotion vanished.
        The probation counter is the way back: *consecutive* calm
        sample-partition observations (peak/mean at or below
        ``demote_ratio``, no overflow) accrue; an overflowing or skewed
        sample call resets to zero (the distribution is still rough).
        Radix, untagged (MoE), and empty (``m == 0``) observations pass the
        counter through unchanged — they say nothing about the promoted
        cell's calm.

        >>> lrn = CapacityLearner()
        >>> calm = ExchangeObservation(m=128, part_buckets=8, capacity=32,
        ...     peak=16, overflowed=False, retries=0, partition="sample")
        >>> lrn.calm_streak(4, calm)
        5
        >>> rough = ExchangeObservation(m=128, part_buckets=8, capacity=32,
        ...     peak=48, overflowed=True, retries=1, partition="sample")
        >>> lrn.calm_streak(4, rough)
        0
        >>> lrn.calm_streak(4, ExchangeObservation(m=0, part_buckets=8,
        ...     capacity=1, peak=0, overflowed=False, retries=0,
        ...     partition="sample"))                  # idle tick: no evidence
        4
        """
        if obs.partition != "sample" or obs.m == 0:
            return streak
        if obs.peak_mean_ratio() <= self.demote_ratio and not obs.overflowed:
            return streak + 1
        return 0

    def demote_threshold(self, demotions: int = 0) -> int:
        """Calm observations required before the next demotion.

        Doubles with every demotion the cell has already been through
        (capped at 2^16): a cell whose skew keeps coming back spends
        exponentially longer on the sample partition before each new
        probation attempt — the counter is *slow* by design, so promotion
        and demotion can never flap call-to-call.

        >>> lrn = CapacityLearner()
        >>> (lrn.demote_threshold(0), lrn.demote_threshold(2))
        (32, 128)
        """
        return self.demote_after * (2 ** min(demotions, 16))

    def should_demote(self, streak: int, demotions: int = 0) -> bool:
        """True once the calm streak has outlasted this generation's
        probation threshold."""
        return streak >= self.demote_threshold(demotions)


class DelayController:
    """Adaptive coalescing window for ``AsyncSortService``.

    Owns the effective ``max_delay`` within ``[min_delay_ms, max_delay_ms]``:
    a batch that fills to ``capacity`` *before* its deadline shrinks the
    window (waiting longer buys no fill, only latency); a deadline flush
    below ``target_fill`` grows it (the arrival rate needs a longer window
    to amortize).  Flushes between those regimes — and lifecycle flushes at
    close — leave the window unchanged.  All timing flows through the
    injectable ``clock``, so every decision replays deterministically.

    >>> ctl = DelayController(1.0, 8.0, clock=ManualClock())
    >>> ctl.delay_ms                                     # starts patient
    8.0
    >>> ctl.observe_flush(n_requests=8, capacity=8, deadline_hit=False)
    >>> ctl.delay_ms                                     # filled early: shrink
    4.0
    >>> ctl.observe_flush(n_requests=1, capacity=8, deadline_hit=True)
    >>> ctl.delay_ms                                     # flushed sparse: grow
    6.0
    """

    def __init__(
        self,
        min_delay_ms: float,
        max_delay_ms: float,
        *,
        clock: Callable[[], float] = time.monotonic,
        shrink: float = 0.5,
        grow: float = 1.5,
        target_fill: float = 0.5,
        rate_window: int = 256,
    ):
        if not 0 < min_delay_ms <= max_delay_ms:
            raise ValueError("need 0 < min_delay_ms <= max_delay_ms")
        if not 0 < shrink < 1 < grow:
            raise ValueError("need 0 < shrink < 1 < grow")
        if not 0 < target_fill <= 1:
            raise ValueError("need 0 < target_fill <= 1")
        self.min_delay_s = min_delay_ms / 1e3
        self.max_delay_s = max_delay_ms / 1e3
        self.shrink = shrink
        self.grow = grow
        self.target_fill = target_fill
        self._clock = clock
        self._delay_s = self.max_delay_s  # start patient: latency floor is
        self._arrivals: deque = deque(maxlen=rate_window)  # opt-in, fill is not
        self._lock = threading.Lock()
        self.shrinks = 0
        self.grows = 0

    @property
    def delay_s(self) -> float:
        return self._delay_s

    @property
    def delay_ms(self) -> float:
        return self._delay_s * 1e3

    def note_arrival(self) -> None:
        """Record one request arrival (timestamped on the injected clock)."""
        with self._lock:
            self._arrivals.append(self._clock())

    def arrival_rate(self) -> float:
        """Requests/second over the rolling arrival window (0.0 until two
        arrivals at distinct clock readings)."""
        with self._lock:
            if len(self._arrivals) < 2:
                return 0.0
            span = self._arrivals[-1] - self._arrivals[0]
            return (len(self._arrivals) - 1) / span if span > 0 else 0.0

    def observe_flush(
        self, *, n_requests: int, capacity: int, deadline_hit: bool
    ) -> None:
        """Adapt to one flushed batch: shrink on an early full batch, grow on
        a sparse deadline flush, hold otherwise."""
        with self._lock:
            if not deadline_hit and n_requests >= capacity:
                self._delay_s = max(self.min_delay_s, self._delay_s * self.shrink)
                self.shrinks += 1
            elif deadline_hit and n_requests < self.target_fill * capacity:
                self._delay_s = min(self.max_delay_s, self._delay_s * self.grow)
                self.grows += 1
