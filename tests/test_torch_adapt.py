"""The port's capacity learner, learned entries and flush-window controller
against the reference's (``repro.engine.adapt``): the same seeded
observation sequences give the same learned factors, strikes, promotions,
demotions, merges and ``DelayController`` decisions, value for value.
"""
import numpy as np
import pytest

from repro.engine import adapt as ref
from repro.engine.planner import Planner as RefPlanner
from repro_torch.engine import adapt as port
from repro_torch.engine.planner import Planner

SEEDS = range(6)


def _observations(seed: int, n: int = 200):
    """Seeded observation fields: skewed and calm stretches, radix, sample
    and untagged calls, empty shards, overflows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        part_buckets = int(rng.choice([4, 8, 16]))
        m = 0 if rng.random() < 0.03 else int(rng.integers(16, 512))
        # stretches of skew and calm, so promotion and demotion both happen
        skewed = (i // 40) % 2 == 0
        mean = max(m // part_buckets, 1)
        peak = int(mean * (rng.uniform(2.2, 6.0) if skewed else rng.uniform(0.8, 1.4)))
        # calm stretches overflow rarely, so a promoted cell's probation can end
        capacity = int(rng.integers(1, 4 * mean + 2)) if skewed else peak + int(rng.integers(-1, mean))
        overflowed = peak > capacity
        out.append(dict(m=m, part_buckets=part_buckets, capacity=capacity, peak=peak if m else 0,
                        overflowed=overflowed, retries=int(overflowed) * int(rng.integers(1, 3)),
                        partition=[None, "radix", "radix", "sample"][int(rng.integers(0, 4))]
                        if not skewed else ["radix", "sample"][int(rng.integers(0, 2))]))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_learner_steps_match_reference(seed):
    kw = dict(margin=1.25, decay=0.5, demote_after=4)
    lr, lp = ref.CapacityLearner(**kw), port.CapacityLearner(**kw)
    cf_r = cf_p = 2.0
    strikes_r = strikes_p = calm_r = calm_p = 0
    for fields in _observations(seed):
        o_r, o_p = ref.ExchangeObservation(**fields), port.ExchangeObservation(**fields)
        assert o_p.required_factor() == o_r.required_factor()
        assert o_p.peak_mean_ratio() == o_r.peak_mean_ratio()
        cf_r, cf_p = lr.update(cf_r, o_r, default=2.0), lp.update(cf_p, o_p, default=2.0)
        strikes_r, strikes_p = lr.promotion_strikes(strikes_r, o_r), lp.promotion_strikes(strikes_p, o_p)
        calm_r, calm_p = lr.calm_streak(calm_r, o_r), lp.calm_streak(calm_p, o_p)
        assert (cf_p, strikes_p, calm_p) == (cf_r, strikes_r, calm_r)
        assert lp.should_promote(strikes_p) == lr.should_promote(strikes_r)
        for d in range(3):
            assert lp.should_demote(calm_p, d) == lr.should_demote(calm_r, d)
            assert lp.demote_threshold(d) == lr.demote_threshold(d)


@pytest.mark.parametrize("seed", SEEDS)
def test_observe_exchange_learns_the_reference_table(seed):
    """Promotion, probation and demotion through ``observe_exchange``: the
    same entries after every observation, on several keys."""
    rp, pp = RefPlanner(), Planner(device="cpu")
    rp.learner = ref.CapacityLearner(demote_after=3)
    pp.learner = port.CapacityLearner(demote_after=3)
    promotions = demotions = 0
    for i, fields in enumerate(_observations(seed)):
        key = f"{1 << (10 + i % 2)}|int32|cpu/x=4"
        er = rp.observe_exchange(key, ref.ExchangeObservation(**fields))
        ep = pp.observe_exchange(key, port.ExchangeObservation(**fields))
        assert ep.to_dict() == er.to_dict()
        assert pp.promotion_state(key) == rp.promotion_state(key)
        assert pp.capacity_factor_for(key) == rp.capacity_factor_for(key)
        promotions += ep.partition == "sample"
        demotions = max(demotions, ep.demotions)
    assert promotions > 0 and demotions > 0  # the sequences reach both
    assert {k: v.to_dict() for k, v in pp.learned.items()} == {
        k: v.to_dict() for k, v in rp.learned.items()}
    assert pp.telemetry.calls == rp.telemetry.calls
    assert pp.telemetry.total_retries == rp.telemetry.total_retries


def _entries(seed: int, n: int = 60):
    rng = np.random.default_rng(100 + seed)
    return [dict(capacity_factor=float(rng.choice([2.0, 2.5, 3.75, 8.0])),
                 peak_factor=float(rng.choice([1.0, 2.5, 3.0])),
                 observations=int(rng.integers(0, 12)),
                 partition=[None, "radix", "sample"][int(rng.integers(0, 3))],
                 skew_strikes=int(rng.integers(0, 4)), calm_streak=int(rng.integers(0, 40)),
                 demotions=int(rng.integers(0, 3))) for _ in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_learned_capacity_merge_and_dict_match_reference(seed):
    es = _entries(seed)
    for a, b in zip(es, es[1:]):
        ra, rb = ref.LearnedCapacity(**a), ref.LearnedCapacity(**b)
        pa, pb = port.LearnedCapacity(**a), port.LearnedCapacity(**b)
        assert pa.merge(pb).to_dict() == ra.merge(rb).to_dict()
        assert pa.merge(pb) == pb.merge(pa)  # commutative, as the reference's
        assert port.LearnedCapacity.from_dict(ra.to_dict()) == pa
        assert ref.LearnedCapacity.from_dict(pa.to_dict()) == ra


@pytest.mark.parametrize("seed", SEEDS)
def test_delay_controller_decisions_match_reference(seed):
    rng = np.random.default_rng(200 + seed)
    cr, cp = ref.ManualClock(), port.ManualClock()
    dr = ref.DelayController(0.5, 8.0, clock=cr, target_fill=0.5)
    dp = port.DelayController(0.5, 8.0, clock=cp, target_fill=0.5)
    for _ in range(300):
        dt = float(rng.exponential(0.003))
        assert cp.advance(dt) == cr.advance(dt)
        if rng.random() < 0.7:
            dr.note_arrival()
            dp.note_arrival()
        else:
            fl = dict(n_requests=int(rng.integers(1, 17)), capacity=16,
                      deadline_hit=bool(rng.random() < 0.5))
            dr.observe_flush(**fl)
            dp.observe_flush(**fl)
        assert (dp.delay_ms, dp.shrinks, dp.grows) == (dr.delay_ms, dr.shrinks, dr.grows)
        assert dp.arrival_rate() == dr.arrival_rate()


def test_manual_clock_refuses_to_go_back_like_the_reference():
    for mod in (ref, port):
        with pytest.raises(ValueError, match="backward"):
            mod.ManualClock().advance(-1.0)


@pytest.mark.parametrize("bad", [dict(min_delay_ms=0.0, max_delay_ms=1.0),
                                 dict(min_delay_ms=2.0, max_delay_ms=1.0),
                                 dict(min_delay_ms=1.0, max_delay_ms=2.0, shrink=1.5),
                                 dict(min_delay_ms=1.0, max_delay_ms=2.0, target_fill=0.0)])
def test_delay_controller_refuses_what_the_reference_refuses(bad):
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.DelayController(**bad)
