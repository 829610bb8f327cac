"""The port's AsyncSortService against the reference's (``repro.engine.queue``).

Every scenario runs on ``ManualClock`` with no sleeps, as
tests/test_queue.py does: requests are staged before the dispatcher
starts (or the clock is frozen, so only full batches flush), which makes
every flush decision deterministic.  Both packages play the same scenario;
the results are compared bit for bit and the queue's ledger (batch sizes,
fill ratios, queue latencies, the adaptive window's moves) field for field.
"""
import queue as stdqueue
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bits
from repro.engine import AsyncSortService as RefQueue
from repro.engine import ManualClock as RefClock
from repro.engine import QueueStats as RefQueueStats
from repro.engine import planner as ref_planner
from repro_torch import carry
from repro_torch.engine import AsyncSortService, ManualClock, QueueStats

STATS = ("requests", "batches", "keys_in", "padded_keys", "compiles", "cache_hits",
         "enqueued", "rejected", "coalesced_batches", "coalesced_requests")


def _planner(side: str, impl: str = "xla"):
    rp = ref_planner.Planner()
    if impl == "pallas":
        rp.plans[ref_planner.plan_key(64, jnp.int32)] = ref_planner.SortPlan(
            "shared", local_impl="pallas", n_threads=2, block_n=16)
    if side == "ref":
        return rp
    return carry.planner_from_reference(
        {"version": 3, "plans": {k: p.to_dict() for k, p in rp.plans.items()}}, device="cpu")


def _queue(side: str, impl: str = "xla", **kw):
    if side == "ref":
        return RefQueue(planner=_planner(side, impl), clock=kw.pop("clock", RefClock()), **kw)
    return AsyncSortService(planner=_planner(side, impl), clock=kw.pop("clock", ManualClock()),
                            device="cpu", **kw)


def _reqs(seed, n, lengths=(40, 64, 60, 33)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, lengths[i % len(lengths)]).astype(np.int32) for i in range(n)]


def _ledger(svc):
    st = svc.stats
    out = {f: getattr(st, f) for f in STATS}
    out.update(batch_sizes=sorted(st.batch_sizes), fill_ratios=sorted(st.fill_ratios),
               latencies=sorted(st.queue_latency_s), pct=st.latency_percentiles(),
               fill=st.fill_ratio())
    if svc.delay is not None:
        out.update(delay_ms=svc.delay.delay_ms, shrinks=svc.delay.shrinks, grows=svc.delay.grows)
    return out


def _results(futs):
    out = []
    for f in futs:
        res = f.result(timeout=120)
        out.append(tuple(np.asarray(r) for r in res) if isinstance(res, tuple) else np.asarray(res))
    return out


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(bits(a), bits(b))


def _staged(side, impl):
    """Staged traffic of several kinds, then close(): full groups flush as
    they fill, the rest at close, in a fixed order.  The reference's
    interpret-mode kernel plan takes two cells, not eight."""
    svc = _queue(side, impl, start=False, max_batch=3)
    kinds = ("sort", "argsort") if impl == "pallas" else ("sort", "argsort", "sort_kv")
    futs = []
    for i, r in enumerate(_reqs(1, 14)):
        kind = kinds[i % len(kinds)]
        vals = np.arange(len(r), dtype=np.int32)[::-1].copy() if kind == "sort_kv" else None
        ascending = impl == "pallas" or i % 4 != 1
        futs.append(svc.submit_async(r, kind=kind, values=vals, ascending=ascending))
    svc.close()
    return _results(futs), _ledger(svc)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_staged_traffic_flushes_like_the_reference(impl):
    (got, led_p), (want, led_r) = _staged("port", impl), _staged("ref", impl)
    _assert_same_results(got, want)
    assert led_p == led_r


def _adaptive(side):
    """Deadline flushes grow the window, full ones shrink it, close leaves it."""
    clock = RefClock() if side == "ref" else ManualClock()
    svc = _queue(side, start=False, max_batch=4, max_delay_ms=8.0, min_delay_ms=1.0, clock=clock)
    reqs = _reqs(2, 12)
    futs = [svc.submit_async(r) for r in reqs[:1]]  # a sparse group ...
    clock.advance(0.01)  # ... whose deadline passes before the dispatcher looks
    svc.start()
    assert svc.drain(timeout=120)
    futs += [svc.submit_async(r) for r in reqs[1:9]]  # two full groups: shrink twice
    assert svc.drain(timeout=120)
    futs += [svc.submit_async(r) for r in reqs[9:]]  # three, flushed by close
    svc.close()
    return _results(futs), _ledger(svc)


def test_adaptive_window_moves_like_the_reference():
    (got, led_p), (want, led_r) = _adaptive("port"), _adaptive("ref")
    _assert_same_results(got, want)
    assert led_p == led_r
    assert led_p["grows"] == 1 and led_p["shrinks"] == 2


def _producers(side):
    """8 threads with the clock frozen: only full batches of 8 can flush."""
    svc = _queue(side, max_batch=8)
    reqs = _reqs(3, 32, lengths=(50, 64, 33, 47))
    futs = [None] * len(reqs)

    def produce(t):
        for j in range(4):
            i = 4 * t + j
            futs[i] = svc.submit_async(reqs[i])

    threads = [threading.Thread(target=produce, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    got = _results(futs)
    for g, r in zip(got, reqs):
        np.testing.assert_array_equal(g, np.sort(r))
    svc.close()
    return got, _ledger(svc)


def test_concurrent_producers_coalesce_like_the_reference():
    (got, led_p), (want, led_r) = _producers("port"), _producers("ref")
    _assert_same_results(got, want)
    assert led_p == led_r and led_p["batch_sizes"] == [8, 8, 8, 8]


def test_repeated_traffic_builds_no_new_cell():
    svc = _queue("port", max_batch=4)
    for f in [svc.submit_async(r) for r in _reqs(4, 4)]:
        f.result(timeout=60)
    misses = svc.service.cache.misses
    for f in [svc.submit_async(r) for r in _reqs(5, 8)]:
        f.result(timeout=60)
    assert svc.service.cache.misses == misses
    svc.close()


def test_reject_policy_and_close_like_the_reference():
    for side in ("ref", "port"):
        svc = _queue(side, maxsize=2, on_full="reject", start=False, max_batch=2)
        svc.submit_async(np.array([2, 1], np.int32))
        svc.submit_async(np.array([4, 3], np.int32))
        with pytest.raises(stdqueue.Full):
            svc.submit_async(np.array([6, 5], np.int32))
        assert svc.stats.rejected == 1 and svc.stats.enqueued == 2
        svc.close()
        with pytest.raises(RuntimeError, match="closed"):
            svc.submit_async(np.array([1], np.int32))
        with pytest.raises(ValueError):
            svc.submit_async(np.array([1.0, np.nan], np.float32))


def test_queue_stats_ledger_is_the_references():
    rs, ps = RefQueueStats(), QueueStats()
    rng = np.random.default_rng(6)
    for _ in range(40):
        kw = dict(n_requests=int(rng.integers(1, 9)), capacity=8,
                  latencies=list(rng.exponential(0.002, 5)))
        rs.observe_batch(**kw)
        ps.observe_batch(**kw)
        for t, r in (("web", "deadline"), ("batch", "tenant_backlog")):
            rs.observe_shed(t, r)
            ps.observe_shed(t, r)
    assert ps.fill_ratio() == rs.fill_ratio()
    assert ps.latency_percentiles() == rs.latency_percentiles()
    assert ps.shed == rs.shed and ps.shed_total("web") == rs.shed_total("web")


def test_queue_for_the_card_with_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncSortService(start=False)
