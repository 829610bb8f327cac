"""The port's SLO frontend against the reference's (``repro.engine.frontend``).

Traces and payloads are byte-identical for the same seed; ``run_load`` on
``ManualClock`` with ``linear_service_time`` gives the same ``LoadReport``
field for field (every ticket's stamps, every shed and its reason, the
dispatched ``BatchInfo`` sequence and the results bit for bit); warmup
reports the same counts.  No test sleeps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bits
from repro.engine import ManualClock as RefClock
from repro.engine import frontend as ref
from repro.engine import planner as ref_planner
from repro.engine.service import SortService as RefService
from repro_torch import carry
from repro_torch.engine import ManualClock, SortService
from repro_torch.engine import frontend as port
from repro_torch.engine.frontend import loadgen


def _arrivals(trace):
    return [(a.t, a.tenant, a.size, a.seq, a.kind) for a in trace]


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("rates", [{"a": 5.0}, {"web": 200.0, "batch": 50.0},
                                   {"x": 30.0, "y": 0.0, "z": 80.0}])
def test_make_trace_and_payloads_are_the_references_byte_for_byte(seed, rates):
    kw = dict(duration_s=2.0, rates=rates, sizes=(256, 512, 1024, 2048, 4096), zipf_a=1.2,
              seed=seed)
    got, want = port.make_trace(**kw), ref.make_trace(**kw)
    assert _arrivals(got) == _arrivals(want)
    for a, b in zip(got[:20], want[:20]):
        for dtype in (np.int32, np.float32):
            pg, pw = port.payload_for(a, seed=seed, dtype=dtype), ref.payload_for(b, seed=seed,
                                                                                 dtype=dtype)
            assert pg.dtype == pw.dtype and pg.tobytes() == pw.tobytes()


def test_small_helpers_are_the_references():
    for n, skew in ((1, 0.0), (3, 0.0), (4, 2.0), (6, 1.1)):
        assert port.zipf_shares(n, skew) == ref.zipf_shares(n, skew)
    for mb in (1, 2, 6, 8, 16, 33):
        assert port.batch_bucket_ladder(mb) == ref.batch_bucket_ladder(mb)
    assert loadgen.DEFAULT_SIZES == ref.loadgen.DEFAULT_SIZES
    mp, mr = port.linear_service_time(base_ms=0.3, us_per_key=0.07), ref.linear_service_time(
        base_ms=0.3, us_per_key=0.07)
    for n, b in ((1, 256), (4, 1024), (16, 4096)):
        assert mp(port.BatchInfo(n, b, "sort", ())) == mr(ref.BatchInfo(n, b, "sort", ()))
    for mod in (port, ref):
        with pytest.raises(ValueError):
            mod.make_trace(duration_s=0.0, rates={"a": 1.0})
        with pytest.raises(ValueError):
            mod.make_trace(duration_s=1.0, rates={"a": -1.0})
        with pytest.raises(ValueError):
            mod.Tenant("t", weight=0.0)
        with pytest.raises(ValueError):
            mod.zipf_shares(0, 1.0)


def _planner(side):
    rp = ref_planner.Planner()
    if side == "ref":
        return rp
    return carry.planner_from_reference({"version": 3, "plans": {}}, device="cpu")


def _frontend(side, clock, **kw):
    mod = ref if side == "ref" else port
    svc = (RefService(planner=_planner(side)) if side == "ref"
           else SortService(planner=_planner(side), device="cpu"))
    tenants = [mod.Tenant("web", weight=2.0, priority=0, slo_ms=40.0),
               mod.Tenant("batch", weight=1.0, priority=1, slo_ms=200.0)]
    fe = mod.SortFrontend(svc, tenants=tenants, clock=clock, **kw)
    infos = []
    pump = fe.pump

    def recording_pump():
        info = pump()
        if info is not None:
            infos.append((info.n_requests, info.bucket, info.kind, info.tenants))
        return info

    fe.pump = recording_pump
    return mod, fe, infos


def _report(rep, fe, infos):
    tickets = []
    for t in rep.tickets:
        exc = t.future.exception() if t.done() else None
        res = None if exc is not None or not t.done() else bits(np.asarray(t.result())).tolist()
        tickets.append((t.tenant, t.t_submit, t.deadline, t.t_done, t.latency_s, t.slo_met,
                        type(exc).__name__ if exc else None, getattr(exc, "reason", None), res))
    out = dict(offered=rep.offered, sheds=rep.sheds, elapsed=rep.elapsed_s, tickets=tickets,
               batches=infos, derived=rep.derived(), shed_ledger=fe.stats.shed,
               served=fe.stats.tenant_served, batches_run=fe.stats.batches,
               compiles=fe.stats.compiles, cache_hits=fe.stats.cache_hits)
    for tenant in ("web", "batch"):
        out[tenant] = (rep.derived(tenant), rep.goodput(tenant), rep.shed_counts(tenant),
                       rep.latency_percentiles(tenant=tenant))
    return out


def _run_load(side, rates, *, shed_expired=True, maxsize=32):
    clock = RefClock() if side == "ref" else ManualClock()
    mod, fe, infos = _frontend(side, clock, max_batch=4, maxsize=maxsize,
                               shed_expired=shed_expired)
    trace = mod.make_trace(duration_s=0.4, rates=rates, sizes=(64, 128), seed=5)
    rep = mod.run_load(fe, trace, clock=clock,
                       service_time=mod.linear_service_time(base_ms=5.0, us_per_key=0.02))
    return _report(rep, fe, infos)


@pytest.mark.parametrize("case", [
    dict(rates={"web": 100.0, "batch": 40.0}),                       # under capacity
    dict(rates={"web": 700.0, "batch": 500.0}),                      # overload: sheds
    dict(rates={"web": 700.0, "batch": 500.0}, shed_expired=False),  # late, not shed
    dict(rates={"web": 900.0, "batch": 900.0}, maxsize=8),           # backlog bounds
])
def test_run_load_reports_are_the_references(case):
    got, want = _run_load("port", **case), _run_load("ref", **case)
    assert got == want
    if case["rates"]["web"] >= 700.0 and case.get("shed_expired", True):
        assert got["sheds"]  # the overload cases shed, with reasons


def test_edf_priority_and_coalescing_like_the_reference():
    results = []
    for side in ("ref", "port"):
        clock = RefClock() if side == "ref" else ManualClock()
        mod, fe, infos = _frontend(side, clock, max_batch=3)
        rng = np.random.default_rng(9)
        tickets = []
        for i in range(10):
            tenant = ("batch", "web")[i % 2]
            r = rng.integers(0, 100, 20 + 7 * (i % 3)).astype(np.int32)
            tickets.append(fe.submit(tenant, r, deadline=1.0 - 0.05 * i if i % 3 else None,
                                     kind=("sort", "argsort")[i % 4 == 3]))
            clock.advance(0.001)
        fe.poll()
        results.append((infos, [bits(np.asarray(t.result())).tolist() for t in tickets],
                        [(t.t_done, t.slo_met) for t in tickets]))
    assert results[1] == results[0]


@pytest.mark.parametrize("kinds,ascending,values_spec", [
    (("sort", "argsort"), (True,), None),
    (("argsort",), (False,), None),
    (("sort_kv",), (True,), ((2,), np.float32)),
])
def test_warmup_reports_the_references_counts(kinds, ascending, values_spec):
    reports = []
    for side, mod in (("ref", ref), ("port", port)):
        planner = _planner(side)  # one tuned cell, the rest named by cells=
        if side == "ref":
            planner.plans[ref_planner.plan_key(512, jnp.int32)] = ref_planner.SortPlan("shared")
        else:
            planner.plans["512|int32|local/cpu"] = carry.plan_from_reference({"strategy": "shared"})
        svc = (RefService(planner=planner) if side == "ref"
               else SortService(planner=planner, device="cpu"))
        kw = dict(cells=[(100, "int32"), (512, "int32")], kinds=kinds, max_batch=4,
                  ascending=ascending, values_spec=values_spec)
        first, second = mod.warmup(svc, **kw), mod.warmup(svc, **kw)
        reports.append([(r.cells, r.compiled, r.cached) for r in (first, second)])
    assert reports[1] == reports[0]
    assert reports[1][1][1] == 0  # a second warmup builds nothing


def test_a_warmed_frontend_serves_with_no_new_cell():
    fe = port.SortFrontend(SortService(planner=_planner("port"), device="cpu"),
                           tenants=[port.Tenant("web")], max_batch=4, clock=ManualClock())
    rep = fe.warmup(cells=[(256, "int32"), (1024, "int32")], kinds=("sort",))
    assert rep.compiled == 2 * len(port.batch_bucket_ladder(4))
    misses = fe.service.cache.misses
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, 1000, n).astype(np.int32) for n in (200, 256, 700, 1000, 1024, 3)]
    tickets = [fe.submit("web", r) for r in reqs[:5]]
    fe.poll()
    assert fe.service.cache.misses == misses
    for t, r in zip(tickets, reqs):
        np.testing.assert_array_equal(t.result(), np.sort(r))
    fe.submit("web", reqs[5])
    fe.poll()  # bucket 8 was not warmed: one new cell
    assert fe.service.cache.misses == misses + 1


def test_thread_mode_serves_every_tenant():
    fe = port.SortFrontend(SortService(planner=_planner("port"), device="cpu"),
                           tenants=[port.Tenant("a"), port.Tenant("b")], max_batch=8, start=True)
    rng = np.random.default_rng(4)
    sent = [(name, rng.integers(0, 10_000, 200).astype(np.int32)) for name in "abab" * 4]
    tickets = [(arr, fe.submit(name, arr)) for name, arr in sent]
    with fe:
        pass
    for arr, t in tickets:
        np.testing.assert_array_equal(t.result(timeout=60), np.sort(arr))
    assert fe.stats.tenant_served == {"a": 8, "b": 8}
    with pytest.raises(RuntimeError):
        fe.submit("a", np.array([1], np.int32))


def test_frontend_and_warmup_for_the_card_with_no_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.SortFrontend(tenants=[port.Tenant("t")])
    with pytest.raises(RuntimeError, match="CUDA"):
        port.warmup(cells=[(8, "int32")])
