"""The metric arithmetic on hand-made inputs: the trace reduction, the
roofline, each per-layer metric's reader, and the seeded draws."""
import numpy as np
import pytest
import torch

from sortbench import harness
from sortbench.drivers.closed_loop import Reservoir
from sortbench.frozen.roofline import HBM_BYTES_PER_S, least_bytes, roofline_share
from sortbench.reference import numpy_sort
from sortbench.trace import WINDOW, Op, Span, Trace


def _trace(extra=()):
    # a 100 µs window; device busy 10-30, 25-40 (overlapping), 60-70
    return Trace(
        ops=[Op("k1", 10, 30, launched=5), Op("k2", 25, 40, launched=21),
             Op("Memcpy HtoD", 60, 70, launched=55), *extra],
        spans=[Span(WINDOW, 0, 100), Span("sb.call", 1, 50), Span("sb.merge", 20, 22),
               Span("sb.call", 52, 99)])


def test_busy_union_and_idle_share():
    t = _trace()
    assert t.busy_intervals() == [(10, 40), (60, 70)]
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert t.idle_share() == pytest.approx(60.0)
    assert Trace(spans=[Span(WINDOW, 0, 1)]).idle_share() is None


def test_operations_under_a_span_by_launch_time():
    t = _trace()
    assert [op.name for op in t.ops_under("sb.merge")] == ["k2"]
    assert [op.name for op in t.ops_under("sb.call")] == ["k1", "k2", "Memcpy HtoD"]
    assert sum(op.is_kernel for op in t.ops) == 2
    # an operation with no launch record is under no span
    assert Trace(ops=[Op("k", 10, 12)], spans=[Span("sb.merge", 9, 13)]).ops_under("sb.merge") == []


def test_breakdown_lists():
    t = _trace()
    assert t.device_ops()[0] == ["k1", pytest.approx(20e-6)]
    gaps = dict(t.idle_gaps())
    # idle 0-10 begins outside any call span; 40-60 inside the first call;
    # 70-100 inside the second
    assert gaps["no span"] == pytest.approx(10e-6)
    assert gaps["sb.call"] == pytest.approx(50e-6)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.int32])
def test_least_bytes_and_roofline_share(out_dtype):
    # a sort writes its keys, an argsort its int32 indices: 4 bytes a key either way
    x = torch.zeros(1000, dtype=torch.float32)
    assert least_bytes([x], [torch.zeros(1000, dtype=out_dtype)]) == 8000
    # the least time at the peak over the measured time, in percent
    assert roofline_share(HBM_BYTES_PER_S * 1e-3, 2e-3) == pytest.approx(50.0)


def test_keys_per_second_over_the_window():
    # what closed_loop reports: every call's keys over the window's seconds, in millions
    calls, n, window_s = 575, 10_000_000, 5.0648
    assert calls * n / window_s / 1e6 == pytest.approx(1135.286, rel=1e-5)


READINGS = {
    # metric: (counters, its reading of _trace() with those counters)
    "kernel_roofline.bulk": ({"calls": 2, "least_bytes_per_call": 3.35e12 * 20e-6},
                             100.0 * 20e-6 / 20e-6),
    "device_launches.bulk": ({"calls": 2}, 1.0),
    "merge_device_ms.bulk": ({"calls": 2}, 15e-6 / 2 * 1e3),
    "device_idle.bulk": ({"calls": 2}, 60.0),
    "device_idle.mesh": ({"calls": 2}, 60.0),
    "exchange_device_ms.mesh": ({"calls": 2}, 5e-6 / 2 * 1e3),
    "capacity_retries.mesh": ({"calls": 2, "exchanges": 4, "retries": 2}, 0.5),
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_metric_reads_the_trace_and_returns_nothing_where_nothing_is(name):
    """Each reader on a hand-made trace, and on runs with nothing to read
    (no trace, no operation, no exchange): None there, never 0."""
    counters, want = READINGS[name]
    read = harness.load_metric(name).read
    if name == "exchange_device_ms.mesh":
        # an NCCL kernel inside the busy 10-30 and one alone at 80-82
        trace = _trace([Op("ncclDevKernel_AllToAll", 12, 15), Op("ncclKernel_AllReduce", 80, 82)])
        assert read(harness.RunData(_trace(), counters)) is None
    else:
        trace = _trace()
    got = read(harness.RunData(trace, counters))
    assert got == (None if want is None else pytest.approx(want))
    empty = Trace(spans=[Span(WINDOW, 0, 100)])
    nothing = dict(counters, exchanges=0)
    assert read(harness.RunData(empty, nothing)) is None
    if harness.load_metric(name).SOURCE == "device_trace":
        assert read(harness.RunData(None, counters)) is None


def test_seeded_draws_repeat():
    assert harness.derive(2 ** 31 + 9, "keys") == harness.derive(2 ** 31 + 9, "keys")
    assert harness.derive(1, "keys") != harness.derive(1, "check")
    assert 0 <= harness.derive(2 ** 40, "keys", 3) < 2 ** 63
    picks = []
    for _ in range(2):
        r = Reservoir(3, 7)
        for i in range(50):
            r.offer(i, i)
        picks.append(r.items)
    assert picks[0] == picks[1] and len(picks[0]) == 3


@pytest.mark.parametrize("spec, dtype", [({"dist": "normal", "scale": 1000.0}, torch.float32),
                                         ({"dist": "uniform", "low": 0.0, "high": 1.0}, torch.float32),
                                         ({"dist": "randint", "low": 0, "high": 1000}, torch.int32)])
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 5, 2 ** 62 + 5])
def test_keys_from_the_seed(spec, dtype, seed):
    # seeds past 32 bits, as the driver's are, draw alike each time
    def draw(seed):
        gen = torch.Generator().manual_seed(harness.derive(seed, "keys"))
        return harness.make_keys(spec, (2, 64), dtype, gen, "cpu")
    assert torch.equal(draw(seed), draw(seed)) and not torch.equal(draw(seed), draw(seed + 1))
    assert draw(seed).dtype == dtype


def test_reference_and_controls():
    rng = np.random.default_rng(0)
    keys = (rng.standard_normal(5000) * 1000).astype(np.float32)
    assert numpy_sort.mismatches(numpy_sort.answer("sort", keys), np.sort(keys)) == 0
    assert numpy_sort.mismatches(numpy_sort.control("sort", keys), np.sort(keys)) > 1000
    dup = rng.integers(0, 50, 5000).astype(np.int32)
    stable = numpy_sort.answer("argsort", dup)
    same = dup[stable][1:] == dup[stable][:-1]
    assert (np.diff(stable)[same] > 0).all()
    assert numpy_sort.mismatches(numpy_sort.control("argsort", dup), stable) > 1000
    assert numpy_sort.mismatches(np.arange(3), np.arange(5)) == 2


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    import sys
    import types

    for name in ("repro_torch_fake", "reprox", "jaxlike"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("repro.fake"))
    assert "repro.fake" in harness.forbidden_modules()
    assert "reprox" not in harness.forbidden_modules()
