"""The readers of the program's own spans (``sortbench/program_spans.py``
and the five ``program_span`` metrics) on hand-made records and traces,
and the trace reduction left as it was by the program's spans."""
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sortbench import harness, program_spans
from sortbench.trace import WINDOW, Op, Span, Trace, collect


def rec(name, start_us, end_us, *, parent=None, call=1, device_ms=None, thread=7):
    """A record as ``repro_torch.tracing`` keeps it (host times in ns)."""
    return SimpleNamespace(name=name, parent=parent, call=call, thread=thread,
                           start_ns=int(start_us * 1000), end_ns=int(end_us * 1000),
                           device_ms=device_ms)


def two_calls(shift_us=1000.0):
    """Two calls on the program's clock, ``shift_us`` ahead of the trace's:
    sort 10-50 (read 30-40), sort 60-95 (read 80-90); plan and observe in
    each, merge rounds with event times."""
    s = shift_us
    return [
        rec("repro_torch.sort", s + 10, s + 50, call=1),
        rec("repro_torch.plan", s + 11, s + 13, parent=0, call=1),
        rec("repro_torch.shared.merge", s + 14, s + 20, parent=0, call=1, device_ms=1.5),
        rec("repro_torch.retry.read", s + 30, s + 40, parent=0, call=1),
        rec("repro_torch.planner.observe", s + 41, s + 44, parent=0, call=1),
        rec("repro_torch.sort", s + 60, s + 95, call=2),
        rec("repro_torch.plan", s + 61, s + 62, parent=5, call=2),
        rec("repro_torch.shared.merge", s + 63, s + 70, parent=5, call=2, device_ms=2.5),
        rec("repro_torch.retry.read", s + 80, s + 90, parent=5, call=2),
        rec("repro_torch.planner.observe", s + 91, s + 93, parent=5, call=2),
    ]


def trace():
    """A 100 µs window, the device busy 0-20, 35-65 and 85-100; the
    benchmark's call spans a microsecond around each sort."""
    return Trace(ops=[Op("k", 0, 20), Op("k", 35, 65), Op("k", 85, 100)],
                 spans=[Span(WINDOW, 0, 100), Span("sb.call", 9, 51), Span("sb.call", 59, 96)])


def test_per_call_arithmetic():
    recs = two_calls()
    assert program_spans.host_ms_per_call(recs, ("repro_torch.retry.read",), 2) == (
        pytest.approx(10e-3))
    plan = program_spans.host_ms_per_call(recs, ("repro_torch.plan",
                                                 "repro_torch.planner.observe"), 2)
    assert plan == pytest.approx((2 + 3 + 1 + 2) / 2 * 1e-3)
    assert program_spans.device_ms_per_call(recs, "repro_torch.shared.merge", 2) == 2.0
    # nothing to read: no records, no such span, a span with no device interval
    assert program_spans.host_ms_per_call([], ("repro_torch.plan",), 2) is None
    assert program_spans.host_ms_per_call(None, ("repro_torch.plan",), 2) is None
    assert program_spans.device_ms_per_call(recs, "repro_torch.cluster.exchange", 2) is None
    assert program_spans.device_ms_per_call(recs, "repro_torch.plan", 2) is None


def test_clock_join_and_idle_split():
    t = trace()
    split = program_spans.idle_split(t, two_calls(shift_us=1000.0))
    # joined by the start: call 1 sits at 9-49 (read 29-39), call 2 at 59-94 (read 79-89)
    # idle 20-35: inside call 1's host path 20-29; 65-85: inside call 2's 65-79
    assert split.inside_s == pytest.approx((9 + 14) / 1e6)
    assert split.outside_s == pytest.approx((35 - 23) / 1e6)
    # offsets -1001 by the starts (9 - 1010, 59 - 1060), -999 by the ends (51 - 1050, 96 - 1095)
    assert split.join_error_us == pytest.approx(-2.0)
    assert split.calls == 2


def test_idle_split_adds_up_to_the_windows_idle():
    t = trace()
    for shift in (0.0, 1000.0, -2.5e6):
        split = program_spans.idle_split(t, two_calls(shift_us=shift))
        assert split.inside_s + split.outside_s == pytest.approx(t.idle_share() / 100 * t.window_s)
        assert 0 <= split.inside_s <= split.inside_s + split.outside_s


def test_idle_split_none_on_mismatched_calls_or_no_device_operation():
    t = trace()
    assert program_spans.idle_split(t, two_calls()[:5]) is None  # one sort, two sb.call spans
    bare = Trace(spans=t.spans)
    assert program_spans.idle_split(bare, two_calls()) is None
    assert program_spans.idle_split(t, []) is None
    assert program_spans.idle_split(None, two_calls()) is None


def test_idle_split_helpers():
    assert program_spans._subtract((0, 10), [(2, 3), (5, 7)]) == [(0, 2), (3, 5), (7, 10)]
    assert program_spans._subtract((0, 10), [(-1, 1), (9, 12)]) == [(1, 9)]
    assert program_spans._overlap([(0, 5), (10, 20)], [(3, 12), (15, 16)]) == 2 + 2 + 1


METRICS = ["merge_span_ms.bulk", "exchange_span_ms.mesh", "host_wait_ms.mesh",
           "plan_host_us.mesh", "host_path_idle_ms.mesh"]


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_on_records(name, monkeypatch):
    recs = two_calls()
    recs.append(rec("repro_torch.cluster.exchange", 1015, 1025, parent=0, device_ms=3.0))
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    value = harness.load_metric(name).read(harness.RunData(trace(), {"calls": 2}))
    want = {"merge_span_ms.bulk": 2.0, "exchange_span_ms.mesh": 1.5, "host_wait_ms.mesh": 0.01,
            "plan_host_us.mesh": 4.0, "host_path_idle_ms.mesh": 23e-3 / 2}[name]
    assert value == pytest.approx(want)
    # a program with no tracing module: nothing to read, and no exception
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert harness.load_metric(name).read(harness.RunData(trace(), {"calls": 2})) is None


def test_records_none_without_the_program_module(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch" and fromlist and "tracing" in fromlist:
            raise ImportError("no tracing module")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    assert program_spans.records() is None


def _profiled_calls(spans_on: bool, monkeypatch):
    """Three sorts under a CPU profile, in the benchmark's own spans; with
    ``spans_on`` False the program's spans are kept off."""
    import repro_torch
    from repro_torch import tracing

    if not spans_on:
        monkeypatch.setattr(tracing, "_profiler", SimpleNamespace(_is_profiler_enabled=False))
    x = torch.randn(2048)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            for _ in range(3):
                with record_function("sb.call"):
                    repro_torch.sort(x, strategy="shared", local_impl="kernel")
    monkeypatch.undo()
    names = {e.name for e in prof.events()}
    return collect(prof), any(n.startswith("repro_torch.") for n in names)


def test_collect_is_unchanged_by_the_programs_spans(monkeypatch):
    with_spans, seen = _profiled_calls(True, monkeypatch)
    without, unseen = _profiled_calls(False, monkeypatch)
    assert seen and not unseen
    assert [s.name for s in with_spans.spans] == [s.name for s in without.spans]
    assert sorted(s.name for s in with_spans.spans) == ["sb.call"] * 3 + [WINDOW]
    assert [op.name for op in with_spans.ops] == [op.name for op in without.ops]
