"""``repro_torch.tracing``: spans off without a profiler, records under one,
and the span names the port uses."""
import os
import re
import subprocess
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch
from repro_torch import engine, tracing

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_without_a_profiler():
    before = tracing.records()
    with tracing.span("repro_torch.test.outer") as rec:
        with tracing.span("repro_torch.test.inner", device=torch.zeros(1)):
            pass
    assert rec is None
    assert tracing.span("repro_torch.test.a") is tracing.span("repro_torch.test.b")
    assert tracing.records() == before


def test_records_empty_in_a_fresh_process():
    code = ("import torch; from repro_torch import tracing\n"
            "with tracing.span('repro_torch.test'): torch.ones(3).sum()\n"
            "print(len(tracing.records()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"


def test_nested_spans_record_parent_call_and_times():
    with _cpu_profile() as prof:
        for _ in range(2):
            with tracing.span("repro_torch.test.root"):
                with tracing.span("repro_torch.test.child"):
                    torch.ones(8).sum()
                with tracing.span("repro_torch.test.child"):
                    with tracing.span("repro_torch.test.leaf"):
                        pass
    recs = tracing.records()
    assert [r.name.rsplit(".", 1)[1] for r in recs] == ["root", "child", "child", "leaf"] * 2
    assert [r.parent for r in recs] == [None, 0, 0, 2, None, 4, 4, 6]
    assert recs[4].call == recs[0].call + 1
    assert all(r.call == recs[0].call for r in recs[:4])
    assert all(r.call == recs[4].call for r in recs[4:])
    for r in recs:
        assert r.start_ns < r.end_ns and r.device_ms is None
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert recs[1].end_ns <= recs[2].start_ns and recs[3].end_ns <= recs[4].start_ns
    names = [e.name for e in prof.events()]
    for n in ("root", "child", "leaf"):
        assert names.count(f"repro_torch.test.{n}") == {"root": 2, "child": 4, "leaf": 2}[n]


def test_self_time_is_duration_less_children():
    with _cpu_profile():
        with tracing.span("repro_torch.test.root"):
            with tracing.span("repro_torch.test.child"):
                torch.ones(64).sum()
            torch.ones(64).sum()
            with tracing.span("repro_torch.test.child"):
                pass
    recs = tracing.records()
    root, a, b = recs
    want = (root.end_ns - root.start_ns) - (a.end_ns - a.start_ns) - (b.end_ns - b.start_ns)
    assert tracing.self_ns(recs, 0) == want
    assert tracing.self_ns(recs, 1) == a.end_ns - a.start_ns


def test_a_second_session_drops_the_first():
    with _cpu_profile():
        with tracing.span("repro_torch.test.first"):
            pass
    assert [r.name for r in tracing.records()] == ["repro_torch.test.first"]
    with _cpu_profile():
        assert tracing.records() == []
        with tracing.span("repro_torch.test.second"):
            pass
    assert [r.name for r in tracing.records()] == ["repro_torch.test.second"]
    with _cpu_profile():
        pass
    assert tracing.records() == []


@pytest.mark.parametrize("device", [torch.zeros(4), torch.device("cpu"), "cpu"])
def test_device_spans_on_the_cpu_record_no_event(device):
    with _cpu_profile():
        with tracing.span("repro_torch.test.device", device=device):
            torch.ones(4).sum()
    (rec,) = tracing.records()
    assert rec._events is None and rec.device_ms is None


def test_threads_keep_their_own_stacks_and_call_ids():
    seen = {}
    # both threads alive at once: a thread that ended may hand its ident on
    both_started = threading.Barrier(2, timeout=60)

    def work(tag):
        both_started.wait()
        for _ in range(3):
            with tracing.span(f"repro_torch.test.{tag}"):
                with tracing.span(f"repro_torch.test.{tag}.child"):
                    pass
        seen[tag] = threading.get_ident()

    with _cpu_profile():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    recs = tracing.records()
    for tag in ("a", "b"):
        mine = [(i, r) for i, r in enumerate(recs) if r.thread == seen[tag]]
        roots = [r for _, r in mine if r.parent is None]
        assert [r.name for r in roots] == [f"repro_torch.test.{tag}"] * 3
        assert len({r.call for r in roots}) == 3
        for i, r in mine:
            if r.parent is not None:
                assert recs[r.parent].thread == r.thread and recs[r.parent].call == r.call


def test_sort_front_door_spans():
    x = torch.randn(3000)
    with _cpu_profile() as prof:
        with record_function("outside"):
            out = repro_torch.sort(x, strategy="shared", local_impl="kernel")
    assert torch.equal(out, torch.sort(x).values)
    recs = tracing.records()
    assert [r.name for r in recs] == (["repro_torch.sort", "repro_torch.plan"]
                                      + ["repro_torch.shared.merge"] * 3)
    assert [r.parent for r in recs] == [None, 0, 0, 0, 0]
    events = {e.name for e in prof.events()}
    assert {r.name for r in recs} <= events


def _tied_logits():
    """(4, 3000) logits computed in bfloat16 and held as float32, as a bf16
    model hands them to its sampler: equal values straddle the 50th place."""
    g = torch.Generator().manual_seed(2 ** 31 + 3)
    return (torch.randn(4, 3000, generator=g) * 3.0).to(torch.bfloat16).float()


def test_topk_spans_nest_under_one_root():
    x = _tied_logits()
    with _cpu_profile() as prof:
        with record_function("outside"):
            engine.topk(x, 50, impl="kernel")
    recs = tracing.records()
    assert [r.name for r in recs] == ["repro_torch.topk", "repro_torch.kv.order",
                                      "repro_torch.kv.gather"]
    assert [r.parent for r in recs] == [None, 0, 0]
    assert len({r.call for r in recs}) == 1
    assert recs[1].end_ns <= recs[2].start_ns
    assert {r.name for r in recs} <= {e.name for e in prof.events()}


def test_argsort_records_the_kv_order_span():
    keys = torch.randint(0, 50, (3000,), dtype=torch.int32)
    with _cpu_profile():
        out = engine.argsort(keys, impl="kernel")
    assert torch.equal(out, torch.argsort(keys, stable=True).to(torch.int32))
    assert [(r.name, r.parent) for r in tracing.records()] == [("repro_torch.kv.order", None)]


def test_kv_spans_record_nothing_without_a_profiler():
    before = tracing.records()
    engine.topk(_tied_logits(), 50, impl="kernel")
    engine.argsort(torch.randint(0, 50, (3000,), dtype=torch.int32), impl="kernel")
    assert tracing.records() == before


def test_topk_answers_alike_with_spans_on_and_off():
    x = _tied_logits()
    top = torch.sort(x, dim=-1, descending=True).values[:, :51]
    assert (top[:, 49] == top[:, 50]).any()  # ties across the 50th place
    answers = []
    for impl in ("kernel", "xla"):
        answers.append(engine.topk(x, 50, impl=impl))
        with _cpu_profile():
            answers.append(engine.topk(x, 50, impl=impl))
    vals, idx = answers[0]
    assert idx.dtype == torch.int32
    for v, i in answers[1:]:
        assert torch.equal(v.view(torch.int32), vals.view(torch.int32)) and torch.equal(i, idx)


def test_span_names_in_the_port():
    """Every span the port opens is named repro_torch.<...>: none may read
    as a benchmark's sb.* span or a CUDA runtime call (cu*)."""
    names = []
    for root, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names += re.findall(r"\bspan\(\s*[fr]?[\"']([^\"']*)[\"']", fh.read())
    assert len(set(names)) >= 6
    assert all(n.startswith("repro_torch.") for n in names), names
    assert not any(n.startswith(("sb.", "cu")) for n in names)
