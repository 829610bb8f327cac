"""The decode top-k cell, ``topk_cmdr256k.decode``: its tiny CPU runs, its
reference against a brute-force loop, the control and the planted faults
that must make ``correct`` false, and its five per-layer readers."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from sortbench import harness, program_spans
from sortbench.drivers import rows_topk
from sortbench.reference import topk_ref
from sortbench.trace import WINDOW, Op, Span, Trace

CELL = "topk_cmdr256k.decode"
# the cell at a size a test holds: k and the bfloat16 rounding kept
TINY = {"config": {"rows": 4, "vocab": 3000, "pool": 2, "trace_seconds": 0.3}}
FAULTS = {
    rows_topk.CONTROL: "mismatched_indices",
    "sortbench.tests.topk_faults:shifted_row": "mismatched_indices",
    "sortbench.tests.topk_faults:stale_values": "mismatched_values",
}
METRICS = ["topk_roofline.decode", "device_launches.decode", "device_idle.decode",
           "kv_order_span_ms.decode", "launch_host_us.decode"]


def test_the_configuration_is_at_its_published_widths():
    cell = harness.find_cell(CELL)
    cfg, tr = cell.config, cell.traffic
    assert (cfg["rows"], cfg["vocab"], cfg["k"], cfg["reduced"]) == (128, 256000, 50, [])
    assert (tr["op"], tr["largest"], tr["dtype"], tr["round_to"]) == (
        "topk", True, "float32", "bfloat16")
    entry = next(c for c in harness.load_benchmark()["configs"] if c["name"] == "topk_cmdr256k")
    assert entry["reduced"] == [] and "256000" in entry["source"]
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert {m["name"] for m in cell.end_to_end} == {"keys_per_s", "setup_s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cpu_run(trace):
    lines = []
    r = harness.run_cell(CELL, 2 ** 31 + 17, 0.6, bool(trace), device="cpu", overrides=TINY,
                         info=lines.append)
    assert r["correct"] is True and r["attempted"] > 0
    assert set(r["checks"]) == {"mismatched_indices", "mismatched_values", "unchecked_calls"}
    assert all(c["value"] == 0 for c in r["checks"].values())
    if trace:
        # on the CPU no device operation and no event pair is traced
        assert r["metrics"] == {} and "breakdown" in r
    else:
        assert set(r["metrics"]) == {"keys_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    assert lines and all(isinstance(line, dict) for line in lines)


def _brute(row, k, key):
    return sorted(range(len(row)), key=key)[:k]


def _tied_rows():
    """Rows of few distinct values, so ties straddle the k-th place."""
    rng = np.random.default_rng(2 ** 33 + 5)
    return rng.integers(-1, 2, size=(6, 40)).astype(np.float32) * np.float32(0.5)


@pytest.mark.parametrize("largest", [True, False])
def test_reference_against_a_brute_force_loop(largest):
    keys, k = _tied_rows(), 7
    sign = -1 if largest else 1
    vals, idx = topk_ref.answer(keys, k, largest)
    cvals, cidx = topk_ref.control(keys, k, largest)
    assert idx.dtype == cidx.dtype == np.int32 and vals.dtype == np.float32
    for r, row in enumerate(keys):
        low = _brute(row, k, lambda i: (sign * row[i], i))
        high = _brute(row, k, lambda i: (sign * row[i], -i))
        assert idx[r].tolist() == low and cidx[r].tolist() == high
        assert vals[r].tolist() == cvals[r].tolist() == [row[i] for i in low]
    # every row has a tie across the k-th place
    ordered = np.sort(sign * keys, axis=-1)
    assert (ordered[:, k - 1] == ordered[:, k]).all()
    assert topk_ref.mismatches(cidx, idx) > 0 and topk_ref.mismatches(cvals, vals) == 0


def test_mismatches_counts_bits_shapes_and_dtypes():
    a = np.array([[0.0, 1.0]], dtype=np.float32)
    assert topk_ref.mismatches(a, a.copy()) == 0
    assert topk_ref.mismatches(a, np.array([[-0.0, 1.0]], dtype=np.float32)) == 1
    assert topk_ref.mismatches(a, a[:, :1]) == 2
    assert topk_ref.mismatches(a.astype(np.int32), a.astype(np.int64)) == 2


@pytest.mark.parametrize("hook", sorted(FAULTS))
def test_control_and_planted_faults_are_not_correct(hook):
    r = harness.run_cell(CELL, 2 ** 31 + 29, 0.6, False, device="cpu", overrides=TINY,
                         info=lambda obj: None, hooks=(hook,))
    assert r["correct"] is False
    assert r["checks"][FAULTS[hook]]["value"] > 0


def _run(trace=None, **counters):
    base = {"calls": 4, "window_s": 1.0, "least_bytes_per_call": 6.7e6,
            "launches_per_call": 20.0}
    return harness.RunData(trace, dict(base, **counters))


def _trace():
    """A 100 µs window, the device busy 0-30 and 50-90 in three kernels
    and a copy."""
    return Trace(ops=[Op("k", 0, 20), Op("k", 20, 30), Op("MemcpyDtoD", 50, 60),
                      Op("k", 60, 90)], spans=[Span(WINDOW, 0, 100)])


def _records(device_ms=1.25):
    """Four calls; the first two not held back by the card (kv.order 60
    and 80 µs of host time), the last two held back (400 µs)."""
    def rec(name, start_us, end_us, parent=None, call=1):
        return SimpleNamespace(name=name, parent=parent, call=call, thread=7,
                               start_ns=int(start_us * 1000), end_ns=int(end_us * 1000),
                               device_ms=None if name == "repro_torch.topk" else device_ms)
    recs = []
    for c, order_us in enumerate((80, 60, 400, 400)):
        t = 1000.0 * c
        recs += [rec("repro_torch.topk", t, t + order_us + 10, call=c + 1),
                 rec("repro_torch.kv.order", t + 5, t + 5 + order_us, parent=3 * c, call=c + 1),
                 rec("repro_torch.kv.gather", t + order_us + 6, t + order_us + 8,
                     parent=3 * c, call=c + 1)]
    return recs


def test_device_trace_readers():
    run = _run(_trace())
    busy_per_call = 70e-6 / 4
    assert harness.load_metric("topk_roofline.decode").read(run) == pytest.approx(
        6.7e6 / 3.35e12 / busy_per_call * 100)
    assert harness.load_metric("device_launches.decode").read(run) == pytest.approx(3 / 4)
    assert harness.load_metric("device_idle.decode").read(run) == pytest.approx(30.0)


def test_span_readers(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: _records())
    run = _run(_trace())
    assert harness.load_metric("kv_order_span_ms.decode").read(run) == pytest.approx(1.25)
    # the call least held back: 60 µs of host time in kv.order over 20 launches
    assert harness.load_metric("launch_host_us.decode").read(run) == pytest.approx(3.0)


@pytest.mark.parametrize("name", METRICS)
def test_readers_with_nothing_to_read(name, monkeypatch):
    """No trace, a trace with no device operation, a program without the
    spans (the parent), spans with no event pair (the CPU), no launches."""
    mod = harness.load_metric(name)
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert mod.read(_run()) is None
    if mod.SOURCE == "device_trace":
        assert mod.read(_run(Trace(spans=[Span(WINDOW, 0, 100)]))) is None
        return
    assert mod.read(_run(_trace())) is None
    monkeypatch.setattr(program_spans, "records", lambda: [])
    assert mod.read(_run(_trace())) is None
    if name == "kv_order_span_ms.decode":
        monkeypatch.setattr(program_spans, "records", lambda: _records(device_ms=None))
        assert mod.read(_run(_trace())) is None
    else:
        monkeypatch.setattr(program_spans, "records", lambda: _records())
        assert mod.read(_run(_trace(), launches_per_call=0)) is None


def test_a_run_loads_nothing_forbidden_and_the_reference_nothing_of_the_program():
    code = (
        "import json, os, sys\n"
        "sys.path.insert(0, os.getcwd())\n"
        "import sortbench.reference.topk_ref\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('repro_torch', 'torch', 'jax', 'repro', 'benchmarks'))\n"
        "from sortbench import harness\n"
        "from sortbench.tests.test_sortbench_topk import CELL, TINY\n"
        "for trace in (0, 1):\n"
        "    harness.run_cell(CELL, 5, 0.3, bool(trace), device='cpu', overrides=TINY,\n"
        "                     info=lambda obj: None)\n"
        "for m in harness.find_cell(CELL).per_layer:\n"
        "    harness.load_metric(m['name'])\n"
        "print(json.dumps([ref, harness.forbidden_modules()]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(harness.ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], []]
