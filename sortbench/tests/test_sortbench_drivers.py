"""One tiny run of each driver on the CPU through the test-only entry
(``harness.run_cell(device="cpu")``), and the command itself refusing to
run without a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from sortbench import harness

TINY = {
    "bulk10m.sort_f32": {"config": {"n": 4096, "pool": 2, "trace_seconds": 0.3}},
    "bulk10m.argsort_i32": {"config": {"n": 4096, "pool": 2, "trace_seconds": 0.3}},
    "cluster40m.uniform_f32": {"config": {"world": 2, "n_per_rank": 4096, "trace_seconds": 0.3,
                                          "timeout_s": 120}},
}


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without one")


@pytest.fixture
def plans(tmp_path, monkeypatch):
    path = str(tmp_path / "plans.json")
    monkeypatch.setenv("REPRO_SORT_PLANS", path)
    return path


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_cpu_run(name, trace, plans):
    lines = []
    r = harness.run_cell(name, 2 ** 31 + 17, 0.6, bool(trace), device="cpu",
                         overrides=TINY[name], info=lines.append, plans=plans)
    assert r["correct"] is True and r["attempted"] > 0
    assert list(r)[-1] == "checks" and all(c["value"] == 0 for c in r["checks"].values())
    cell = harness.find_cell(name)
    if trace:
        # on the CPU no device operation is traced: only counters are read
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert "breakdown" in r
    else:
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    assert lines and all(isinstance(line, dict) for line in lines)  # earlier lines, not results


def test_command_refuses_without_a_card(no_card):
    out = subprocess.run([sys.executable, "sortbench/run.py", "--workload", "bulk10m.sort_f32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_command_fails_with_only_the_benchmark(tmp_path, no_card):
    """A checkout holding only BENCHMARK.json and the benchmark's folder has
    no program: the command fails and prints no result."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "sortbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "sortbench/run.py", "--workload", "bulk10m.sort_f32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert not any(line.startswith("{\"correct\"") for line in out.stdout.splitlines())


def test_result_line_is_json_with_the_contract_keys(plans):
    r = harness.run_cell("bulk10m.sort_f32", 3, 0.3, False, device="cpu",
                         overrides=TINY["bulk10m.sort_f32"], info=lambda obj: None, plans=plans)
    line = json.loads(json.dumps(r))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())


def test_four_rank_mesh_on_the_cpu(plans):
    """The mesh driver at the cell's own four ranks (gloo on the CPU)."""
    ov = {"config": dict(TINY["cluster40m.uniform_f32"]["config"], world=4)}
    r = harness.run_cell("cluster40m.uniform_f32", 2 ** 31 + 19, 0.6, False, device="cpu",
                         overrides=ov, info=lambda obj: None, plans=plans)
    assert r["correct"] is True and r["device"]["count"] == 4
    assert r["metrics"]["mesh_keys_per_s"]["value"] > 0
