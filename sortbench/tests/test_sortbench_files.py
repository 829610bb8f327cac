"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""
import json
import os

import pytest

from sortbench import harness

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = 200


def _line(text):
    return 1 <= len(text) <= LINE and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "sortbench/run.py"]
    assert BENCH["paths"] == ["sortbench"]
    assert all(_line(word) for word in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    assert all(harness.NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])


def test_four_chip_cells_within_the_share():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        c = harness.find_cell(cell)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.find_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert name == f"{entry['config']}.{entry['traffic']}"
    assert os.path.exists(os.path.join(harness.HERE, "drivers", cell.config["driver"] + ".py"))
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert config["file"] == f"sortbench/configs/{entry['config']}.json"


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_file_declares_its_entry(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    mod = harness.load_metric(name)
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
        entry["name"], entry["unit"], entry["layer"], entry["source"], entry["moves"])
    assert mod.WORKLOADS == entry["workloads"]
    for cell in entry["workloads"]:
        assert entry["moves"] in {m["name"] for m in harness.find_cell(cell).end_to_end}


def test_layers_named_alike_share_one_spelling():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len({layer.split(" (")[0] for layer in layers}) == len(layers)


def test_every_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_check_budget_fits():
    """2 + 14 runs a cell at run_seconds + 60, 180 s a cell to compile and
    1200 s spare fit in 43200 s with 24 cells."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
