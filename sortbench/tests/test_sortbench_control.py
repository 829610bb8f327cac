"""The control (the reference one step below the configuration's
precision, or without its stability, in the program's place) and each
fault a cell can have, planted under the timed path: every one of them
must make ``correct`` come out false."""
import pytest

from sortbench import control, harness
from sortbench.tests.test_sortbench_drivers import TINY

FAULTS = {
    "bulk10m.sort_f32": ["unchanged", "altered"],
    "bulk10m.argsort_i32": ["unchanged", "altered"],
    "cluster40m.uniform_f32": ["unchanged", "altered", "no_exchange"],
}


@pytest.fixture
def plans(tmp_path, monkeypatch):
    path = str(tmp_path / "plans.json")
    monkeypatch.setenv("REPRO_SORT_PLANS", path)
    return path


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct(name, plans):
    r = control.run_control(name, 2 ** 31 + 23, 0.6, device="cpu", overrides=TINY[name])
    assert r["correct"] is False
    assert max(c["value"] for c in r["checks"].values()) > 0


@pytest.mark.parametrize("name, fault", [(n, f) for n, fs in sorted(FAULTS.items()) for f in fs])
def test_planted_fault_is_not_correct(name, fault, plans):
    r = harness.run_cell(name, 2 ** 31 + 29, 0.6, False, device="cpu", overrides=TINY[name],
                         info=lambda obj: None, plans=plans,
                         hooks=(f"sortbench.tests.faults:{fault}",))
    assert r["correct"] is False
