"""The port's multihost harness: crash and hang containment, and its report schema.

The counterparts of ``tests/multihost/test_multihost_harness.py``.  A wedged
or killed rank must fail *that run* with diagnostics, quickly, and never
hang the pytest run.  The runs start together once per file (a module
fixture) and each test reads its own; times are the coordinator's
(``MultihostRun.wall_s``, ``first_failure_s``), so a loaded machine's slow
interpreter start-up does not count against containment.  The schema
validator is held against the reference's, doc for doc.
"""
import json
import os
from functools import partial

import pytest

import _torch_multihost as harness
from multihost import harness as ref_harness

B = "_torch_multihost_bodies.py"
RUNS = {
    "crash_victim_1": (f"{B}:crash_body", 2, {"victim": 1}, 60),
    "crash_victim_0": (f"{B}:crash_body", 2, {"victim": 0}, 60),
    "hang": (f"{B}:hang_body", 2, None, 10),
    "nonsense": (f"{B}:cluster_sort_body", 1, {"n": 64, "mode": "nonsense"}, None),
    "ok": (f"{B}:cluster_sort_body", 1, {"n": 64, "seed": 3}, None),
}


@pytest.fixture(scope="module")
def runs():
    def one(spec, nprocs, args, timeout):
        kw = {} if timeout is None else {"timeout": timeout}
        return harness.run_multihost(spec, nprocs, args=args, **kw)

    return harness.run_together({name: partial(one, *cfg) for name, cfg in RUNS.items()},
                                max_workers=len(RUNS))


def test_killed_rank_fails_cleanly_within_grace_period(runs):
    """Rank 1 dies hard (``os._exit(17)``, no report); rank 0 would sleep for
    two minutes.  The coordinator fails the run within the grace period of
    the death (plus 5 s) and terminates the survivor; a crash is not a
    timeout."""
    run = runs["crash_victim_1"]
    assert not run.ok
    assert not run.timed_out, "a crash is a failure, not a timeout"
    assert run.reports[1].returncode == 17
    assert "rc=17" in run.reports[1].error
    assert run.reports[0].returncode != 0, "survivor must have been terminated"
    contained = run.wall_s - run.first_failure_s
    assert contained < harness.GRACE_AFTER_FAILURE_S + 5, (
        f"containment took {contained:.1f}s after the death: survivor not reaped promptly")
    assert run.wall_s < harness.GRACE_AFTER_FAILURE_S + 30, run.describe()
    # per-rank diagnostics are available for the failure message
    assert "rank 1: FAILED" in run.describe()
    # every report, the synthesized one of the rank that died included,
    # satisfies the report schema
    for r in run.reports:
        doc = harness.validate_report_doc(r.to_doc())
        assert doc["rank"] == r.rank
    assert run.reports[1].result is None


def test_hung_run_is_killed_at_timeout(runs):
    run = runs["hang"]
    assert not run.ok
    assert run.timed_out
    assert run.wall_s < 15, f"timeout enforcement took {run.wall_s:.0f}s"
    assert all(not r.ok for r in run.reports)
    assert "timeout" in run.reports[0].error


def test_failed_rank_report_carries_traceback(runs):
    """A body that raises produces a per-rank report with the traceback."""
    run = runs["nonsense"]
    assert not run.ok
    r = run.reports[0]
    assert r.returncode == 1
    assert r.error and r.traceback
    assert "nonsense" in (r.traceback or "") or "nonsense" in (r.error or "")


def test_require_success_message_names_the_failing_rank(runs):
    with pytest.raises(AssertionError, match="rank 0: FAILED"):
        runs["crash_victim_0"].require_success()


# ------------------------------------------------------- report schema ---
GOOD = {"rank": 0, "ok": True, "result": {"x": 1}, "error": None}
# the reference test's malformed docs, each with the violation it names
BAD = [
    ([1, 2], "must be an object"),
    ({"rank": 0, "ok": True}, "missing fields"),
    ({**GOOD, "rank": -1}, "non-negative"),
    ({**GOOD, "rank": True}, "non-negative int"),
    ({**GOOD, "ok": 1}, "must be a bool"),
    ({**GOOD, "error": 5}, "null or a string"),
    ({**GOOD, "traceback": 5}, "null or a string"),
    ({**GOOD, "duration_s": "3s"}, "null or a number"),
    ({**GOOD, "returncode": "0"}, "null or an int"),
    ({**GOOD, "ok": False}, "must carry an error"),
    ({**GOOD, "result": {1, 2}}, "not JSON-serializable"),
]


def _verdict(validate, doc):
    try:
        validate(doc)
    except ValueError as e:
        return str(e)
    return "accepted"


def test_report_schema_validator_rejects_malformed():
    """Every way a report can rot raises with a message naming the
    violation, and the port's validator and the reference's accept or
    reject each doc alike, with the same message."""
    assert harness.validate_report_doc(GOOD) is GOOD
    assert ref_harness.validate_report_doc(GOOD) is GOOD
    for doc, msg in BAD:
        with pytest.raises(ValueError, match=msg):
            harness.validate_report_doc(doc)
        assert _verdict(harness.validate_report_doc, doc) == _verdict(
            ref_harness.validate_report_doc, doc)


def test_on_disk_reports_are_schema_valid(runs):
    """What ranks write (``_torch_multihost_worker.py``) satisfies the schema
    of both validators, ok and failed alike."""
    assert runs["ok"].ok, runs["ok"].describe()
    for run, want_ok in ((runs["ok"], True), (runs["nonsense"], False)):
        path = os.path.join(run.report_dir, "report-0.json")
        with open(path) as f:
            doc = harness.validate_report_doc(json.load(f))
        assert ref_harness.validate_report_doc(doc) is doc
        assert doc["ok"] is want_ok
        if not want_ok:
            assert "nonsense" in (doc["error"] or "") + (doc["traceback"] or "")


def test_run_port_contains_a_failing_rank(tmp_path):
    """``_torch_ranks.run_port`` shares the harness's containment: a rank
    that raises while its peer sits in a long wait fails the call within
    the grace period (the peer terminated), with every rank's log in the
    assertion."""
    import time

    import numpy as np

    from _torch_ranks import run_port, save_inputs

    save_inputs(tmp_path, {"x": np.zeros(2, np.int32)})
    body = """
if RANK == 1:
    raise RuntimeError("rank 1 fails on purpose")
time.sleep(120)
"""
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as info:
        run_port("import time\n" + body, 2, tmp_path, timeout=60)
    assert time.monotonic() - t0 < harness.GRACE_AFTER_FAILURE_S + 30
    msg = str(info.value)
    assert "rank 1 fails on purpose" in msg and "--- rank 0 ---" in msg
    assert "(1, 1)" in msg and "exceeded" not in msg
