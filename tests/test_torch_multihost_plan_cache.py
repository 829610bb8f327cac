"""Concurrent capacity learning across real gloo ranks, one plan-cache file.

The counterparts of ``tests/multihost/test_multihost_plan_cache.py``: two
ranks run the full sort capacity-learning loop (``sort_learn_body``) at
once against one JSON file, which must end up *merged*: both ranks' cells
under ``per_host`` scope, one converged cell under ``global`` scope, never a
last-writer-wins clobber.  The learned factors, and the learned keys up to
the fingerprint, equal the reference body's on a forced 2-device mesh with
the same args (``run_forced_mesh``, one process: a single ``@h0`` cell
under ``per_host``), each side on its own files.
"""
import json
import os
from functools import partial

import pytest

import _torch_multihost as harness
from multihost import harness as ref_harness

BODY = "sort_learn_body"
ARGS = {"n": 256, "seed": 0}
PORT_FP, REF_FP = "cpu/ranks=2/procs2x1", "cpu/x=2"


def _port(path, scope):
    return harness.run_multihost(f"_torch_multihost_bodies.py:{BODY}", 2,
                                 args={**ARGS, "plans_path": path, "scope": scope})


def _ref(path, scope):
    return ref_harness.run_forced_mesh(f"bodies.py:{BODY}", 2,
                                       args={**ARGS, "plans_path": path, "scope": scope})


def _twice(run, path):
    """Two runs one after the other on one plan file (the second a restart)."""
    return run(path, "global").require_success(), run(path, "global").require_success()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("multihost_plan_cache")
    paths = {f"{side}/{case}": str(wd / f"{side}_{case}.json")
             for side in ("port", "ref") for case in ("per_host", "global", "warm")}
    calls = {}
    for side, run in (("port", _port), ("ref", _ref)):
        for scope in ("per_host", "global"):
            calls[f"{side}/{scope}"] = partial(run, paths[f"{side}/{scope}"], scope)
        calls[f"{side}/warm"] = partial(_twice, run, paths[f"{side}/warm"])
    return paths, harness.run_together(calls)


def _load(plans_path):
    with open(plans_path) as f:
        return json.load(f)


def _same_cell(port_key, ref_key):
    assert port_key.split("|")[:2] == ref_key.split("|")[:2]
    assert port_key.replace(PORT_FP, REF_FP) == ref_key


def test_per_host_scope_merges_both_hosts_cells(runs):
    paths, runs = runs
    r0, r1 = runs["port/per_host"].require_success().results()
    ref = runs["ref/per_host"].require_success().result()
    assert r0["plan_key"] == r1["plan_key"]
    assert r0["scoped_key"].endswith("@h0")
    assert r1["scoped_key"].endswith("@h1")
    # skewed range-mode traffic forced the learner above the default
    assert r0["learned_factor"] > 2.0
    assert r0["learned_factor"] == r1["learned_factor"] == ref["learned_factor"]
    _same_cell(r0["scoped_key"], ref["scoped_key"])

    doc = _load(paths["port/per_host"])
    assert sorted(doc["learned"]) == sorted({r0["scoped_key"], r1["scoped_key"]}), (
        "both ranks' learned cells must survive concurrent saves")
    want = _load(paths["ref/per_host"])["learned"][ref["scoped_key"]]
    for key in (r0["scoped_key"], r1["scoped_key"]):
        assert doc["learned"][key]["capacity_factor"] == r0["learned_factor"]
        assert doc["learned"][key] == want


def test_global_scope_converges_to_one_merged_cell(runs):
    paths, runs = runs
    r0, r1 = runs["port/global"].require_success().results()
    ref = runs["ref/global"].require_success().result()
    assert r0["scoped_key"] == r0["plan_key"], "global scope adds no host suffix"
    _same_cell(r0["plan_key"], ref["plan_key"])
    assert r0["learned_factor"] == r1["learned_factor"] == ref["learned_factor"]
    doc = _load(paths["port/global"])
    assert sorted(doc["learned"]) == [r0["plan_key"]]
    assert doc["learned"][r0["plan_key"]]["capacity_factor"] == r0["learned_factor"]
    assert [k.replace(PORT_FP, REF_FP) for k in r0["learned_keys"]] == ref["learned_keys"]


def test_learned_state_warms_a_fresh_planner_in_a_new_run(runs):
    """A second run against the same plan file starts from the learned
    factor (the restart warm start the persistence exists for)."""
    paths, runs = runs
    first, second = runs["port/warm"]
    ref_first, ref_second = runs["ref/warm"]
    # same traffic, so the already-learned factor holds steady
    assert second.result()["learned_factor"] == first.result()["learned_factor"]
    assert second.result()["learned_factor"] == ref_second.result()["learned_factor"]
    assert first.result()["learned_factor"] == ref_first.result()["learned_factor"]
    entry = _load(paths["port/warm"])["learned"][first.result()["plan_key"]]
    assert entry["observations"] >= 2
    ref_entry = _load(paths["ref/warm"])["learned"][ref_first.result()["plan_key"]]
    assert entry["capacity_factor"] == ref_entry["capacity_factor"]
