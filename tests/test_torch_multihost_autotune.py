"""Rank-coordinated autotune on real gloo ranks, with its fault battery.

The counterparts of ``tests/multihost/test_multihost_autotune.py``, held
within the port as the reference's own tests hold the reference, since the
winners depend on timing: a ``Planner.autotune`` sweep on 2 or 4 ranks must
land every rank on the same winning plan (rank 0's, broadcast), with rank 0
the only writer of the shared plan cache; a rank killed or hung mid-sweep
must fail contained and leave the cache loadable, holding what it held
before; two uncoordinated autotuners must merge their cells through the
fcntl-locked save.  All runs start at once in the module fixture, each with
its own plan file.  The hang case bounds gloo's collectives at 10 s
(``gloo_timeout_s``), so the rank blocked in the candidate barrier fails on
its own and the run ends in the grace period after it, well inside its
45 s timeout.
"""
import json
import os
from functools import partial

import pytest

import _torch_multihost as harness
from repro_torch.engine.planner import Planner, SortPlan

SEED_KEY = "32|int32|seed/fp"
HANG_TIMEOUT_S = 45


def _strict_load(plans_path):
    """Load the shared cache the way tooling does: strict, fresh planner."""
    return Planner(device="cpu").load(plans_path, strict=True)


def _seed_cache(plans_path):
    """One known cell in the shared cache, so the fault tests show a failed
    sweep preserved prior contents, not only an empty file."""
    p = Planner(device="cpu")
    p.plans[SEED_KEY] = SortPlan("shared", us_per_call=1.0)
    p.save(plans_path)


def _autotune(plans_path, nprocs, *, reps=2, fault=None, gloo_timeout_s=None, timeout=None):
    args = {"plans_path": plans_path, "n": 256, "reps": reps}
    if fault is not None:
        args["fault"] = fault
    if gloo_timeout_s is not None:
        args["gloo_timeout_s"] = gloo_timeout_s
    kw = {} if timeout is None else {"timeout": timeout}
    return partial(harness.run_multihost, "_torch_multihost_bodies.py:autotune_body", nprocs,
                   args=args, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("multihost_autotune")
    dirs = {name: wd / name for name in ("two", "four", "writer", "killed", "hung", "local")}
    for d in dirs.values():
        d.mkdir()
    paths = {name: str(d / "plans.json") for name, d in dirs.items()}
    _seed_cache(paths["killed"])
    _seed_cache(paths["hung"])
    calls = {
        "two": _autotune(paths["two"], 2),
        "four": _autotune(paths["four"], 4),
        "writer": _autotune(paths["writer"], 2, reps=1),
        "killed": _autotune(paths["killed"], 2, timeout=120,
                            fault={"rank": 1, "point": "candidate:1", "kind": "crash"}),
        "hung": _autotune(paths["hung"], 2, gloo_timeout_s=10, timeout=HANG_TIMEOUT_S,
                          fault={"rank": 1, "point": "candidate:1", "kind": "hang"}),
        "local": partial(harness.run_multihost, "_torch_multihost_bodies.py:autotune_local_body",
                         2, args={"plans_path": paths["local"], "base_n": 64, "reps": 2}),
    }
    return dirs, paths, harness.run_together(calls)


# ------------------------------------------------------------ bit identity ---
def test_two_process_sweep_bit_identical_across_ranks_and_cache(runs):
    _, paths, runs = runs
    r0, r1 = runs["two"].require_success().results()
    # the whole plan table - winner, timings, every cell - is identical
    assert r0["best"] == r1["best"]
    assert r0["plans"] == r1["plans"]
    assert r0["plan_key"] == r1["plan_key"]
    assert r0["mesh_fp"] == "cpu/ranks=2/procs2x1", r0["mesh_fp"]
    # ... and identical to the cache rank 0 wrote
    fresh = _strict_load(paths["two"])
    assert fresh.plans[r0["plan_key"]].to_dict() == r0["best"]
    assert {k: p.to_dict() for k, p in fresh.plans.items()} == r0["plans"]


def test_four_process_sweep_bit_identical_across_ranks_and_cache(runs):
    _, paths, runs = runs
    results = runs["four"].require_success().results()
    assert all(r["best"] == results[0]["best"] for r in results)
    assert all(r["plans"] == results[0]["plans"] for r in results)
    assert results[0]["mesh_fp"] == "cpu/ranks=4/procs4x1"
    fresh = _strict_load(paths["four"])
    assert fresh.plans[results[0]["plan_key"]].to_dict() == results[0]["best"]


def test_rank0_is_the_single_writer(runs):
    """Rank 0 persisted the winner; every other rank only read the file the
    post-save barrier guaranteed was on disk."""
    _, paths, runs = runs
    assert [r["wrote"] for r in runs["writer"].require_success().results()] == [True, False]
    with open(paths["writer"]) as f:
        doc = json.load(f)
    assert doc["version"] == 3
    (key,) = doc["plans"]
    assert key.endswith("/procs2x1"), key


# ------------------------------------------------- fault-injection battery ---
def test_rank_killed_mid_sweep_leaves_cache_uncorrupted(runs):
    """Rank 1 dies hard between two timed candidates; rank 0 fails in the
    next barrier.  The sweep never reached its save, so the shared cache
    still holds exactly the pre-seeded cell: strictly loadable, no partial
    writes, no leftover tmp files; the run ended by the grace period, not
    the timeout."""
    dirs, paths, runs = runs
    run = runs["killed"]
    assert not run.ok, run.describe()
    assert not run.timed_out, run.describe()
    # rank 1 died at the armed point, after both ranks had joined the group
    assert run.fault_reached(1) == "candidate:1", run.describe()
    assert run.reports[0].joined, run.describe()
    assert run.reports[1].returncode == 13, run.describe()
    assert run.wall_s - run.first_failure_s < harness.GRACE_AFTER_FAILURE_S + 5
    fresh = _strict_load(paths["killed"])
    assert sorted(fresh.plans) == [SEED_KEY]
    assert fresh.learned == {}
    tmps = [f for f in os.listdir(dirs["killed"]) if ".tmp." in f]
    assert not tmps, f"partial plan-cache writes left behind: {tmps}"


def test_rank_hung_during_timed_collective_fails_contained(runs):
    """Rank 1 wedges mid-sweep, leaving rank 0 blocked inside the candidate
    barrier (a real collective).  The run ends - gloo's own timeout or the
    harness deadline, whichever lands first - without the cache changing."""
    _, paths, runs = runs
    run = runs["hung"]
    assert not run.ok, run.describe()
    assert all(not r.ok for r in run.reports)
    assert run.wall_s < HANG_TIMEOUT_S + 5, run.describe()
    # rank 1 hung at the armed point, after both ranks had joined the group
    assert run.fault_reached(1) == "candidate:1", run.describe()
    assert run.reports[0].joined, run.describe()
    # here gloo's 10 s lands first: rank 0 reports its own collective inside
    # the autotune timed out
    r0 = run.reports[0]
    assert not run.timed_out and "Timed out" in r0.error, run.describe()
    assert "in autotune" in r0.traceback, run.describe()
    fresh = _strict_load(paths["hung"])
    assert sorted(fresh.plans) == [SEED_KEY]


def test_two_concurrent_autotuners_merge_to_a_union_table(runs):
    """Two uncoordinated autotuning ranks (``distributed=False``) race
    rank-distinct cells into one shared cache: the fcntl-locked merge-on-save
    unions the tables; both cells survive under their multi-process
    fingerprint, strictly loadable."""
    _, paths, runs = runs
    r0, r1 = runs["local"].require_success().results()
    assert r0["plan_key"] != r1["plan_key"], "ranks must tune distinct cells"
    assert [r["wrote"] for r in (r0, r1)] == [True, True]
    assert r0["plan_key"].endswith("|local/cpu/procs2x1"), r0["plan_key"]
    fresh = _strict_load(paths["local"])
    assert sorted(fresh.plans) == sorted([r0["plan_key"], r1["plan_key"]])
    assert fresh.plans[r0["plan_key"]].to_dict() == r0["best"]
    assert fresh.plans[r1["plan_key"]].to_dict() == r1["best"]
