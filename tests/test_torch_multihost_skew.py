"""Sample partition and skew auto-promotion across real gloo ranks.

The counterparts of ``tests/multihost/test_multihost_skew.py``:

* sample-mode ``cluster_sort`` on 2 and 4 ranks equals the reference body's
  output on a forced mesh of as many devices, and the port's one-rank run;
* the radix->sample auto-promotion loop runs end to end with every rank
  learning into one shared, fcntl-locked plan-cache file: the same per-step
  (mode, partition, retries, ratio, promoted, strikes) trace on every rank
  and in the reference body's run, and a promoted partition that persists
  through the file into a fresh planner, as the reference's does.

All runs start at once in the module fixture, each learning run with its
own plan file.
"""
import json
import os
from functools import partial

import pytest

import _torch_multihost as harness
from multihost import harness as ref_harness

SORTS = {2: {"n": 256, "seed": 13, "mode": "sample"}, 4: {"n": 512, "seed": 21, "mode": "sample"}}
# a 2-shard mesh has 2 buckets, so peak/mean tops out at exactly 2.0 and can
# never exceed the default promote_ratio: the 2-rank case lowers it
PROMOTIONS = {2: {"n": 256, "seed": 2, "steps": 5, "promote_ratio": 1.5},
              4: {"n": 512, "seed": 4, "steps": 5}}
RESTART = ("restart_partition", "restart_strikes", "restart_mode")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("multihost_skew")
    calls = {}
    for nprocs, args in SORTS.items():
        calls[("sort", nprocs, "port")] = partial(
            harness.run_multihost, "_torch_multihost_bodies.py:cluster_sort_body", nprocs,
            args=args)
        calls[("sort", nprocs, "single")] = partial(
            harness.run_single, "_torch_multihost_bodies.py:cluster_sort_body", args=args)
        calls[("sort", nprocs, "ref")] = partial(
            ref_harness.run_forced_mesh, "bodies.py:cluster_sort_body", nprocs, args=args)
    for nprocs, args in PROMOTIONS.items():
        calls[("promote", nprocs, "port")] = partial(
            harness.run_multihost, "_torch_multihost_bodies.py:skew_promotion_body", nprocs,
            args={**args, "plans_path": str(wd / f"port{nprocs}.json")})
        calls[("promote", nprocs, "ref")] = partial(
            ref_harness.run_forced_mesh, "bodies.py:skew_promotion_body", nprocs,
            args={**args, "plans_path": str(wd / f"ref{nprocs}.json")})
    out = harness.run_together(calls)
    return wd, {k: run.require_success() for k, run in out.items()}


@pytest.mark.parametrize("nprocs", sorted(SORTS))
def test_sample_mode_bit_identical_to_forced(runs, nprocs):
    runs = runs[1]
    results = runs[("sort", nprocs, "port")].results()
    assert all(r["sorted"] == results[0]["sorted"] for r in results), "ranks disagree"
    assert results[0]["sorted"] == runs[("sort", nprocs, "ref")].result()["sorted"], (
        f"{nprocs}-rank sample-mode sort differs from the reference's {nprocs}-device mesh")
    assert results[0]["sorted"] == runs[("sort", nprocs, "single")].result()["sorted"]


def _check_promotion_trace(trace):
    """The canonical trajectory: a radix era accruing strikes, a latch, then
    a balanced zero-retry sample era."""
    assert trace[0]["mode"] == "radix" and trace[0]["partition"] == "radix"
    assert trace[0]["promoted"] is None
    flip = next(i for i, t in enumerate(trace) if t["promoted"] == "sample")
    assert trace[flip]["strikes"] >= 3
    post = trace[flip + 1:]
    assert post, "need post-promotion steps in the trace"
    for t in post:
        assert t["mode"] == "sample" and t["partition"] == "sample"
        assert t["retries"] == 0, f"promoted cell still overflowing: {t}"
        assert t["ratio"] <= 1.5, f"promoted cell still skewed: {t}"
    return flip


def _check_against_reference(port, ref):
    results = port.results()
    assert all(r["trace"] == results[0]["trace"] for r in results), "ranks disagree"
    want = ref.result()
    assert results[0]["trace"] == want["trace"], "the promotion path differs from the reference's"
    for r in results:
        assert {k: r[k] for k in RESTART} == {k: want[k] for k in RESTART}
    assert results[0]["sorted"] == want["sorted"]
    return results


def test_skew_promotion_2proc_persists_through_locked_cache(runs):
    wd, runs = runs
    r0, _ = _check_against_reference(runs[("promote", 2, "port")], runs[("promote", 2, "ref")])
    _check_promotion_trace(r0["trace"])
    assert r0["restart_partition"] == "sample"
    assert r0["restart_mode"] == "sample", (
        "a restarted planner's serving path must inject sample mode")
    # the shared file both ranks wrote through the fcntl lock carries the
    # latch in the v3 schema
    with open(os.path.join(wd, "port2.json")) as f:
        doc = json.load(f)
    assert doc["version"] == 3
    (entry,) = doc["learned"].values()
    assert entry["partition"] == "sample" and entry["skew_strikes"] >= 3


def test_skew_promotion_4proc_default_threshold(runs):
    runs = runs[1]
    results = _check_against_reference(runs[("promote", 4, "port")], runs[("promote", 4, "ref")])
    flip = _check_promotion_trace(results[0]["trace"])
    assert results[0]["trace"][0]["retries"] >= 1, (
        "radix mode should pay overflow retries on 4-bucket Zipf data")
    assert flip >= 2, "promotion needs persistent skew, not one bad call"
    assert all(r["restart_partition"] == "sample" for r in results)
    assert results[0]["restart_mode"] == "sample"
