"""Model D across real gloo ranks, against the reference body and one rank.

The counterparts of ``tests/multihost/test_multihost_sort.py``.  Each case
runs the port's ``cluster_sort_body`` / ``cluster_sort_kv_body`` on P
ranks and on one rank (``run_single``), and the reference's own body on a
forced P-device mesh (``tests/multihost/harness.py:run_forced_mesh``), all
started at once by the module fixture.  Sorted keys, the stable index and
the float payload's hash are held bit for bit.

The reference's 2-process x 2-device topology has no port counterpart (a
rank is a process with one device); its test becomes: the plan-cache
fingerprints at 2 and 4 ranks differ, name the rank count and the process
layout, and round-trip through ``parse_plan_key``.
"""
from functools import partial

import pytest

import _torch_multihost as harness
from multihost import harness as ref_harness
from repro_torch.engine.planner import parse_plan_key

CASES = {
    "splitters2": ("cluster_sort_body", 2, {"n": 256, "seed": 3, "mode": "splitters"}),
    "range2": ("cluster_sort_body", 2, {"n": 300, "seed": 11, "mode": "range"}),
    "splitters4": ("cluster_sort_body", 4, {"n": 512, "seed": 7, "mode": "splitters"}),
    "kv2": ("cluster_sort_kv_body", 2, {"n": 200, "seed": 5}),
}


@pytest.fixture(scope="module")
def runs():
    calls = {}
    for name, (body, nprocs, args) in CASES.items():
        calls[f"{name}/port"] = partial(harness.run_multihost,
                                        f"_torch_multihost_bodies.py:{body}", nprocs, args=args)
        calls[f"{name}/single"] = partial(harness.run_single,
                                          f"_torch_multihost_bodies.py:{body}", args=args)
        calls[f"{name}/ref"] = partial(ref_harness.run_forced_mesh, f"bodies.py:{body}", nprocs,
                                       args=args)
    out = harness.run_together(calls)
    return {k: run.require_success() for k, run in out.items()}


def _check_sorted(runs, name):
    port, single, ref = (runs[f"{name}/{side}"] for side in ("port", "single", "ref"))
    results = port.results()
    assert all(r["sorted"] == results[0]["sorted"] for r in results), "ranks disagree"
    assert results[0]["sorted"] == ref.result()["sorted"], (
        f"{port.nprocs}-rank sort differs from the reference's {port.nprocs}-device mesh")
    assert results[0]["sorted"] == single.result()["sorted"], "differs from one rank"
    return results


def test_cluster_sort_2proc_bit_identical_to_forced(runs):
    r0, _ = _check_sorted(runs, "splitters2")
    assert r0["processes"] == 2 and r0["devices"] == 2


def test_cluster_sort_range_mode_2proc_bit_identical_to_forced(runs):
    _check_sorted(runs, "range2")


def test_cluster_sort_4proc(runs):
    results = _check_sorted(runs, "splitters4")
    assert results[0]["devices"] == 4


def test_fingerprint_names_each_topology(runs):
    """2 and 4 ranks: distinct plan-cache fingerprints that name the rank
    count and the process layout, round-trip through ``parse_plan_key``, and
    never share a cell with the reference's single-process mesh."""
    two = runs["splitters2/port"].result()
    four = runs["splitters4/port"].result()
    assert two["mesh_fp"] == "cpu/ranks=2/procs2x1"
    assert four["mesh_fp"] == "cpu/ranks=4/procs4x1"
    assert two["local_fp"] == "local/cpu/procs2x1"
    assert runs["splitters2/single"].result()["mesh_fp"] == "cpu/ranks=1"
    for r, n in ((two, 256), (four, 512)):
        bucket, dtype_name, fp = parse_plan_key(r["plan_key"])
        assert (bucket, dtype_name, fp) == (n, "int32", r["mesh_fp"])
    assert runs["splitters4/ref"].result()["mesh_fp"] == "cpu/x=4"
    assert len({two["mesh_fp"], four["mesh_fp"], runs["splitters4/ref"].result()["mesh_fp"]}) == 3


def test_cluster_sort_kv_2proc_bit_identical_to_forced(runs):
    port, single, ref = (runs[f"kv2/{side}"] for side in ("port", "single", "ref"))
    r0, r1 = port.results()
    f, s = ref.result(), single.result()
    assert r0["sorted_keys"] == r1["sorted_keys"] == f["sorted_keys"] == s["sorted_keys"]
    assert r0["idx"] == r1["idx"] == f["idx"] == s["idx"], (
        "stability order differs across process counts")
    assert r0["w_sha"] == r1["w_sha"] == f["w_sha"] == s["w_sha"], (
        "float payload not bit-identical")
