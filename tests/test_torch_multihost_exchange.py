"""The exchange layer over real cross-rank all_to_all, against the reference body.

The counterparts of ``tests/multihost/test_multihost_exchange.py``:
``partition_exchange`` -> ``combine_exchange``, plain and on the int8 wire,
on 2 and 4 gloo ranks.  The body asserts the round trip in-process; here the
content hashes must equal on every rank and equal the reference body's on a
forced mesh of as many devices (``run_forced_mesh``), bit for bit.
"""
from functools import partial

import pytest

import _torch_multihost as harness
from multihost import harness as ref_harness

CASES = {2: {"seed": 1, "m": 32, "d": 4}, 4: {"seed": 2, "m": 16, "d": 8}}


@pytest.fixture(scope="module")
def runs():
    calls = {}
    for nprocs, args in CASES.items():
        calls[(nprocs, "port")] = partial(
            harness.run_multihost, "_torch_multihost_bodies.py:exchange_roundtrip_body", nprocs,
            args=args)
        calls[(nprocs, "ref")] = partial(
            ref_harness.run_forced_mesh, "bodies.py:exchange_roundtrip_body", nprocs, args=args)
    return {k: run.require_success() for k, run in harness.run_together(calls).items()}


@pytest.mark.parametrize("nprocs", sorted(CASES))
def test_exchange_roundtrip_bit_identical_to_forced(runs, nprocs):
    results = runs[(nprocs, "port")].results()
    assert all(r == results[0] for r in results), "ranks saw different bytes"
    want = runs[(nprocs, "ref")].result()
    assert results[0] == want, f"exchange hashes differ from the reference: {results[0]} vs {want}"
