"""The port's SortService against the reference's (``repro.engine.service``).

Both services get plan tables pinned alike (the reference's ``'pallas'``
plan is the port's ``'kernel'``, through ``carry.planner_from_reference``)
and the same seeded ragged batches; results are compared bit for bit and
the ``ServiceStats`` counters field for field.  The reference runs
``'pallas'`` in interpret mode, so its cells stay small.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bits
from repro.engine import planner as ref_planner
from repro.engine.service import SortService as RefService
from repro_torch import carry
from repro_torch.engine import SortService
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

LENGTHS = (1, 5, 100, 120)  # buckets 8 (a batch of two) and 128 (two)
BUCKETS = (8, 16, 32, 64, 128, 256)
DTYPES = ("int32", "float32", "uint16")
BLOCK_N = {"kernel": 32}
# (impl, dtype, kind, ascending, value trailing shape); the kv kinds run the
# 'xla' argsort for every plan but 'kernel', so only 'xla' and 'kernel' run them
CASES = (
    [("xla", d, k, a, v) for d in DTYPES
     for k, a, v in [("sort", True, None), ("sort", False, None), ("argsort", True, None),
                     ("argsort", False, None), ("sort_kv", True, ()), ("sort_kv", False, (2,))]]
    + [(i, d, "sort", d == "int32", None) for i in ("merge", "bitonic") for d in ("int32", "float32")]
    + [("kernel", "int32", "sort", True, None), ("kernel", "float32", "sort", False, None),
       ("kernel", "int32", "argsort", True, None), ("kernel", "float32", "argsort", False, None),
       ("kernel", "uint16", "sort_kv", True, ())]
)


def _requests(dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    reqs = []
    for n in LENGTHS:
        if dtype == "float32":
            r = (rng.standard_normal(n) * 100).astype(np.float32)
            r[::7] = np.where(np.arange(len(r[::7])) % 2, np.float32(-0.0), np.float32(0.0))
        else:
            r = rng.integers(0, 50 if dtype == "uint16" else 1_000_000, n).astype(dtype)
        reqs.append(r)
    return reqs


@functools.lru_cache(maxsize=None)
def _services(impl: str):
    """One reference and one port service with every bucket pinned to the
    same shared plan, kept for the module: both see the same submissions
    in the same order, so their counters stay comparable."""
    rp = ref_planner.Planner()
    ref_impl = {"kernel": "pallas"}.get(impl, impl)
    for b in BUCKETS:
        for d in DTYPES:
            rp.plans[ref_planner.plan_key(b, jnp.dtype(d))] = ref_planner.SortPlan(
                "shared", local_impl=ref_impl, n_threads=4, block_n=BLOCK_N.get(impl))
    doc = {"version": 3, "plans": {k: p.to_dict() for k, p in rp.plans.items()}}
    pp = carry.planner_from_reference(doc, device="cpu")
    return RefService(planner=rp), SortService(planner=pp, device="cpu")


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("impl,dtype,kind,ascending,vshape", CASES)
def test_submit_matches_reference(impl, dtype, kind, ascending, vshape):
    rs, ps = _services(impl)
    reqs = _requests(dtype, seed=len(kind) + 3 * ascending)
    vals = None
    if kind == "sort_kv":
        rng = np.random.default_rng(5)
        vals = [rng.standard_normal((len(r),) + vshape).astype(np.float32) if vshape
                else np.arange(len(r), dtype=np.int32) for r in reqs]
    want = rs.submit(reqs, kind=kind, values=vals, ascending=ascending)
    got = ps.submit(reqs, kind=kind, values=vals, ascending=ascending)
    for g, w, r in zip(got, want, reqs):
        if kind == "sort_kv":
            _same(g[0], np.asarray(w[0]))
            _same(g[1], np.asarray(w[1]))
        else:
            _same(g, np.asarray(w))
        if kind == "argsort":  # the stable order, ties in arrival order both ways
            key = r if ascending else -r.astype(np.float64)
            np.testing.assert_array_equal(g, np.argsort(key, kind="stable"))
    _assert_stats_equal(rs, ps)


def _assert_stats_equal(rs, ps):
    fields = ("requests", "batches", "keys_in", "padded_keys", "compiles", "cache_hits",
              "overflow_retries", "recompiles", "peak_mean_ratio")
    assert {f: getattr(ps.stats, f) for f in fields} == {f: getattr(rs.stats, f) for f in fields}
    assert ps.cache.stats() == rs.cache.stats()


def test_repeated_traffic_builds_no_new_cell():
    """The reference's zero-recompile property, in the port's terms: the
    cache's misses and the kernel library's loads do not move."""
    _, ps = _services("xla")
    reqs = _requests("int32", seed=1)
    ps.submit(reqs)
    misses, loads = ps.cache.misses, kernels._lib.cache_info().misses
    for kind in ("sort", "sort"):
        ps.submit([r[::-1].copy() for r in reqs], kind=kind)
    assert ps.cache.misses == misses and kernels._lib.cache_info().misses == loads
    assert ps.stats.cache_hits >= 2


def test_warm_cell_reports_fresh_and_warm_like_the_reference():
    rs, ps = RefService(planner=ref_planner.Planner()), SortService(
        planner=carry.planner_from_reference({"version": 1, "plans": {}}, device="cpu"),
        device="cpu")
    cells = [("sort", 1024, "int32", 1, True, None), ("sort", 1024, "int32", 1, True, None),
             ("argsort", 256, "float32", 4, False, None), ("sort", 1024, "int32", 2, True, None),
             ("sort_kv", 64, "uint16", 2, True, ((3,), np.float32)),
             ("sort_kv", 64, "uint16", 2, True, ((3,), np.float32)),
             ("sort_kv", 64, "uint16", 2, True, None)]
    for kind, bucket, dtype, bb, asc, vspec in cells:
        kw = dict(batch_bucket=bb, ascending=asc, values_spec=vspec)
        assert ps.warm_cell(kind, bucket, dtype, **kw) == rs.warm_cell(kind, bucket, dtype, **kw)
    _assert_stats_equal(rs, ps)
    # a warmed cell serves its first request as a hit
    before = ps.cache.misses
    ps.submit([np.arange(1000, dtype=np.int32)[::-1].copy()])
    assert ps.cache.misses == before


@pytest.mark.parametrize("bad", [
    dict(requests=[np.array([1.0, np.nan], np.float32)]),
    dict(requests=[np.array([[1, 2]], np.int32)]),
    dict(requests=[np.array([1, 2], np.int32)], kind="topk"),
    dict(requests=[np.array([1, 2], np.int32)], kind="sort_kv"),
    dict(requests=[np.array([1, 2], np.int32)], values=[np.array([1, 2])]),
    dict(requests=[np.array([1, 2], np.int32)], kind="sort_kv", values=[np.array([1])]),
    dict(requests=[np.array([1, 2], np.int32)], kind="sort_kv", values=[]),
])
def test_refuses_what_the_reference_refuses(bad):
    errors = []
    for svc in (RefService(planner=ref_planner.Planner()),
                SortService(planner=carry.planner_from_reference({"version": 1, "plans": {}}),
                            device="cpu")):
        with pytest.raises(ValueError) as err:
            svc.submit(**bad)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_bfloat16_requests_fail_the_same_way():
    import ml_dtypes

    errors = []
    for svc in (RefService(planner=ref_planner.Planner()),
                SortService(planner=carry.planner_from_reference({"version": 1, "plans": {}}),
                            device="cpu")):
        with pytest.raises(ValueError) as err:
            svc.submit([np.array([2, 1], ml_dtypes.bfloat16)])
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_service_for_the_card_with_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SortService()
