"""The engine on the card: SortService, the async queue and the planner's
autotune with kernel plans, against the same plans on the CPU (where the
kernels run their plain versions), bit for bit.

Marked ``gpu``; every test takes the ``cuda`` fixture, which skips when no
card is present.  Run on a machine with a card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_engine.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import carry
from repro_torch.engine import AsyncSortService, SortService
from repro_torch.engine.planner import Planner, SortPlan, mesh_fingerprint, plan_key
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

pytestmark = pytest.mark.gpu

DTYPES = ("int32", "float32", "float16", "uint16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    kernels.reset_launch_counts()
    return torch.device("cuda", torch.cuda.current_device())


def _kernel_planner(device, block_n=256):
    """Every cell pinned to the reference's 'pallas' plan, mapped."""
    plan = {"strategy": "shared", "local_impl": "pallas", "block_n": block_n}
    plans = {plan_key(1 << b, d, device=device): plan for b in range(3, 21) for d in DTYPES}
    return carry.planner_from_reference({"version": 3, "plans": plans}, device=device)


def _requests(dtype, seed, lengths=(1, 7, 300, 1000, 5000, 70_000)):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        r = rng.integers(0, 500, n)  # ties on purpose: stability shows
        r = r.astype(dtype)
        if dtype.startswith("float"):
            r[::9] = np.where(np.arange(len(r[::9])) % 2, -0.0, 0.0).astype(dtype)
        out.append(r)
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("kind,ascending", [("sort", True), ("sort", False), ("argsort", True),
                                            ("argsort", False), ("sort_kv", True)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_service_kernel_plans_match_the_plain_network(cuda, dtype, kind, ascending):
    card = SortService(planner=_kernel_planner(cuda), device=cuda)
    plain = SortService(planner=_kernel_planner("cpu"), device="cpu")
    reqs = _requests(dtype, seed=len(kind))
    vals = [np.arange(len(r), dtype=np.float32)[:, None].repeat(4, 1) for r in reqs] \
        if kind == "sort_kv" else None
    got = card.submit(reqs, kind=kind, values=vals, ascending=ascending)
    want = plain.submit(reqs, kind=kind, values=vals, ascending=ascending)
    for g, w, r in zip(got, want, reqs):
        for a, b in zip(g if kind == "sort_kv" else (g,), w if kind == "sort_kv" else (w,)):
            assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
        if kind == "argsort":
            key = r.astype(np.float64) if ascending else -r.astype(np.float64)
            assert np.array_equal(g, np.argsort(key, kind="stable"))
    counts = kernels.launch_counts()
    names = ("block_sort", "block_merge", "global_stage") if kind == "sort" else (
        "block_sort_kv", "block_merge_kv", "global_stage_kv")
    assert all(counts[n] > 0 for n in names), counts


def test_warm_cells_serve_with_no_new_cell_and_no_new_load(cuda):
    svc = SortService(planner=_kernel_planner(cuda), device=cuda)
    for kind in ("sort", "argsort"):
        for bb in (1, 2, 4, 8):
            svc.warm_cell(kind, 8192, "int32", batch_bucket=bb)
    misses, loads = svc.cache.misses, kernels._lib.cache_info().misses
    kernels.reset_launch_counts()
    rng = np.random.default_rng(1)
    for kind in ("sort", "argsort", "sort", "argsort"):
        reqs = [rng.integers(0, 1 << 20, n).astype(np.int32) for n in (5000, 8000, 8192)]
        out = svc.submit(reqs, kind=kind)
        for o, r in zip(out, reqs):
            want = np.sort(r) if kind == "sort" else np.argsort(r, kind="stable")
            assert np.array_equal(o, want)
    assert svc.cache.misses == misses and kernels._lib.cache_info().misses == loads
    assert sum(kernels.launch_counts().values()) > 0


def test_async_queue_on_the_card(cuda):
    rng = np.random.default_rng(2)
    reqs = [rng.integers(0, 1000, 4096).astype(np.int32) for _ in range(40)]
    with AsyncSortService(SortService(planner=_kernel_planner(cuda), device=cuda),
                          max_batch=16) as svc:
        futs = [svc.submit_async(r) for r in reqs]
        for f, r in zip(futs, reqs):
            assert np.array_equal(f.result(timeout=120), np.sort(r))
    assert kernels.launch_counts()["block_sort"] > 0


def test_autotune_on_the_card_times_the_kernel_candidates(cuda, tmp_path):
    path = str(tmp_path / "plans.json")
    planner = Planner(path, device=cuda)
    kernels.reset_launch_counts()
    seen = []
    best = planner.autotune(1 << 16, torch.float32, quick=True, reps=2,
                            on_candidate=lambda i, c: seen.append(c.local_impl))
    assert seen == ["xla", "merge", "kernel"]  # nothing is skipped on the card
    assert kernels.launch_counts()["block_sort"] > 0
    key = plan_key(1 << 16, torch.float32, device=cuda)
    assert key.endswith(mesh_fingerprint(device=cuda)) and "cuda:" in key
    assert Planner(path, device=cuda).plans[key] == best == planner.plans[key]


def test_a_failing_kernel_candidate_raises_on_the_card(cuda, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("bitonic_tile_network failed: injected")

    monkeypatch.setattr(kernels, "_launch", broken)
    with pytest.raises(RuntimeError, match="injected"):
        Planner(device=cuda).autotune(1 << 12, candidates=[
            SortPlan("shared"), SortPlan("shared", local_impl="kernel", block_n=256)], reps=1)
