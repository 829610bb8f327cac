"""Model D and model C on the card, on a one-rank NCCL group: the kernels'
slabs against the plain network, bit for bit.

Marked ``gpu``; every test takes the ``group`` fixture, which skips when no
card is present.  Run on a machine with a card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_cluster.py``.

The plain network is the kernels' plain versions run on a CPU copy of what
the exchange delivered on the card: ``kernel_sort`` of the received slab,
at the capacity the call settled on.  Float keys carry -0.0 and +0.0
mixed, so the comparison pins where each lands.
"""
import pytest
import torch
import torch.distributed as dist

import repro_torch
from repro_torch import engine
from repro_torch.core import distributed_merge_sort
from repro_torch.core.cluster_sort import cluster_sort
from repro_torch.core.radix import make_partitioner
from repro_torch.exchange import AxisGroup, partition_exchange, slab_geometry
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels
from repro_torch.kernels.bitonic_sort.ops import kernel_sort

pytestmark = pytest.mark.gpu

DTYPES = (torch.float32, torch.int32, torch.float16, torch.bfloat16)
SIZES = (1000, (1 << 16) + 3, 1 << 20)
BLOCK_N = 1024


@pytest.fixture(scope="module")
def group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    yield AxisGroup()
    dist.destroy_process_group()


def _keys(dtype, n, seed, *, decimal=False):
    g = torch.Generator().manual_seed(seed)
    if decimal:
        return torch.randint(0, 1000, (n,), generator=g, dtype=torch.int32).cuda()
    if dtype == torch.int32:
        return torch.randint(-(2**31), 2**31 - 1, (n,), generator=g, dtype=torch.int32).cuda()
    x = torch.randn(n, generator=g) * 100
    x[::5] = 0.0
    x[1::10] = -0.0
    return x.to(dtype).cuda()


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def _plain_slab(x, group, mode, capacity):
    """What the exchange delivers on the card, sorted by the plain network."""
    part_buckets, n_buckets, _ = slab_geometry(mode, x.shape[0], group.size, 2.0)
    part = make_partitioner(mode, n_buckets=part_buckets, digits=3, group=group)
    ex = partition_exchange(x, None, part(x), group, capacity=capacity, n_buckets=n_buckets)
    return kernel_sort(ex.recv_keys.reshape(-1).cpu(), block_n=BLOCK_N)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode,dtype", [(m, d) for m in ("splitters", "sample", "radix") for d in DTYPES]
                         + [("decimal", torch.int32)], ids=str)  # decimal keys are integers
def test_cluster_sort_kernels_match_plain_network(group, mode, dtype, n):
    x = _keys(dtype, n, seed=n, decimal=mode == "decimal")
    seen = []
    kernels.reset_launch_counts()
    slab, valid = cluster_sort(x, group, mode=mode, digits=3, local_impl="kernel",
                               block_n=BLOCK_N, telemetry=lambda **t: seen.append(t))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert slab.is_cuda and counts["block_sort"] >= 1
    if slab.shape[0] > BLOCK_N:
        assert counts["block_merge"] >= 1 and counts["global_stage"] >= 1
    want = _plain_slab(x, group, mode, seen[0]["capacity"])
    assert torch.equal(_bits(slab.cpu()), _bits(want))
    assert int(valid.sum()) == n and bool(valid[:n].all())
    assert torch.equal(slab[valid], torch.sort(x).values)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_model_c_kernels_match_plain_network(group, dtype, n):
    x = _keys(dtype, n, seed=n + 1)
    kernels.reset_launch_counts()
    buf = distributed_merge_sort(x, group, local_impl="kernel", block_n=BLOCK_N)
    torch.cuda.synchronize()
    assert buf.is_cuda and kernels.launch_counts()["block_sort"] == 1
    assert torch.equal(_bits(buf.cpu()), _bits(kernel_sort(x.cpu(), block_n=BLOCK_N)))


@pytest.mark.parametrize("mode", ["splitters", "sample", "radix"])
@pytest.mark.parametrize("ascending", [True, False])
def test_mesh_kv_front_doors_are_the_stable_sort(group, mode, ascending):
    n = (1 << 16) + 3
    keys = torch.randint(0, 50, (n,), dtype=torch.int32, device="cuda")
    payload = torch.randn(n, 4, device="cuda")
    idx = engine.argsort(keys, mesh=group, ascending=ascending, mode=mode)
    want = torch.argsort(keys if ascending else -keys, stable=True)
    assert idx.dtype == torch.int32 and torch.equal(idx.long(), want)
    k, v = engine.sort_kv(keys, {"p": payload}, mesh=group, ascending=ascending, mode=mode)
    assert torch.equal(k, keys[want]) and torch.equal(v["p"], payload[want])


def test_sort_and_run_plan_take_the_group(group):
    x = _keys(torch.float32, (1 << 16) + 3, seed=7)
    slab, valid = engine.run_plan(engine.SortPlan("cluster", local_impl="kernel"), x, mesh=group)
    got, got_valid = repro_torch.sort(x, mesh=group, local_impl="kernel")
    assert torch.equal(_bits(got), _bits(slab)) and torch.equal(got_valid, valid)
    buf = repro_torch.sort(x, mesh=dist.group.WORLD, strategy="distributed_merge",
                           local_impl="kernel", ascending=False)
    assert buf.is_cuda and torch.equal(buf, torch.sort(x, descending=True).values)
