"""Port vs reference: the kernel ops, the merge tree, the local sorts, model
B, the plan core, the sort front door, the slab math and the carry helpers.

Inputs are seeded numpy arrays; the port runs on CPU tensors (the kernels'
plain versions), the reference on JAX's CPU backend (Pallas in interpret
mode).  Results are compared bit for bit, the ``'xla'`` local sort too:
both library sorts are stable, so -0.0 and +0.0 keep their input order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DTYPES, LENGTHS, SIGNED_ZEROS, assert_bits_equal, bits, cpu, make_keys
import repro
import repro_torch
from repro.core import merge as ref_merge
from repro.core import seqsort as ref_seqsort
from repro.core.shared_sort import shared_memory_sort as ref_shared_memory_sort
from repro.engine import planner as ref_planner
from repro.exchange import slabs as ref_slabs
from repro.kernels.bitonic_sort import ops as ref_ops
from repro_torch.carry import plan_from_reference, tensor_from_reference, tensor_to_reference
from repro_torch.core import merge, seqsort
from repro_torch.core.shared_sort import shared_memory_sort
from repro_torch.engine import planner
from repro_torch.exchange import partition, slabs
from repro_torch.kernels.bitonic_sort import ops


# -------------------------------------------------------------- kernel ops ---
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_sort_matches_pallas_sort(dtype, n):
    x = make_keys(dtype, n, seed=10 + n)
    want = ref_ops.pallas_sort(jnp.asarray(x), block_n=128, interpret=True)
    assert_bits_equal(ops.kernel_sort(cpu(x), block_n=128), want)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_kernel_sort_keeps_keys_equal_to_the_pad_sentinel(dtype):
    x = make_keys(dtype, 100, seed=11)
    x[[0, 50]] = np.asarray(ref_slabs.sentinel_for(jnp.dtype(x.dtype), largest=True))
    want = ref_ops.pallas_sort(jnp.asarray(x), block_n=64, interpret=True)
    assert_bits_equal(ops.kernel_sort(cpu(x), block_n=64), want)
    np.testing.assert_array_equal(ops.kernel_sort(cpu(x), block_n=64).numpy(), np.sort(x))


def test_kernel_sort_keeps_signed_zeros_like_pallas_sort():
    want = ref_ops.pallas_sort(jnp.asarray(SIGNED_ZEROS), block_n=4, interpret=True)
    assert_bits_equal(ops.kernel_sort(cpu(SIGNED_ZEROS), block_n=4), want)


@pytest.mark.parametrize("n", [3, 100, 777])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_argsort_matches_pallas_argsort(dtype, n):
    x = make_keys(dtype, n, seed=12 + n, duplicates=True)
    x[0] = np.asarray(ref_slabs.sentinel_for(jnp.dtype(x.dtype), largest=True))
    want = ref_ops.pallas_argsort(jnp.asarray(x), block_n=64, interpret=True)
    got = ops.kernel_argsort(cpu(x), block_n=64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.argsort(x, kind="stable"))


def test_kernel_sort_kv_matches_pallas_sort_kv():
    k = make_keys("float32", 333, seed=13, duplicates=True)
    v = {"a": np.random.default_rng(14).standard_normal((333, 2)).astype(np.float32),
         "i": np.arange(333, dtype=np.int32)}
    got_k, got_v = ops.kernel_sort_kv(cpu(k), {n: cpu(a) for n, a in v.items()}, block_n=128)
    want_k, want_v = ref_ops.pallas_sort_kv(
        jnp.asarray(k), {n: jnp.asarray(a) for n, a in v.items()}, block_n=128, interpret=True
    )
    assert_bits_equal(got_k, want_k)
    for name in v:
        assert_bits_equal(got_v[name], want_v[name])


def test_kernel_ops_reject_bad_shapes():
    with pytest.raises(ValueError):
        ops.kernel_sort(torch.zeros(16), block_n=48)
    with pytest.raises(ValueError):
        ops.kernel_sort(torch.tensor(1.0))
    with pytest.raises(ValueError):
        ops.kernel_argsort(torch.zeros(0))
    with pytest.raises(ValueError):
        ops.kernel_sort_kv(torch.zeros(2, 4), {})
    # a tile above the shared-memory cap is taken, as the reference takes it
    x = make_keys("float32", 4 * ops.MAX_BLOCK_N, seed=9)
    want = ref_ops.pallas_sort(jnp.asarray(x), block_n=2 * ops.MAX_BLOCK_N, interpret=True)
    assert_bits_equal(ops.kernel_sort(cpu(x), block_n=2 * ops.MAX_BLOCK_N), want)


def test_kernel_argsort_takes_tiles_above_the_cap():
    x = make_keys("int32", 4 * ops.MAX_BLOCK_N, seed=8, duplicates=True)
    want = ref_ops.pallas_argsort(jnp.asarray(x), block_n=2 * ops.MAX_BLOCK_N, interpret=True)
    np.testing.assert_array_equal(
        ops.kernel_argsort(cpu(x), block_n=2 * ops.MAX_BLOCK_N).numpy(), np.asarray(want)
    )


NARROW = ["int8", "uint8", "int16", "uint16", "uint32"]


@pytest.mark.parametrize("dtype", NARROW)
def test_kernel_ops_take_narrow_integer_keys(dtype):
    """Through the int32 network by an order-preserving map: the same dtype
    and bits as the reference's kernels, extremes and duplicates included."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(7)
    x = rng.integers(info.min, info.max, 300, endpoint=True).astype(dtype)
    x[::7] = x[3]
    x[[0, 50, 299]], x[[10, 11]] = info.max, info.min  # keys equal to the pad sentinel
    got = ops.kernel_sort(cpu(x), block_n=64)
    want = ref_ops.pallas_sort(jnp.asarray(x), block_n=64, interpret=True)
    assert got.dtype == cpu(x).dtype
    assert_bits_equal(got, want)
    perm = ops.kernel_argsort(cpu(x), block_n=64)
    want_perm = ref_ops.pallas_argsort(jnp.asarray(x), block_n=64, interpret=True)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    got_k, got_v = ops.kernel_sort_kv(cpu(x), {"k": cpu(x)}, block_n=64)
    want_k, want_v = ref_ops.pallas_sort_kv(jnp.asarray(x), {"k": jnp.asarray(x)}, block_n=64,
                                            interpret=True)
    assert_bits_equal(got_k, want_k)
    assert_bits_equal(got_v["k"], want_v["k"])


@pytest.mark.parametrize("dtype", [torch.bool, torch.int64, torch.float64], ids=str)
def test_kernel_ops_say_why_they_reject_a_key_dtype(dtype):
    with pytest.raises(TypeError, match="reference"):
        ops.kernel_sort(torch.zeros(8, dtype=dtype))


@pytest.mark.parametrize("shape,block_n", [((3, 64), 64), ((2, 3, 100), 32), ((4, 10), 1024)])
def test_kernel_local_sort_batches_like_the_vmapped_reference(shape, block_n):
    """Rows of one tile (trouble spot: a flat tile id would sort odd rows
    descending) and rows of several tiles both sort like the reference."""
    x = make_keys("float32", shape, seed=15)
    want = ref_seqsort.pallas_local_sort(jnp.asarray(x), block_n=block_n)
    got = seqsort.kernel_local_sort(cpu(x), block_n=block_n)
    assert_bits_equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=-1))


# ------------------------------------------------------------------- merge ---
@pytest.mark.parametrize("width", [1, 4, 32])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_merge_adjacent_matches_reference(dtype, width):
    x = np.sort(make_keys(dtype, (2, 8, width), seed=16, duplicates=True), axis=-1)
    x = x.reshape(2, 8 * width)
    assert_bits_equal(merge.merge_adjacent(cpu(x), width), ref_merge.merge_adjacent(jnp.asarray(x), width))


def test_merge_with_values_matches_reference():
    rng = np.random.default_rng(17)
    a = np.sort(rng.integers(0, 5, 16)).astype(np.int32)
    b = np.sort(rng.integers(0, 5, 16)).astype(np.int32)
    va, vb = np.arange(16, dtype=np.int32), np.arange(16, 32, dtype=np.int32)
    got_k, got_v = merge.merge_sorted_pair(cpu(a), cpu(b), {"v": cpu(va)}, {"v": cpu(vb)})
    want_k, want_v = ref_merge.merge_sorted_pair(
        jnp.asarray(a), jnp.asarray(b), {"v": jnp.asarray(va)}, {"v": jnp.asarray(vb)}
    )
    assert_bits_equal(got_k, want_k)
    assert_bits_equal(got_v["v"], want_v["v"])
    x = np.stack([a, b]).reshape(32)
    got_k, got_v = merge.merge_adjacent(cpu(x), 16, {"v": cpu(np.concatenate([va, vb]))})
    want_k, want_v = ref_merge.merge_adjacent(
        jnp.asarray(x), 16, {"v": jnp.asarray(np.concatenate([va, vb]))}
    )
    assert_bits_equal(got_k, want_k)
    assert_bits_equal(got_v["v"], want_v["v"])


# ------------------------------------------------------------- local sorts ---
_IMPLS = {"xla": "xla", "bitonic": "bitonic", "kernel": "pallas", "merge": "merge"}


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("impl", list(_IMPLS))
def test_fast_local_sort_matches_reference(impl, ascending):
    x = make_keys("float32", (2, 100), seed=18)
    x[:, ::3] = np.where(np.arange(x[:, ::3].size).reshape(2, -1) % 2, -0.0, 0.0)  # mixed +-0
    got = seqsort.fast_local_sort(cpu(x), ascending=ascending, impl=impl, block_n=32)
    want = ref_seqsort.fast_local_sort(
        jnp.asarray(x), ascending=ascending, impl=_IMPLS[impl], block_n=32
    )
    assert_bits_equal(got, want)


def test_fast_local_sort_rejects_the_reference_impl_name():
    with pytest.raises(ValueError):
        seqsort.fast_local_sort(torch.zeros(4), impl="pallas")
    assert seqsort.LOCAL_SORTS == ("xla", "bitonic", "kernel", "merge")


def test_recursive_merge_sort_host_matches_reference():
    x = make_keys("int32", (3, 37), seed=19, duplicates=True)
    np.testing.assert_array_equal(
        seqsort.recursive_merge_sort_host(x), ref_seqsort.recursive_merge_sort_host(x)
    )


# ----------------------------------------------------------------- model B ---
@pytest.mark.parametrize("n", [1, 500, 1000, 1024])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("n_threads", [1, 2, 8])
def test_shared_memory_sort_kernel_matches_reference(n_threads, ascending, n):
    x = make_keys("float32", n, seed=20 + n)
    got = shared_memory_sort(cpu(x), n_threads=n_threads, local_impl="kernel",
                             ascending=ascending, block_n=64)
    want = ref_shared_memory_sort(jnp.asarray(x), n_threads=n_threads, local_impl="pallas",
                                  ascending=ascending, block_n=64)
    assert_bits_equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("local_impl", ["bitonic", "merge"])
def test_shared_memory_sort_other_impls_match_reference(local_impl, dtype):
    x = make_keys(dtype, 300, seed=21, duplicates=dtype == "int32")
    got = shared_memory_sort(cpu(x), n_threads=8, local_impl=local_impl)
    want = ref_shared_memory_sort(jnp.asarray(x), n_threads=8, local_impl=local_impl)
    assert_bits_equal(got, want)


def test_shared_memory_sort_rejects_non_pow2_threads():
    with pytest.raises(ValueError):
        shared_memory_sort(torch.zeros(8), n_threads=3)


# ------------------------------------------------------- front door, plans ---
@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"strategy": "shared"},
        {"strategy": "shared_merge", "n_threads": 4},
        {"strategy": "shared", "local_impl": "kernel", "n_threads": 8, "block_n": 64},
        {"local_impl": "kernel", "ascending": False, "block_n": 128},
    ],
    ids=["default", "shared", "shared_merge", "kernel", "kernel_desc"],
)
def test_sort_matches_reference(kwargs):
    x = make_keys("float32", 1000, seed=22)
    ref_kwargs = dict(kwargs)
    if ref_kwargs.get("local_impl") == "kernel":
        ref_kwargs["local_impl"] = "pallas"
    got = repro_torch.sort(cpu(x), **kwargs)
    want = repro.sort(jnp.asarray(x), **ref_kwargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kwargs.get("local_impl") == "kernel":
        assert_bits_equal(got, want)


def test_sort_plan_beats_default_and_strategy_beats_plan():
    x = make_keys("int32", 200, seed=23)
    ref_plan = ref_planner.SortPlan("shared", local_impl="pallas", n_threads=4, block_n=32)
    plan = plan_from_reference(ref_plan.to_dict())
    assert plan.local_impl == "kernel"
    assert_bits_equal(repro_torch.sort(cpu(x), plan=plan), repro.sort(jnp.asarray(x), plan=ref_plan))
    assert_bits_equal(
        planner.run_plan(plan, cpu(x), ascending=False),
        ref_planner.run_plan(ref_plan, jnp.asarray(x), ascending=False),
    )
    got = repro_torch.sort(cpu(x), plan=plan, strategy="shared_merge")
    want = repro.sort(jnp.asarray(x), plan=ref_plan, strategy="shared_merge")
    assert_bits_equal(got, want)


@pytest.mark.parametrize("strategy", ["shared", "shared_merge", "shared_hybrid", "distributed_merge", "cluster"])
def test_plan_from_strategy_matches_reference(strategy):
    want = ref_planner.plan_from_strategy(strategy, n_threads=4).to_dict()
    assert planner.plan_from_strategy(strategy, n_threads=4).to_dict() == want
    assert planner.default_plan().to_dict() == ref_planner.default_plan().to_dict()


def test_sort_plan_methods_match_reference():
    for mode in ("decimal", "range", "radix", "splitters", "sample"):
        for part in (None, "radix", "sample"):
            ref_plan = ref_planner.SortPlan("cluster", mode=mode, partition=part)
            plan = plan_from_reference(ref_plan.to_dict())
            assert plan.to_dict() == ref_plan.to_dict()
            assert plan.effective_partition() == ref_plan.effective_partition()
            assert plan.partitioner_mode() == ref_plan.partitioner_mode()
    with pytest.raises(ValueError):
        partition.partition_of("quantum")


def test_mesh_strategies_raise_not_implemented():
    # the mesh strategies are ported (tests/test_torch_cluster.py); they
    # refuse what the reference refuses, and what is not a process group
    for strategy in ("cluster", "distributed_merge"):
        with pytest.raises(ValueError, match="requires mesh="):
            planner.run_plan(planner.plan_from_strategy(strategy), torch.zeros(8))
    with pytest.raises(ValueError, match="ascending only"):
        planner.run_plan(planner.SortPlan("cluster"), torch.zeros(8), mesh=object(),
                         ascending=False)
    with pytest.raises(TypeError, match="AxisGroup or a torch.distributed ProcessGroup"):
        repro_torch.sort(torch.zeros(8), mesh=object(), axis="x")
    with pytest.raises(ValueError):
        planner.plan_from_strategy("quantum")


# -------------------------------------------------------- slabs and carry ---
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("largest", [True, False])
def test_sentinel_for_matches_reference(dtype, largest):
    want = ref_slabs.sentinel_for(jnp.dtype(DTYPES[dtype]), largest=largest)
    got = slabs.sentinel_for(tensor_from_reference(np.zeros(1, DTYPES[dtype]), "cpu").dtype,
                             largest=largest)
    assert_bits_equal(got.reshape(1), np.asarray(want).reshape(1))


def test_slab_math_matches_reference():
    for m in (0, 1, 64, 1000, 4097):
        for buckets in (1, 4, 8, 10):
            for cf in (0.001, 1.0, 1.25, 1.5, 2.0, 8.0):
                assert slabs.slab_capacity(m, buckets, cf) == ref_slabs.slab_capacity(m, buckets, cf)
                assert slabs.expert_capacity(m, 2, buckets, cf) == ref_slabs.expert_capacity(m, 2, buckets, cf)
    for mode in ("decimal", "splitters", "radix"):
        for p in (1, 2, 4, 8):
            assert slabs.slab_geometry(mode, 1000, p, 1.5) == ref_slabs.slab_geometry(mode, 1000, p, 1.5)
    counts = np.array([3, 0, 5, 1], np.int32)
    np.testing.assert_array_equal(
        slabs.slab_valid(24, cpu(counts), 4).numpy(),
        np.asarray(ref_slabs.slab_valid(24, jnp.asarray(counts), 4)),
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_carry_keeps_dtype_and_bits(dtype):
    a = make_keys(dtype, 50, seed=24)
    t = tensor_from_reference(a, "cpu")
    back = tensor_to_reference(t)
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(bits(back), bits(a))
