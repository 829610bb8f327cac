"""Port vs reference: model D (``cluster_sort``, ``cluster_sort_kv``), the
mesh kv front doors, model C (``distributed_merge_sort``) and the mesh plan
dispatch, on 1, 2 and 4 ranks, plus the paper's decimal scheme on 8.

The reference runs on a forced host mesh in one subprocess per world size;
the port runs as that many gloo ranks (``_torch_ranks``).  Slabs, value
slabs, validity masks and merge-tree buffers are compared bit for bit.
Port ``'xla'`` and ``'bitonic'`` are held against the reference's own.
Port ``'kernel'`` (the CUDA kernels' plain versions on CPU tensors) is held
against the reference's ``'pallas'``, which runs inside ``shard_map`` only
with the replication check off: it is taken through the reference's own
model-D and model-C bodies (``cluster_sort_local``, ``merge_tree_local``),
at the capacity the reference's ``'xla'`` run of the same case settled on.
Model D with a payload sorts its slabs with the kernels as well
(``local_impl='kernel'``), held against the reference's slabs of the same
case: the stable (key, rank) network gives the library's permutation.
(The reference's ``'bitonic'`` is no oracle for the kernel: it places -0.0
and +0.0 otherwise.)  The reference's dense mesh ``sort_kv`` / ``argsort``
and ``distributed_merge_sort`` do not run on this jax, so the mesh front
doors are held against ``np.argsort(kind='stable')`` and model C against
the reference's compiled merge tree.
"""
import functools

import numpy as np
import pytest

from _torch_ranks import bits, concat, mesh_keys, run_both, save_inputs

WORLDS = (1, 2, 4, 8)  # 8 ranks run the decimal cases only
M = 128
BLOCK_N = 64  # the kernels' tile: two tiles a rank, so A, B and C all run
KINDS = ("uniform", "zipf", "all_equal", "dup_heavy")
DATA = [f"{k}-{d}" for k in KINDS for d in ("float32", "int32")]
DECIMAL = [f"{k}-decimal" for k in KINDS]
MODES = ("splitters", "sample", "radix")

# model D with the library sort for every mode; with the kernels (whose
# network does not care which partitioner filled the slab) for one
SORT_CASES = {f"{data}-{mode}-{impl}": (data, mode, impl)
              for data, mode in [(d, m) for d in DATA for m in MODES] + [(d, "decimal") for d in DECIMAL]
              for impl in ("xla", "kernel") if impl == "xla" or mode in ("splitters", "decimal")}
KV_CASES = {f"{data}-{mode}": (data, mode, False)
            for data, mode in [(d, m) for d in DATA for m in MODES] + [(d, "decimal") for d in DECIMAL]}
KV_CASES["dup_heavy-float32-sample-compress"] = ("dup_heavy-float32", "sample", True)
# model D with a payload also sorts its slabs with the kernels (local_impl
# 'kernel', case name + "-kernel_kv"), for one partitioner of each family,
# against the reference's slabs of the same case
KV_KERNEL = [n for n, (_, mode, compress) in KV_CASES.items()
             if mode in ("splitters", "decimal") and not compress]
FRONT_CASES = {f"{data}-{mode}-{order}": (data, mode, order == "ascending")
               for data in DATA for mode in MODES
               for order in ("ascending", "descending")}
C_CASES = {f"{data}-{impl}": (data, impl) for data in DATA for impl in ("xla", "bitonic", "kernel")}
# the plan dispatch: (data, what the port runs, what the reference runs)
DISPATCH = {
    "sort_default": ("uniform-float32", "sort", "sort"),
    "run_plan_cluster_promoted": ("zipf-int32", "run_plan_cluster", "run_plan_cluster"),
    "run_plan_merge_descending": ("dup_heavy-float32", "run_plan_merge_desc", "merge_tree"),
    "sort_strategy_merge": ("uniform-int32", "sort_merge", "merge_tree"),
}


def _on(world: int, cases: dict) -> list:
    """The cases a world size runs: all of them, and the decimal ones on 8."""
    return [n for n, c in cases.items() if world < 8 or c[1] == "decimal"]


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    n = max(WORLDS) * M
    arrays = {}
    for i, kind in enumerate(KINDS):
        for dtype in ("float32", "int32"):
            arrays[f"{kind}-{dtype}"] = mesh_keys(kind, dtype, n, seed=20 * i + len(dtype))
        arrays[f"{kind}-decimal"] = np.abs(mesh_keys(kind, "int32", n, seed=20 * i + 3)) % 1000
    rng = np.random.default_rng(8)
    arrays["f"] = rng.standard_normal((n, 2)).astype(np.float32)
    return arrays


_PARAMS = (f"M = {M}\nBLOCK_N = {BLOCK_N}\nSORT_CASES = {SORT_CASES!r}\n"
           f"KV_CASES = {KV_CASES!r}\nKV_KERNEL = {KV_KERNEL!r}\n"
           f"FRONT_CASES = {FRONT_CASES!r}\nC_CASES = {C_CASES!r}\n"
           f"DISPATCH = {DISPATCH!r}\n") + """
def on(cases):
    return [(n, c) for n, c in cases.items() if WORLD < 8 or c[1] == "decimal"]
"""

REF_BODY = _PARAMS + """
import functools
from functools import partial
from repro.core import sort
from repro.core.cluster_sort import cluster_sort, cluster_sort_local
from repro.core.distributed_sort import _compiled_merge_tree, merge_tree_local
from repro.core.radix import make_partitioner
from repro.engine.kv import cluster_sort_kv
from repro.engine.planner import SortPlan, run_plan
from repro.exchange import slab_geometry

X = lambda data: jnp.asarray(IN[data][:WORLD * M])
iota = jnp.arange(WORLD * M, dtype=jnp.int32)

@functools.lru_cache(maxsize=None)
def pallas_cluster_sort(mode, capacity):
    # the reference's own model-D body with its Pallas local sort: under
    # shard_map that runs only with the replication check off
    part_buckets, n_buckets, _ = slab_geometry(mode, M, WORLD, 2.0)
    part = make_partitioner(mode, n_buckets=part_buckets, digits=3, axis_name="x")
    body = partial(cluster_sort_local, axis_name="x", capacity=capacity, partitioner=part,
                   n_buckets=n_buckets, local_impl="pallas", block_n=BLOCK_N)
    return smap(body, P("x"), (P("x"), P("x"), P(), P()))

for name, (data, mode, impl) in on(SORT_CASES):
    if impl == "kernel":
        continue
    seen = []
    out[name + "/slab"], out[name + "/valid"] = cluster_sort(
        X(data), mesh, "x", mode=mode, digits=3, telemetry=lambda **t: seen.append(t))
    kname = name[: -len("xla")] + "kernel"
    if kname in SORT_CASES:  # the kernel's case: the same exchange and capacity
        out[kname + "/valid"] = out[name + "/valid"]
        out[kname + "/slab"] = pallas_cluster_sort(mode, seen[0]["capacity"])(X(data))[0]

for name, (data, mode, compress) in on(KV_CASES):
    vals = {"f": jnp.asarray(IN["f"][:WORLD * M]), "i": iota}
    k, v, valid = cluster_sort_kv(X(data), vals, mesh, "x", mode=mode, digits=3, compress=compress)
    out[name + "/slab"], out[name + "/valid"] = k, valid
    out[name + "/f"], out[name + "/i"] = v["f"], v["i"]

if WORLD < 8:
    pallas_merge_tree = smap(partial(merge_tree_local, axis_name="x", local_impl="pallas",
                                     block_n=BLOCK_N), P("x"), P("x"))
    for name, (data, impl) in C_CASES.items():
        if impl == "kernel":
            out[name + "/buf"] = pallas_merge_tree(X(data))
        else:
            out[name + "/buf"] = _compiled_merge_tree(mesh, "x", impl, None)(X(data))
    for name, (data, _, ref) in DISPATCH.items():
        if ref == "sort":
            out[name] = sort(X(data), mesh=mesh, axis="x")[0]
        elif ref == "run_plan_cluster":
            plan = SortPlan("cluster", local_impl="xla", mode="radix", partition="sample",
                            capacity_factor=1.5)
            out[name] = run_plan(plan, X(data), mesh=mesh, axis="x")[0]
        else:
            out[name] = _compiled_merge_tree(mesh, "x", "xla", None)(X(data))
"""

PORT_BODY = _PARAMS + """
from repro_torch.core import sort
from repro_torch.core.cluster_sort import cluster_sort
from repro_torch.core.distributed_sort import distributed_merge_sort
from repro_torch.engine import argsort, cluster_sort_kv, sort_kv
from repro_torch.engine.planner import SortPlan, run_plan

X = lambda data: shard(IN[data][:WORLD * M])
iota = RANK * M + torch.arange(M, dtype=torch.int32)
for name, (data, mode, impl) in on(SORT_CASES):
    slab, valid = cluster_sort(X(data), G, mode=mode, digits=3, local_impl=impl, block_n=BLOCK_N)
    out[name + "/slab"], out[name + "/valid"] = slab.numpy(), valid.numpy()

for name, (data, mode, compress) in on(KV_CASES):
    for impl in ("xla", "kernel") if name in KV_KERNEL else ("xla",):
        vals = {"f": X("f"), "i": iota}
        k, v, valid = cluster_sort_kv(X(data), vals, G, mode=mode, digits=3, compress=compress,
                                      local_impl=impl)
        case = name if impl == "xla" else name + "-kernel_kv"
        out[case + "/slab"], out[case + "/valid"] = k.numpy(), valid.numpy()
        out[case + "/f"], out[case + "/i"] = v["f"].numpy(), v["i"].numpy()

if WORLD < 8:
    for name, (data, mode, ascending) in FRONT_CASES.items():
        k, v = sort_kv(X(data), {"f": X("f")}, mesh=G, ascending=ascending, mode=mode)
        out[name + "/keys"], out[name + "/f"] = k.numpy(), v["f"].numpy()
        out[name + "/idx"] = argsort(X(data), mesh=G, ascending=ascending, mode=mode).numpy()
    for name, (data, impl) in C_CASES.items():
        out[name + "/buf"] = distributed_merge_sort(X(data), G, local_impl=impl,
                                                    block_n=BLOCK_N).numpy()
    # the mesh front doors above taught the default planner capacities; the
    # reference's never ran them (its mesh kv path raises), so its sort
    # dispatches from an empty learned table: start the port's alike
    import repro_torch.engine.planner as planner_module
    planner_module._DEFAULT = None
    for name, (data, port, _) in DISPATCH.items():
        if port == "sort":
            got = sort(X(data), mesh=G)[0]
        elif port == "run_plan_cluster":
            plan = SortPlan("cluster", local_impl="xla", mode="radix", partition="sample",
                            capacity_factor=1.5)
            got = run_plan(plan, X(data), mesh=G)[0]
        elif port == "run_plan_merge_desc":
            got = run_plan(SortPlan("distributed_merge"), X(data), mesh=G, ascending=False)
        else:
            got = sort(X(data), mesh=G, strategy="distributed_merge")
        out[name] = got.numpy()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cluster")
    save_inputs(workdir, _inputs())
    return run_both(REF_BODY, PORT_BODY, WORLDS, workdir)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("world,name", [(w, n) for w in WORLDS for n in _on(w, SORT_CASES)])
def test_cluster_sort_matches_reference(results, world, name):
    ref, port = results[0][world], results[1][world]
    _same(concat(port, name + "/slab"), ref[name + "/slab"])
    _same(concat(port, name + "/valid"), ref[name + "/valid"])
    data = SORT_CASES[name][0]
    keys = _inputs()[data][: world * M]
    got = concat(port, name + "/slab")[concat(port, name + "/valid")]
    np.testing.assert_array_equal(got, np.sort(keys))  # values; -0.0 == 0.0


@pytest.mark.parametrize("world,name", [(w, n) for w in WORLDS for n in _on(w, KV_CASES)]
                         + [(w, n + "-kernel_kv") for w in WORLDS for n in _on(w, KV_CASES)
                            if n in KV_KERNEL])
def test_cluster_sort_kv_matches_reference(results, world, name):
    ref, port = results[0][world], results[1][world]
    case = name.removesuffix("-kernel_kv")  # the kernels' slabs are the library's
    for field in ("slab", "valid", "f", "i"):
        _same(concat(port, f"{name}/{field}"), ref[f"{case}/{field}"])
    keys = _inputs()[KV_CASES[case][0]][: world * M]
    valid = concat(port, name + "/valid")
    np.testing.assert_array_equal(concat(port, name + "/i")[valid],
                                  np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("name", list(FRONT_CASES))
@pytest.mark.parametrize("world", WORLDS[:3])
def test_mesh_front_doors_are_the_stable_sort(results, world, name):
    port = results[1][world]
    data, _, ascending = FRONT_CASES[name]
    inputs = _inputs()
    keys, f = inputs[data][: world * M], inputs["f"][: world * M]
    order = np.argsort(keys if ascending else -keys.astype(np.float64), kind="stable")
    idx = concat(port, name + "/idx")
    assert idx.dtype == np.int32
    np.testing.assert_array_equal(idx, order)
    _same(concat(port, name + "/keys"), keys[order])
    _same(concat(port, name + "/f"), f[order])


@pytest.mark.parametrize("name", list(C_CASES))
@pytest.mark.parametrize("world", WORLDS[:3])
def test_model_c_buffers_match_reference(results, world, name):
    ref, port = results[0][world], results[1][world]
    _same(concat(port, name + "/buf"), ref[name + "/buf"])
    keys = _inputs()[C_CASES[name][0]][: world * M]
    np.testing.assert_array_equal(port[0][name + "/buf"], np.sort(keys))


@pytest.mark.parametrize("name", list(DISPATCH))
@pytest.mark.parametrize("world", WORLDS[:3])
def test_mesh_dispatch_matches_reference(results, world, name):
    ref, port = results[0][world], results[1][world]
    want = ref[name]
    if DISPATCH[name][1] == "run_plan_merge_desc":  # every rank's buffer, flipped
        want = np.flip(want.reshape(world, -1), axis=-1).reshape(-1)
    _same(concat(port, name), want)
