"""Port vs reference: the partitioners of model D on 1, 2 and 4 ranks.

The reference runs on a forced host mesh in one subprocess per world size;
the port runs as that many gloo ranks (``_torch_ranks``).  Both get the same
seeded keys: uniform, zipf, all-equal and duplicate-heavy, float32 (with
-0.0 and +0.0 mixed in: the sorts treat them as equal keys, and every
result must keep the reference's bits) and int32.  Bucket ids, plain
splitters and composite ``(key, id)`` splitters are compared bit for bit.
"""

import numpy as np
import pytest

from _torch_ranks import bits, concat, mesh_keys, replicated, run_both, save_inputs

WORLDS = (1, 2, 4)
M = 200  # keys a rank: strided samples (stride 12, 6, 3 at 1, 2, 4 ranks)
KINDS = ("uniform", "zipf", "all_equal", "dup_heavy")
DTYPES = ("float32", "int32")
N_BUCKETS = 5  # not a power of two, not the world size: the arithmetic in full


def _cases():
    cases = {}
    for kind in KINDS:
        for dtype in DTYPES:
            data = f"{kind}-{dtype}"
            for mode in ("radix", "splitters", "sample", "sample_stable", "range"):
                cases[f"{data}-{mode}"] = (data, mode)
        cases[f"{kind}-decimal"] = (f"{kind}-decimal", "decimal")
    cases["inf-float32-radix"] = ("inf-float32", "radix")
    cases["inf-float32-sample"] = ("inf-float32", "sample")
    return cases


CASES = _cases()


def _inputs() -> dict:
    n = max(WORLDS) * M
    arrays = {}
    for i, kind in enumerate(KINDS):
        for dtype in DTYPES:
            arrays[f"{kind}-{dtype}"] = mesh_keys(kind, dtype, n, seed=10 * i + len(dtype))
        arrays[f"{kind}-decimal"] = np.abs(mesh_keys(kind, "int32", n, seed=10 * i + 7)) % 1000
    inf = mesh_keys("uniform", "float32", n, seed=99)
    inf[::11], inf[5::13] = np.inf, -np.inf
    arrays["inf-float32"] = inf
    return arrays


_PARAMS = f"M = {M}\nB = {N_BUCKETS}\nCASES = {CASES!r}\n"

# range mode's static [lo, hi) is the data's own, rounded out
_RANGE = """
def lo_hi(a):
    return float(np.floor(a.min())), float(np.floor(a.max())) + 1.0
"""

REF_BODY = _PARAMS + _RANGE + """
from repro.core.radix import decimal_msd_bucket, range_bucket
from repro.exchange.partition import (
    _composite_splitters, choose_splitters, radix_bucket_ids, sample_partition_ids,
    splitter_bucket)

def composite(k, stable):
    idx, P_, m = jax.lax.axis_index("x"), jax.lax.axis_size("x"), k.shape[-1]
    pos = jnp.arange(m, dtype=jnp.int32)
    gid = idx * m + pos if stable else pos * P_ + idx
    return _composite_splitters(k, gid, B, "x", 16)

for name, (data, mode) in CASES.items():
    a = IN[data][:WORLD * M]
    x = jnp.asarray(a)
    if mode == "radix":
        out[name] = smap(lambda k: radix_bucket_ids(k, B, "x"), P("x"), P("x"))(x)
    elif mode == "range":
        lo, hi = lo_hi(a)
        out[name] = smap(lambda k: range_bucket(k, n_buckets=8, lo=lo, hi=hi), P("x"), P("x"))(x)
    elif mode == "decimal":
        out[name] = smap(lambda k: decimal_msd_bucket(k, digits=3), P("x"), P("x"))(x)
    elif mode == "splitters":
        spl = smap(lambda k: choose_splitters(k, B, "x"), P("x"), P())(x)
        out[name + "/splitters"] = spl
        out[name] = smap(lambda k: splitter_bucket(k, choose_splitters(k, B, "x")),
                         P("x"), P("x"))(x)
    else:
        stable = mode == "sample_stable"
        out[name] = smap(lambda k: sample_partition_ids(k, B, "x", stable=stable),
                         P("x"), P("x"))(x)
        out[name + "/spl_k"], out[name + "/spl_id"] = smap(
            lambda k: composite(k, stable), P("x"), (P(), P()))(x)
"""

PORT_BODY = _PARAMS + _RANGE + """
from repro_torch.core.radix import decimal_msd_bucket, range_bucket
from repro_torch.exchange.partition import (
    _composite_splitters, choose_splitters, radix_bucket_ids, sample_partition_ids,
    splitter_bucket)

def composite(k, stable):
    m = k.shape[-1]
    pos = torch.arange(m, dtype=torch.int32)
    gid = RANK * m + pos if stable else pos * WORLD + RANK
    return _composite_splitters(k, gid, B, G, 16)

for name, (data, mode) in CASES.items():
    a = IN[data][:WORLD * M]
    x = shard(a)
    if mode == "radix":
        got = radix_bucket_ids(x, B, G)
    elif mode == "range":
        lo, hi = lo_hi(a)
        got = range_bucket(x, n_buckets=8, lo=lo, hi=hi)
    elif mode == "decimal":
        got = decimal_msd_bucket(x, digits=3)
    elif mode == "splitters":
        out[name + "/splitters"] = choose_splitters(x, B, G).numpy()
        got = splitter_bucket(x, choose_splitters(x, B, G))
    else:
        stable = mode == "sample_stable"
        got = sample_partition_ids(x, B, G, stable=stable)
        spl_k, spl_id = composite(x, stable)
        out[name + "/spl_k"], out[name + "/spl_id"] = spl_k.numpy(), spl_id.numpy()
    out[name] = got.numpy()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("partition")
    save_inputs(workdir, _inputs())
    return run_both(REF_BODY, PORT_BODY, WORLDS, workdir)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_bucket_ids_match_reference(results, world, name):
    ref, port = results[0][world], results[1][world]
    got = concat(port, name)
    assert got.dtype == np.int32 and ref[name].dtype == np.int32
    np.testing.assert_array_equal(got, ref[name])


@pytest.mark.parametrize("name", [c for c, (_, mode) in CASES.items() if mode != "decimal"
                                  and mode not in ("radix", "range")])
@pytest.mark.parametrize("world", WORLDS)
def test_splitters_match_reference(results, world, name):
    ref, port = results[0][world], results[1][world]
    fields = ("/splitters",) if CASES[name][1] == "splitters" else ("/spl_k", "/spl_id")
    for field in fields:
        got = replicated(port, name + field)
        assert got.dtype == ref[name + field].dtype
        np.testing.assert_array_equal(bits(got), bits(ref[name + field]))
