"""Port vs reference: the exchange wire, its inverse, the int8 wire's
gradients and the capacity retry, on 1, 2 and 4 ranks.

The reference runs ``partition_exchange`` inside ``shard_map`` on a forced
host mesh; the port runs it on gloo ranks (``_torch_ranks``).  Every field
of ``ExchangeResult`` — received keys, values, source slots, send slots,
counts, overflow — the ``combine_exchange`` round trip, the gradients of
``sum(recv ** 2) / 2`` through the plain and the int8 wire (``jax.grad``
against ``torch.autograd``) and the retry loop's telemetry are compared
bit for bit.  The int8 wire's values come out bit-equal too: both sides
quantize with the same float32 operations in the same order.
"""

import numpy as np
import pytest

from _torch_ranks import bits, concat, mesh_keys, run_both, save_inputs

WORLDS = (1, 2, 4)
M = 96

# name: (keys, bucket rule, buckets per rank, capacity, partition, values, compress)
#   bucket rule "mod" = key % n_buckets (ints) / index % n_buckets; None derives
#   the ids from ``partition``; capacity "m" is loss-free, "tight" overflows
CASES = {
    "mod": ("uniform-int32", "mod", 1, "m", None, "fi", False),
    "mod_2_buckets_a_rank": ("uniform-int32", "mod", 2, "m", None, "fi", False),
    "overflow": ("dup_heavy-int32", "mod", 1, "tight", None, "fi", False),
    "radix": ("uniform-float32", None, 1, "m", "radix", "f", False),
    "sample_values": ("all_equal-float32", None, 1, "m", "sample", "fi", False),
    "sample_keys_only": ("zipf-int32", None, 1, "m", "sample", "", False),
    "compress": ("uniform-int32", "mod", 1, "m", None, "fi", True),
    "compress_overflow": ("dup_heavy-int32", "mod", 1, "tight", None, "fi", True),
}
FIELDS = ("recv_keys", "recv_src_slot", "send_slot", "counts", "overflow")
GRAD_CASES = ("mod", "overflow", "compress", "compress_overflow")
RETRY = {  # zipf keys over a static range: the hot low bucket overflows at 1.2
    "retry": dict(max_retries=4),
    "retry_exhausted": dict(max_retries=0),
}


def _inputs() -> dict:
    n = max(WORLDS) * M
    rng = np.random.default_rng(5)
    arrays = {f"{k}-{d}": mesh_keys(k, d, n, seed=i)
              for i, (k, d) in enumerate([("uniform", "int32"), ("dup_heavy", "int32"),
                                          ("uniform", "float32"), ("all_equal", "float32"),
                                          ("zipf", "int32")])}
    arrays["f"] = rng.standard_normal((n, 3)).astype(np.float32) * 10
    arrays["i"] = np.arange(n, dtype=np.int32)
    arrays["zipf"] = (rng.zipf(1.5, n) % 900 + 100).astype(np.int32)
    return arrays


_PARAMS = (f"M = {M}\nCASES = {CASES!r}\nGRAD_CASES = {GRAD_CASES!r}\n"
           f"RETRY = {RETRY!r}\n") + """
def setup(name, lib):
    keys, rule, per_rank, cap, partition, vals, compress = CASES[name]
    B = per_rank * WORLD
    C = M if cap == "m" else max(1, M // (4 * B))
    return keys, rule, B, C, partition, vals, compress
"""

REF_BODY = _PARAMS + """
from repro.core.cluster_sort import cluster_sort
from repro.exchange import combine_exchange, partition_exchange

def exchange(name, k, f, i):
    keys, rule, B, C, partition, vals, compress = setup(name, "jax")
    values = {n: v for n, v in (("f", f), ("i", i)) if n in vals} or None
    bucket = None if rule is None else (k % B).astype(jnp.int32)
    return partition_exchange(k, values, bucket, "x", capacity=C, n_buckets=B,
                              compress=compress, partition=partition)

for name in CASES:
    def body(k, f, i, name=name):
        ex = exchange(name, k, f, i)
        back = None if ex.recv_values is None else combine_exchange(ex.recv_values, ex, "x")
        return (ex.recv_keys.reshape(1, -1), ex.recv_src_slot.reshape(1, -1), ex.send_slot,
                ex.counts[None], ex.overflow[None], ex.recv_values, back)
    spec = P("x")
    got = smap(body, (spec, spec, spec), (spec,) * 7)(
        jnp.asarray(IN[CASES[name][0]][:WORLD * M]), jnp.asarray(IN["f"][:WORLD * M]),
        jnp.asarray(IN["i"][:WORLD * M]))
    for field, v in zip(("recv_keys", "recv_src_slot", "send_slot", "counts", "overflow"), got):
        out[f"{name}/{field}"] = v
    for leaf, v in (got[5] or {}).items():
        out[f"{name}/recv_values/{leaf}"] = np.asarray(v).reshape((WORLD, -1) + v.shape[2:])
        out[f"{name}/combine/{leaf}"] = got[6][leaf]

for name in GRAD_CASES:
    def grad_body(k, f, i, name=name):
        def loss(f):
            return 0.5 * jnp.sum(exchange(name, k, f, i).recv_values["f"] ** 2)
        return jax.grad(loss)(f)
    spec = P("x")
    out[f"{name}/grad"] = smap(grad_body, (spec, spec, spec), spec)(
        jnp.asarray(IN[CASES[name][0]][:WORLD * M]), jnp.asarray(IN["f"][:WORLD * M]),
        jnp.asarray(IN["i"][:WORLD * M]))

for name, kw in RETRY.items():
    seen = []
    x = jnp.asarray(IN["zipf"][:WORLD * M])
    try:
        slab, valid = cluster_sort(x, mesh, "x", mode="range", lo=100, hi=1000,
                                   capacity_factor=1.2, telemetry=lambda **t: seen.append(t), **kw)
        out[f"{name}/slab"], out[f"{name}/valid"] = slab, valid
        out[f"{name}/raised"] = np.array(0)
    except RuntimeError:
        out[f"{name}/raised"] = np.array(1)
    (t,) = seen
    for field, v in t.items():
        out[f"{name}/telemetry/{field}"] = np.array(str(v))
"""

PORT_BODY = _PARAMS + """
from repro_torch.core.cluster_sort import cluster_sort
from repro_torch.exchange import combine_exchange, partition_exchange

def sh(name):
    return shard(IN[name][:WORLD * M])

def exchange(name, k, f, i):
    keys, rule, B, C, partition, vals, compress = setup(name, "torch")
    values = {n: v for n, v in (("f", f), ("i", i)) if n in vals} or None
    bucket = None if rule is None else (k % B).to(torch.int32)
    return partition_exchange(k, values, bucket, G, capacity=C, n_buckets=B,
                              compress=compress, partition=partition)

for name in CASES:
    k, f, i = sh(CASES[name][0]), sh("f"), sh("i")
    ex = exchange(name, k, f, i)
    out[f"{name}/recv_keys"] = ex.recv_keys.reshape(1, -1).numpy()
    out[f"{name}/recv_src_slot"] = ex.recv_src_slot.reshape(1, -1).numpy()
    out[f"{name}/send_slot"] = ex.send_slot.numpy()
    out[f"{name}/counts"] = ex.counts[None].numpy()
    out[f"{name}/overflow"] = ex.overflow[None].numpy()
    if ex.recv_values is not None:
        back = combine_exchange(ex.recv_values, ex, G)
        for leaf, v in ex.recv_values.items():
            out[f"{name}/recv_values/{leaf}"] = v.reshape((1, -1) + v.shape[2:]).numpy()
            out[f"{name}/combine/{leaf}"] = back[leaf].numpy()

for name in GRAD_CASES:
    f = sh("f").requires_grad_()
    ex = exchange(name, sh(CASES[name][0]), f, sh("i"))
    (0.5 * (ex.recv_values["f"] ** 2).sum()).backward()
    out[f"{name}/grad"] = f.grad.numpy()

for name, kw in RETRY.items():
    seen = []
    try:
        slab, valid = cluster_sort(sh("zipf"), G, mode="range", lo=100, hi=1000,
                                   capacity_factor=1.2, telemetry=lambda **t: seen.append(t), **kw)
        out[f"{name}/slab"], out[f"{name}/valid"] = slab.numpy(), valid.numpy()
        out[f"{name}/raised"] = np.array(0)
    except RuntimeError:
        out[f"{name}/raised"] = np.array(1)
    (t,) = seen
    for field, v in t.items():
        out[f"{name}/telemetry/{field}"] = np.array(str(v))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("exchange")
    save_inputs(workdir, _inputs())
    return run_both(REF_BODY, PORT_BODY, WORLDS, workdir)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_exchange_result_matches_reference(results, world, name, field):
    ref, port = results[0][world], results[1][world]
    _same(concat(port, f"{name}/{field}"), ref[f"{name}/{field}"])
    if field == "overflow":  # the flag is the group's: every rank sees the same
        assert len(set(concat(port, f"{name}/{field}").tolist())) == 1
        assert bool(ref[f"{name}/{field}"][0]) == (CASES[name][3] == "tight")


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[5]])
@pytest.mark.parametrize("world", WORLDS)
def test_exchanged_values_and_round_trip_match_reference(results, world, name):
    ref, port = results[0][world], results[1][world]
    for leaf in CASES[name][5]:
        _same(concat(port, f"{name}/recv_values/{leaf}"), ref[f"{name}/recv_values/{leaf}"])
        back = concat(port, f"{name}/combine/{leaf}")
        _same(back, ref[f"{name}/combine/{leaf}"])
        if CASES[name][3] == "m" and (leaf == "i" or not CASES[name][6]):
            sent = _inputs()[leaf][: world * M]
            np.testing.assert_array_equal(back, sent)  # exact round trip


@pytest.mark.parametrize("name", GRAD_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_wire_gradients_match_jax_grad(results, world, name):
    ref, port = results[0][world], results[1][world]
    _same(concat(port, f"{name}/grad"), ref[f"{name}/grad"])


@pytest.mark.parametrize("name", list(RETRY))
@pytest.mark.parametrize("world", WORLDS)
def test_retry_and_telemetry_match_reference(results, world, name):
    ref, port = results[0][world], results[1][world]
    assert len(port) == world
    raised = int(ref[f"{name}/raised"])
    for rank in port:
        assert int(rank[f"{name}/raised"]) == raised
        fields = sorted(k for k in rank if k.startswith(f"{name}/telemetry/"))
        assert fields == sorted(k for k in ref if k.startswith(f"{name}/telemetry/"))
        for field in fields:
            if field.endswith("/recompiles"):
                assert str(rank[field]) == "0"  # the port compiles nothing
            else:
                assert str(rank[field]) == str(ref[field]), field
    if world > 1:  # the hot bucket really overflowed at capacity factor 1.2
        assert str(ref[f"{name}/telemetry/overflowed"]) == "True"
        assert raised == (name == "retry_exhausted")
    if not raised:
        _same(concat(port, f"{name}/slab"), ref[f"{name}/slab"])
        _same(concat(port, f"{name}/valid"), ref[f"{name}/valid"])
