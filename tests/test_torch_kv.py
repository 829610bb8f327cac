"""Port vs reference: single-device argsort / sort_kv / sort_pairs / topk.

``impl='kernel'`` (the CUDA kernels' plain versions on CPU tensors) is held
against the reference's ``impl='pallas'`` (interpret mode), and
``impl='xla'`` (``torch.sort(stable=True)``) against ``impl='xla'``
(``jnp.argsort(stable=True)``).  Permutations and gathered payloads (any
nest of dicts, lists and tuples, as the reference's pytree) are compared
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DTYPES, assert_bits_equal, cpu, make_keys
from repro.engine import kv as ref_kv
from repro_torch import keys
from repro_torch.engine import kv

_REF_IMPL = {"kernel": "pallas", "xla": "xla"}


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_argsort_matches_reference(impl, dtype, ascending):
    x = make_keys(dtype, (2, 300), seed=30, duplicates=True)
    got = kv.argsort(cpu(x), ascending=ascending, impl=impl, block_n=64)
    want = ref_kv.argsort(jnp.asarray(x), ascending=ascending, impl=_REF_IMPL[impl], block_n=64)
    assert got.dtype == torch.int32 and np.asarray(want).dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    order = x if ascending else -x.astype(np.float64)
    np.testing.assert_array_equal(got.numpy(), np.argsort(order, axis=-1, kind="stable"))


@pytest.mark.parametrize("n", [1, 2, 3, 1000])
def test_kernel_argsort_any_length(n):
    x = make_keys("int32", n, seed=31, duplicates=True)
    x[0] = np.iinfo(np.int32).max  # a key equal to the pad sentinel
    got = kv.argsort(cpu(x), impl="kernel", block_n=128)
    want = ref_kv.argsort(jnp.asarray(x), impl="pallas", block_n=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_sort_kv_matches_reference(impl, ascending):
    keys = make_keys("float32", 500, seed=32, duplicates=True)
    rng = np.random.default_rng(33)
    values = {"payload": rng.standard_normal((500, 4)).astype(np.float32),
              "id": np.arange(500, dtype=np.int32)}
    got_k, got_v = kv.sort_kv(cpu(keys), {k: cpu(v) for k, v in values.items()},
                              ascending=ascending, impl=impl, block_n=128)
    want_k, want_v = ref_kv.sort_kv(jnp.asarray(keys), jax.tree.map(jnp.asarray, values),
                                    ascending=ascending, impl=_REF_IMPL[impl], block_n=128)
    assert_bits_equal(got_k, want_k)
    for name in values:
        assert_bits_equal(got_v[name], want_v[name])


@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_sort_pairs_matches_reference(impl):
    keys = make_keys("bfloat16", (3, 100), seed=34, duplicates=True)
    values = np.random.default_rng(35).integers(0, 1000, (3, 100)).astype(np.int32)
    got_k, got_v = kv.sort_pairs(cpu(keys), cpu(values), impl=impl, block_n=32)
    want_k, want_v = ref_kv.sort_pairs(jnp.asarray(keys), jnp.asarray(values),
                                       impl=_REF_IMPL[impl], block_n=32)
    assert_bits_equal(got_k, want_k)
    assert_bits_equal(got_v, want_v)


@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_sort_kv_takes_any_pytree_like_the_reference(impl):
    """A tuple payload and a nest of dicts and lists come back in their
    structure, each leaf permuted like the reference's."""
    keys = make_keys("int32", 200, seed=38, duplicates=True)
    rng = np.random.default_rng(39)
    a, b = rng.standard_normal((200, 3)).astype(np.float32), np.arange(200, dtype=np.int32)
    c = rng.integers(0, 9, 200).astype(np.int32)
    for values in ((a, b), {"x": [a, {"y": b}], "z": (c,)}):
        got_k, got_v = kv.sort_kv(cpu(keys), jax.tree.map(cpu, values), impl=impl, block_n=64)
        want_k, want_v = ref_kv.sort_kv(jnp.asarray(keys), jax.tree.map(jnp.asarray, values),
                                        impl=_REF_IMPL[impl], block_n=64)
        assert_bits_equal(got_k, want_k)
        assert jax.tree.structure(jax.tree.map(np.asarray, want_v)) == jax.tree.structure(
            jax.tree.map(lambda t: t.numpy(), got_v))
        for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got_v)), jax.tree.leaves(want_v)):
            assert_bits_equal(g, w)
    got_k, got_v = kv.sort_pairs(cpu(keys), (cpu(a), cpu(b)), impl=impl, block_n=64)
    want_k, want_v = ref_kv.sort_kv(jnp.asarray(keys), (jnp.asarray(a), jnp.asarray(b)),
                                    impl=_REF_IMPL[impl], block_n=64)
    assert isinstance(got_v, tuple) and len(got_v) == 2
    assert_bits_equal(got_v[0], want_v[0])
    assert_bits_equal(got_v[1], want_v[1])


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_topk_matches_reference_with_ties(impl, largest):
    x = make_keys("float32", (4, 700), seed=36)
    x[:, [5, 77, 400]] = x[:, [3]]  # ties put in on purpose: lowest index wins
    x[:, [10, 11]] = x.max() + 1
    got_v, got_i = kv.topk(cpu(x), 20, largest=largest, impl=impl, block_n=128)
    want_v, want_i = ref_kv.topk(jnp.asarray(x), 20, largest=largest,
                                 impl=_REF_IMPL[impl], block_n=128)
    assert_bits_equal(got_v, want_v)
    assert got_i.dtype == torch.int32 and np.asarray(want_i).dtype == np.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if largest:
        lax_v, lax_i = jax.lax.top_k(jnp.asarray(x), 20)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(lax_i))


def test_kernel_and_library_argsort_agree_on_signed_zeros():
    x = np.array([0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 0.0, 2.0], np.float32)
    want = ref_kv.argsort(jnp.asarray(x), impl="pallas", block_n=4)
    np.testing.assert_array_equal(kv.argsort(cpu(x), impl="kernel", block_n=4).numpy(), np.asarray(want))
    np.testing.assert_array_equal(kv.argsort(cpu(x), impl="xla").numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rev_key_matches_reference(dtype):
    x = make_keys(dtype, 64, seed=37)
    got = keys.rev_key(cpu(x))
    assert got.dtype == cpu(x).dtype
    assert_bits_equal(got, ref_kv._rev_key(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32], ids=lambda d: d.__name__)
@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_descending_unsigned_keys_match_reference(impl, dtype):
    """argsort / sort_kv / topk with the order reversed on unsigned keys,
    extremes and duplicates included."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(38)
    x = rng.integers(info.min, info.max, (2, 300), endpoint=True).astype(dtype)
    x[:, ::7] = x[:, [3]]
    x[:, [0, 50]], x[:, [10, 11]] = info.max, info.min
    ref_impl = _REF_IMPL[impl]
    got = kv.argsort(cpu(x), ascending=False, impl=impl, block_n=64)
    want = ref_kv.argsort(jnp.asarray(x), ascending=False, impl=ref_impl, block_n=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.argsort(-x.astype(np.int64), axis=-1, kind="stable"))
    got_k, got_v = kv.sort_kv(cpu(x[0]), [cpu(x[1])], ascending=False, impl=impl, block_n=64)
    want_k, want_v = ref_kv.sort_kv(jnp.asarray(x[0]), [jnp.asarray(x[1])], ascending=False,
                                    impl=ref_impl, block_n=64)
    assert_bits_equal(got_k, want_k)
    assert_bits_equal(got_v[0], want_v[0])
    got_v, got_i = kv.topk(cpu(x), 20, impl=impl, block_n=64)
    want_v, want_i = ref_kv.topk(jnp.asarray(x), 20, impl=ref_impl, block_n=64)
    assert_bits_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_mesh_and_unknown_impl_raise():
    # the mesh paths are ported (tests/test_torch_cluster.py): what is not a
    # process group is refused
    with pytest.raises(TypeError, match="AxisGroup or a torch.distributed ProcessGroup"):
        kv.argsort(torch.zeros(8), mesh=object(), axis="x")
    with pytest.raises(TypeError, match="AxisGroup or a torch.distributed ProcessGroup"):
        kv.sort_kv(torch.zeros(8), {}, mesh=object(), axis="x")
    with pytest.raises(ValueError):
        kv.argsort(torch.zeros(8), impl="pallas")
