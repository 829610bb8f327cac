"""NaN in the port's rank merge: positions, merges and model B against the
reference, bit for bit.

The merge searches float runs on an integer image of the keys in
``jnp.searchsorted``'s order (-0.0 equal to +0.0, every NaN above ``+inf``
and equal to every other NaN), so NaN-holding runs merge as the
reference's do and the merge positions always form a permutation.

The reference's model B pads with ``+inf``, which sorts before NaN, so
its output for keys holding NaN drops a NaN and holds an ``inf`` that was
not in the input (its own fault, listed in ROADMAP Queue 3).  That output
is the parity target of ``shared_memory_sort`` here, not a contract.  For
``local_impl`` ``'bitonic'`` and ``'kernel'`` NaN output is unspecified:
those tests only hold that no call raises and the shape is the input's.
Tolerance: exact (bit patterns) throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import merge as ref_merge
from repro.core.shared_sort import shared_memory_sort as ref_shared_sort
from repro_torch import engine
from repro_torch.core import merge
from repro_torch.core.shared_sort import shared_memory_sort

from _torch_parity import DTYPES, assert_bits_equal, cpu

FLOATS = ("float32", "float16", "bfloat16")
SPECIAL = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)
SEVEN = np.array([3.0, 1.0, np.nan, 0.0, -1.0, np.nan, -0.0], np.float32)


def nan_keys(dtype: str, n: int, seed: int) -> np.ndarray:
    """Seeded keys with NaN (both signs), ±inf and ±0 mixed in, a quarter
    of the slots special."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(n) * 4).astype(np.float32)  # ties on purpose
    at = rng.random(n) < 0.25
    x[at] = rng.choice(SPECIAL, int(at.sum()))
    return x.astype(DTYPES[dtype])


def sorted_runs(dtype: str, rows: int, w: int, seed: int) -> np.ndarray:
    """(rows, 2, w) pairs of runs sorted as jnp.sort sorts (NaN last)."""
    x = nan_keys(dtype, rows * 2 * w, seed).reshape(rows, 2, w)
    return np.asarray(jnp.sort(jnp.asarray(x), axis=-1))


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("side", ["left", "right"])
def test_search_positions_match_jnp_searchsorted(dtype, side):
    runs = sorted_runs(dtype, 8, 64, seed=1)
    for a, b in runs:
        want = np.asarray(jnp.searchsorted(jnp.asarray(a), jnp.asarray(b), side=side))
        got = torch.searchsorted(merge.sort_image(cpu(a)), merge.sort_image(cpu(b)), side=side)
        np.testing.assert_array_equal(got.numpy(), want)


def test_the_listed_pair_merges_as_the_reference():
    a, b = np.array([1.0, np.nan], np.float32), np.array([0.0, np.nan], np.float32)
    got = merge.merge_sorted_pair(cpu(a), cpu(b))
    want = ref_merge.merge_sorted_pair(jnp.asarray(a), jnp.asarray(b))
    assert_bits_equal(got, want)
    assert np.isnan(got.numpy()[2:]).all() and got.numpy()[:2].tolist() == [0.0, 1.0]


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("w", [1, 4, 33])
def test_merge_sorted_pair_with_nan_matches_reference(dtype, w):
    runs = sorted_runs(dtype, 6, w, seed=w)
    vals = np.arange(runs.size, dtype=np.int32).reshape(runs.shape)
    got, got_v = merge.merge_sorted_pair(cpu(runs[:, 0]), cpu(runs[:, 1]),
                                         {"i": cpu(vals[:, 0])}, {"i": cpu(vals[:, 1])})
    want, want_v = ref_merge.merge_sorted_pair(jnp.asarray(runs[:, 0]), jnp.asarray(runs[:, 1]),
                                               {"i": jnp.asarray(vals[:, 0])},
                                               {"i": jnp.asarray(vals[:, 1])})
    assert_bits_equal(got, want)
    assert_bits_equal(got_v["i"], want_v["i"])
    # a permutation: every input slot read exactly once
    assert sorted(got_v["i"].reshape(-1).tolist()) == list(range(runs.size))


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("width", [1, 2, 8])
def test_merge_adjacent_with_nan_matches_reference(dtype, width):
    n = 64
    x = nan_keys(dtype, 3 * n, seed=width).reshape(3, n // width, width)
    x = np.asarray(jnp.sort(jnp.asarray(x), axis=-1)).reshape(3, n)
    assert_bits_equal(merge.merge_adjacent(cpu(x), width), ref_merge.merge_adjacent(jnp.asarray(x), width))


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("local_impl", ["xla", "merge"])
@pytest.mark.parametrize("n,n_threads", [(7, 2), (100, 4)])
def test_shared_memory_sort_with_nan_matches_reference(dtype, local_impl, n, n_threads):
    x = nan_keys(dtype, n, seed=n)
    asc = dtype != "float16"  # descending is the ascending result flipped: once is enough
    got = shared_memory_sort(cpu(x), n_threads=n_threads, local_impl=local_impl, ascending=asc)
    want = ref_shared_sort(jnp.asarray(x), n_threads=n_threads, local_impl=local_impl,
                           ascending=asc)
    assert_bits_equal(got, want)


@pytest.mark.parametrize("local_impl", ["xla", "merge"])
def test_front_door_sort_of_the_listed_keys_matches_reference(local_impl):
    got = repro_torch.sort(SEVEN, strategy="shared", local_impl=local_impl, n_threads=2,
                           device="cpu")
    want = repro.sort(jnp.asarray(SEVEN), strategy="shared", local_impl=local_impl, n_threads=2)
    assert_bits_equal(got, want)
    got_default = repro_torch.sort(SEVEN, device="cpu")
    assert_bits_equal(got_default, repro.sort(jnp.asarray(SEVEN)))


@pytest.mark.parametrize("local_impl", ["bitonic", "kernel"])
@pytest.mark.parametrize("dtype", FLOATS)
def test_unspecified_impls_do_not_raise_on_nan(local_impl, dtype):
    for n, n_threads in [(7, 2), (100, 4), (300, 8)]:
        x = nan_keys(dtype, n, seed=n)
        out = repro_torch.sort(x, strategy="shared", local_impl=local_impl, n_threads=n_threads,
                               device="cpu")
        assert out.shape == (n,) and out.dtype == cpu(x).dtype


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_argsort_with_nan_does_not_raise(impl):
    """'xla' returns a permutation; the kernel's NaN order is unspecified
    (a pad rank may displace a real one), so only its shape is held."""
    x = nan_keys("float32", 300, seed=3)
    for asc in (True, False):
        idx = engine.argsort(x, ascending=asc, impl=impl, device="cpu")
        assert idx.shape == (300,) and idx.dtype == torch.int32
        if impl == "xla":
            assert sorted(idx.tolist()) == list(range(300))


@pytest.mark.parametrize("dtype", FLOATS)
def test_library_sorts_order_nan_as_the_reference(dtype):
    """'xla' sorts floats on ``sort_image``: NaN of either sign last, as
    ``jnp.sort`` / ``jnp.argsort`` order it (torch's own sort on the card
    puts a negative NaN first)."""
    from repro.engine import argsort as ref_argsort
    from repro_torch.core.seqsort import fast_local_sort

    x = nan_keys(dtype, 3 * 64, seed=9).reshape(3, 64)
    assert_bits_equal(fast_local_sort(cpu(x), impl="xla"), jnp.sort(jnp.asarray(x), axis=-1))
    for asc in (True, False):
        got = engine.argsort(cpu(x), ascending=asc, impl="xla")
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_argsort(jnp.asarray(x), ascending=asc)))
