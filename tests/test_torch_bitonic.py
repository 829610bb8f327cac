"""Port vs reference: the bitonic network, its oracles and the kernels' plain
versions.

``repro_torch.core.bitonic`` against ``repro.core.bitonic``, the ``ref.py``
oracles against theirs, and the CUDA kernels' plain versions (what the
wrappers run on CPU tensors) against the Pallas kernels in interpret mode.
Same seeded numpy inputs, bit patterns compared (exact: nothing does
arithmetic on the keys).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DTYPES, LENGTHS, SIGNED_ZEROS, assert_bits_equal, cpu, make_keys
from repro.core import bitonic as ref_bitonic
from repro.kernels.bitonic_sort import bitonic_sort as ref_kernels
from repro.kernels.bitonic_sort import ref as ref_oracles
from repro_torch.core import bitonic
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels
from repro_torch.kernels.bitonic_sort import ref as oracles


# ------------------------------------------------------------ core network ---
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bitonic_sort_matches_reference(dtype, n):
    x = make_keys(dtype, (2, n), seed=n)
    assert_bits_equal(bitonic.bitonic_sort(cpu(x)), ref_bitonic.bitonic_sort(jnp.asarray(x)))


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bitonic_sort_stable_with_values(dtype, ascending):
    k = make_keys(dtype, 300, seed=1, duplicates=True)
    v = np.random.default_rng(2).standard_normal(300).astype(np.float32)
    got_k, got_v = bitonic.bitonic_sort(cpu(k), {"v": cpu(v)}, ascending=ascending, stable=True)
    want_k, want_v = ref_bitonic.bitonic_sort(
        jnp.asarray(k), {"v": jnp.asarray(v)}, ascending=ascending, stable=True
    )
    assert_bits_equal(got_k, want_k)
    assert_bits_equal(got_v["v"], want_v["v"])


def test_network_keeps_signed_zeros_in_network_order():
    assert_bits_equal(
        bitonic.bitonic_sort(cpu(SIGNED_ZEROS)), ref_bitonic.bitonic_sort(jnp.asarray(SIGNED_ZEROS))
    )


@pytest.mark.parametrize("largest", [True, False])
def test_bitonic_topk_matches_reference(largest):
    x = make_keys("float32", (3, 100), seed=3, duplicates=True)
    got_v, got_i = bitonic.bitonic_topk(cpu(x), 10, largest=largest)
    want_v, want_i = ref_bitonic.bitonic_topk(jnp.asarray(x), 10, largest=largest)
    assert_bits_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("ascending", [True, False])
def test_bitonic_merge_pair_matches_reference(ascending):
    rng = np.random.default_rng(4)
    a = np.sort(rng.integers(0, 50, 64)).astype(np.int32)
    b = np.sort(rng.integers(0, 50, 64)).astype(np.int32)
    va, vb = np.arange(64, dtype=np.int32), np.arange(64, 128, dtype=np.int32)
    if not ascending:
        a, b = a[::-1].copy(), b[::-1].copy()
    got_k, got_v = bitonic.bitonic_merge_pair(cpu(a), cpu(b), cpu(va), cpu(vb), ascending=ascending)
    want_k, want_v = ref_bitonic.bitonic_merge_pair(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb), ascending=ascending
    )
    assert_bits_equal(got_k, want_k)
    assert_bits_equal(got_v, want_v)


def test_next_pow2_matches_reference():
    for n in (1, 2, 3, 4, 5, 1000, 1024, 1025, 10_000_000):
        assert bitonic.next_pow2(n) == ref_bitonic.next_pow2(n)


# ----------------------------------------------------------------- oracles ---
# the reference oracles are plain jnp; jit keeps their op-by-op dispatch short
_REF_BLOCK_SORT = jax.jit(ref_oracles.block_sort_ref, static_argnums=1)
_REF_BLOCK_MERGE = jax.jit(ref_oracles.block_merge_ref, static_argnums=(1, 2))
_REF_GLOBAL_STAGE = jax.jit(ref_oracles.global_stage_ref, static_argnums=(1, 2))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ref_oracles_match_reference(dtype):
    block_n, n = 32, 256
    x = make_keys(dtype, n, seed=5)
    y, ry = oracles.block_sort_ref(cpu(x), block_n), _REF_BLOCK_SORT(jnp.asarray(x), block_n)
    assert_bits_equal(y, ry)
    k = 2 * block_n
    while k <= n:
        j = k // 2
        while j >= block_n:
            y, ry = oracles.global_stage_ref(y, j, k), _REF_GLOBAL_STAGE(ry, j, k)
            assert_bits_equal(y, ry)
            j //= 2
        y, ry = oracles.block_merge_ref(y, block_n, k), _REF_BLOCK_MERGE(ry, block_n, k)
        assert_bits_equal(y, ry)
        k *= 2
    assert_bits_equal(oracles.full_sort_ref(cpu(x)), ref_oracles.full_sort_ref(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_sort_ref_keeps_signed_zeros_like_the_reference(dtype):
    """Both library sorts are stable: -0.0 and +0.0 keep their input order."""
    x = np.tile(np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0], np.float32), (2, 4)).astype(DTYPES[dtype])
    assert_bits_equal(oracles.full_sort_ref(cpu(x)), ref_oracles.full_sort_ref(jnp.asarray(x)))


# ------------------------------------ plain kernel versions vs Pallas kernels ---
@pytest.mark.parametrize("block_n,n", [(64, 64), (64, 512), (128, 1024)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_sort_plain_matches_pallas(dtype, block_n, n):
    x = make_keys(dtype, n, seed=block_n + n)
    want = ref_kernels.block_sort(jnp.asarray(x), block_n, interpret=True)
    assert_bits_equal(kernels.block_sort(cpu(x), block_n), want)


def test_block_sort_plain_keeps_signed_zeros_like_pallas():
    want = ref_kernels.block_sort(jnp.asarray(SIGNED_ZEROS), 4, interpret=True)
    assert_bits_equal(kernels.block_sort(cpu(SIGNED_ZEROS), 4), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_merge_and_global_stage_plain_match_pallas(dtype):
    """B and C over every stage of a 64-wide tiling of 512 keys, each step
    from the same state."""
    block_n, n = 64, 512
    x = jnp.asarray(make_keys(dtype, n, seed=6))
    y = ref_kernels.block_sort(x, block_n, interpret=True)
    k = 2 * block_n
    while k <= n:
        j = k // 2
        while j >= block_n:
            want = ref_kernels.global_stage(y, j, k)
            assert_bits_equal(kernels.global_stage(cpu(np.asarray(y)), j, k), want)
            y, j = want, j // 2
        want = ref_kernels.block_merge(y, block_n, k, interpret=True)
        assert_bits_equal(kernels.block_merge(cpu(np.asarray(y)), block_n, k), want)
        y, k = want, k * 2


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kv_kernels_plain_match_pallas(dtype):
    """A-kv, C-kv and B-kv on duplicate-heavy keys (the rank tie-break
    decides), with a key equal to the pad sentinel."""
    block_n, n = 64, 256
    x = make_keys(dtype, n, seed=7, duplicates=True)
    x[3] = np.asarray(ref_bitonic.sentinel_for(jnp.dtype(DTYPES[dtype]), largest=True))
    r = np.arange(n, dtype=np.int32)
    y, ry = ref_kernels.block_sort_kv(jnp.asarray(x), jnp.asarray(r), block_n, interpret=True)
    got, got_r = kernels.block_sort_kv(cpu(x), cpu(r), block_n)
    assert_bits_equal(got, y)
    assert_bits_equal(got_r, ry)
    k = 2 * block_n
    while k <= n:
        j = k // 2
        while j >= block_n:
            y, ry = ref_kernels.global_stage_kv(y, ry, j, k)
            got, got_r = kernels.global_stage_kv(got, got_r, j, k)
            assert_bits_equal(got, y)
            assert_bits_equal(got_r, ry)
            j //= 2
        y, ry = ref_kernels.block_merge_kv(y, ry, block_n, k, interpret=True)
        got, got_r = kernels.block_merge_kv(got, got_r, block_n, k)
        assert_bits_equal(got, y)
        assert_bits_equal(got_r, ry)
        k *= 2


def test_block_sort_plain_directions_follow_the_tile_within_its_row():
    """Rows one tile long all sort ascending: the direction comes from the
    tile's index within its row, as the reference computes it under vmap."""
    x = make_keys("float32", (3, 64), seed=8)
    got = kernels.block_sort(cpu(x), 64)
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=-1))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(64)
    with pytest.raises(ValueError):
        kernels.block_sort(x, 48)  # block_n not a power of two
    wide = make_keys("float32", kernels.MAX_BLOCK_N * 2, seed=9)  # a tile above the cap is taken
    assert_bits_equal(kernels.block_sort(cpu(wide), kernels.MAX_BLOCK_N * 2),
                      ref_kernels.block_sort(jnp.asarray(wide), kernels.MAX_BLOCK_N * 2, interpret=True))
    with pytest.raises(ValueError):
        kernels.block_sort(torch.zeros(48), 16)  # row length not a power of two
    with pytest.raises(ValueError):
        kernels.block_sort(torch.zeros(8, 64).t(), 4)  # not contiguous
    with pytest.raises(TypeError):
        kernels.block_sort(torch.zeros(64, dtype=torch.int64), 16)
    with pytest.raises(ValueError):
        kernels.global_stage(x, 16, 16)  # k < 2j
    with pytest.raises(ValueError):
        kernels.block_sort_kv(x, torch.arange(64), 16)  # int64 ranks


@pytest.mark.parametrize("has_rank", [False, True])
def test_tiles_above_the_cap_match_pallas(has_rank):
    """block_sort(_kv) and block_merge(_kv) at block_n = 2 * MAX_BLOCK_N on a
    2^16 row, against the Pallas kernels, which take the tile whole."""
    bn, n = 2 * kernels.MAX_BLOCK_N, 4 * kernels.MAX_BLOCK_N
    x = make_keys("float32", n, seed=10, duplicates=has_rank)
    if not has_rank:
        y = ref_kernels.block_sort(jnp.asarray(x), bn, interpret=True)
        assert_bits_equal(kernels.block_sort(cpu(x), bn), y)
        assert_bits_equal(kernels.block_merge(cpu(np.asarray(y)), bn, n),
                          ref_kernels.block_merge(y, bn, n, interpret=True))
        return
    r = np.arange(n, dtype=np.int32)
    y, ry = ref_kernels.block_sort_kv(jnp.asarray(x), jnp.asarray(r), bn, interpret=True)
    got, got_r = kernels.block_sort_kv(cpu(x), cpu(r), bn)
    assert_bits_equal(got, y)
    assert_bits_equal(got_r, ry)
    want, want_r = ref_kernels.block_merge_kv(y, ry, bn, n, interpret=True)
    got, got_r = kernels.block_merge_kv(got, got_r, bn, n)
    assert_bits_equal(got, want)
    assert_bits_equal(got_r, want_r)


def test_tile_launches_above_the_cap():
    """What the card runs for a tile above the cap: A at the cap with parity
    mask W, then per stage C's substages down to the cap, up to GLOBAL_SPAN of
    them a launch, and B at the cap."""
    assert kernels._tile_launches(64, None, 16) == (
        ("sort", 16, 2, 16, 64),
        ("global", 16, 16, 32, 64), ("merge", 16, 32, 32, 64),
        ("global", 32, 16, 64, 64), ("merge", 16, 64, 64, 64),
    )
    assert kernels._tile_launches(64, 256, 16) == (
        ("global", 32, 16, 256, 0), ("merge", 16, 256, 256, 0),
    )
    # five substages above the cap: one launch of three, one of two
    assert kernels._tile_launches(512, 1024, 16) == (
        ("global", 256, 64, 1024, 0), ("global", 32, 16, 1024, 0), ("merge", 16, 1024, 1024, 0),
    )
    assert kernels._tile_launches(1024, None) == (("sort", 1024, 2, 1024, 1024),)
    assert kernels._tile_launches(1024, 4096) == (("merge", 1024, 4096, 4096, 0),)
    # a whole sort: the tile above the cap, then per stage C down to the tile
    # and B on it, which above the cap is C down to the cap and B at the cap
    assert kernels.sort_launches(256, 64, 16) == (
        ("sort", 16, 2, 16, 64),
        ("global", 16, 16, 32, 64), ("merge", 16, 32, 32, 64),
        ("global", 32, 16, 64, 64), ("merge", 16, 64, 64, 64),
        ("global", 64, 64, 128, 0), ("global", 32, 16, 128, 0), ("merge", 16, 128, 128, 0),
        ("global", 128, 64, 256, 0), ("global", 32, 16, 256, 0), ("merge", 16, 256, 256, 0),
    )
    cap = kernels.MAX_BLOCK_N
    assert kernels.sort_launches(8 * cap, 2 * cap) == (
        kernels._tile_launches(2 * cap, None)
        + (("global", 2 * cap, 2 * cap, 4 * cap, 0),) + kernels._tile_launches(2 * cap, 4 * cap)
        + (("global", 4 * cap, 2 * cap, 8 * cap, 0),) + kernels._tile_launches(2 * cap, 8 * cap)
    )
    assert kernels.sort_launches(1024, 1024) == kernels._tile_launches(1024, None)


def test_plain_versions_leave_launch_counts_alone():
    kernels.reset_launch_counts()
    kernels.block_sort(torch.zeros(64), 16)
    assert set(kernels.launch_counts().values()) == {0}


def test_counters_keep_their_keys_and_read_zero_after_a_reset():
    kernels.tally.update(block_sort_kv=2, substages=3, merge_runs=1, rank_merge_pairs=4, topk_select=5)
    assert kernels.launch_counts()["block_sort_kv"] == 2
    assert kernels.launch_counts()["topk_select"] == 5
    assert kernels.substage_counts()["global_stage"] == 3
    assert kernels.merge_round_counts() == {"merge_runs": 1, "rank_merge_pairs": 4}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        "block_sort": 0, "block_merge": 0, "global_stage": 0,
        "block_sort_kv": 0, "block_merge_kv": 0, "global_stage_kv": 0, "merge_runs": 0,
        "topk_select": 0,
    }
    assert kernels.substage_counts() == {"global_stage": 0, "global_stage_kv": 0}
    assert kernels.merge_round_counts() == {"merge_runs": 0, "rank_merge_pairs": 0}


# ------------------------------------------ kernel C's fused cross-tile pass ---
def _tie_keys(dtype: str, shape, seed: int) -> np.ndarray:
    """Duplicate-heavy keys, with -0.0 beside +0.0 for the float types."""
    x = make_keys(dtype, shape, seed, duplicates=True)
    if dtype != "int32":
        x[np.random.default_rng(seed + 1).random(shape) < 0.3] = np.asarray(-0.0, x.dtype)
    return x


@pytest.mark.parametrize("f", [0, 128])
@pytest.mark.parametrize("span", range(1, kernels.GLOBAL_SPAN + 1))
@pytest.mark.parametrize("has_rank", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_global_stages_equal_successive_substages(dtype, has_rank, span, f):
    """One fused launch of C over ``span`` substages, in plain torch, equals
    ``plain_global_stage`` at each of them in turn, bit for bit; f = 128 is
    the parity mask of a tile above the cap (W >= k)."""
    n, j_lo, k = 256, 4, 64
    j_hi = j_lo << (span - 1)
    x = cpu(_tie_keys(dtype, (2, n), seed=span))
    r = torch.randperm(n, generator=torch.Generator().manual_seed(span), dtype=torch.int32)
    r = r.expand(2, n).contiguous() if has_rank else None
    want, want_r, j = x, r, j_hi
    while j >= j_lo:
        want, want_r = kernels.plain_global_stage(want, want_r, j, k, f)
        j //= 2
    got, got_r = kernels.plain_global_stages(x, r, j_hi, j_lo, k, f)
    assert_bits_equal(got, want)
    if has_rank:
        assert torch.equal(got_r, want_r)
    if f == 0:  # the wrappers run the same on CPU tensors
        wrapped = kernels.global_stages_kv(x, r, j_hi, j_lo, k) if has_rank else (
            kernels.global_stages(x, j_hi, j_lo, k), None)
        assert_bits_equal(wrapped[0], want)
        if has_rank:
            assert torch.equal(wrapped[1], want_r)


@pytest.mark.parametrize("rows,n,launches,substages", [
    (8, 1 << 21, 21, 66),  # model B's tiles of a 10M sort
    (1, 1 << 24, 32, 105),  # the 10M argsort's row
    (1, 1 << 25, 36, 120),  # model D's 2 x 10^7-slot slab
    (128, 1 << 18, 12, 36),  # the decode top-k's rows of 256,000 logits
])
def test_global_spans_group_the_cross_tile_substages(rows, n, launches, substages):
    """Per stage k of a sort at block_n 1024, the spans cover j = k/2 ..
    block_n in order, at most GLOBAL_SPAN substages each, in ceil(d / span)
    launches; the sort's schedule is one A, those C launches and one B a
    stage."""
    block_n, got, covered = 1024, 0, 0
    k = 2 * block_n
    while k <= n:
        spans = kernels.global_spans(k // 2, block_n)
        d = (k // 2).bit_length() - block_n.bit_length() + 1
        assert len(spans) == -(-d // kernels.GLOBAL_SPAN)
        j = k // 2
        for j_hi, j_lo in spans:
            assert j_hi == j and j_lo <= j_hi < j_lo << kernels.GLOBAL_SPAN
            covered += j_hi.bit_length() - j_lo.bit_length() + 1
            j = j_lo // 2
        assert j == block_n // 2
        got += len(spans)
        k *= 2
    assert (got, covered) == (launches, substages)
    steps = kernels.sort_launches(n, block_n)
    kinds = [kind for kind, *_ in steps]
    assert (kinds.count("sort"), kinds.count("global"), kinds.count("merge")) == (
        1, launches, n.bit_length() - block_n.bit_length())
    assert sum(s[1].bit_length() - s[2].bit_length() + 1 for s in steps if s[0] == "global") == substages


@pytest.mark.parametrize("block_n", [16, 1024])
@pytest.mark.parametrize("d", [kernels.GLOBAL_SPAN - 1, kernels.GLOBAL_SPAN, kernels.GLOBAL_SPAN + 1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_sort_and_argsort_across_span_boundaries(dtype, d, block_n):
    """Rows whose last stage has d substages above the tile (one launch of C
    below, at and one past GLOBAL_SPAN) sort as torch.sort(stable=True)
    does, through the plain versions on the CPU."""
    from repro_torch.kernels.bitonic_sort import ops

    n = (block_n << d) - 5  # padded to block_n * 2^d
    x = cpu(_tie_keys(dtype, (2, n), seed=d))
    want = torch.sort(x.float(), dim=-1, stable=True)
    assert torch.equal(ops.kernel_sort(x, block_n=block_n).float(), want.values)
    assert torch.equal(ops.kernel_argsort(x, block_n=block_n).long(), want.indices)


def test_global_stages_reject_spans_the_kernel_cannot_take():
    x, r = torch.zeros(1024), torch.arange(1024, dtype=torch.int32)
    span = kernels.GLOBAL_SPAN
    with pytest.raises(ValueError):
        kernels.global_stages(x, 2 << span, 2, 1024)  # one substage too many
    with pytest.raises(ValueError):
        kernels.global_stages_kv(x, r, 4, 8, 16)  # j_lo above j_hi
    with pytest.raises(ValueError):
        kernels.global_stages(x, 64, 16, 64)  # k < 2 * j_hi
    kernels.reset_launch_counts()
    kernels.global_stages(x, 1 << span, 2, 1024)  # plain: counts stay at 0
    assert set(kernels.substage_counts().values()) == {0}
