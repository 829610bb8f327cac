"""The CUDA kernels on the card: each against its plain version, bit for bit,
and the launch counts that show the kernels ran.

Marked ``gpu``; every test takes the ``cuda`` fixture, which skips when no
card is present.  Run on a machine with a card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.core import merge
from repro_torch.core.shared_sort import shared_memory_sort
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels
from repro_torch.kernels.bitonic_sort import ops

from _torch_topk import CASES as TOPK_CASES, case_id, numpy_topk, topk_keys
from test_torch_merge_path import CASES as MERGE_CASES, merge_keys, rank_merge

pytestmark = pytest.mark.gpu

DTYPES = (torch.float32, torch.int32, torch.float16, torch.bfloat16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    kernels.reset_launch_counts()
    return torch.device("cuda")


def _keys(dtype, shape, seed, duplicates=False):
    g = torch.Generator().manual_seed(seed)
    if duplicates:
        return torch.randint(0, 7, shape, generator=g).to(dtype)
    if dtype == torch.int32:
        return torch.randint(-(2**31), 2**31 - 1, shape, generator=g, dtype=torch.int32)
    return (torch.randn(shape, generator=g) * 100).to(dtype)


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def _assert_same_bits(got, want):
    assert torch.equal(_bits(got.cpu()), _bits(want.cpu()))


@pytest.mark.parametrize("block_n", [1, 2, 64, 1024, kernels.MAX_BLOCK_N])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_block_kernels_match_plain(cuda, dtype, block_n):
    n = 4 * kernels.MAX_BLOCK_N  # room for stage k = 4 * block_n
    x = _keys(dtype, (3, n), seed=block_n)
    r = torch.arange(n, dtype=torch.int32).expand(3, n).contiguous()
    _assert_same_bits(kernels.block_sort(x.to(cuda), block_n), kernels.block_sort(x, block_n))
    got, got_r = kernels.block_sort_kv(x.to(cuda), r.to(cuda), block_n)
    want, want_r = kernels.block_sort_kv(x, r, block_n)
    _assert_same_bits(got, want)
    assert torch.equal(got_r.cpu(), want_r)
    k = 4 * block_n
    _assert_same_bits(kernels.block_merge(x.to(cuda), block_n, k), kernels.block_merge(x, block_n, k))
    got, got_r = kernels.block_merge_kv(x.to(cuda), r.to(cuda), block_n, k)
    want, want_r = kernels.block_merge_kv(x, r, block_n, k)
    _assert_same_bits(got, want)
    assert torch.equal(got_r.cpu(), want_r)
    assert kernels.launch_counts() == {
        "block_sort": 1, "block_merge": 1, "global_stage": 0,
        "block_sort_kv": 1, "block_merge_kv": 1, "global_stage_kv": 0, "merge_runs": 0,
        "topk_select": 0,
    }


@pytest.mark.parametrize("j,j_lo,k", [
    (1, 1, 2), (64, 64, 256), (4096, 4096, 65536), (32768, 32768, 65536),  # one substage
    (2, 1, 4), (64, 16, 256), (32768, 4096, 65536), (4096, 512, 65536),  # spans of 2, 3, 4
])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_global_stage_kernels_match_plain(cuda, dtype, j, j_lo, k):
    # one substage through global_stage(_kv), a span through global_stages(_kv):
    # one launch each, counted with its substages on the one-substage wrapper
    n = 65536
    x = _keys(dtype, (2, n), seed=j, duplicates=True)
    r = torch.arange(n, dtype=torch.int32).expand(2, n).contiguous()
    if j == j_lo:
        _assert_same_bits(kernels.global_stage(x.to(cuda), j, k), kernels.global_stage(x, j, k))
        got, got_r = kernels.global_stage_kv(x.to(cuda), r.to(cuda), j, k)
        want, want_r = kernels.global_stage_kv(x, r, j, k)
    else:
        _assert_same_bits(kernels.global_stages(x.to(cuda), j, j_lo, k),
                          kernels.plain_global_stages(x, None, j, j_lo, k)[0])
        got, got_r = kernels.global_stages_kv(x.to(cuda), r.to(cuda), j, j_lo, k)
        want, want_r = kernels.plain_global_stages(x, r, j, j_lo, k)
    _assert_same_bits(got, want)
    assert torch.equal(got_r.cpu(), want_r)
    assert kernels.launch_counts()["global_stage"] == 1
    assert kernels.launch_counts()["global_stage_kv"] == 1
    span = j.bit_length() - j_lo.bit_length() + 1
    assert kernels.substage_counts() == {"global_stage": span, "global_stage_kv": span}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_global_stages_kernel_takes_parity_masks_and_refuses_long_spans(cuda, dtype):
    # f = W: a W-wide tile above the cap; a span of GLOBAL_SPAN + 1 is refused
    # by the wrapper, and by the kernel's entry point if the wrapper is passed by
    n, w = 65536, 32768
    x = _tie_keys(dtype, (2, n), seed=11)
    r = torch.randperm(n, generator=torch.Generator().manual_seed(11), dtype=torch.int32)
    r = r.expand(2, n).contiguous()
    for k in (w // 2, w):
        got, got_r = kernels._run(x.to(cuda), r.to(cuda), (("global", k // 2, k // 16, k, w),))
        want, want_r = kernels.plain_global_stages(x, r, k // 2, k // 16, k, w)
        _assert_same_bits(got, want)
        assert torch.equal(got_r.cpu(), want_r)
    span = kernels.GLOBAL_SPAN
    with pytest.raises(ValueError):
        kernels.global_stages(x.to(cuda), 2 << span, 2, n)
    with pytest.raises(RuntimeError, match="invalid argument"):
        kernels._run(x.to(cuda), None, (("global", 2 << span, 2, n, 0),))


def test_sort_and_argsort_fuse_the_cross_tile_substages(cuda):
    # the benchmark's shapes: model B's 8 tiles of a 10M sort, the 10M argsort's row
    x = _keys(torch.float32, (8, 1 << 21), seed=12)
    assert torch.equal(ops.kernel_sort(x.to(cuda)).cpu(), torch.sort(x, dim=-1).values)
    assert kernels.launch_counts() == {
        "block_sort": 1, "block_merge": 11, "global_stage": 21,
        "block_sort_kv": 0, "block_merge_kv": 0, "global_stage_kv": 0, "merge_runs": 0,
        "topk_select": 0,
    }
    assert kernels.substage_counts() == {"global_stage": 66, "global_stage_kv": 0}
    kernels.reset_launch_counts()
    keys = torch.randint(0, 1000, (1 << 24,), generator=torch.Generator().manual_seed(13),
                         dtype=torch.int32)
    idx = ops.kernel_argsort(keys.to(cuda))
    assert torch.equal(idx.cpu().long(), torch.sort(keys, stable=True).indices)
    assert kernels.launch_counts() == {
        "block_sort": 0, "block_merge": 0, "global_stage": 0,
        "block_sort_kv": 1, "block_merge_kv": 14, "global_stage_kv": 32, "merge_runs": 0,
        "topk_select": 0,
    }
    assert kernels.substage_counts() == {"global_stage": 0, "global_stage_kv": 105}


def _tie_keys(dtype, shape, seed):
    """Duplicate-heavy keys, with -0.0 beside +0.0 for the float types."""
    x = _keys(dtype, shape, seed, duplicates=True)
    if dtype != torch.int32:
        g = torch.Generator().manual_seed(seed + 1)
        x = torch.where(torch.rand(shape, generator=g) < 0.3, torch.tensor(-0.0, dtype=dtype), x)
    return x


@pytest.mark.parametrize("block_n", [1 << i for i in range(kernels.MAX_BLOCK_N.bit_length())])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_merge_kernels_match_plain_at_every_tile_width(cuda, dtype, block_n):
    # (3, 2 * block_n) leaves a ragged last chunk for the narrow tiles
    launches = 0
    for rows, n in ((3, 4 * kernels.MAX_BLOCK_N), (3, 2 * block_n)):
        x = _tie_keys(dtype, (rows, n), seed=block_n)
        r = torch.randperm(n, generator=torch.Generator().manual_seed(block_n), dtype=torch.int32)
        r = r.expand(rows, n).contiguous()
        for k in sorted(k for k in {2 * block_n, 4 * block_n, n} if k <= n):
            got = kernels.block_merge(x.to(cuda), block_n, k)
            _assert_same_bits(got, kernels.block_merge(x, block_n, k))
            got, got_r = kernels.block_merge_kv(x.to(cuda), r.to(cuda), block_n, k)
            want, want_r = kernels.block_merge_kv(x, r, block_n, k)
            _assert_same_bits(got, want)
            assert torch.equal(got_r.cpu(), want_r), f"rows={rows} n={n} k={k}"
            launches += 1
    assert kernels.launch_counts()["block_merge"] == kernels.launch_counts()["block_merge_kv"] == launches


@pytest.mark.parametrize("block_n", [1 << i for i in range(kernels.MAX_BLOCK_N.bit_length())])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_sort_kernels_match_plain_at_every_tile_width(cuda, dtype, block_n):
    # rows of several tiles (odd tiles descend) and rows of one tile (all up);
    # (3, block_n) leaves a ragged last chunk for the narrow tiles
    launches = 0
    for rows, n in ((3, 4 * kernels.MAX_BLOCK_N), (3, block_n)):
        x = _tie_keys(dtype, (rows, n), seed=block_n + 1)
        r = torch.randperm(n, generator=torch.Generator().manual_seed(block_n), dtype=torch.int32)
        r = r.expand(rows, n).contiguous()
        _assert_same_bits(kernels.block_sort(x.to(cuda), block_n), kernels.block_sort(x, block_n))
        got, got_r = kernels.block_sort_kv(x.to(cuda), r.to(cuda), block_n)
        want, want_r = kernels.block_sort_kv(x, r, block_n)
        _assert_same_bits(got, want)
        assert torch.equal(got_r.cpu(), want_r), f"rows={rows} n={n}"
        launches += 1
    assert kernels.launch_counts()["block_sort"] == kernels.launch_counts()["block_sort_kv"] == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16], ids=str)
def test_signed_zeros_through_a_descending_sort_tile(cuda, dtype):
    x = torch.tensor([0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 0.0, 2.0] * 128, dtype=dtype)
    r = torch.arange(x.numel(), dtype=torch.int32)
    for block_n in (8, 64, 512):  # odd tiles descend; 512: every layout of the kernel
        _assert_same_bits(kernels.block_sort(x.to(cuda), block_n), kernels.block_sort(x, block_n))
        got, got_r = kernels.block_sort_kv(x.to(cuda), r.to(cuda), block_n)
        want, want_r = kernels.block_sort_kv(x, r, block_n)
        _assert_same_bits(got, want)
        assert torch.equal(got_r.cpu(), want_r)


def test_misaligned_sort_input_raises(cuda):
    n = 4096
    shifted = torch.zeros(n + 1, device=cuda)[1:]  # contiguous, 4 bytes past 16
    ranks = torch.arange(n, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.block_sort(shifted, 1024)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.block_sort_kv(shifted, ranks, 1024)
    assert np.all(np.array(list(kernels.launch_counts().values())) == 0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_sort_paths_take_views_that_start_off_16_bytes(cuda, dtype):
    # A [1:] view of length 2^k needs no padding, so the rows it reaches the
    # ops with are the caller's storage; kernel A refuses it, so the ops copy it.
    n = 4096
    plain = _keys(dtype, (n + 1,), seed=9, duplicates=True)[1:]
    view = _keys(dtype, (n + 1,), seed=9, duplicates=True).to(cuda)[1:]
    assert view.data_ptr() % 16
    _assert_same_bits(ops.kernel_sort(view, block_n=1024), ops.kernel_sort(plain, block_n=1024))
    want = ops.kernel_argsort(plain, block_n=1024)
    assert torch.equal(ops.kernel_argsort(view, block_n=1024).cpu(), want)
    assert torch.equal(engine.argsort(view, impl="kernel", block_n=1024).cpu(), want)
    counts = kernels.launch_counts()
    assert counts["block_sort"] == 1 and counts["block_sort_kv"] == 2


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int16, torch.uint16, torch.uint32], ids=str)
def test_narrow_integer_keys_on_the_card(cuda, dtype):
    info = torch.iinfo(dtype)
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 1 << 16, (4, 3000), generator=g).to(torch.int64)
    x = (x * (info.max - info.min) // (1 << 16) + info.min)
    x[:, ::5], x[:, 7] = info.max, info.min
    x = torch.tensor(x.tolist(), dtype=dtype)
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32}[x.element_size()]  # compares on the CPU
    got = ops.kernel_sort(x.to(cuda), block_n=256)
    assert got.dtype == dtype
    assert torch.equal(got.cpu().view(signed), ops.kernel_sort(x, block_n=256).view(signed))
    assert torch.equal(ops.kernel_argsort(x.to(cuda), block_n=256).cpu(), ops.kernel_argsort(x, block_n=256))


_WIDE_NARROW_WIDE = """
import torch
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels
for dtype in (torch.float32, torch.bfloat16):
    n = 4 * kernels.MAX_BLOCK_N
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(2, n, generator=g) * 100).to(dtype)
    r = torch.randperm(n, generator=g, dtype=torch.int32).expand(2, n).contiguous()
    view = torch.int32 if dtype == torch.float32 else torch.int16
    for block_n in (8192, 4096, 8192):
        got, got_r = kernels.block_merge_kv(x.cuda(), r.cuda(), block_n, 2 * block_n)
        want, want_r = kernels.block_merge_kv(x, r, block_n, 2 * block_n)
        assert torch.equal(got.cpu().view(view), want.view(view)), (dtype, block_n)
        assert torch.equal(got_r.cpu(), want_r), (dtype, block_n)
"""


def test_merge_kernel_takes_tile_widths_in_any_order(cuda):
    # A kernel's shared-memory limit is state of the process: run a wide tile,
    # a narrower one of the same instantiation, then the wide one again, in a
    # fresh process that no earlier test has touched.
    src = str(Path(kernels.__file__).resolve().parents[3])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")]))}
    proc = subprocess.run([sys.executable, "-c", _WIDE_NARROW_WIDE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16], ids=str)
def test_signed_zeros_through_a_descending_merge_tile(cuda, dtype):
    x = torch.tensor([0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 0.0, 2.0] * 4, dtype=dtype)
    for block_n, k in ((8, 16), (16, 32)):  # the tiles at 16 .. 31 descend
        _assert_same_bits(kernels.block_merge(x.to(cuda), block_n, k), kernels.block_merge(x, block_n, k))


def test_misaligned_merge_input_raises(cuda):
    n = 4096
    aligned = torch.zeros(n, device=cuda)
    shifted = torch.zeros(n + 1, device=cuda)[1:]  # contiguous, 4 bytes past 16
    ranks = torch.arange(n, dtype=torch.int32, device=cuda)
    shifted_ranks = torch.arange(n + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        kernels.block_merge(shifted, 1024, n)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.block_merge_kv(shifted, ranks, 1024, n)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.block_merge_kv(aligned, shifted_ranks, 1024, n)
    assert np.all(np.array(list(kernels.launch_counts().values())) == 0)


def test_signed_zeros_stay_in_network_order(cuda):
    x = torch.tensor([0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 0.0, 2.0])
    _assert_same_bits(ops.kernel_sort(x.to(cuda), block_n=4), ops.kernel_sort(x, block_n=4))


@pytest.mark.parametrize("n", [1, 3, 1000, 100_000])
def test_sort_and_argsort_launch_the_kernels(cuda, n):
    x = _keys(torch.float32, (4, n), seed=n)
    got = ops.kernel_sort(x.to(cuda), block_n=256)
    assert torch.equal(got.cpu(), torch.sort(x, dim=-1).values)
    idx = engine.argsort(x.to(cuda), impl="kernel", block_n=256)
    assert torch.equal(idx.cpu().long(), torch.sort(x, dim=-1, stable=True).indices)
    counts = kernels.launch_counts()
    assert counts["block_sort"] == 1 and counts["block_sort_kv"] == 1
    stages = max(0, (max(n, 1) - 1).bit_length() - 8)  # stages above the 256 tile
    assert counts["block_merge"] == counts["block_merge_kv"] == stages


def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on a CUDA tensor")

    # the public plain versions, and the ones the launch path runs on a CPU tensor
    for name in ("plain_block_sort", "plain_block_merge", "plain_global_stage",
                 "_plain_tile", "plain_global_stages", "plain_merge_runs", "plain_topk_select"):
        monkeypatch.setattr(kernels, name, refuse)
    x = _keys(torch.int32, (50_000,), seed=1).to(cuda)
    vals, idx = engine.topk(x, 10, impl="kernel", block_n=1024)
    want_v, _ = torch.topk(x.cpu(), 10)
    assert torch.equal(vals.cpu(), want_v)
    assert torch.equal(engine.argsort(x, impl="kernel").cpu().long(), torch.argsort(x.cpu(), stable=True))
    assert torch.equal(ops.kernel_sort(x).cpu(), torch.sort(x.cpu()).values)
    # a merge round that kernel M takes
    tile = kernels.MERGE_TILE
    y = merge_keys("ties", torch.float32, (2, 4 * tile), tile, seed=9)
    _assert_same_bits(merge.merge_adjacent(y.to(cuda), tile), rank_merge(y, tile))
    counts = kernels.launch_counts()
    assert all(counts[name] for name in ("block_sort", "block_merge", "global_stage",
                                         "block_sort_kv", "block_merge_kv", "global_stage_kv",
                                         "topk_select"))
    assert counts["merge_runs"] == 1


def test_block_n_above_the_cap_is_composed(cuda):
    # A tile above the cap is composed from launches at the cap (A, then per
    # stage C and B, all with parity mask 2 * cap), each launch counted on its
    # own kernel.
    bn, n = 2 * kernels.MAX_BLOCK_N, 4 * kernels.MAX_BLOCK_N
    x = _tie_keys(torch.float32, (2, n), seed=5)
    r = torch.randperm(n, generator=torch.Generator().manual_seed(5), dtype=torch.int32)
    r = r.expand(2, n).contiguous()
    _assert_same_bits(kernels.block_sort(x.to(cuda), bn), kernels.block_sort(x, bn))
    got, got_r = kernels.block_sort_kv(x.to(cuda), r.to(cuda), bn)
    want, want_r = kernels.block_sort_kv(x, r, bn)
    _assert_same_bits(got, want)
    assert torch.equal(got_r.cpu(), want_r)
    _assert_same_bits(kernels.block_merge(x.to(cuda), bn, n), kernels.block_merge(x, bn, n))
    got, got_r = kernels.block_merge_kv(x.to(cuda), r.to(cuda), bn, n)
    want, want_r = kernels.block_merge_kv(x, r, bn, n)
    _assert_same_bits(got, want)
    assert torch.equal(got_r.cpu(), want_r)
    # A: one A launch, then stage 2*cap: one C and one B; B: one C, one B
    assert kernels.launch_counts() == {
        "block_sort": 1, "block_merge": 2, "global_stage": 2,
        "block_sort_kv": 1, "block_merge_kv": 2, "global_stage_kv": 2, "merge_runs": 0,
        "topk_select": 0,
    }
    y = _keys(torch.float32, (3, 100_000), seed=6)
    assert torch.equal(ops.kernel_sort(y.to(cuda), block_n=bn).cpu(), torch.sort(y, dim=-1).values)
    idx = ops.kernel_argsort(y.to(cuda), block_n=bn)
    assert torch.equal(idx.cpu().long(), torch.sort(y, dim=-1, stable=True).indices)


def _model_b_runs(dtype, width, seed, cuda):
    """2^24 keys, as model B's tree merges them, with ties, -0.0 beside +0.0
    and NaN payloads mixed in, each ``width`` run sorted on the card on its
    sort image."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = 1 << 24
    if dtype == torch.int32:
        x = torch.randint(-1000, 1000, (n,), generator=g, device=cuda, dtype=torch.int32)
    else:
        x = (torch.randn(n, generator=g, device=cuda) * 100).round().to(dtype)
        x[torch.rand(n, generator=g, device=cuda) < 0.1] = -0.0
        nan = torch.rand(n, generator=g, device=cuda) < 0.01
        x[nan] = float("nan")
        _bits(x)[nan & (torch.rand(n, generator=g, device=cuda) < 0.5)] ^= 1  # another payload
        x[torch.rand(n, generator=g, device=cuda) < 0.01] = -float("nan")
    rows = x.view(-1, width)
    order = torch.sort(merge.sort_image(rows), dim=-1, stable=True).indices
    return merge.gather_bits(rows, order).view(n)


@pytest.mark.parametrize("width", [1 << 21, 1 << 22, 1 << 23])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_merge_runs_matches_the_rank_merge_at_model_b_shapes(cuda, dtype, width):
    x = _model_b_runs(dtype, width, seed=width.bit_length(), cuda=cuda)
    got = kernels.merge_runs(x, width)
    torch.cuda.synchronize()
    _assert_same_bits(got, rank_merge(x.cpu(), width))
    assert kernels.launch_counts()["merge_runs"] == 1


@pytest.mark.parametrize("kind,dtype,shape,width", MERGE_CASES)
def test_merge_runs_matches_the_rank_merge_on_special_keys(cuda, kind, dtype, shape, width):
    x = merge_keys(kind, dtype, shape, width, seed=len(shape) * 1000 + width % 997)
    _assert_same_bits(kernels.merge_runs(x.to(cuda), width), rank_merge(x, width))


def test_merge_runs_on_unsorted_runs_stays_in_bounds(cuda):
    # NaN keys leave the networks' runs unsorted on the image: the output is
    # unspecified, but M reads and writes only inside its runs, as its plain
    # version does, bit for bit
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(1 << 22, generator=g, device=cuda)
    x[::7] = float("nan")
    for width in (kernels.MERGE_TILE // 2, 1 << 21):
        got = kernels.merge_runs(x, width)
        torch.cuda.synchronize()
        _assert_same_bits(got, kernels.plain_merge_runs(x, width))


def test_model_b_sort_merges_every_round_in_kernel_m(cuda):
    # the benchmark's sort: 10^7 keys, 8 tiles of 2^21, three rounds
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(10_000_000, generator=g, device=cuda)
    got = shared_memory_sort(x, n_threads=8, local_impl="kernel")
    assert torch.equal(got, torch.sort(x).values)
    assert kernels.launch_counts()["merge_runs"] == 3
    assert kernels.merge_round_counts() == {"merge_runs": 3, "rank_merge_pairs": 0}


def test_merge_adjacent_routes_by_what_the_round_shows(cuda):
    tile = kernels.MERGE_TILE
    x = merge_keys("ties", torch.float32, (2, 4 * tile), tile, seed=6)
    want = rank_merge(x, tile)
    _assert_same_bits(merge.merge_adjacent(x.to(cuda), tile), want)
    assert kernels.merge_round_counts() == {"merge_runs": 1, "rank_merge_pairs": 0}
    # a view that starts off 16 bytes is copied, then merged by M
    shifted = torch.cat([torch.zeros(1), x.view(-1)]).to(cuda)[1:].view(x.shape)
    assert shifted.data_ptr() % 16
    _assert_same_bits(merge.merge_adjacent(shifted, tile), want)
    assert kernels.merge_round_counts() == {"merge_runs": 2, "rank_merge_pairs": 0}
    # narrower than a tile, with values, or of another dtype: the rank merge
    narrow = merge_keys("ties", torch.float32, (2, 4 * tile), tile // 4, seed=7)
    _assert_same_bits(merge.merge_adjacent(narrow.to(cuda), tile // 4), rank_merge(narrow, tile // 4))
    v = torch.arange(x.numel(), dtype=torch.int32).view(x.shape)
    got, got_v = merge.merge_adjacent(x.to(cuda), tile, {"i": v.to(cuda)})
    _assert_same_bits(got, want)
    wide = merge_keys("ties", torch.int32, (2, 4 * tile), tile, seed=8).to(torch.int64)
    got = merge.merge_adjacent(wide.to(cuda), tile)
    assert torch.equal(got.cpu(), merge.merge_adjacent(wide, tile))
    assert kernels.merge_round_counts() == {"merge_runs": 2, "rank_merge_pairs": 3}
    assert kernels.launch_counts()["merge_runs"] == 2


def test_merge_runs_refuses_what_it_does_not_take(cuda):
    tile = kernels.MERGE_TILE
    x = torch.zeros(4 * tile, device=cuda)
    with pytest.raises(TypeError):
        kernels.merge_runs(x.to(torch.int64), tile)
    with pytest.raises(TypeError):
        kernels.merge_runs(x.double(), tile)
    with pytest.raises(ValueError, match="MERGE_TILE"):
        kernels.merge_runs(x, tile // 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.merge_runs(torch.zeros(2 * tile, 2, device=cuda).t(), tile)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.merge_runs(torch.zeros(4 * tile + 1, device=cuda)[1:], tile)
    # the entry point refuses a geometry it was not built for
    out = torch.empty_like(x)
    err = kernels._lib().bitonic_merge_runs(0, x.data_ptr(), out.data_ptr(), x.numel(), tile,
                                            kernels.MERGE_THREADS, 3, kernels.MERGE_PASSES,
                                            torch.cuda.current_stream().cuda_stream)
    assert err and kernels._lib().bitonic_error_string(err) == b"invalid argument"
    assert kernels.launch_counts()["merge_runs"] == 0


# ------------------------------------------------------------------ kernel T ---
def _launched(counts):
    return {name: v for name, v in counts.items() if v}


@pytest.mark.parametrize("largest", [True, False])
def test_topk_select_at_the_decode_cell_shape(cuda, largest):
    # 128 rows of a 256,000-token vocabulary, k = 50, logits rounded to bf16:
    # ties straddle the 50th place, so the indices decide
    x = topk_keys("bf16_ties", torch.float32, (128, 256_000), seed=50).to(cuda)
    vals, idx = engine.topk(x, 50, largest=largest, impl="kernel")
    assert _launched(kernels.launch_counts()) == {"topk_select": 2}
    assert torch.equal(idx, kernels.plain_topk_select(x, 50, largest))
    want_vals, want_idx = engine.topk(x, 50, largest=largest, impl="xla")
    assert torch.equal(idx, want_idx)
    _assert_same_bits(vals, want_vals)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("case", TOPK_CASES, ids=case_id)
def test_topk_select_matches_plain_on_edge_cases(cuda, case, largest):
    kind, dtype, shape, k = case
    x = topk_keys(kind, dtype, shape, seed=k + 1)
    vals, idx = engine.topk(x.to(cuda), k, largest=largest, impl="kernel")
    assert kernels.launch_counts()["topk_select"] >= 1
    np.testing.assert_array_equal(idx.cpu().numpy(), numpy_topk(x, k, largest))
    assert torch.equal(idx.cpu(), ops.kernel_topk(x, k, largest=largest))
    # torch.sort takes no uint32 on CUDA: impl="xla" runs those keys on the CPU
    want_vals, want_idx = engine.topk(x if dtype == torch.uint32 else x.to(cuda), k,
                                      largest=largest, impl="xla")
    assert torch.equal(idx.cpu(), want_idx.cpu())
    assert torch.equal(vals.cpu().view(torch.uint8), want_vals.cpu().view(torch.uint8))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_topk_select_takes_keys_at_any_alignment(cuda, dtype):
    # a row that starts off 16 bytes (a view), and rows whose width puts each
    # start elsewhere, across several segments
    x = topk_keys("specials", torch.float32, (100_003,), seed=3).to(dtype)
    for offset in (1, 2, 3):
        row = x.to(cuda)[offset:]
        got = kernels.topk_select(row, 64)
        assert torch.equal(got.cpu(), kernels.plain_topk_select(x[offset:], 64))
    rows = x[: 3 * 33_331].reshape(3, 33_331)
    assert torch.equal(kernels.topk_select(rows.to(cuda), 50, False).cpu(),
                       kernels.plain_topk_select(rows, 50, False))


def test_topk_above_select_max_k_launches_the_network(cuda):
    x = topk_keys("bf16_ties", torch.float32, (4, 3000), seed=4).to(cuda)
    k = kernels.SELECT_MAX_K + 1
    vals, idx = engine.topk(x, k, impl="kernel")
    counts = _launched(kernels.launch_counts())
    assert "topk_select" not in counts and counts["block_sort_kv"] == 1
    assert torch.equal(idx, engine.topk(x, k, impl="xla")[1])


def test_topk_select_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 100, device=cuda)
    with pytest.raises(ValueError, match="1 <= k"):
        kernels.topk_select(x, kernels.SELECT_MAX_K + 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.topk_select(x[:, ::2], 5)
    assert kernels.launch_counts()["topk_select"] == 0
