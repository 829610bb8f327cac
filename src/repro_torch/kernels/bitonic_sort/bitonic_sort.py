"""Hand-written CUDA bitonic network kernels for Hopper, and their plain versions.

Counterpart of ``repro/kernels/bitonic_sort/bitonic_sort.py`` (Pallas, TPU).
The kernels are in ``csrc/bitonic_sort.cu``; this module builds that file with
``nvcc`` for ``sm_90a`` into ``build/`` at the repository root on first use,
loads it with ``ctypes``, and wraps each kernel:

  A     block_sort     / block_sort_kv     per-tile full network, tile b of a
                                           row ascending iff b is even
  B     block_merge    / block_merge_kv    substages j = block_n/2 .. 1 of one
                                           stage k > block_n, fused per tile
  C     global_stage   / global_stage_kv   one cross-tile substage j >= block_n
        global_stages  / global_stages_kv  the cross-tile substages j_hi .. j_lo
                                           of one stage in one pass (at most
                                           GLOBAL_SPAN of them)
  M     merge_runs                         one round of model B's merge tree:
                                           adjacent sorted runs merged stably
                                           on ``keys.sort_image``
  T     topk_select                        the top-k of each row by selection:
                                           its k least items (``select_items``)

A and B are one CUDA kernel body (``tile_network``) that holds a tile in
registers and runs stages k_first .. k_last of it (``_tile_geometry``).  C
holds groups of up to 2**GLOBAL_SPAN keys a thread in registers: a stage's
substages at distances >= block_n take ``global_spans`` launches, a pass over
memory each, instead of one a substage.  M is a merge path over output tiles
of ``MERGE_THREADS * MERGE_ELEMS`` keys, ``MERGE_PASSES`` of them
(``MERGE_TILE`` keys) a block; ``merge_runs_takes`` is the rule for the
rounds it takes, by which ``core.merge.merge_adjacent`` routes them to it.
T reads each row once in segments of ``select_geometry`` (a block a segment,
each warp keeping the least items it has seen) and merges a row's segment
lists in a second launch; ``ops.topk_takes`` is the rule by which
``engine.topk`` routes a call to it.

Every launch is a step of a schedule: ``_tile_launches`` for kernel A or B at
one tile width, ``sort_launches`` for the whole network of a sort.  The
wrappers and ``sort_rows`` check their input once (``_check``, and
``_check_stage`` for a stage's parameters) and hand it with their steps to
``_run``, which runs the steps where the tensor lives: on a CUDA
tensor it launches each step through ``_launch`` and counts it in ``tally``
(``launch_counts``, ``substage_counts``, ``merge_round_counts``); on a CPU
tensor it runs the plain torch version, which repeats the kernel's
arithmetic step by step.  T, whose two launches are of other shapes than
the networks' steps, launches through ``_launch`` from its own wrapper and
counts there.

Every network wrapper takes a contiguous tensor whose last axis (length n, a
power of two) is sorted row by row; the leading dims are rows of the kernel grid.  The
``*_kv`` twins carry int32 ranks with the (key, rank) comparator, so the rank
output is the stable permutation.  Keys may be float32, int32, float16 or
bfloat16.  One launch of A or B holds tiles of at most ``MAX_BLOCK_N`` keys
(one CUDA block's shared memory); a wider power-of-two ``block_n`` is
composed from launches at the cap (``_tile_launches``), as the TPU's VMEM
took it whole.  NaN keys give unspecified output from the networks, as in
the reference.  A, B and M copy their inputs by 16-byte words, so on the
card these must start on a 16-byte boundary (``ValueError`` otherwise);
``ops.py`` and ``merge_adjacent`` copy a caller's view that does not.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.keys import int_bits, sort_image

__all__ = [
    "MAX_BLOCK_N",
    "KERNELS",
    "block_sort",
    "block_merge",
    "global_stage",
    "block_sort_kv",
    "block_merge_kv",
    "global_stage_kv",
    "global_stages",
    "global_stages_kv",
    "GLOBAL_SPAN",
    "global_spans",
    "build",
    "plain_block_sort",
    "plain_block_merge",
    "plain_global_stage",
    "plain_global_stages",
    "launch_counts",
    "substage_counts",
    "reset_launch_counts",
    "KEY_DTYPES",
    "MERGE_TILE",
    "merge_runs",
    "plain_merge_runs",
    "merge_round_counts",
    "merge_runs_takes",
    "SELECT_MAX_K",
    "select_geometry",
    "select_items",
    "topk_select",
    "plain_topk_select",
    "sort_launches",
    "sort_rows",
    "tally",
    "next_pow2",
]

# f32 keys + int32 ranks at 16384 is 128 KiB of the 227 KiB a block may use
MAX_BLOCK_N = 16384
# most cross-tile substages one launch of kernel C runs (csrc: kGlobalSpan)
GLOBAL_SPAN = 4
_SMEM_PER_BLOCK = 232_448  # dynamic shared memory one sm_90 block may use
_TILE_MIN_THREADS = 128  # narrower tiles are packed several to a block
_TILE_BARRIER_BYTES = 8  # the tile kernel's mbarrier, after its slot

_DTYPE_CODE = {torch.float32: 0, torch.int32: 1, torch.float16: 2, torch.bfloat16: 3}
KEY_DTYPES = tuple(_DTYPE_CODE)
# kernel M's block (csrc: kMerge*): MERGE_PASSES tiles of MERGE_THREADS threads
# that merge MERGE_ELEMS output keys each
MERGE_THREADS, MERGE_ELEMS, MERGE_PASSES = 256, 16, 2
MERGE_TILE = MERGE_THREADS * MERGE_ELEMS * MERGE_PASSES  # output keys a block of M writes
_SPLIT_PROBES = 32  # M's tile-edge search: one probe a lane of a warp
# kernel T (csrc: kSelect*): a warp's list holds the least 64, 128 or 256
# items it has seen, the least of these lengths >= k
_SELECT_LISTS = (64, 128, 256)
SELECT_MAX_K = _SELECT_LISTS[-1]
_SELECT_MIN_SEGMENT = 8192  # keys a block scans at the least: 1,024 a warp
# first-launch blocks a call aims at, about two a SM of an H100's 132: every
# warp's list takes some k (1 + ln(keys / k)) items, so few long segments
# do the least work while the loads still fill the card
_SELECT_BLOCKS = 256
_SELECT_MAX_SEGMENTS = 64  # the second launch merges at most 64 lists a row

_SOURCE = Path(__file__).resolve().parent / "csrc" / "bitonic_sort.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build() -> tuple[Path, str]:
    """Compile ``csrc/bitonic_sort.cu`` into ``build/`` (once per source
    version) and return ``(library path, compiler log)``; raises if nvcc fails.
    The library is named by a hash of the source and flags, so an edited
    source never loads a stale build."""
    tag = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = _BUILD_DIR / f"bitonic_sort-{tag[:16]}.so"
    if out.exists():
        return out, ""
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out, proc.stdout + proc.stderr


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.bitonic_tile_network.argtypes = [
        i32, ptr, ptr, ptr, ptr, i64, i64, i32, i64, i64, i64, i32, i32, i32, i32, ptr,
    ]
    lib.bitonic_global_stage.argtypes = [i32, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, ptr]
    lib.bitonic_merge_runs.argtypes = [i32, ptr, ptr, i64, i64, i32, i32, i32, ptr]
    lib.bitonic_topk_select.argtypes = [i32, ptr, ptr, ptr, i64, i64, i32, i32, i32, i32, ptr]
    for fn in (lib.bitonic_tile_network, lib.bitonic_global_stage, lib.bitonic_merge_runs,
               lib.bitonic_topk_select):
        fn.restype = i32
    lib.bitonic_error_string.argtypes = [i32]
    lib.bitonic_error_string.restype = ctypes.c_char_p
    return lib


def _is_pow2(v: int) -> bool:
    return v >= 1 and v & (v - 1) == 0


def next_pow2(n: int) -> int:
    """The length a row of ``n >= 1`` keys is padded to: the least power of two >= n."""
    return 1 << max(0, (n - 1).bit_length())


def _on_cuda(x: torch.Tensor) -> bool:
    """True to launch the kernel, False to run the plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"bitonic kernels run on CUDA or CPU tensors, not {x.device}")


class TileGeometry(NamedTuple):
    """Launch geometry of kernels A and B for one tile width (see ``_tile_geometry``)."""

    threads_per_tile: int  # T
    elems_per_thread: int  # E, with T * E == block_n
    tiles_per_block: int
    smem_bytes: int


@functools.cache
def _tile_geometry(block_n: int, itemsize: int, has_rank: bool, sort: bool) -> TileGeometry:
    """The tile kernel's geometry for ``block_n`` keys of ``itemsize`` bytes,
    for kernel A (``sort``) or B.

    T threads hold E keys each in registers.  Every substage j < T in the
    contiguous layout is a warp shuffle at lane distance j / E, so T <= 32 * E.
    B, bound by bytes, takes the smallest E in (8, 16, 32) with
    block_n <= 32 * E**2, which keeps the most blocks in flight; A, bound by
    its compare-exchanges, takes E = 32, which turns shuffles into register
    compare-exchanges (E = block_n below 8, resp. 32).  Tiles of fewer than 128
    threads are packed into blocks of 128.  The block's shared memory holds
    one chunk of tiles: the next chunk's bulk copy starts once the tile's last
    shared-memory read is done."""
    if sort:
        e = min(block_n, 32)
    else:
        e = min(block_n, next(e for e in (8, 16, 32) if block_n <= 32 * e * e))
    t = block_n // e
    tiles_per_block = max(1, _TILE_MIN_THREADS // t)
    slot = tiles_per_block * block_n * (itemsize + (4 if has_rank else 0))
    return TileGeometry(t, e, tiles_per_block, slot + _TILE_BARRIER_BYTES)


def _check_aligned(*tensors) -> None:
    """Kernels A, B and M copy their inputs by 16-byte words: each must start
    on 16 bytes (None, for absent ranks, is skipped)."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(
                "block_sort, block_merge and merge_runs need inputs that start on a 16-byte "
                f"boundary (data_ptr % 16 = {t.data_ptr() % 16}); pass a fresh contiguous tensor"
            )


def _launch(fn: str, *args) -> None:
    """Call the library's entry point ``fn``; raise on the error it returns."""
    err = getattr(_lib(), fn)(*args)
    if err:
        raise RuntimeError(f"{fn} failed: {_lib().bitonic_error_string(err).decode()}")


# ------------------------------------------------------------- plain versions ---
def _ce_plain(x, r, j: int, dir_up):
    """One compare-exchange substage at distance j over rows of x.

    ``dir_up`` is a bool tensor over the n/(2j) groups of a row (leading
    dims broadcast); the comparator and swap rule are the kernel's."""
    shape = x.shape
    lead = shape[:-1]
    xa, xb = x.reshape(*lead, -1, 2, j).unbind(-2)
    gt = xa > xb
    if r is not None:
        ra, rb = r.reshape(*lead, -1, 2, j).unbind(-2)
        gt = gt | ((xa == xb) & (ra > rb))
    swap = gt == dir_up[..., None]
    x = torch.stack([torch.where(swap, xb, xa), torch.where(swap, xa, xb)], dim=-2)
    if r is not None:
        r = torch.stack([torch.where(swap, rb, ra), torch.where(swap, ra, rb)], dim=-2)
        r = r.reshape(shape)
    return x.reshape(shape), r


def _group_starts(n: int, j: int, device) -> torch.Tensor:
    """Row index of the first element of each of the n/(2j) groups."""
    return torch.arange(n // (2 * j), device=device, dtype=torch.int64) * (2 * j)


def _directions(i, k: int, f: int):
    """Up or down for the pairs whose lower element has row index ``i``, at
    stage k with parity mask f: ((i & k & (f-1)) == 0) == ((i & f) == 0).
    f = block_n is kernel A's rule, f = 0 that of B and C."""
    return ((i & k & (f - 1)) == 0) == ((i & f) == 0)


def plain_global_stages(x, r, j_hi: int, j_lo: int, k: int, f: int = 0):
    """One launch of kernel C (or C-kv) over substages j_hi .. j_lo of stage
    k in plain torch, on any device -> (x, r): those substages one by one, as
    the kernel runs them in registers; ``f`` is the parity mask of a tile
    above the cap (``_tile_launches``)."""
    j = j_hi
    while j >= j_lo:
        x, r = _ce_plain(x, r, j, _directions(_group_starts(x.shape[-1], j, x.device), k, f))
        j //= 2
    return x, r


def plain_global_stage(x, r, j: int, k: int, f: int = 0):
    """Kernel C or C-kv in plain torch at one substage -> (x, r)."""
    return plain_global_stages(x, r, j, j, k, f)


def _plain_tile(x, r, block_n: int, k_first: int, k_last: int, f: int):
    """One launch of the tile kernel in plain torch: stages k_first .. k_last
    of every ``block_n`` tile, each over substages min(k, block_n)/2 .. 1,
    with parity mask f."""
    k = k_first
    while k <= k_last:
        x, r = plain_global_stages(x, r, min(k, block_n) // 2, 1, k, f)
        k *= 2
    return x, r


def plain_block_sort(x, r, block_n: int):
    """Kernel A (``r`` None) or A-kv in plain torch, on any device -> (x, r)."""
    return _plain_tile(x, r, block_n, 2, block_n, block_n)


def plain_block_merge(x, r, block_n: int, k: int):
    """Kernel B or B-kv in plain torch, on any device -> (x, r)."""
    return _plain_tile(x, r, block_n, k, k, 0)


def _at(run: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``run[p, index[p, ...]]`` for an integer (pairs, w) ``run``, the index
    clamped into the run (where the kernel reads nothing, the result is
    masked)."""
    flat = index.reshape(index.shape[0], -1).clamp(0, run.shape[-1] - 1)
    return torch.gather(run, -1, flat).view(index.shape)


def _edge_splits(ka, kb, d):
    """Kernel M's search at the tile edges ``d`` (pairs, edges): how many of
    run a's keys are among the first d of the merge, the first m at which
    a[m] > b[d - 1 - m] on the image, found as one warp finds it
    (``diagonal_split`` in the source): each round probes m_k = lo + (k + 1) *
    step - 1 for k < 32 and keeps the range after the c probes that hold."""
    w = ka.shape[-1]
    lo, hi = (d - w).clamp(min=0), d.clamp(max=w)
    probe = torch.arange(1, _SPLIT_PROBES + 1, device=d.device)
    while bool((active := hi > lo).any()):
        step = (hi - lo + _SPLIT_PROBES - 1) // _SPLIT_PROBES
        m = lo[..., None] + probe * step[..., None] - 1
        holds = (m < hi[..., None]) & (_at(ka, m) <= _at(kb, d[..., None] - 1 - m))
        c = holds.sum(-1)
        lo, hi = (torch.where(active, lo + c * step, lo),
                  torch.where(active, torch.minimum(hi, lo + (c + 1) * step - 1), hi))
    return lo


def plain_merge_runs(x, width: int, threads: int = MERGE_THREADS, elems: int = MERGE_ELEMS):
    """Kernel M in plain torch, on any device: the same tile cut, diagonal
    searches, tie rule and merge, step by step.  Each tile of ``threads *
    elems`` output keys of a pair takes the slices of runs a and b between
    the splits at its edges (clamped into the runs as the kernel clamps them);
    thread t finds its split at tile diagonal t * elems by binary search in
    those slices, then takes ``elems`` keys in order, run a's on equal images."""
    tile = threads * elems
    shape, w = x.shape, width
    keys = int_bits(x).reshape(-1, 2, w)
    img = sort_image(x).reshape(-1, 2, w)
    ka, kb, ba, bb = img[:, 0], img[:, 1], keys[:, 0], keys[:, 1]
    d0 = torch.arange(0, 2 * w + 1, tile, device=x.device).expand(ka.shape[0], -1)
    edge = _edge_splits(ka, kb, d0)
    i0, d0 = edge[:, :-1, None], d0[:, :-1, None]  # (pairs, tiles, 1)
    i1 = edge[:, 1:, None].clamp(torch.maximum(i0, d0 + tile - w), torch.clamp(i0 + tile, max=w))
    j0, la = d0 - i0, i1 - i0
    lb = tile - la
    dt = torch.arange(threads, device=x.device) * elems  # (threads,)
    lo, hi = (dt - lb).clamp(min=0), torch.minimum(dt, la)
    while bool((active := lo < hi).any()):
        mid = (lo + hi) // 2
        holds = _at(ka, i0 + mid) <= _at(kb, j0 + dt - 1 - mid)
        lo, hi = torch.where(active & holds, mid + 1, lo), torch.where(active & ~holds, mid, hi)
    ia, ib = lo, dt - lo
    out = []
    for _ in range(elems):
        take_a = (ib >= lb) | ((ia < la) & (_at(ka, i0 + ia) <= _at(kb, j0 + ib)))
        out.append(torch.where(take_a, _at(ba, i0 + ia), _at(bb, j0 + ib)))
        ia, ib = ia + take_a, ib + ~take_a
    return torch.stack(out, dim=-1).reshape(shape).view(x.dtype)


def select_items(x, largest: bool):
    """Kernel T's items of keys ``x`` (a dtype the kernels take), as int64:
    the order key in the upper 32 bits, signed, the index along the last axis
    below.  The key is ``keys.sort_image`` of the key, or for the largest
    keys its reverse (-1 - image), NaN of either sign last in both; so the
    ascending items are ``topk``'s order, ties to the lowest index, and no two
    tie.  (The kernel holds the key in unsigned order, 2^31 above this.)"""
    key = sort_image(x).to(torch.int64)
    if largest:
        reverse = -1 - key
        key = torch.where(torch.isnan(x), key, reverse) if x.dtype.is_floating_point else reverse
    return key * (1 << 32) + torch.arange(x.shape[-1], device=x.device)


def plain_topk_select(x, k: int, largest: bool = True):
    """Kernel T in plain torch, on any device -> int32 indices (leading
    dims, k): the k least ``select_items`` of each row, least first, by the
    plain network over the row padded to a power of two with the greatest
    int64, which no item reaches.  The kernel's segments and lists select
    the same k, since no two items tie."""
    n = x.shape[-1]
    items = select_items(x, largest).reshape(-1, n)
    np2 = next_pow2(n)
    if np2 != n:
        items = torch.cat([items, items.new_full((items.shape[0], np2 - n), torch.iinfo(torch.int64).max)],
                          dim=-1)
    items, _ = _plain_tile(items, None, np2, 2, np2, np2)
    return (items[:, :k] & 0xFFFFFFFF).to(torch.int32).reshape(x.shape[:-1] + (k,))


def global_spans(j_hi: int, j_lo: int) -> tuple:
    """The launches of kernel C that run the substages j_hi, j_hi/2, .., j_lo
    of one stage: ``(j_hi, j_lo)`` of each, in order, ceil(d / GLOBAL_SPAN) of
    them for d substages, split as evenly as they go (the wider first)."""
    d = j_hi.bit_length() - j_lo.bit_length() + 1
    launches = -(-d // GLOBAL_SPAN)
    spans = []
    for i in range(launches):
        s = d // launches + (i < d % launches)
        spans.append((j_hi, j_hi >> (s - 1)))
        j_hi >>= s
    return tuple(spans)


@functools.cache
def _tile_launches(block_n: int, k: int | None, cap: int = MAX_BLOCK_N) -> tuple:
    """The launches that make up kernel A (``k`` None) or kernel B at stage
    ``k`` on tiles of ``block_n`` keys: ``(kernel, width, k_first, k_last,
    f)`` for a tile launch, kernel "sort" (A, stages 2 .. width) or "merge"
    (B, the one stage k), and ``("global", j_hi, j_lo, k, f)`` for a launch
    of kernel C over substages j_hi .. j_lo.

    Up to ``cap`` this is one launch.  A wider tile W is the network of a
    sort of W keys at the cap (``sort_launches``), every launch with parity
    mask f = W; B on W-wide tiles is C for j = W/2 .. cap, then B at the cap.
    C's substages are grouped by ``global_spans``."""
    if block_n <= cap:
        return (("sort", block_n, 2, block_n, block_n),) if k is None else (("merge", block_n, k, k, 0),)
    if k is None:
        return tuple((*step[:-1], block_n) for step in sort_launches(block_n, cap, cap))
    spans = tuple(("global", *span, k, 0) for span in global_spans(block_n // 2, cap))
    return spans + _tile_launches(cap, k, cap)


@functools.cache
def sort_launches(n: int, block_n: int, cap: int = MAX_BLOCK_N) -> tuple:
    """The launches of the whole network of a sort of rows of ``n`` keys at
    tile width ``block_n``, as steps of ``_tile_launches``: kernel A, then
    for each stage k = 2*block_n .. n kernel C over its substages
    j = k/2 .. block_n (``global_spans``, parity mask 0) and kernel B.  The
    reference's ``_pallas_sort_impl`` and ``_pallas_argsort_impl`` run this
    network."""
    steps = list(_tile_launches(block_n, None, cap))
    for k in (1 << s for s in range(block_n.bit_length(), n.bit_length())):
        steps += [("global", *span, k, 0) for span in global_spans(k // 2, block_n)]
        steps += _tile_launches(block_n, k, cap)
    return tuple(steps)


# launches by wrapper name (``KERNELS``), the substages that C and C-kv ran
# ("substages", "substages_kv") and the merge rounds on the card that
# ``core.merge.merge_adjacent`` left to the rank merge ("rank_merge_pairs")
tally: Counter = Counter()


def merge_runs_takes(dtype: torch.dtype, width: int) -> bool:
    """Kernel M's rule: keys of a dtype it takes, in runs of ``width`` whose
    merged runs (``2 * width``) fill whole tiles of it (``MERGE_TILE``)."""
    return dtype in _DTYPE_CODE and width >= 1 and (2 * width) % MERGE_TILE == 0


def _check(x, r, block_n=None, width=None) -> int:
    """Validate keys (and ranks) and the tile width; return the row length n,
    a power of two, or for kernel M (``width`` given) a multiple of
    ``2 * width`` that ``merge_runs_takes``."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported key dtype {x.dtype}; expected one of {list(_DTYPE_CODE)}")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError(f"keys must be contiguous with at least one axis, got shape {tuple(x.shape)}")
    n = x.shape[-1]
    if width is not None:
        if not merge_runs_takes(x.dtype, width) or n % (2 * width):
            raise ValueError(f"merge_runs needs 2 * width a multiple of MERGE_TILE = {MERGE_TILE} "
                             f"that divides the last axis, got width={width}, n={n}")
    elif not _is_pow2(n):
        raise ValueError(f"last axis must be a power of two, got shape {tuple(x.shape)}")
    if r is not None and (r.dtype != torch.int32 or r.shape != x.shape or r.device != x.device
                          or not r.is_contiguous()):
        raise ValueError("ranks must be int32, contiguous, shaped and placed like the keys")
    if block_n is not None and not (_is_pow2(block_n) and block_n <= n):
        raise ValueError(f"block_n={block_n} must be a power of two <= n={n}")
    return n


@functools.cache
def select_geometry(rows: int, n: int, k: int) -> tuple:
    """Kernel T's ``(segments a row, list length)`` for ``rows`` rows of
    ``n`` keys: the least list of ``_SELECT_LISTS`` that holds k; segments of
    at least ``_SELECT_MIN_SEGMENT`` keys, as many as bring the first launch
    to ``_SELECT_BLOCKS`` blocks, at most ``_SELECT_MAX_SEGMENTS``."""
    list_len = next(m for m in _SELECT_LISTS if k <= m)
    segments = min(-(-n // _SELECT_MIN_SEGMENT), -(-_SELECT_BLOCKS // max(rows, 1)), _SELECT_MAX_SEGMENTS)
    return max(1, segments), list_len


def _check_stage(n: int, j_hi: int, j_lo: int, k: int) -> None:
    """Substages j_hi .. j_lo of stage k in one launch: of C, or of B at
    j_hi = j_lo = block_n."""
    if not (_is_pow2(j_hi) and _is_pow2(j_lo) and _is_pow2(k)
            and j_lo <= j_hi < j_lo << GLOBAL_SPAN and 2 * j_hi <= k <= n):
        raise ValueError(f"need powers of two j_lo <= j_hi within {GLOBAL_SPAN} substages and "
                         f"2*j_hi <= k <= n, got j_hi={j_hi} j_lo={j_lo} k={k} n={n}")


def _run(x, r, steps):
    """The one path of every launch: run ``steps`` (see ``_tile_launches``;
    ``("runs", width)`` is one launch of kernel M) on keys ``x`` checked by
    the caller, or on (key, rank) pairs where ``r`` is given -> (x, r).  On
    a CUDA tensor each step is one launch through ``_launch``, counted in
    ``tally``; on a CPU tensor its plain version.  The inputs are let go
    after the first step, as the steps' outputs are."""
    if not _on_cuda(x):
        for kind, *args in steps:
            if kind == "global":
                x, r = plain_global_stages(x, r, *args)
            elif kind == "runs":
                x = plain_merge_runs(x, *args)
            else:
                x, r = _plain_tile(x, r, *args)
        return x, r
    _check_aligned(x, r)
    code, kv, n = _DTYPE_CODE[x.dtype], "" if r is None else "_kv", x.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for kind, *args in steps:
            out, out_r = torch.empty_like(x), None if r is None else torch.empty_like(r)
            if kind == "runs":
                # the entry point checks the geometry against the one it was built for
                _launch("bitonic_merge_runs", code, x.data_ptr(), out.data_ptr(), x.numel(), *args,
                        MERGE_THREADS, MERGE_ELEMS, MERGE_PASSES, stream)
                tally["merge_runs"] += 1
            else:
                rows = (code, x.data_ptr(), None if r is None else r.data_ptr(), out.data_ptr(),
                        None if r is None else out_r.data_ptr(), x.numel() // n, n)
                if kind == "global":
                    _launch("bitonic_global_stage", *rows, *args, stream)
                    tally["global_stage" + kv] += 1
                    tally["substages" + kv] += args[0].bit_length() - args[1].bit_length() + 1
                else:
                    geometry = _tile_geometry(args[0], x.element_size(), r is not None, kind == "sort")
                    _launch("bitonic_tile_network", *rows, *args, *geometry, stream)
                    tally["block_" + kind + kv] += 1
            x, r = out, out_r
    return x, r


# ------------------------------------------------------------------ wrappers ---
def block_sort(x: torch.Tensor, block_n: int) -> torch.Tensor:
    """Kernel A: sort every aligned ``block_n`` tile of each row, tile b of a
    row ascending iff b is even (replaces ``_block_sort_kernel``)."""
    _check(x, None, block_n)
    return _run(x, None, _tile_launches(block_n, None))[0]


def block_merge(x: torch.Tensor, block_n: int, k: int) -> torch.Tensor:
    """Kernel B: substages j = block_n/2 .. 1 of stage ``k > block_n``, fused
    per tile; up iff (tile start & k) == 0 (replaces ``_block_merge_kernel``)."""
    _check_stage(_check(x, None, block_n), block_n, block_n, k)
    return _run(x, None, _tile_launches(block_n, k))[0]


def global_stage(x: torch.Tensor, j: int, k: int) -> torch.Tensor:
    """Kernel C: one cross-tile compare-exchange at distance ``j`` of stage
    ``k``; a group starting at i sorts up iff (i & k) == 0 (replaces the
    jnp-level ``global_stage``)."""
    _check_stage(_check(x, None), j, j, k)
    return _run(x, None, (("global", j, j, k, 0),))[0]


def global_stages(x: torch.Tensor, j_hi: int, j_lo: int, k: int) -> torch.Tensor:
    """Kernel C over substages j_hi, j_hi/2, .., j_lo of stage ``k`` in one
    pass (at most ``GLOBAL_SPAN`` of them): ``global_stage`` at each in turn."""
    _check_stage(_check(x, None), j_hi, j_lo, k)
    return _run(x, None, (("global", j_hi, j_lo, k, 0),))[0]


def block_sort_kv(x: torch.Tensor, r: torch.Tensor, block_n: int):
    """Kernel A-kv: kernel A on (key, int32 rank) pairs -> (keys, ranks)
    (replaces ``_block_sort_kv_kernel``)."""
    _check(x, r, block_n)
    return _run(x, r, _tile_launches(block_n, None))


def block_merge_kv(x: torch.Tensor, r: torch.Tensor, block_n: int, k: int):
    """Kernel B-kv: kernel B on (key, int32 rank) pairs -> (keys, ranks)
    (replaces ``_block_merge_kv_kernel``)."""
    _check_stage(_check(x, r, block_n), block_n, block_n, k)
    return _run(x, r, _tile_launches(block_n, k))


def global_stage_kv(x: torch.Tensor, r: torch.Tensor, j: int, k: int):
    """Kernel C-kv: kernel C on (key, int32 rank) pairs -> (keys, ranks)
    (replaces the jnp-level ``global_stage_kv``)."""
    _check_stage(_check(x, r), j, j, k)
    return _run(x, r, (("global", j, j, k, 0),))


def global_stages_kv(x: torch.Tensor, r: torch.Tensor, j_hi: int, j_lo: int, k: int):
    """Kernel C-kv over substages j_hi .. j_lo of stage ``k`` in one pass ->
    (keys, ranks)."""
    _check_stage(_check(x, r), j_hi, j_lo, k)
    return _run(x, r, (("global", j_hi, j_lo, k, 0),))


def merge_runs(x: torch.Tensor, width: int) -> torch.Tensor:
    """Kernel M: every pair of adjacent sorted runs of ``width`` keys along
    the last axis merged into one run, in ``keys.sort_image`` order, run a's
    key first on equal images; ``2 * width`` a multiple of ``MERGE_TILE``
    that divides the last axis.  On runs sorted on that image the output is
    ``core.merge.rank_merge_pairs``', bit for bit (the reference's jnp merge;
    M replaces no Pallas kernel).

    >>> x = torch.cat([torch.arange(0, MERGE_TILE, 2), torch.arange(1, MERGE_TILE, 2)]).int()
    >>> torch.equal(merge_runs(x, MERGE_TILE // 2), torch.arange(MERGE_TILE, dtype=torch.int32))
    True
    """
    _check(x, None, width=width)
    return _run(x, None, (("runs", width),))[0]


def topk_select(x: torch.Tensor, k: int, largest: bool = True) -> torch.Tensor:
    """Kernel T: int32 indices (leading dims, k) of the k best keys of each
    row along the last axis, best first: the k least ``select_items``, so
    NaN of either sign last, -0.0 tied with +0.0 and ties to the lowest
    index, as ``engine.topk`` orders them.  ``x`` is contiguous, of a dtype
    the kernels take, at any alignment, with 1 <= k <= min(n, SELECT_MAX_K)
    and n < 2^31.  One launch, or two where a row has several segments
    (``select_geometry``), each counted on ``topk_select``."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported key dtype {x.dtype}; expected one of {list(_DTYPE_CODE)}")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError(f"keys must be contiguous with at least one axis, got shape {tuple(x.shape)}")
    n = x.shape[-1]
    if not 1 <= k <= min(n, SELECT_MAX_K) or n >= 1 << 31:
        raise ValueError(f"topk_select needs 1 <= k <= min(n, {SELECT_MAX_K}) and n < 2^31, "
                         f"got k={k}, n={n}")
    if not _on_cuda(x):
        return plain_topk_select(x, k, largest)
    rows = x.numel() // n
    segments, list_len = select_geometry(rows, n, k)
    out = torch.empty(x.shape[:-1] + (k,), dtype=torch.int32, device=x.device)
    lists = None if segments == 1 else torch.empty(rows * segments * list_len, dtype=torch.int64,
                                                   device=x.device)
    with torch.cuda.device(x.device):
        _launch("bitonic_topk_select", _DTYPE_CODE[x.dtype], x.data_ptr(),
                None if lists is None else lists.data_ptr(), out.data_ptr(), rows, n, segments,
                list_len, k, int(largest), torch.cuda.current_stream(x.device).cuda_stream)
    tally["topk_select"] += 1 if segments == 1 else 2
    return out


def sort_rows(x: torch.Tensor, block_n: int, ranked: bool = False):
    """The whole network of a sort of each row (``sort_launches``) on keys,
    or where ``ranked`` on (key, int32 rank) pairs whose ranks start as
    0 .. n-1 along each row -> (keys, ranks): the stable permutation."""
    n = _check(x, None, block_n)
    # the ranks are made in the call, so that nothing holds them after A-kv
    return _run(x, torch.arange(n, dtype=torch.int32, device=x.device).expand(x.shape).contiguous()
                if ranked else None, sort_launches(n, block_n))


KERNELS = (block_sort, block_merge, global_stage, block_sort_kv, block_merge_kv, global_stage_kv,
           merge_runs, topk_select)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {fn.__name__: tally[fn.__name__] for fn in KERNELS}


def substage_counts() -> dict:
    """Substages that C and C-kv launches ran since the last reset: over
    their ``launch_counts``, how many substages a pass took."""
    return {"global_stage": tally["substages"], "global_stage_kv": tally["substages_kv"]}


def merge_round_counts() -> dict:
    """Merge rounds on the card since the last reset: kernel M's launches and
    the rounds ``core.merge.merge_adjacent`` left to ``rank_merge_pairs``
    (narrower than a tile, with values, or of another dtype)."""
    return {"merge_runs": tally["merge_runs"], "rank_merge_pairs": tally["rank_merge_pairs"]}


def reset_launch_counts() -> None:
    """Every count of ``tally`` back to 0."""
    tally.clear()
