"""Kernel B's register-resident design, checked on the CPU.

``merge_kernel`` in ``csrc/bitonic_sort.cu`` cannot run without a card, so
this file holds what it computes against the plain version in plain torch:

* ``_merge_geometry`` gives every tile width a launch the kernel accepts;
* ``emulate_merge`` repeats the kernel's data movement step by step, with the
  kernel's index maps: the strided registers (thread t of a tile holds
  t + T*e), the swizzled transpose through shared memory, the contiguous
  registers (E*t + e), the shuffles at lane distance j/E, the ragged last
  chunk.  It must equal ``plain_block_merge`` bit for bit;
* the swizzle keeps the transpose free of shared-memory bank conflicts.
"""
import numpy as np
import pytest
import torch

from _torch_parity import DTYPES, cpu, make_keys
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

BLOCK_NS = [1 << i for i in range(kernels.MAX_BLOCK_N.bit_length())]  # 1 .. MAX_BLOCK_N
SMEM_PER_BLOCK = 232_448  # bytes of dynamic shared memory one sm_90 block may use


def merge_max_threads(e: int) -> int:
    """The kernel's __launch_bounds__ for E keys a thread (merge_max_threads in the .cu)."""
    return 128 if e <= 4 else 256 if e == 8 else 512


def swizzle(i: torch.Tensor, e: int, itemsize: int) -> torch.Tensor:
    """Transpose-buffer position of chunk element i (swizzle<BYTES, E> in the .cu)."""
    w = 4 // itemsize
    row_shift = 6 if w == 2 else 5
    return i ^ (((i >> row_shift) * w) & (e - 1))


def _greater(a, b, ra, rb):
    gt = a > b
    if ra is not None:
        gt = gt | ((a == b) & (ra > rb))
    return gt


def emulate_merge(x: torch.Tensor, r, block_n: int, k: int):
    """Kernel B as ``merge_kernel`` moves the data: rows of x -> (x, r)."""
    shape, n = x.shape, x.shape[-1]
    g = kernels._merge_geometry(block_n, x.element_size(), r is not None)
    t_n, e_n, per_block = g.threads_per_tile, g.elems_per_thread, g.tiles_per_block
    chunk, threads = per_block * block_n, per_block * t_n
    k_mask = k if k < n else 0
    flat = x.reshape(-1)
    flat_r = None if r is None else r.reshape(-1)
    out, out_r = torch.empty_like(flat), None if r is None else torch.empty_like(flat_r)

    tid = torch.arange(threads)
    p, t = tid // t_n, tid % t_n
    e = torch.arange(e_n)
    strided = (p * block_n + t)[:, None] + t_n * e[None, :]  # (threads, E)
    contiguous = e_n * tid[:, None] + e[None, :]

    def ce_regs(kk, rr, lo, hi, up):
        a, b = kk[:, lo], kk[:, hi]
        swap = _greater(a, b, None if rr is None else rr[:, lo],
                        None if rr is None else rr[:, hi]) == up
        kk[:, lo], kk[:, hi] = torch.where(swap, b, a), torch.where(swap, a, b)
        if rr is not None:
            ra, rb = rr[:, lo], rr[:, hi]
            rr[:, lo], rr[:, hi] = torch.where(swap, rb, ra), torch.where(swap, ra, rb)

    for first in range(0, flat.numel(), chunk):
        length = min(chunk, flat.numel() - first)
        slot = torch.zeros(chunk, dtype=x.dtype)  # a ragged chunk's missing tiles stay unset
        slot[:length] = flat[first:first + length]
        kk = slot[strided]
        rr = None
        if r is not None:
            slot_r = torch.zeros(chunk, dtype=torch.int32)
            slot_r[:length] = flat_r[first:first + length]
            rr = slot_r[strided]
        up = ((first + p * block_n) & k_mask) == 0

        m = e_n // 2
        while m >= 1:  # j = T*m >= T: registers e and e + m
            for lo in range(e_n):
                if lo & m == 0:
                    ce_regs(kk, rr, lo, lo + m, up)
            m //= 2

        slot[swizzle(strided, e_n, x.element_size())] = kk  # the transpose
        kk = slot[swizzle(contiguous, e_n, x.element_size())]
        if r is not None:
            slot_r[swizzle(strided, e_n, 4)] = rr
            rr = slot_r[swizzle(contiguous, e_n, 4)]

        d = t_n // (2 * e_n)
        while d >= 1:  # E <= j < T: lane ^ d, d = j / E
            assert d < 32
            partner = tid ^ d
            assert torch.equal(partner // 32, tid // 32)
            lower = ((t & d) == 0)[:, None]
            o = kk[partner]
            ro = None if rr is None else rr[partner]
            gt = torch.where(lower, _greater(kk, o, rr, ro), _greater(o, kk, ro, rr))
            swap = gt == up[:, None]
            kk = torch.where(swap, o, kk)
            if rr is not None:
                rr = torch.where(swap, ro, rr)
            d //= 2

        j = e_n // 2
        while j >= 1:  # j < min(E, T): registers e and e + j
            if j < t_n:
                for lo in range(e_n):
                    if lo & j == 0:
                        ce_regs(kk, rr, lo, lo + j, up)
            j //= 2

        stored = p * block_n < length
        out[first + contiguous[stored]] = kk[stored]
        if r is not None:
            out_r[first + contiguous[stored]] = rr[stored]
    return out.reshape(shape), None if r is None else out_r.reshape(shape)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


@pytest.mark.parametrize("has_rank", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("block_n", BLOCK_NS)
def test_merge_geometry_is_one_the_kernel_takes(block_n, itemsize, has_rank):
    g = kernels._merge_geometry(block_n, itemsize, has_rank)
    t_n, e_n = g.threads_per_tile, g.elems_per_thread
    assert t_n * e_n == block_n
    assert t_n <= 1024 and t_n * g.tiles_per_block <= merge_max_threads(e_n) <= 1024
    assert t_n <= 32 * e_n  # every substage j < T is one shuffle inside a warp
    assert e_n in (1, 2, 4, 8, 16, 32) and g.slots in (1, 2)
    chunk = g.tiles_per_block * block_n
    assert (chunk * itemsize) % 16 == 0  # a full chunk is one bulk copy
    assert g.smem_bytes == g.slots * chunk * (itemsize + 4 * has_rank) + 16
    assert g.smem_bytes <= SMEM_PER_BLOCK
    if block_n >= 1024:
        assert t_n * g.tiles_per_block >= 128 and e_n >= 8  # 16-byte stores of every key type


# (block_n, rows, n): every width class of _merge_geometry, and ragged last
# chunks (rows * n / block_n not a multiple of tiles_per_block), some of
# fewer than 16 bytes
CASES = [
    (1, 3, 2),
    (2, 3, 4),
    (4, 1, 16),
    (8, 3, 16),
    (16, 2, 64),
    (64, 3, 128),
    (256, 2, 1024),
    (1024, 2, 4096),
    (2048, 1, 8192),
    (4096, 2, 8192),
    (16384, 1, 32768),
]


def _merge_keys(dtype: str, shape, seed: int) -> np.ndarray:
    """Duplicate-heavy keys with both signed zeros among them."""
    x = make_keys(dtype, shape, seed, duplicates=True)
    if dtype != "int32":
        rng = np.random.default_rng(seed + 1)
        x = np.where(rng.random(shape) < 0.3, np.array(-0.0, dtype=x.dtype), x).astype(x.dtype)
    return x


@pytest.mark.parametrize("has_rank", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("block_n,rows,n", CASES)
def test_emulated_merge_kernel_equals_plain_bit_for_bit(block_n, rows, n, dtype, has_rank):
    x = cpu(_merge_keys(dtype, (rows, n), seed=block_n))
    perm = np.random.default_rng(block_n).permutation(n).astype(np.int32)
    r = torch.from_numpy(np.tile(perm, (rows, 1))) if has_rank else None
    for k in sorted({2 * block_n, n}):  # tiles alternating up/down, and all up
        got, got_r = emulate_merge(x, r, block_n, k)
        want, want_r = kernels.plain_block_merge(x, r, block_n, k)
        assert torch.equal(_bits(got), _bits(want)), (k, "keys")
        if has_rank:
            assert torch.equal(got_r, want_r), (k, "ranks")


def test_emulated_merge_puts_signed_zeros_where_the_plain_network_does():
    x = torch.tensor([[0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 0.0, 2.0] * 4])
    for k in (16, 32):  # the first tile of 8 descends at k = 16
        got, _ = emulate_merge(x, None, 8, k)
        assert torch.equal(_bits(got), _bits(kernels.plain_block_merge(x, None, 8, k)[0]))


def _distinct_banks(elements: torch.Tensor, itemsize: int) -> bool:
    """True when the distinct 4-byte words one warp access touches lie in
    distinct banks (lanes on one word are a broadcast, not a conflict)."""
    words = torch.unique(elements * itemsize // 4)
    return torch.unique(words % 32).numel() == words.numel()


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("block_n", [b for b in BLOCK_NS if b >= 256])
def test_transpose_is_free_of_bank_conflicts(block_n, itemsize):
    g = kernels._merge_geometry(block_n, itemsize, False)
    t_n, e_n = g.threads_per_tile, g.elems_per_thread
    lanes = torch.arange(32)
    for sizes in ((itemsize, e_n), (4, e_n)):  # keys, then ranks
        for warp in range(t_n // 32):
            tid = warp * 32 + lanes
            for e in range(e_n):
                write = swizzle(tid + t_n * e, e_n, sizes[0])  # strided layout
                read = swizzle(e_n * tid + e, e_n, sizes[0])  # contiguous layout
                assert _distinct_banks(write, sizes[0]) and _distinct_banks(read, sizes[0])
