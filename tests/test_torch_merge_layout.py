"""Kernels A and B's register-resident design, checked on the CPU.

``tile_network`` in ``csrc/bitonic_sort.cu`` cannot run without a card, so
this file holds what it computes against the plain versions in plain torch:

* ``_tile_geometry`` gives every tile width a launch the kernel accepts;
* ``emulate_tile`` repeats the kernel's data movement step by step, with the
  kernel's index maps: the contiguous registers (thread t of a tile holds
  E*t + e) read as 16-byte words in lane-XORed order, the strided registers
  (t + T*e), the swizzled transposes through shared memory between them,
  the shuffles at lane distance j/E, the per-pair directions from the
  element's index and the parity mask, the ragged last chunk.  Kernel B
  (one stage) must equal ``plain_block_merge`` and kernel A (stages
  2 .. block_n) ``plain_block_sort`` bit for bit, and capped launches
  composed by ``_tile_launches`` must equal the wide tile;
* the swizzle and the XOR order keep shared memory free of bank conflicts.
"""
import numpy as np
import pytest
import torch

from _torch_parity import DTYPES, cpu, make_keys
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

BLOCK_NS = [1 << i for i in range(kernels.MAX_BLOCK_N.bit_length())]  # 1 .. MAX_BLOCK_N
SMEM_PER_BLOCK = 232_448  # bytes of dynamic shared memory one sm_90 block may use


def tile_max_threads(e: int) -> int:
    """The kernel's __launch_bounds__ for E keys a thread (tile_max_threads in the .cu)."""
    return 128 if e <= 4 else 256 if e == 8 else 512


def swizzle(i: torch.Tensor, e: int, itemsize: int) -> torch.Tensor:
    """Transpose-buffer position of chunk element i (swizzle<BYTES, E> in the .cu)."""
    w = 4 // itemsize
    row_shift = 6 if w == 2 else 5
    return i ^ (((i >> row_shift) * w) & (e - 1))


def load_order(tid: torch.Tensor, e_n: int, itemsize: int):
    """(word, s) of load_contiguous: the 16-byte word each thread reads at
    step q (a (threads, NQ) tensor of word indices in the slot) and the XOR
    s of its order; None when a thread's E values are not whole words."""
    nq = e_n * itemsize // 16
    if (e_n * itemsize) % 16:
        return None
    s = (tid >> (3 - (nq.bit_length() - 1))) & (nq - 1)
    q = torch.arange(nq)
    return tid[:, None] * nq + (q[None, :] ^ s[:, None]), s


def load_contiguous(slot: torch.Tensor, tid: torch.Tensor, e_n: int) -> torch.Tensor:
    """Registers (threads, E) of load_contiguous: the words in XOR order,
    then one round of selects per bit of s."""
    itemsize = slot.element_size()
    order = load_order(tid, e_n, itemsize)
    if order is None:
        return slot[e_n * tid[:, None] + torch.arange(e_n)[None, :]]
    word, s = order
    per = 16 // itemsize
    w = slot.reshape(-1, per)[word]  # (threads, NQ, PER): w[:, q] is word q ^ s
    nq = w.shape[1]
    b = 1
    while b < nq:
        flip = ((s & b) != 0)[:, None]
        for c in range(nq):
            if c & b == 0:
                lo, hi = w[:, c].clone(), w[:, c | b].clone()
                w[:, c] = torch.where(flip, hi, lo)
                w[:, c | b] = torch.where(flip, lo, hi)
        b <<= 1
    return w.reshape(len(tid), e_n)


def _greater(a, b, ra, rb):
    gt = a > b
    if ra is not None:
        gt = gt | ((a == b) & (ra > rb))
    return gt


def emulate_tile(x: torch.Tensor, r, block_n: int, k_first: int, k_last: int, f: int):
    """Stages k_first .. k_last of every tile as ``tile_network`` moves the
    data, with parity mask f: rows of x -> (x, r)."""
    shape, n = x.shape, x.shape[-1]
    sort = k_first == 2 and k_last == block_n and f != 0  # kernel A (SORT in the .cu)
    g = kernels._tile_geometry(block_n, x.element_size(), r is not None, sort)
    t_n, e_n, per_block = g.threads_per_tile, g.elems_per_thread, g.tiles_per_block
    log_t = t_n.bit_length() - 1
    chunk, threads = per_block * block_n, per_block * t_n
    flat = x.reshape(-1)
    flat_r = None if r is None else r.reshape(-1)
    out, out_r = torch.empty_like(flat), None if r is None else torch.empty_like(flat_r)

    tid = torch.arange(threads)
    p, t = tid // t_n, tid % t_n
    e = torch.arange(e_n)
    strided = (p * block_n + t)[:, None] + t_n * e[None, :]  # (threads, E)
    contiguous = e_n * tid[:, None] + e[None, :]

    def jtop(k):
        return min(k, block_n) // 2

    # kernel B's direction on the flat tile start: up iff it has an even
    # number of the (distinct) bits k & (f-1) and f, each taken below n
    b_kbit = k_first & (f - 1)
    b_bits = (b_kbit if b_kbit < n else 0) | (f if f < n else 0)

    def ce_regs(kk, rr, m, up):
        """Registers lo and lo + m for every lo with (lo & m) == 0; ``up``
        is (threads, pairs)."""
        lo = torch.tensor([i for i in range(e_n) if i & m == 0])
        a, b = kk[:, lo], kk[:, lo + m]
        ra, rb = (None, None) if rr is None else (rr[:, lo], rr[:, lo + m])
        swap = _greater(a, b, ra, rb) == up
        kk[:, lo], kk[:, lo + m] = torch.where(swap, b, a), torch.where(swap, a, b)
        if rr is not None:
            rr[:, lo], rr[:, lo + m] = torch.where(swap, rb, ra), torch.where(swap, ra, rb)
        return lo

    def transpose(slot, slot_r, kk, rr, src, dst):
        slot[swizzle(src, e_n, x.element_size())] = kk
        kk = slot[swizzle(dst, e_n, x.element_size())]
        if rr is not None:
            slot_r[swizzle(src, e_n, 4)] = rr
            rr = slot_r[swizzle(dst, e_n, 4)]
        return kk, rr

    for first in range(0, flat.numel(), chunk):
        length = min(chunk, flat.numel() - first)
        slot = torch.zeros(chunk, dtype=x.dtype)  # a ragged chunk's missing tiles stay unset
        slot[:length] = flat[first:first + length]
        slot_r = None
        if r is not None:
            slot_r = torch.zeros(chunk, dtype=torch.int32)
            slot_r[:length] = flat_r[first:first + length]
        if sort:  # kernel A: contiguous, then stages k_first .. k_last
            kk = load_contiguous(slot, tid, e_n)
            rr = None if r is None else load_contiguous(slot_r, tid, e_n)
            is_strided = False
            ts = (first + p * block_n) & (n - 1)  # the tile's start within its row
            asc = (ts & f) == 0
            stages = []
            k = k_first
            while k <= k_last:
                kmask = k & (f - 1)
                up_k = ((ts & kmask) == 0) == asc  # (threads,)
                kl = kmask & (block_n - 1)  # 0, or the stage's bit inside the tile
                stages.append((k, up_k, kl, (((t * e_n) & kl) == 0) == up_k))
                k *= 2
        else:  # kernel B: strided, the one stage, up one per tile
            kk = slot[strided]
            rr = None if r is None else slot_r[strided]
            is_strided = log_t > 0
            set_bits = (first + p * block_n) & b_bits
            up = (((set_bits & b_kbit) != 0).int() + ((set_bits & f) != 0).int()) % 2 == 0
            stages = [(k_first, up, 0, up)]

        for k, up_k, kl, up_t in stages:
            top = jtop(k)
            if top >= t_n:
                if log_t > 0 and not is_strided:
                    kk, rr = transpose(slot, slot_r, kk, rr, contiguous, strided)
                    is_strided = True
                kle = kl >> log_t  # strided: loc & kl is (e & kle) << log_t
                m = e_n // 2
                while m >= 1:  # j = T*m >= T: registers lo and lo + m
                    if m * t_n <= top:
                        lo = torch.tensor([i for i in range(e_n) if i & m == 0])
                        ce_regs(kk, rr, m, ((lo[None, :] & kle) == 0) == up_k[:, None])
                    m //= 2
                if log_t > 0:
                    kk, rr = transpose(slot, slot_r, kk, rr, strided, contiguous)
                    is_strided = False

            d = min(top, t_n // 2) // e_n
            while d >= 1:  # E <= j < T: lane ^ d, d = j / E
                assert d < 32
                partner = tid ^ d
                assert torch.equal(partner // 32, tid // 32)
                lower = ((t & d) == 0)[:, None]
                o = kk[partner]
                ro = None if rr is None else rr[partner]
                gt = torch.where(lower, _greater(kk, o, rr, ro), _greater(o, kk, ro, rr))
                swap = gt == up_t[:, None]
                kk = torch.where(swap, o, kk)
                if rr is not None:
                    rr = torch.where(swap, ro, rr)
                d //= 2

            j = e_n // 2
            while j >= 1:  # j < min(E, T), j <= top: registers lo and lo + j
                if j < t_n and j <= top:
                    lo = torch.tensor([i for i in range(e_n) if i & j == 0])
                    if 0 < kl < e_n:  # stages k < E of kernel A: bit k of e
                        up = ((lo[None, :] & kl) == 0) == up_k[:, None]
                    else:
                        up = up_t[:, None].expand(-1, len(lo))
                    ce_regs(kk, rr, j, up)
                j //= 2

        stored = p * block_n < length
        out[first + contiguous[stored]] = kk[stored]
        if r is not None:
            out_r[first + contiguous[stored]] = rr[stored]
    return out.reshape(shape), None if r is None else out_r.reshape(shape)


def emulate_merge(x: torch.Tensor, r, block_n: int, k: int):
    """Kernel B: the one stage k > block_n, parity mask 0."""
    return emulate_tile(x, r, block_n, k, k, 0)


def emulate_sort(x: torch.Tensor, r, block_n: int):
    """Kernel A: stages 2 .. block_n, parity mask block_n."""
    return emulate_tile(x, r, block_n, 2, block_n, block_n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


@pytest.mark.parametrize("has_rank", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("block_n", BLOCK_NS)
def test_merge_geometry_is_one_the_kernel_takes(block_n, itemsize, has_rank):
    for sort in (False, True):  # kernel B, then kernel A
        g = kernels._tile_geometry(block_n, itemsize, has_rank, sort)
        t_n, e_n = g.threads_per_tile, g.elems_per_thread
        assert t_n * e_n == block_n
        assert t_n <= 1024 and t_n * g.tiles_per_block <= tile_max_threads(e_n) <= 1024
        assert t_n <= 32 * e_n  # every substage j < T is one shuffle inside a warp
        assert e_n in (1, 2, 4, 8, 16, 32)
        chunk = g.tiles_per_block * block_n
        assert (chunk * itemsize) % 16 == 0  # a full chunk is one bulk copy
        assert g.smem_bytes == chunk * (itemsize + 4 * has_rank) + 8  # the slot, its mbarrier
        assert g.smem_bytes <= SMEM_PER_BLOCK
        if block_n >= 1024:
            assert t_n * g.tiles_per_block >= 128 and e_n >= 8  # 16-byte stores of every key type
        if sort and block_n >= 32:
            assert e_n == 32


# (block_n, rows, n): every width class of _tile_geometry, and ragged last
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
    lanes = torch.arange(32)
    for sort in (False, True):  # kernel B, then kernel A (E = 32: T may be below a warp)
        g = kernels._tile_geometry(block_n, itemsize, False, sort)
        t_n, e_n = g.threads_per_tile, g.elems_per_thread
        for size in (itemsize, 4):  # keys, then ranks
            for warp in range(t_n * g.tiles_per_block // 32):
                tid = warp * 32 + lanes
                p, t = tid // t_n, tid % t_n
                for e in range(e_n):
                    write = swizzle(p * block_n + t + t_n * e, e_n, size)  # strided layout
                    read = swizzle(e_n * tid + e, e_n, size)  # contiguous layout
                    assert _distinct_banks(write, size) and _distinct_banks(read, size)


# (block_n, rows, n) for kernel A: every width class, rows of one tile
# (n == block_n: every such tile sorts up), ragged last chunks
SORT_CASES = [
    (1, 3, 2),
    (2, 3, 2),
    (4, 3, 16),
    (8, 3, 8),
    (16, 2, 64),
    (64, 3, 64),
    (256, 3, 512),
    (1024, 2, 1024),
    (2048, 1, 4096),
    (4096, 2, 4096),
    (16384, 1, 16384),
]


@pytest.mark.parametrize("has_rank", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("block_n,rows,n", SORT_CASES)
def test_emulated_sort_kernel_equals_plain_bit_for_bit(block_n, rows, n, dtype, has_rank):
    x = cpu(_merge_keys(dtype, (rows, n), seed=block_n + 1))
    perm = np.random.default_rng(block_n).permutation(n).astype(np.int32)
    r = torch.from_numpy(np.tile(perm, (rows, 1))) if has_rank else None
    got, got_r = emulate_sort(x, r, block_n)
    want, want_r = kernels.plain_block_sort(x, r, block_n)
    assert torch.equal(_bits(got), _bits(want)), "keys"
    if has_rank:
        assert torch.equal(got_r, want_r), "ranks"


def test_emulated_sort_puts_signed_zeros_where_the_plain_network_does():
    x = torch.tensor([[0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 0.0, 2.0] * 64])
    for block_n in (8, 64, 256):  # odd tiles descend; 256: every layout
        got, _ = emulate_sort(x, None, block_n)
        assert torch.equal(_bits(got), _bits(kernels.plain_block_sort(x, None, block_n)[0]))


@pytest.mark.parametrize("has_rank", [False, True])
@pytest.mark.parametrize("cap,width,n", [(16, 64, 256), (64, 512, 1024), (kernels.MAX_BLOCK_N, 2 * kernels.MAX_BLOCK_N, 2 * kernels.MAX_BLOCK_N)])
def test_emulated_capped_launches_compose_the_wide_tile(cap, width, n, has_rank):
    """``_tile_launches`` above the cap, run on emulated tile launches and the
    plain kernel C, equals the wide tile's plain network: kernel A's parity
    mask f = width, and at k = f the tile's parity alone."""
    x = cpu(_merge_keys("float32", (2, n), seed=cap))
    r = torch.arange(n, dtype=torch.int32).expand(2, n).contiguous() if has_rank else None

    def run(steps, y, ry):
        for kind, *args in steps:
            if kind == "global":
                y, ry = kernels.plain_global_stages(y, ry, *args)
            else:
                y, ry = emulate_tile(y, ry, *args)
        return y, ry

    got, got_r = run(kernels._tile_launches(width, None, cap), x, r)
    want, want_r = kernels.plain_block_sort(x, r, width)
    assert torch.equal(_bits(got), _bits(want))
    if has_rank:
        assert torch.equal(got_r, want_r)
    got, got_r = run(kernels._tile_launches(width, 2 * width, cap), want, want_r)
    want, want_r = kernels.plain_block_merge(want, want_r, width, 2 * width)
    assert torch.equal(_bits(got), _bits(want))
    if has_rank:
        assert torch.equal(got_r, want_r)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("block_n", [b for b in BLOCK_NS if b >= 16])
def test_contiguous_load_is_free_of_bank_conflicts(block_n, itemsize):
    """Each quarter-warp phase of load_contiguous's 16-byte reads touches 8
    different 16-byte bank groups."""
    g = kernels._tile_geometry(block_n, itemsize, False, True)
    tid = torch.arange(g.threads_per_tile * g.tiles_per_block)
    for size in (itemsize, 4):  # keys, then ranks
        order = load_order(tid, g.elems_per_thread, size)
        if order is None:
            continue
        word, _ = order
        for phase in range(0, len(tid), 8):
            for q in range(word.shape[1]):
                assert torch.unique(word[phase:phase + 8, q] % 8).numel() == 8
