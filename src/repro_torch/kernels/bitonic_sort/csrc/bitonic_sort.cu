// Bitonic sort network kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bitonic_sort/bitonic_sort.py:
//   A     block_sort        _block_sort_kernel     (l.88,  pallas_call l.164)
//   B     block_merge       _block_merge_kernel    (l.124, pallas_call l.178)
//   A-kv  block_sort_kv     _block_sort_kv_kernel  (l.105, pallas_call l.214)
//   B-kv  block_merge_kv    _block_merge_kv_kernel (l.143, pallas_call l.231)
//   C     global_stage(_kv) global_stage / global_stage_kv (l.188, l.244; jnp there)
//
// Every kernel computes exactly what its reference computes: the comparator is
// `a > b` (keys) or `(a > b) | (a == b & ra > rb)` (key, rank), a pair swaps iff
// `gt == dir_up`, and the partners, directions and substage order are the
// reference's.  fp16/bf16 keys are compared through __half2float /
// __bfloat162float; only the comparison converts, the stored bits move untouched.
// NaN keys give unspecified output, as in the reference.
//
// Direction.  The pair whose lower element has index i within its row sorts up
// at stage k iff ((i & k & (f - 1)) == 0) == ((i & f) == 0), with f the parity
// mask: f = block_n makes it kernel A's rule (tile b of a row ascending iff b is
// even, as the reference's vmap gives it), f = 0 the rule of B and C
// ((i & k) == 0), and f = W > block_n lets capped launches compose the network
// of one W-wide tile (bitonic_sort.py:_tile_launches).
//
// Bound: each launch reads its keys (and ranks) once and writes them once,
// 2*n*sizeof(key) bytes (+ 2*n*4 with ranks).  Its compare-exchanges (a compare
// and two selects a pair and substage, three compares and four selects with
// ranks) take less time than that at the card's peak op rate, so the least time
// of every kernel is its bytes over 3.35 TB/s (H100 SXM).  A and A-kv reach a
// fraction of it all the same: with 55 substages a tile at block_n 1024, what
// holds them back is issuing those compare-exchanges, not memory.
//
// A / B (tile_network; entry points sort_kernel, merge_kernel): stages
//   k_first .. k_last of every block_n tile, each stage k the substages
//   j = min(k, block_n)/2 .. 1.  Kernel A is stages 2 .. block_n (55 substages
//   at 1024), kernel B the one stage k > block_n.  A network that makes one
//   pass through shared memory per substage, with a barrier and half the
//   threads idle, reached a third of the byte rate for B and a tenth for A.
//   So the tile lives in registers, T threads holding E keys (and ranks) each,
//   T * E = block_n, in one of two layouts:
//   - contiguous, thread t holding E*t + e: substages j < E are between two
//     registers of a thread, E <= j < T a __shfl_xor_sync at lane distance j/E
//     (T <= 32*E keeps the partner in the warp); both lanes compute gt with the
//     lower index's element as `a`, so they agree on ties and +-0 lands where
//     the plain network puts it;
//   - strided, thread t holding t + T*e: substages j >= T are between two
//     registers of a thread.
//   A stage with substages j >= T moves the tile contiguous -> strided -> back
//   through shared memory, XOR-swizzled inside each E-element group by its
//   128-byte row, so that the strided side (a warp on 32 neighbours) and the
//   contiguous side (lane l on E*l + e) hit 32 different banks.  B runs one
//   such transpose.  A is held back by its compare-exchanges, not by bytes, and
//   a register compare-exchange is half the work per key of a shuffled one, so A
//   takes E = 32: at block_n 1024 (T 32) it runs 40 substages in registers, 15
//   strided and none as shuffles, with 10 transposes.  Directions are one per
//   thread where the layout allows it and per register index elsewhere, from
//   the element's index in the layout that holds it.
//   Tiles arrive by 1-D bulk copies (cp.async.bulk, completion on an mbarrier)
//   into the one slot of a persistent block; the next chunk's copy starts as
//   soon as the tile's last shared-memory read is done, so it loads while this
//   tile finishes its network in registers and stores (a second slot was never
//   faster).  B reads the slot in the strided layout (lane l on word l: no
//   conflict).  A reads it contiguous as 16-byte vectors, the cheapest way to
//   take E contiguous keys from the linear order of a bulk copy: a scalar read
//   would stride E words and conflict E ways; the 16-byte words of one thread
//   are read in an order XORed with the lane, so that the 8 lanes of each
//   quarter-warp phase hit 8 different 16-byte bank groups.  Stores are 16-byte
//   vectors from the contiguous registers.  Tiles narrower than 128 threads'
//   worth are packed several to a block.  A ragged last chunk whose size is not
//   a multiple of 16 bytes is loaded by the block itself.  The geometry (T, E,
//   tiles per block, shared bytes) comes from bitonic_sort.py:_tile_geometry
//   and is validated here.
//
// C / C-kv (global_stage_kernel): the cross-tile substages j_hi .. j_lo of one
//   stage k > block_n in one pass over memory.  Each launch reads and writes
//   the whole array, so a stage's d substages at distances >= block_n cost d
//   passes one at a time; their pairs stay within groups of 2^d elements, so a
//   thread holds up to 2^kGlobalSpan of them (one group, a stride of j_lo
//   apart) in registers, runs up to kGlobalSpan substages there and stores
//   once: ceil(d / kGlobalSpan) passes a stage (bitonic_sort.py:global_spans).
//   Lanes own neighbouring groups, so every load and store of a warp is one
//   coalesced line.  Grid-stride loop, out of place; one substage (j_hi = j_lo)
//   is the reference's global_stage.
//
// M (merge_runs_kernel): one round of model B's merge tree, every pair of
//   adjacent sorted runs of `width` keys merged into one run of 2*width.  It
//   replaces no Pallas kernel: the reference merges in jnp (src/repro/core/
//   merge.py, rank_merge_pairs: two searchsorted, a scatter and a gather),
//   and so did the port, in about 22 torch ops a round of which several were
//   random-access passes over 8-byte positions.  Its order is that of
//   core/merge.py:sort_image, computed in registers (-0.0 == +0.0, every NaN
//   equal to every other and above +inf, fp16/bf16 through float32), and on
//   equal images run a's key goes first, the rank merge's side='left' /
//   side='right' rule: so on runs sorted on that image its output is the rank
//   merge's, bit for bit.  Keys move as raw bits.
//   Bound: a round reads every key once and writes it once, 2*n*sizeof(key)
//   bytes, 0.040 ms for 2^24 float32 keys at 3.35 TB/s; the comparisons are a
//   few integer ops a key.  Design (merge path): the output of a pair is cut
//   into tiles of THREADS * E keys, PASSES consecutive tiles a block.  One
//   warp for each tile edge finds where that output position splits the runs,
//   by a 32-way search along the diagonal in device memory (5 rounds of two
//   loads a lane at 2^23, not 23 dependent rounds), all edges of the block at
//   once, so the search's latency is paid once for PASSES tiles.  For each
//   tile the block copies its slices of a and b into shared memory as aligned
//   16-byte words, coalesced; each thread finds its own split there by binary
//   search, merges its E keys in registers (one shared load a key, no
//   divergent branch) and stores them as 16-byte vectors.  So device memory
//   sees one read and one write of each key, plus the searches.
//   The splits are clamped so that every slice stays inside its run whatever
//   the keys: runs that are not sorted (NaN out of the networks) give
//   unspecified output, never an access out of bounds.
//
// T (select_segments_kernel, select_merge_kernel): the top-k of each row, the
//   k least items (key, index) as one 64-bit word, the order key above the
//   index: the key is the image above (merge_image) in unsigned order, and for
//   the largest keys its complement, NaN of either sign staying last.  Items
//   never tie, so the k least are the stable top-k of engine/kv.py:topk (ties to
//   the lowest index).  It replaces no Pallas kernel: the reference, and the
//   port before it, sorted the whole row padded to a power of two through the kv
//   network (21 launches at 128 x 256,000) to keep k of each row.  Bound: the
//   keys read once, 128 x 256,000 float32 in 0.039 ms at 3.35 TB/s; the answer
//   is k int32 a row.  Design: a first launch cuts each row into segments, a
//   block of 8 warps a segment, the warps taking its 16-byte words in turn, each
//   lane testing U of them while its next U load.  A warp keeps the L least
//   items it has seen (L = 64, 128 or 256 >= k, sorted, strided over the lanes
//   in registers) and a bound: the least k-th item of any warp of the block, in
//   shared memory.  A key is formed in registers and compared with the bound;
//   what passes goes to a warp queue in shared memory (ballot and popc), and
//   each 32 queued items are sorted by a warp bitonic network and merged into
//   the list (a min against the list's last 32, then a bitonic merge).  After
//   the first few words of a segment almost no key passes; a warp's list takes
//   some k (1 + ln(keys / k)) items in all, so the launch runs few long segments
//   (bitonic_sort.py:select_geometry).  The warps' lists are merged pairwise
//   into the block's (min of one list against the other reversed, then a bitonic
//   merge), and the block writes it to a scratch of rows x segments x L items; a
//   second launch merges a row's segment lists the same way and writes the first
//   k indices.  A row of one segment takes the first launch alone.  A key that
//   fails the bound has k lesser items in some warp's list, and a list drops
//   only items with L >= k lesser ones, so no item of the answer is ever
//   dropped.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <type_traits>
#include <utility>

namespace {

// ------------------------------------------------------------ kernels A, B ---
// The kernels move keys as raw bits (U) and convert only to compare.
template <typename T> struct KeyBits;
template <> struct KeyBits<float> {
  using U = uint32_t;
  static __device__ __forceinline__ float ord(U u) { return __uint_as_float(u); }
};
template <> struct KeyBits<int32_t> {
  using U = uint32_t;
  static __device__ __forceinline__ int32_t ord(U u) { return static_cast<int32_t>(u); }
};
template <> struct KeyBits<__half> {
  using U = uint16_t;
  static __device__ __forceinline__ float ord(U u) { return __half2float(__ushort_as_half(u)); }
};
template <> struct KeyBits<__nv_bfloat16> {
  using U = uint16_t;
  static __device__ __forceinline__ float ord(U u) {
    return __bfloat162float(__ushort_as_bfloat16(u));
  }
};

// Most cross-tile substages one launch of kernel C runs: 2^4 keys (and ranks)
// a thread in registers (bitonic_sort.py:GLOBAL_SPAN).
constexpr int kGlobalSpan = 4;

// Threads a tile block may have for E keys a thread (its __launch_bounds__);
// _tile_geometry never asks for more.
__host__ __device__ constexpr int tile_max_threads(int e) { return e <= 4 ? 128 : (e == 8 ? 256 : 512); }

// The reference's gt for the pair (a at the lower index, b at the upper).
template <typename T, bool HAS_RANK>
__device__ __forceinline__ bool greater(typename KeyBits<T>::U a, typename KeyBits<T>::U b,
                                        int32_t ra, int32_t rb) {
  const auto ca = KeyBits<T>::ord(a);
  const auto cb = KeyBits<T>::ord(b);
  bool gt = ca > cb;
  if constexpr (HAS_RANK) gt = gt || (ca == cb && ra > rb);
  return gt;
}

// Compare-exchange of registers lo < hi of one thread.
template <typename T, bool HAS_RANK, int E>
__device__ __forceinline__ void ce_regs(typename KeyBits<T>::U (&k)[E], int32_t (&rk)[E], int lo,
                                        int hi, bool up) {
  const auto a = k[lo], b = k[hi];
  const bool swap = greater<T, HAS_RANK>(a, b, rk[lo], rk[hi]) == up;
  k[lo] = swap ? b : a;
  k[hi] = swap ? a : b;
  if constexpr (HAS_RANK) {
    const int32_t ra = rk[lo], rb = rk[hi];
    rk[lo] = swap ? rb : ra;
    rk[hi] = swap ? ra : rb;
  }
}

// Position of chunk element i in the transpose buffer: the low bits (inside
// one thread's E-element group) XORed with the element's 128-byte row, so
// that a warp writing 32 neighbours and a warp reading E*l + e (lane l) each
// touch 32 different 4-byte banks.  BYTES is the element size.
template <int BYTES, int E>
__device__ __forceinline__ int swizzle(int i) {
  constexpr int W = 4 / BYTES;                  // elements in one bank word
  constexpr int ROW_SHIFT = W == 2 ? 6 : 5;     // log2(elements in 128 bytes)
  return i ^ (((i >> ROW_SHIFT) * W) & (E - 1));
}

// v[e] = buf[E*tid + e]: E contiguous values of a linear buffer.  A thread
// whose values fill NQ >= 1 whole 16-byte words reads them as uint4 in the
// order q ^ s, s taken from the lane so that the 8 lanes of a quarter-warp
// phase touch 8 different 16-byte bank groups, then undoes the XOR with
// selects, one round per bit of s, so every register index stays static.
template <typename V, int E>
__device__ __forceinline__ void load_contiguous(const V* buf, int tid, V (&v)[E]) {
  constexpr int BYTES = E * int(sizeof(V));
  if constexpr (BYTES % 16 != 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = buf[E * tid + e];
  } else {
    constexpr int NQ = BYTES / 16;
    constexpr int PER = 16 / int(sizeof(V));  // values in one uint4
    static_assert(NQ <= 8, "at most 8 uint4 a thread");
    constexpr int LOG_NQ = NQ == 8 ? 3 : (NQ == 4 ? 2 : (NQ == 2 ? 1 : 0));
    const int s = (tid >> (3 - LOG_NQ)) & (NQ - 1);
    const uint4* src = reinterpret_cast<const uint4*>(buf) + tid * NQ;
    uint4 w[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) w[q] = src[q ^ s];
#pragma unroll
    for (int b = 1; b < NQ; b <<= 1) {
      const bool flip = (s & b) != 0;
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        if ((c & b) == 0) {
          const uint4 lo = w[c], hi = w[c | b];
          w[c] = flip ? hi : lo;
          w[c | b] = flip ? lo : hi;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const uint32_t word[4] = {w[q].x, w[q].y, w[q].z, w[q].w};
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if constexpr (sizeof(V) == 4) {
          v[q * PER + i] = static_cast<V>(word[i]);
        } else {
          v[q * PER + i] = static_cast<V>(word[i / 2] >> (16 * (i % 2)));
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Word w of the E keys of a thread, for a 16-byte vector store.
template <typename U, int E>
__device__ __forceinline__ uint32_t key_word(const U (&k)[E], int w) {
  if constexpr (sizeof(U) == 4) {
    return k[w];
  } else {
    return uint32_t(k[2 * w]) | (uint32_t(k[2 * w + 1]) << 16);
  }
}

// Kernels A and B: stages k_first .. k_last (k_first doubling up to k_last) of
// every block_n tile of rows of n keys, with parity mask f (see the top of the
// file).  SORT is kernel A (stages 2 .. block_n); without it the launch is
// kernel B (one stage k > block_n), where the direction is one per tile and the
// tile starts strided, so its build carries none of A's paths and registers.
// A block walks over chunks of `tiles_per_block` tiles, one chunk at a time in
// its slot; `1 << log_t` threads work on a tile.
template <typename T, bool HAS_RANK, int E, bool SORT>
__device__ __forceinline__ void tile_network(
    const typename KeyBits<T>::U* __restrict__ x, const int32_t* __restrict__ r,
    typename KeyBits<T>::U* __restrict__ ox, int32_t* __restrict__ orank, int64_t tiles,
    int64_t n, int block_n, int log_t, int tiles_per_block, int64_t k_first, int64_t k_last,
    int64_t f) {
  using U = typename KeyBits<T>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = tiles_per_block * block_n;  // elements of the slot
  const int key_bytes = chunk * int(sizeof(U));
  U* sk = reinterpret_cast<U*>(smem);
  int32_t* sr = reinterpret_cast<int32_t*>(smem + key_bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + key_bytes + (HAS_RANK ? chunk * 4 : 0));
  const int64_t chunks = (tiles + tiles_per_block - 1) / tiles_per_block;
  const int tid = threadIdx.x;
  const int t_n = 1 << log_t;
  const int p = tid >> log_t;      // tile within the chunk
  const int t = tid & (t_n - 1);   // thread within the tile
  const int sbase = p * block_n + t;  // strided layout: element sbase + (e << log_t)
  const int cbase = tid * E;          // contiguous layout: element cbase + e
  auto jtop = [&](int64_t k) { return int((k < block_n ? k : int64_t{block_n}) / 2); };
  // a tile moves through shared memory if its last stage has substages j >= T
  // (T == 1: the two layouts are one)
  const bool moves = log_t > 0 && jtop(k_last) >= t_n;
  // kernel B's direction on the flat tile start s: up iff ((s & k & (f-1)) == 0)
  // == ((s & f) == 0), the two bits taken only below n (above, a row has none).
  // They are distinct (k & (f-1) < f), so up iff s has an even number of them.
  const int64_t b_kbit = k_first & (f - 1);
  const int64_t b_bits = (b_kbit < n ? b_kbit : 0) | (f < n ? f : 0);

  // elements in chunk c: fewer in a ragged last chunk
  auto chunk_len = [&](int64_t c) {
    const int64_t left = (tiles - c * tiles_per_block) * block_n;
    return left < chunk ? int(left) : chunk;
  };
  // thread 0: start the bulk copy of chunk c into the slot, unless its size
  // is not a multiple of 16 bytes (then the block loads it itself)
  auto start_load = [&](int64_t c) {
    const int len = chunk_len(c);
    if ((len * int(sizeof(U))) % 16) return;
    mbar_expect_tx(bar, len * (int(sizeof(U)) + (HAS_RANK ? 4 : 0)));
    bulk_load(sk, x + c * chunk, len * sizeof(U), bar);
    if constexpr (HAS_RANK) bulk_load(sr, r + c * chunk, len * 4, bar);
  };

  if (tid == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && blockIdx.x < chunks) start_load(blockIdx.x);

  int it = 0;
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x, ++it) {
    const int64_t first = c * chunk;
    const int len = chunk_len(c);
    if ((len * int(sizeof(U))) % 16 == 0) {
      mbar_wait(bar, it & 1);
    } else {
      for (int i = tid; i < len; i += blockDim.x) {
        sk[i] = x[first + i];
        if constexpr (HAS_RANK) sr[i] = r[first + i];
      }
      __syncthreads();
    }
    // every thread is done with the slot: hand it to the next bulk copy
    auto release = [&]() {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      const int64_t next = c + gridDim.x;
      if (tid == 0 && next < chunks) start_load(next);
    };

    U k[E];
    int32_t rk[E];
    // the tile through shared memory: contiguous -> strided and back
    auto to_strided = [&]() {
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sk[swizzle<sizeof(U), E>(cbase + e)] = k[e];
        if constexpr (HAS_RANK) sr[swizzle<4, E>(cbase + e)] = rk[e];
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = sbase + (e << log_t);
        k[e] = sk[swizzle<sizeof(U), E>(i)];
        if constexpr (HAS_RANK) rk[e] = sr[swizzle<4, E>(i)];
      }
    };
    auto to_contiguous = [&]() {
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = sbase + (e << log_t);
        sk[swizzle<sizeof(U), E>(i)] = k[e];
        if constexpr (HAS_RANK) sr[swizzle<4, E>(i)] = rk[e];
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) {
        k[e] = sk[swizzle<sizeof(U), E>(cbase + e)];
        if constexpr (HAS_RANK) rk[e] = sr[swizzle<4, E>(cbase + e)];
      }
    };
    // the pair at tile-local index loc goes up iff ((loc & kl) == 0) == up_k,
    // kl 0 or the stage's bit inside the tile (>= 2j for every substage j)
    // strided, j = T*m >= T, j <= top: registers e and e + m; loc & kl is
    // (e & kle) << log_t
    auto strided_substages = [&](int top, int kle, bool up_k) {
#pragma unroll
      for (int m = E / 2; m >= 1; m >>= 1) {
        if (m * t_n <= top) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if ((e & m) == 0) ce_regs<T, HAS_RANK, E>(k, rk, e, e + m, ((e & kle) == 0) == up_k);
          }
        }
      }
    };
    // contiguous, E <= j < T, j <= top: the partner is lane ^ d, d = j / E;
    // both lanes compare (lower index's element, upper index's element).
    // kl >= 2E or 0 here, so up is one per thread.
    auto shuffle_substages = [&](int top, bool up) {
      for (int d = (top < t_n / 2 ? top : t_n / 2) / E; d >= 1; d >>= 1) {
        const bool lower = (t & d) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const U o = static_cast<U>(__shfl_xor_sync(0xffffffffu, uint32_t(k[e]), d));
          const int32_t ro = HAS_RANK ? __shfl_xor_sync(0xffffffffu, rk[e], d) : 0;
          const bool gt = lower ? greater<T, HAS_RANK>(k[e], o, rk[e], ro)
                                : greater<T, HAS_RANK>(o, k[e], ro, rk[e]);
          if (gt == up) {
            k[e] = o;
            rk[e] = ro;
          }
        }
      }
    };
    // contiguous, j < min(E, T), j <= top: registers e and e + j; with
    // 0 < kl < E (stages k < E of kernel A) the direction is bit k of e, else
    // one per thread (up_t)
    auto register_substages = [&](int top, int kl, bool up_k, bool up_t) {
      if (kl != 0 && kl < E) {
#pragma unroll
        for (int j = E / 2; j >= 1; j >>= 1) {
          if (j < t_n && j <= top) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              if ((e & j) == 0) ce_regs<T, HAS_RANK, E>(k, rk, e, e + j, ((e & kl) == 0) == up_k);
            }
          }
        }
      } else {
#pragma unroll
        for (int j = E / 2; j >= 1; j >>= 1) {
          if (j < t_n && j <= top) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              if ((e & j) == 0) ce_regs<T, HAS_RANK, E>(k, rk, e, e + j, up_t);
            }
          }
        }
      }
    };

    if constexpr (SORT) {
      // kernel A: read the slot contiguous, then stages 2 .. block_n
      load_contiguous<U, E>(sk, tid, k);
      if constexpr (HAS_RANK) {
        load_contiguous<int32_t, E>(sr, tid, rk);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) rk[e] = 0;
      }
      if (!moves) release();
      // the tile's start within its row, and its parity under f
      const int64_t ts = (first + int64_t{p} * block_n) & (n - 1);
      const bool asc = (ts & f) == 0;
      // every stage starts and ends contiguous
      for (int64_t kk = k_first; kk <= k_last; kk <<= 1) {
        const int64_t kmask = kk & (f - 1);
        const bool up_k = ((ts & kmask) == 0) == asc;
        const int kl = int(kmask & (block_n - 1));
        const bool up_t = (((t * E) & kl) == 0) == up_k;
        const int top = jtop(kk);
        if (top >= t_n) {
          if (log_t > 0) to_strided();
          strided_substages(top, kl >> log_t, up_k);
          if (log_t > 0) {
            to_contiguous();
            if (kk == k_last) release();
          }
        }
        shuffle_substages(top, up_t);
        register_substages(top, kl, up_k, up_t);
      }
    } else {
      // kernel B: read the slot strided, then the one stage, up one per tile
#pragma unroll
      for (int e = 0; e < E; ++e) {
        k[e] = sk[sbase + (e << log_t)];
        rk[e] = HAS_RANK ? sr[sbase + (e << log_t)] : 0;
      }
      if (log_t == 0) release();  // T == 1: no transpose
      const bool up = (__popcll((first + int64_t{p} * block_n) & b_bits) & 1) == 0;
      const int top = block_n / 2;
      strided_substages(top, 0, up);
      if (log_t > 0) {
        to_contiguous();
        release();
      }
      shuffle_substages(top, up);
      register_substages(top, 0, up, up);
    }

    if (p * block_n < len) {  // a ragged last chunk has fewer tiles
      U* dst = ox + first + cbase;
      if constexpr ((E * sizeof(U)) % 16 == 0) {
#pragma unroll
        for (int q = 0; q < int(E * sizeof(U)) / 16; ++q) {
          reinterpret_cast<uint4*>(dst)[q] =
              make_uint4(key_word(k, 4 * q), key_word(k, 4 * q + 1), key_word(k, 4 * q + 2),
                         key_word(k, 4 * q + 3));
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) dst[e] = k[e];
      }
      if constexpr (HAS_RANK) {
        int32_t* rdst = orank + first + cbase;
        if constexpr (E % 4 == 0) {
#pragma unroll
          for (int q = 0; q < E / 4; ++q) {
            reinterpret_cast<int4*>(rdst)[q] =
                make_int4(rk[4 * q], rk[4 * q + 1], rk[4 * q + 2], rk[4 * q + 3]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) rdst[e] = rk[e];
        }
      }
    }
  }
}

// The tile network's two entry points differ only in their launch bounds: with
// the plain bound ptxas keeps B at the registers that fill the SM with blocks
// (32 keys-only at E = 8) but caps A's E = 16 build with ranks at 64 and spills;
// a minimum of one block a SM lets A take what it needs (up to 128) unspilled.
template <typename T, bool HAS_RANK, int E>
__global__ void __launch_bounds__(tile_max_threads(E), 1)
    sort_kernel(const typename KeyBits<T>::U* __restrict__ x, const int32_t* __restrict__ r,
                typename KeyBits<T>::U* __restrict__ ox, int32_t* __restrict__ orank,
                int64_t tiles, int64_t n, int block_n, int log_t, int tiles_per_block,
                int64_t k_first, int64_t k_last, int64_t f) {
  tile_network<T, HAS_RANK, E, true>(x, r, ox, orank, tiles, n, block_n, log_t, tiles_per_block,
                                     k_first, k_last, f);
}

template <typename T, bool HAS_RANK, int E>
__global__ void __launch_bounds__(tile_max_threads(E))
    merge_kernel(const typename KeyBits<T>::U* __restrict__ x, const int32_t* __restrict__ r,
                 typename KeyBits<T>::U* __restrict__ ox, int32_t* __restrict__ orank,
                 int64_t tiles, int64_t n, int block_n, int log_t, int tiles_per_block,
                 int64_t k_first, int64_t k_last, int64_t f) {
  tile_network<T, HAS_RANK, E, false>(x, r, ox, orank, tiles, n, block_n, log_t,
                                      tiles_per_block, k_first, k_last, f);
}

// Kernel C: the cross-tile substages j_hi, j_hi/2, .., j_lo of stage k in one
// pass over all rows, with parity mask f.  The 2^S elements i0 + m*j_lo
// (m < 2^S, S = log2(j_hi/j_lo) + 1 <= kGlobalSpan) exchange only among
// themselves in those substages, so one thread owns them: it loads the group
// into registers, runs the substages in order (j_hi first: bit S-1 of m, down
// to bit 0) and stores the group once.  i0 is the thread's group number with S
// zero bits put in at bit log2(j_lo), so neighbouring lanes hold neighbouring
// i0 and each of the thread's loads and stores is one coalesced line once
// j_lo >= 32.  k and f lie above the group's bits (2*j_hi <= k, f 0 or >= k),
// so every pair of the group takes i0's direction.  S is a template argument, so a
// short span holds only its 2^S keys (and ranks): one substage in a kernel
// sized for 16 keys a thread ran at half the byte rate of two a thread.
template <typename T, bool HAS_RANK, int S>
__global__ void __launch_bounds__(256)
    global_stage_kernel(const typename KeyBits<T>::U* __restrict__ x,
                        const int32_t* __restrict__ r, typename KeyBits<T>::U* __restrict__ ox,
                        int32_t* __restrict__ orank, int64_t groups, int log_n, int log_j_lo,
                        int64_t k, int64_t f) {
  using U = typename KeyBits<T>::U;
  constexpr int G = 1 << S;
  const int log_row_groups = log_n - S;
  const int64_t row_groups = int64_t{1} << log_row_groups;
  const int64_t j_lo = int64_t{1} << log_j_lo;
  const int64_t kmask = k & (f - 1);
  const int64_t stride = int64_t{gridDim.x} * blockDim.x;
  for (int64_t g = int64_t{blockIdx.x} * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const int64_t gi = g & (row_groups - 1);
    const int64_t i0 = ((gi >> log_j_lo) << (log_j_lo + S)) | (gi & (j_lo - 1));
    const bool dir_up = ((i0 & kmask) == 0) == ((i0 & f) == 0);
    const int64_t base = ((g >> log_row_groups) << log_n) + i0;
    U key[G];
    int32_t rk[G];
#pragma unroll
    for (int m = 0; m < G; ++m) {
      key[m] = x[base + (int64_t{m} << log_j_lo)];
      if constexpr (HAS_RANK) rk[m] = r[base + (int64_t{m} << log_j_lo)];
    }
#pragma unroll
    for (int b = S - 1; b >= 0; --b) {
#pragma unroll
      for (int m = 0; m < G; ++m) {
        if (!(m & (1 << b))) ce_regs<T, HAS_RANK, G>(key, rk, m, m | (1 << b), dir_up);
      }
    }
#pragma unroll
    for (int m = 0; m < G; ++m) {
      ox[base + (int64_t{m} << log_j_lo)] = key[m];
      if constexpr (HAS_RANK) orank[base + (int64_t{m} << log_j_lo)] = rk[m];
    }
  }
}

// ---------------------------------------------------------------- kernel M ---
// core/merge.py:sort_image of a key, as an int32: floats widened to float32,
// -0.0 as +0.0, sign-magnitude turned into two's-complement order, NaN of
// either sign above +inf.
template <typename T>
__device__ __forceinline__ int32_t merge_image(typename KeyBits<T>::U u) {
  if constexpr (std::is_same_v<T, int32_t>) {
    return static_cast<int32_t>(u);
  } else {
    const float f = KeyBits<T>::ord(u);
    if (f != f) return INT32_MAX;
    if (f == 0.0f) return 0;
    const int32_t i = __float_as_int(f);
    return i < 0 ? i ^ INT32_MAX : i;
  }
}

// The split of diagonal d of runs a and b (w keys each): how many of a's keys
// are among the first d keys of the merge, the first m in [max(0, d - w),
// min(d, w)] at which a[m] > b[d - 1 - m] on the image (a's key goes first on
// ties).  One warp: each round the 32 lanes probe m_k = lo + (k + 1) * step - 1,
// and the count c of true probes (a prefix, on sorted runs) leaves
// [lo + c * step, min(hi, lo + (c + 1) * step - 1)].  Whatever the keys, the
// range only narrows inside [lo, hi].
template <typename T>
__device__ __forceinline__ int64_t diagonal_split(const typename KeyBits<T>::U* a,
                                                  const typename KeyBits<T>::U* b, int64_t w,
                                                  int64_t d, int lane) {
  int64_t lo = d > w ? d - w : 0, hi = d < w ? d : w;
  while (hi > lo) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t m = lo + (lane + 1) * step - 1;
    const bool p = m < hi && merge_image<T>(a[m]) <= merge_image<T>(b[d - 1 - m]);
    const int64_t c = __popc(__ballot_sync(0xffffffffu, p));
    const int64_t top = lo + (c + 1) * step - 1;
    lo += c * step;
    hi = top < hi ? top : hi;
  }
  return lo;
}

// Kernel M: block g merges PASSES consecutive tiles of TILE output keys of
// one pair (see the top of the file), tile by tile; warp w finds the split at
// the w-th tile edge, all PASSES + 1 of them at once.  Shared memory holds a
// tile's two slices as 16-byte words from the word holding each slice's first
// key: at most TILE / V + 3 words, and one more for the key one past b's slice
// that the merge reads.
template <typename T, int THREADS, int E, int PASSES>
__global__ void __launch_bounds__(THREADS)
    merge_runs_kernel(const typename KeyBits<T>::U* __restrict__ x,
                      typename KeyBits<T>::U* __restrict__ out, int64_t width,
                      int64_t tiles_per_pair) {
  using U = typename KeyBits<T>::U;
  constexpr int TILE = THREADS * E;
  constexpr int V = 16 / int(sizeof(U));  // keys in a 16-byte word
  static_assert(TILE % V == 0 && (E * int(sizeof(U))) % 16 == 0, "whole 16-byte words");
  static_assert(PASSES < THREADS / 32, "a warp for each tile edge");
  __shared__ uint4 words[TILE / V + 4];
  __shared__ int64_t edge[PASSES + 1];
  const int tid = threadIdx.x;
  const int64_t first = int64_t{blockIdx.x} * PASSES;  // the block's first tile
  const int64_t pair = first / tiles_per_pair;
  const int64_t d_first = (first - pair * tiles_per_pair) * int64_t{TILE};
  const U* a = x + pair * 2 * width;
  const U* b = a + width;
  if ((tid >> 5) <= PASSES) {
    const int64_t s = diagonal_split<T>(a, b, width, d_first + (tid >> 5) * int64_t{TILE}, tid & 31);
    if ((tid & 31) == 0) edge[tid >> 5] = s;
  }
  for (int pass = 0; pass < PASSES; ++pass) {
    __syncthreads();  // the edges are found; the last pass is done with the slices
    // the tile takes a[i0, i1) and b[j0, j1); i1 clamped so that both slices
    // lie in their runs (a no-op on sorted runs)
    const int64_t d0 = d_first + pass * int64_t{TILE};
    const int64_t i0 = edge[pass];
    int64_t i1 = edge[pass + 1];
    const int64_t i1_lo = i0 > d0 + TILE - width ? i0 : d0 + TILE - width;
    const int64_t i1_hi = i0 + TILE < width ? i0 + TILE : width;
    i1 = i1 < i1_lo ? i1_lo : (i1 > i1_hi ? i1_hi : i1);
    const int64_t j0 = d0 - i0, j1 = d0 + TILE - i1;
    const int64_t a_first = i0 & ~int64_t{V - 1}, b_first = j0 & ~int64_t{V - 1};
    const int a_words = int((i1 - a_first + V - 1) / V);
    const int b_words = int((j1 - b_first + V - 1) / V);
    const uint4* ga = reinterpret_cast<const uint4*>(a + a_first);
    const uint4* gb = reinterpret_cast<const uint4*>(b + b_first);
    for (int i = tid; i < a_words + b_words; i += THREADS) {
      words[i] = i < a_words ? ga[i] : gb[i - a_words];
    }
    __syncthreads();
    const U* sa = reinterpret_cast<const U*>(words) + (i0 - a_first);
    const U* sb = reinterpret_cast<const U*>(words) + a_words * V + (j0 - b_first);
    const int la = int(i1 - i0), lb = int(j1 - j0);
    // this thread's split of the slices at diagonal dt
    const int dt = tid * E;
    int lo = dt - lb > 0 ? dt - lb : 0, hi = dt < la ? dt : la;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (merge_image<T>(sa[mid]) <= merge_image<T>(sb[dt - 1 - mid])) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    // E keys in order; the slices hold TILE - dt >= E keys past the split, so
    // one of them always has a key left
    int ia = lo, ib = dt - lo;
    U ka = sa[ia], kb = sb[ib];
    int32_t ma = merge_image<T>(ka), mb = merge_image<T>(kb);
    U k[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool take_a = ib >= lb || (ia < la && ma <= mb);
      k[e] = take_a ? ka : kb;
      ia += take_a;
      ib += !take_a;
      const U next = *(take_a ? sa + ia : sb + ib);
      const int32_t mn = merge_image<T>(next);
      ka = take_a ? next : ka;
      ma = take_a ? mn : ma;
      kb = take_a ? kb : next;
      mb = take_a ? mb : mn;
    }
    uint4* dst = reinterpret_cast<uint4*>(out + pair * 2 * width + d0 + dt);
#pragma unroll
    for (int q = 0; q < E * int(sizeof(U)) / 16; ++q) {
      dst[q] = make_uint4(key_word(k, 4 * q), key_word(k, 4 * q + 1), key_word(k, 4 * q + 2),
                          key_word(k, 4 * q + 3));
    }
  }
}

// ---------------------------------------------------------------- kernel T ---
constexpr int kSelectThreads = 256;  // bitonic_sort.py: SELECT_THREADS
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;
// One item: the order key in the upper 32 bits, the index (below 2^31) in the
// lower.  kNoItem fills a list's empty slots and follows every item.
using Item = unsigned long long;
constexpr Item kNoItem = ~Item{0};

// The order key of a raw key: topk's order ascending in unsigned compares.
template <typename T>
__device__ __forceinline__ uint32_t select_key(typename KeyBits<T>::U u, bool largest) {
  const uint32_t a = uint32_t(merge_image<T>(u)) ^ 0x80000000u;
  if constexpr (std::is_same_v<T, int32_t>) {
    return largest ? ~a : a;
  } else {
    return largest && a != 0xffffffffu ? ~a : a;  // NaN (image INT32_MAX) stays last
  }
}

__device__ __forceinline__ Item select_item(uint32_t key, int64_t index) {
  return (Item{key} << 32) | uint32_t(index);
}

// The V keys of a 16-byte word, in memory order.
template <typename K, int V>
__device__ __forceinline__ void unpack_word(const uint4& w, K (&k)[V]) {
  const uint32_t word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if constexpr (sizeof(K) == 4) {
      k[i] = word[i];
    } else {
      k[i] = static_cast<K>(word[i / 2] >> (16 * (i % 2)));
    }
  }
}

// Sorts a bitonic sequence of R * 32 items ascending; item r * 32 + lane is v[r].
template <int R>
__device__ __forceinline__ void merge_bitonic(Item (&v)[R], int lane) {
#pragma unroll
  for (int m = R / 2; m >= 1; m >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((r & m) == 0) {
        const Item a = v[r], b = v[r + m];
        v[r] = a < b ? a : b;
        v[r + m] = a < b ? b : a;
      }
    }
  }
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1) {
    const bool lower = (lane & j) == 0;  // the lower lane of a pair keeps the lesser
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const Item o = __shfl_xor_sync(kFullWarp, v[r], j);
      v[r] = (v[r] < o) == lower ? v[r] : o;
    }
  }
}

// The 32 items of a warp, one a lane, sorted ascending across the lanes.
__device__ __forceinline__ Item warp_sort(Item v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k / 2; j >= 1; j >>= 1) {
      const Item o = __shfl_xor_sync(kFullWarp, v, j);
      const bool keep_lesser = ((lane & j) == 0) == ((lane & k) == 0);
      v = (v < o) == keep_lesser ? v : o;
    }
  }
  return v;
}

// The list (sorted, R * 32 items) becomes the least R * 32 of it and the
// warp's 32 items c: against the list's last 32 items, c in descending order
// leaves a bitonic sequence of the least.
template <int R>
__device__ __forceinline__ void list_insert(Item (&v)[R], Item c, int lane) {
  const Item back = __shfl_xor_sync(kFullWarp, warp_sort(c, lane), 31);
  v[R - 1] = back < v[R - 1] ? back : v[R - 1];
  merge_bitonic<R>(v, lane);
}

// Item i of the list, on every lane.
template <int R>
__device__ __forceinline__ Item list_item(const Item (&v)[R], int i) {
  Item x = v[0];
#pragma unroll
  for (int r = 1; r < R; ++r) x = (i >> 5) == r ? v[r] : x;
  return __shfl_sync(kFullWarp, x, i & 31);
}

// One warp: list a becomes the least R * 32 items of sorted lists a and b.
template <int R>
__device__ __forceinline__ void merge_lists(Item* a, const Item* b, int lane) {
  constexpr int L = R * 32;
  Item v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const Item x = a[r * 32 + lane], y = b[L - 1 - r * 32 - lane];
    v[r] = x < y ? x : y;
  }
  merge_bitonic<R>(v, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) a[r * 32 + lane] = v[r];
}

// The whole block: lists[0] becomes the least R * 32 items of the `count`
// sorted lists (shared or device memory), merged pairwise a round at a time.
template <int R>
__device__ void merge_tree(Item* lists, int count) {
  constexpr int L = R * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  __syncthreads();
  for (int step = 1; step < count; step <<= 1) {
    for (int a = 2 * step * warp; a + step < count; a += 2 * step * warps) {
      merge_lists<R>(lists + int64_t{a} * L, lists + int64_t{a + step} * L, lane);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ Item load_volatile(const Item* p) {
  return *reinterpret_cast<const volatile Item*>(p);
}

// Kernel T's first launch: block b takes segment b % segments of row
// b / segments and writes the least L = R * 32 items of it to lists (or, with
// one segment a row, the first k indices to out).  Its 16-byte words [a0, a1)
// go to warp w in batches of 32 (batch i to warp i % kSelectWarps), U batches
// of a warp in flight; the fewer than 2V keys around them go to warp 0's lanes.
template <typename T, int R, int U>
__global__ void __launch_bounds__(kSelectThreads)
    select_segments_kernel(const typename KeyBits<T>::U* __restrict__ x, Item* __restrict__ lists,
                           int32_t* __restrict__ out, int64_t n, int segments, int k,
                           bool largest) {
  using K = typename KeyBits<T>::U;
  constexpr int L = R * 32;
  constexpr int V = 16 / int(sizeof(K));  // keys in a 16-byte word
  constexpr int Q = 32 * V + 32;          // under 32 items left, and a word a lane
  __shared__ Item queues[kSelectWarps][Q];
  __shared__ Item warp_lists[kSelectWarps * L];
  __shared__ Item bound;  // the least k-th item of any warp's list
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x / segments;
  const int seg = int(blockIdx.x % segments);
  const int64_t begin = n * seg / segments, end = n * (seg + 1) / segments;
  const K* keys = x + row * n;
  const int64_t skew =
      int64_t((16 - reinterpret_cast<uintptr_t>(keys + begin) % 16) % 16) / int64_t{sizeof(K)};
  const int64_t a0 = begin + skew < end ? begin + skew : end;
  const int64_t words = (end - a0) / V;
  const int64_t a1 = a0 + words * V;
  if (threadIdx.x == 0) bound = kNoItem;
  __syncthreads();

  Item v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = kNoItem;
  Item theta = kNoItem;  // item k - 1 of this warp's list
  Item* q = queues[warp];
  int count = 0;  // items in the queue, the same on every lane
  auto push = [&](Item c, bool pass) {
    const unsigned m = __ballot_sync(kFullWarp, pass);
    if (pass) q[count + __popc(m & ((1u << lane) - 1u))] = c;
    count += __popc(m);
  };
  auto drain = [&]() {
    __syncwarp();
    while (count >= 32) {
      count -= 32;
      const Item c = q[count + lane];
      __syncwarp();
      list_insert<R>(v, c, lane);
      theta = list_item<R>(v, k - 1);
    }
    if (lane == 0 && theta < load_volatile(&bound)) atomicMin(&bound, theta);
  };

  if (warp == 0) {
    const int64_t head = a0 - begin, around = head + (end - a1);
    const int64_t i = lane < head ? begin + lane : a1 + (lane - head);
    const bool has = lane < around;
    push(has ? select_item(select_key<T>(keys[i], largest), i) : kNoItem, has);
    drain();
  }
  const uint4* word = reinterpret_cast<const uint4*>(keys + a0);
  const int64_t batches = (words + 31) / 32;
  const int64_t step = int64_t{kSelectWarps} * U;
  uint4 w[U], ahead[U];
  auto fetch = [&](int64_t b, uint4 (&to)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t p = (b + int64_t{u} * kSelectWarps) * 32 + lane;
      to[u] = p < words ? __ldcs(word + p) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  fetch(warp, w);
  for (int64_t b = warp; b < batches; b += step) {
    fetch(b + step, ahead);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t p = (b + int64_t{u} * kSelectWarps) * 32 + lane;
      const Item shared_bound = load_volatile(&bound);
      const Item limit = theta < shared_bound ? theta : shared_bound;
      K key[V];
      unpack_word<K, V>(w[u], key);
      Item c[V];
      bool pass[V], any = false;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        c[e] = select_item(select_key<T>(key[e], largest), a0 + p * V + e);
        pass[e] = p < words && c[e] < limit;
        any = any || pass[e];
      }
      if (__any_sync(kFullWarp, any)) {
#pragma unroll
        for (int e = 0; e < V; ++e) push(c[e], pass[e]);
        drain();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = ahead[u];
  }
  __syncwarp();
  if (count > 0) list_insert<R>(v, lane < count ? q[lane] : kNoItem, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) warp_lists[warp * L + r * 32 + lane] = v[r];
  merge_tree<R>(warp_lists, kSelectWarps);
  if (out != nullptr) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) out[row * k + i] = int32_t(uint32_t(warp_lists[i]));
  } else {
    Item* mine = lists + (row * segments + seg) * L;
    for (int i = threadIdx.x; i < L; i += blockDim.x) mine[i] = warp_lists[i];
  }
}

// Kernel T's second launch: block r merges row r's segment lists in place and
// writes the first k indices.
template <int R>
__global__ void __launch_bounds__(kSelectThreads)
    select_merge_kernel(Item* __restrict__ lists, int32_t* __restrict__ out, int segments, int k) {
  constexpr int L = R * 32;
  const int64_t row = blockIdx.x;
  Item* mine = lists + row * segments * L;
  merge_tree<R>(mine, segments);
  for (int i = threadIdx.x; i < k; i += blockDim.x) out[row * k + i] = int32_t(uint32_t(mine[i]));
}

int log2_exact(int64_t v) {
  int l = 0;
  while ((int64_t{1} << l) < v) ++l;
  return l;
}

constexpr int kMaxBlockN = 16384;        // bitonic_sort.py:MAX_BLOCK_N
constexpr int kMaxSharedBytes = 232448;  // dynamic shared memory one sm_90 block may use
constexpr int kBarrierBytes = 8;         // one mbarrier after the slot

bool is_pow2(int64_t v) { return v >= 1 && (v & (v - 1)) == 0; }

// Blocks of `kernel` the current card holds at once (SMs x blocks per SM),
// asked of the runtime once per (kernel, device, threads, shared bytes): the
// occupancy query costs more host time than a launch, and top-k is bound by
// host time.  The first ask for a (kernel, device) raises the kernel's dynamic
// shared memory limit to the most any geometry may use, once: the limit
// belongs to the kernel, so lowering it for one tile width would fail a later
// launch of a wider one whose occupancy is already known.
cudaError_t resident_blocks(const void* kernel, int threads, int smem, int64_t* blocks) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> raised;
  static std::map<std::tuple<const void*, int, int, int>, int64_t> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(kernel, dev, threads, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  if (raised.count({kernel, dev}) == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (e != cudaSuccess) return e;
    raised.insert({kernel, dev});
  }
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = known[key] = int64_t{sms} * per_sm;
  return cudaSuccess;
}

// One persistent block per free slot of the card, at most one per chunk.
template <typename T, bool HAS_RANK, int E, bool SORT>
cudaError_t launch_tile_e(const void* x, const void* r, void* ox, void* orank, int64_t tiles,
                          int64_t n, int block_n, int log_t, int tiles_per_block, int smem,
                          int64_t k_first, int64_t k_last, int64_t f, cudaStream_t stream) {
  using U = typename KeyBits<T>::U;
  auto kernel = SORT ? &sort_kernel<T, HAS_RANK, E> : &merge_kernel<T, HAS_RANK, E>;
  const int threads = tiles_per_block << log_t;
  if (threads > tile_max_threads(E)) return cudaErrorInvalidValue;
  int64_t resident = 0;
  const cudaError_t e =
      resident_blocks(reinterpret_cast<const void*>(kernel), threads, smem, &resident);
  if (e != cudaSuccess) return e;
  const int64_t chunks = (tiles + tiles_per_block - 1) / tiles_per_block;
  const int64_t blocks = chunks < resident ? chunks : resident;
  kernel<<<unsigned(blocks), threads, smem, stream>>>(
      static_cast<const U*>(x), static_cast<const int32_t*>(r), static_cast<U*>(ox),
      static_cast<int32_t*>(orank), tiles, n, block_n, log_t, tiles_per_block, k_first, k_last,
      f);
  return cudaGetLastError();
}

// Validates the stages and the geometry from _tile_geometry before any
// launch: cudaErrorInvalidValue on a mismatch, cudaErrorMisalignedAddress on
// a pointer the bulk copies and vector loads and stores cannot take.  The
// stages are kernel A's (2 .. block_n, f a power of two >= block_n) or kernel
// B's (one stage k > block_n, f 0 or a power of two >= k).
template <typename T, bool HAS_RANK>
cudaError_t launch_tile(const void* x, const void* r, void* ox, void* orank, int64_t rows,
                        int64_t n, int block_n, int64_t k_first, int64_t k_last, int64_t f,
                        int threads_per_tile, int elems, int tiles_per_block, int smem,
                        cudaStream_t stream) {
  using U = typename KeyBits<T>::U;
  const int64_t chunk = int64_t{tiles_per_block} * block_n;
  const int64_t elem_bytes = sizeof(U) + (HAS_RANK ? 4 : 0);
  const bool sort_stages = k_first == 2 && k_last == block_n && f != 0;
  const bool merge_stage = k_first == k_last && is_pow2(k_first) && k_first > block_n;
  const bool ok = is_pow2(block_n) && block_n <= kMaxBlockN && is_pow2(threads_per_tile) &&
                  is_pow2(elems) && elems <= 32 && int64_t{threads_per_tile} * elems == block_n &&
                  threads_per_tile <= 32 * elems && is_pow2(tiles_per_block) &&
                  int64_t{threads_per_tile} * tiles_per_block <= 1024 &&
                  (chunk * int64_t{sizeof(U)}) % 16 == 0 &&
                  int64_t{smem} == chunk * elem_bytes + kBarrierBytes &&
                  smem <= kMaxSharedBytes && is_pow2(n) && n % block_n == 0 &&
                  (sort_stages || merge_stage) && k_last <= n &&
                  (f == 0 || (is_pow2(f) && f >= k_last && f <= n));
  if (!ok) return cudaErrorInvalidValue;
  for (const void* ptr : {x, r, static_cast<const void*>(ox), static_cast<const void*>(orank)}) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorMisalignedAddress;
  }
  const int64_t tiles = rows * (n / block_n);
  if (tiles == 0) return cudaSuccess;
  const int log_t = log2_exact(threads_per_tile);
  switch (elems) {
#define TILE_CASE(E)                                                                       \
  case E:                                                                                  \
    return sort_stages                                                                     \
               ? launch_tile_e<T, HAS_RANK, E, true>(x, r, ox, orank, tiles, n, block_n,   \
                                                     log_t, tiles_per_block, smem, k_first, \
                                                     k_last, f, stream)                    \
               : launch_tile_e<T, HAS_RANK, E, false>(x, r, ox, orank, tiles, n, block_n,  \
                                                      log_t, tiles_per_block, smem,        \
                                                      k_first, k_last, f, stream);
    TILE_CASE(1) TILE_CASE(2) TILE_CASE(4) TILE_CASE(8) TILE_CASE(16) TILE_CASE(32)
#undef TILE_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool HAS_RANK, int S>
cudaError_t launch_span(const void* x, const void* r, void* ox, void* orank, int64_t rows,
                        int64_t n, int64_t j_lo, int64_t k, int64_t f, cudaStream_t stream) {
  using U = typename KeyBits<T>::U;
  const int64_t groups = (rows * n) >> S;
  if (groups == 0) return cudaSuccess;
  const int threads = 256;
  int64_t blocks = (groups + threads - 1) / threads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  global_stage_kernel<T, HAS_RANK, S><<<unsigned(blocks), threads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<const int32_t*>(r), static_cast<U*>(ox),
      static_cast<int32_t*>(orank), groups, log2_exact(n), log2_exact(j_lo), k, f);
  return cudaGetLastError();
}

// Validates the span before any launch (cudaErrorInvalidValue otherwise):
// powers of two with j_lo <= j_hi, 2*j_hi <= k <= n, at most kGlobalSpan
// substages, f 0 or a power of two in [k, n].
template <typename T, bool HAS_RANK>
cudaError_t launch_global(const void* x, const void* r, void* ox, void* orank, int64_t rows,
                          int64_t n, int64_t j_hi, int64_t j_lo, int64_t k, int64_t f,
                          cudaStream_t stream) {
  const bool ok = is_pow2(n) && is_pow2(k) && is_pow2(j_hi) && is_pow2(j_lo) && j_lo <= j_hi &&
                  2 * j_hi <= k && k <= n && (f == 0 || (is_pow2(f) && f >= k && f <= n));
  if (!ok) return cudaErrorInvalidValue;
  static_assert(kGlobalSpan == 4, "one case a span length below");
  switch (log2_exact(j_hi / j_lo) + 1) {
    case 1: return launch_span<T, HAS_RANK, 1>(x, r, ox, orank, rows, n, j_lo, k, f, stream);
    case 2: return launch_span<T, HAS_RANK, 2>(x, r, ox, orank, rows, n, j_lo, k, f, stream);
    case 3: return launch_span<T, HAS_RANK, 3>(x, r, ox, orank, rows, n, j_lo, k, f, stream);
    case 4: return launch_span<T, HAS_RANK, 4>(x, r, ox, orank, rows, n, j_lo, k, f, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Kernel M's one geometry (bitonic_sort.py: MERGE_THREADS, MERGE_ELEMS,
// MERGE_PASSES).  The tile-edge search's latency is paid once a block and
// shared by its passes: on an H100 SXM at 2^24 float32 keys, 256 x 16 took
// 0.087 ms a launch with one tile a block and 0.074 with two; four tiles, 512
// threads, 8 or 32 keys a thread, or the output staged through shared memory
// for coalesced stores, were all slower.
constexpr int kMergeThreads = 256, kMergeElems = 16, kMergePasses = 2;

// Validates before any launch: cudaErrorInvalidValue unless (threads, elems,
// passes) is kernel M's geometry, 2*width a multiple of a block's keys and
// total a multiple of 2*width with at most 2^31 - 1 blocks;
// cudaErrorMisalignedAddress unless both pointers start on 16 bytes.
template <typename T>
cudaError_t launch_merge(const void* x, void* out, int64_t total, int64_t width, int threads,
                         int elems, int passes, cudaStream_t stream) {
  using U = typename KeyBits<T>::U;
  constexpr int64_t tile = int64_t{kMergeThreads} * kMergeElems;
  constexpr int64_t block_keys = tile * kMergePasses;
  const bool ok = threads == kMergeThreads && elems == kMergeElems && passes == kMergePasses &&
                  width >= 1 && (2 * width) % block_keys == 0 && total >= 0 &&
                  total % (2 * width) == 0 && total / block_keys <= INT32_MAX;
  if (!ok) return cudaErrorInvalidValue;
  for (const void* ptr : {x, static_cast<const void*>(out)}) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorMisalignedAddress;
  }
  if (total == 0) return cudaSuccess;
  merge_runs_kernel<T, kMergeThreads, kMergeElems, kMergePasses>
      <<<unsigned(total / block_keys), kMergeThreads, 0, stream>>>(
          static_cast<const U*>(x), static_cast<U*>(out), width, 2 * width / tile);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_select_lists(const void* x, void* lists, void* out, int64_t rows, int64_t n,
                                int segments, int k, bool largest, cudaStream_t stream) {
  using K = typename KeyBits<T>::U;
  constexpr int U = sizeof(K) == 4 ? 4 : 2;  // 16 keys a lane in flight
  select_segments_kernel<T, R, U><<<unsigned(rows * segments), kSelectThreads, 0, stream>>>(
      static_cast<const K*>(x), static_cast<Item*>(lists),
      segments == 1 ? static_cast<int32_t*>(out) : nullptr, n, segments, k, largest);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || segments == 1) return e;
  select_merge_kernel<R><<<unsigned(rows), kSelectThreads, 0, stream>>>(
      static_cast<Item*>(lists), static_cast<int32_t*>(out), segments, k);
  return cudaGetLastError();
}

// Validates before any launch (cudaErrorInvalidValue otherwise): 1 <= k <=
// min(n, list_len), list_len 64, 128 or 256, n below 2^31 (int32 indices),
// 1 <= segments <= n, at most 2^31 - 1 blocks, and scratch for the lists
// unless a row is one segment.  Keys need no alignment.
template <typename T>
cudaError_t launch_select(const void* x, void* lists, void* out, int64_t rows, int64_t n,
                          int segments, int list_len, int k, bool largest, cudaStream_t stream) {
  const bool ok = rows >= 0 && n >= 1 && n <= INT32_MAX && k >= 1 && k <= list_len && k <= n &&
                  segments >= 1 && segments <= n && rows * segments <= INT32_MAX &&
                  (segments == 1 || lists != nullptr);
  if (!ok) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  switch (list_len) {
    case 64: return launch_select_lists<T, 2>(x, lists, out, rows, n, segments, k, largest, stream);
    case 128: return launch_select_lists<T, 4>(x, lists, out, rows, n, segments, k, largest, stream);
    case 256: return launch_select_lists<T, 8>(x, lists, out, rows, n, segments, k, largest, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype codes, as bitonic_sort.py passes them
enum : int { kFloat32 = 0, kInt32 = 1, kFloat16 = 2, kBFloat16 = 3 };

// Calls LAUNCH<key type, HAS_RANK>(args...) for the dtype code.
#define DISPATCH_DTYPE(LAUNCH, HAS_RANK, ...)                                 \
  switch (dtype) {                                                            \
    case kFloat32: return LAUNCH<float, HAS_RANK>(__VA_ARGS__);               \
    case kInt32: return LAUNCH<int32_t, HAS_RANK>(__VA_ARGS__);               \
    case kFloat16: return LAUNCH<__half, HAS_RANK>(__VA_ARGS__);              \
    case kBFloat16: return LAUNCH<__nv_bfloat16, HAS_RANK>(__VA_ARGS__);      \
    default: return cudaErrorInvalidValue;                                    \
  }

template <bool HAS_RANK>
cudaError_t dispatch_tile(int dtype, const void* x, const void* r, void* ox, void* orank,
                          int64_t rows, int64_t n, int block_n, int64_t k_first, int64_t k_last,
                          int64_t f, int threads_per_tile, int elems, int tiles_per_block,
                          int smem, cudaStream_t s) {
  DISPATCH_DTYPE(launch_tile, HAS_RANK, x, r, ox, orank, rows, n, block_n, k_first, k_last, f,
                 threads_per_tile, elems, tiles_per_block, smem, s)
}

template <bool HAS_RANK>
cudaError_t dispatch_global(int dtype, const void* x, const void* r, void* ox, void* orank,
                            int64_t rows, int64_t n, int64_t j_hi, int64_t j_lo, int64_t k,
                            int64_t f, cudaStream_t s) {
  DISPATCH_DTYPE(launch_global, HAS_RANK, x, r, ox, orank, rows, n, j_hi, j_lo, k, f, s)
}

}  // namespace

// Entry points: `r`/`orank` are null for the keys-only kernels.  Each launches
// on `stream` and returns cudaGetLastError() (0 on success).

// Kernels A and B with the geometry _tile_geometry computed for (block_n,
// dtype, ranks): stages k_first .. k_last of every tile, parity mask f.
extern "C" int bitonic_tile_network(int dtype, const void* x, const void* r, void* ox,
                                    void* orank, long long rows, long long n, int block_n,
                                    long long k_first, long long k_last, long long f,
                                    int threads_per_tile, int elems, int tiles_per_block,
                                    int smem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return r ? dispatch_tile<true>(dtype, x, r, ox, orank, rows, n, block_n, k_first, k_last, f,
                                 threads_per_tile, elems, tiles_per_block, smem, s)
           : dispatch_tile<false>(dtype, x, r, ox, orank, rows, n, block_n, k_first, k_last, f,
                                  threads_per_tile, elems, tiles_per_block, smem, s);
}

// Kernel C: substages j_hi .. j_lo of stage k in one pass, parity mask f.
extern "C" int bitonic_global_stage(int dtype, const void* x, const void* r, void* ox,
                                    void* orank, long long rows, long long n, long long j_hi,
                                    long long j_lo, long long k, long long f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return r ? dispatch_global<true>(dtype, x, r, ox, orank, rows, n, j_hi, j_lo, k, f, s)
           : dispatch_global<false>(dtype, x, r, ox, orank, rows, n, j_hi, j_lo, k, f, s);
}

// Kernel M: every pair of adjacent sorted runs of `width` keys in `total`
// keys merged into `out`, `passes` tiles of `threads` x `elems` keys a block.
extern "C" int bitonic_merge_runs(int dtype, const void* x, void* out, long long total,
                                  long long width, int threads, int elems, int passes,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_merge<float>(x, out, total, width, threads, elems, passes, s);
    case kInt32: return launch_merge<int32_t>(x, out, total, width, threads, elems, passes, s);
    case kFloat16: return launch_merge<__half>(x, out, total, width, threads, elems, passes, s);
    case kBFloat16:
      return launch_merge<__nv_bfloat16>(x, out, total, width, threads, elems, passes, s);
    default: return cudaErrorInvalidValue;
  }
}

// Kernel T: the int32 indices of the k best keys of each of `rows` rows of n
// into out (rows x k), best first; `lists` holds rows x segments x list_len
// items of scratch (none for one segment a row).
extern "C" int bitonic_topk_select(int dtype, const void* x, void* lists, void* out,
                                   long long rows, long long n, int segments, int list_len, int k,
                                   int largest, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool l = largest != 0;
  switch (dtype) {
    case kFloat32: return launch_select<float>(x, lists, out, rows, n, segments, list_len, k, l, s);
    case kInt32: return launch_select<int32_t>(x, lists, out, rows, n, segments, list_len, k, l, s);
    case kFloat16: return launch_select<__half>(x, lists, out, rows, n, segments, list_len, k, l, s);
    case kBFloat16:
      return launch_select<__nv_bfloat16>(x, lists, out, rows, n, segments, list_len, k, l, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* bitonic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
