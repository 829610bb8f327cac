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
// Bound: each launch reads its keys (and ranks) once and writes them once,
// 2*n*sizeof(key) bytes (+ 2*n*4 with ranks); the compare-exchanges are a few
// integer/float ops per element per substage, far below the card's op rate, so
// every kernel is bound by bytes (3.35 TB/s on an H100 SXM).
//
// A / A-kv (block_kernel): one CUDA block per block_n tile; the tile (ranks
//   first, then keys, so the int32 ranks stay aligned) lives in dynamic shared
//   memory; each thread does block_n / 2 / blockDim.x compare-exchanges per
//   substage, with __syncthreads() between substages.  Tiles over 48 KiB raise
//   the dynamic shared memory limit with cudaFuncSetAttribute.  The tile index
//   is folded over (row, block) into blockIdx.x; a block's direction comes from
//   its index *within its row*, as the reference computes it under vmap.
//
// B / B-kv (merge_kernel): the log2(block_n) substages of one tile are a few
//   operations per byte, so the kernel has to move the tile at the memory's
//   rate and keep the network out of its way.  A network that makes one pass
//   through shared memory per substage (with a barrier, half the threads idle)
//   does not: it reached a third of the byte rate.  So the tile lives in
//   registers, T threads holding E keys (and ranks) each, T * E = block_n:
//   - strided layout, thread t holds elements t + T*e: every substage j >= T is
//     a compare-exchange between two registers of one thread;
//   - one transpose through shared memory into the contiguous layout, thread t
//     holding E*t + e; the buffer is XOR-swizzled inside each E-element group
//     by its 128-byte row, so the strided write (a warp on 32 neighbours) and
//     the contiguous read (lane l on element E*l + e) hit 32 different banks;
//   - E <= j < T is a __shfl_xor_sync at lane distance j/E (T <= 32*E keeps the
//     partner in the warp); both lanes compute gt with the lower index's element
//     as `a`, so they agree on ties and +-0 lands where the plain network puts it;
//   - j < E is again between registers.
//   Tiles arrive by 1-D bulk copies (cp.async.bulk, completion on an mbarrier)
//   into a ring of one or two slots of a persistent block, so the next tile
//   loads while this one runs its network; stores are 16-byte vectors from the
//   contiguous registers.  Tiles narrower than 128 threads' worth are packed
//   several to a block; a tile's direction comes from its flat start index.  A
//   ragged last chunk whose size is not a multiple of 16 bytes is loaded by the
//   block itself.  The geometry (T, E, tiles per block, slots, shared bytes)
//   comes from bitonic_sort.py:_merge_geometry and is validated here.
//
// C / C-kv: one thread per compare-exchange pair, grid-stride loop, out of place.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

namespace {

__device__ __forceinline__ float cmp_value(float v) { return v; }
__device__ __forceinline__ int32_t cmp_value(int32_t v) { return v; }
__device__ __forceinline__ float cmp_value(__half v) { return __half2float(v); }
__device__ __forceinline__ float cmp_value(__nv_bfloat16 v) { return __bfloat162float(v); }

// Compare-exchange of keys[i] and keys[i + j] (and their ranks) in place.
template <typename T, bool HAS_RANK>
__device__ __forceinline__ void compare_exchange(T* keys, int32_t* ranks, int i, int j,
                                                 bool dir_up) {
  const T a = keys[i];
  const T b = keys[i + j];
  const auto ca = cmp_value(a);
  const auto cb = cmp_value(b);
  bool gt = ca > cb;
  int32_t ra = 0, rb = 0;
  if constexpr (HAS_RANK) {
    ra = ranks[i];
    rb = ranks[i + j];
    gt = gt || (ca == cb && ra > rb);
  }
  if (gt == dir_up) {
    keys[i] = b;
    keys[i + j] = a;
    if constexpr (HAS_RANK) {
      ranks[i] = rb;
      ranks[i + j] = ra;
    }
  }
}

// Position of the first element of compare-exchange pair p at distance j:
// pairs are numbered group by group, j pairs to a group of 2j elements.
template <typename I>
__device__ __forceinline__ I pair_index(I p, I j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// Kernel A on one block_n tile per CUDA block.
template <typename T, bool HAS_RANK>
__global__ void block_kernel(const T* __restrict__ x, const int32_t* __restrict__ r,
                             T* __restrict__ ox, int32_t* __restrict__ orank,
                             int64_t blocks_per_row, int block_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_rank = reinterpret_cast<int32_t*>(smem);
  T* s_key = reinterpret_cast<T*>(smem + (HAS_RANK ? sizeof(int32_t) * block_n : 0));

  const int64_t tile = blockIdx.x;
  const int64_t b = tile % blocks_per_row;  // block index within its row
  const int64_t base = tile * block_n;

  for (int t = threadIdx.x; t < block_n; t += blockDim.x) {
    s_key[t] = x[base + t];
    if constexpr (HAS_RANK) s_rank[t] = r[base + t];
  }
  __syncthreads();

  const int half = block_n >> 1;
  // kernel A: full network, block b ascending iff b is even
  const bool asc = (b & 1) == 0;
  for (int k = 2; k <= block_n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = pair_index(p, j);
        compare_exchange<T, HAS_RANK>(s_key, s_rank, i, j, ((i & k) == 0) == asc);
      }
      __syncthreads();
    }
  }

  for (int t = threadIdx.x; t < block_n; t += blockDim.x) {
    ox[base + t] = s_key[t];
    if constexpr (HAS_RANK) orank[base + t] = s_rank[t];
  }
}

// ---------------------------------------------------------------- kernel B ---
// The merge kernel moves keys as raw bits (U) and converts only to compare.
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

// Threads a merge block may have for E keys a thread (its __launch_bounds__);
// _merge_geometry never asks for more.
__host__ __device__ constexpr int merge_max_threads(int e) { return e <= 4 ? 128 : (e == 8 ? 256 : 512); }

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

// Kernel B: substages j = block_n/2 .. 1 of stage k > block_n on every tile;
// a tile whose flat start s has (s & k_mask) == 0 sorts up (k_mask is k, or 0
// when k == n, where no tile start within a row has the bit).  A block walks
// over chunks of `tiles_per_block` tiles; `1 << log_t` threads work on a tile.
template <typename T, bool HAS_RANK, int E>
__global__ void __launch_bounds__(merge_max_threads(E))
    merge_kernel(const typename KeyBits<T>::U* __restrict__ x, const int32_t* __restrict__ r,
                 typename KeyBits<T>::U* __restrict__ ox, int32_t* __restrict__ orank,
                 int64_t tiles, int block_n, int log_t, int tiles_per_block, int slots,
                 int64_t k_mask) {
  using U = typename KeyBits<T>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = tiles_per_block * block_n;  // elements of one ring slot
  const int key_bytes = chunk * int(sizeof(U));
  const int slot_bytes = key_bytes + (HAS_RANK ? chunk * 4 : 0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + slots * slot_bytes);
  const int64_t chunks = (tiles + tiles_per_block - 1) / tiles_per_block;
  const int tid = threadIdx.x;
  const int p = tid >> log_t;               // tile within the chunk
  const int t = tid & ((1 << log_t) - 1);   // thread within the tile

  // elements in chunk c: fewer in a ragged last chunk
  auto chunk_len = [&](int64_t c) {
    const int64_t left = (tiles - c * tiles_per_block) * block_n;
    return left < chunk ? int(left) : chunk;
  };
  // thread 0: start the bulk copy of chunk c into slot s, unless its size is
  // not a multiple of 16 bytes (then the block loads it itself)
  auto start_load = [&](int64_t c, int s) {
    const int len = chunk_len(c);
    if ((len * int(sizeof(U))) % 16) return;
    unsigned char* dst = smem + s * slot_bytes;
    mbar_expect_tx(&bar[s], len * (int(sizeof(U)) + (HAS_RANK ? 4 : 0)));
    bulk_load(dst, x + c * chunk, len * sizeof(U), &bar[s]);
    if constexpr (HAS_RANK) bulk_load(dst + key_bytes, r + c * chunk, len * 4, &bar[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      const int64_t c = blockIdx.x + int64_t{s} * gridDim.x;
      if (c < chunks) start_load(c, s);
    }
  }

  int it = 0;
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x, ++it) {
    const int s = slots == 1 ? 0 : (it & 1);
    U* sk = reinterpret_cast<U*>(smem + s * slot_bytes);
    int32_t* sr = reinterpret_cast<int32_t*>(smem + s * slot_bytes + key_bytes);
    const int64_t first = c * chunk;
    const int len = chunk_len(c);
    if ((len * int(sizeof(U))) % 16 == 0) {
      mbar_wait(&bar[s], (slots == 1 ? it : it >> 1) & 1);
    } else {
      for (int i = tid; i < len; i += blockDim.x) {
        sk[i] = x[first + i];
        if constexpr (HAS_RANK) sr[i] = r[first + i];
      }
      __syncthreads();
    }

    U k[E];
    int32_t rk[E];
    const int sbase = p * block_n + t;  // strided layout: element sbase + (e << log_t)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      k[e] = sk[sbase + (e << log_t)];
      rk[e] = HAS_RANK ? sr[sbase + (e << log_t)] : 0;
    }
    const bool up = ((first + int64_t{p} * block_n) & k_mask) == 0;

    // j = T*m >= T: registers e and e + m
#pragma unroll
    for (int m = E / 2; m >= 1; m >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((e & m) == 0) ce_regs<T, HAS_RANK, E>(k, rk, e, e + m, up);
      }
    }

    // transpose through the slot into the contiguous layout: element cbase + e
    __syncthreads();  // every thread has read its strided elements
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = sbase + (e << log_t);
      sk[swizzle<sizeof(U), E>(i)] = k[e];
      if constexpr (HAS_RANK) sr[swizzle<4, E>(i)] = rk[e];
    }
    __syncthreads();
    const int cbase = tid * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      k[e] = sk[swizzle<sizeof(U), E>(cbase + e)];
      if constexpr (HAS_RANK) rk[e] = sr[swizzle<4, E>(cbase + e)];
    }
    // the slot's reads and writes come before the next bulk copy into it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0 && c + int64_t{slots} * gridDim.x < chunks) start_load(c + int64_t{slots} * gridDim.x, s);

    // E <= j < T: the partner is lane ^ d, d = j / E; both lanes compare
    // (lower index's element, upper index's element)
    for (int d = (1 << log_t) / (2 * E); d >= 1; d >>= 1) {
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

    // j < min(E, T): registers e and e + j (j >= T was done strided)
#pragma unroll
    for (int j = E / 2; j >= 1; j >>= 1) {
      if (j < (1 << log_t)) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & j) == 0) ce_regs<T, HAS_RANK, E>(k, rk, e, e + j, up);
        }
      }
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

// Kernel C: one cross-block substage at distance j of stage k, over all rows.
template <typename T, bool HAS_RANK>
__global__ void global_stage_kernel(const T* __restrict__ x, const int32_t* __restrict__ r,
                                    T* __restrict__ ox, int32_t* __restrict__ orank,
                                    int64_t pairs, int log_half_n, int64_t j, int64_t k) {
  const int64_t half_n = int64_t{1} << log_half_n;
  const int64_t stride = int64_t{gridDim.x} * blockDim.x;
  for (int64_t p = int64_t{blockIdx.x} * blockDim.x + threadIdx.x; p < pairs; p += stride) {
    const int64_t row = p >> log_half_n;
    const int64_t i = pair_index(p & (half_n - 1), j);  // index within the row
    const bool dir_up = (i & k) == 0;                  // ((m*2j)//k) % 2 == 0
    const int64_t ia = (row << (log_half_n + 1)) + i;
    const int64_t ib = ia + j;
    const T a = x[ia];
    const T b = x[ib];
    const auto ca = cmp_value(a);
    const auto cb = cmp_value(b);
    bool gt = ca > cb;
    int32_t ra = 0, rb = 0;
    if constexpr (HAS_RANK) {
      ra = r[ia];
      rb = r[ib];
      gt = gt || (ca == cb && ra > rb);
    }
    const bool swap = gt == dir_up;
    ox[ia] = swap ? b : a;
    ox[ib] = swap ? a : b;
    if constexpr (HAS_RANK) {
      orank[ia] = swap ? rb : ra;
      orank[ib] = swap ? ra : rb;
    }
  }
}

int log2_exact(int64_t v) {
  int l = 0;
  while ((int64_t{1} << l) < v) ++l;
  return l;
}

template <typename T, bool HAS_RANK>
cudaError_t launch_block(const void* x, const void* r, void* ox, void* orank, int64_t rows,
                         int64_t n, int block_n, cudaStream_t stream) {
  const int64_t blocks_per_row = n / block_n;
  const int64_t tiles = rows * blocks_per_row;
  if (tiles > INT32_MAX) return cudaErrorInvalidConfiguration;
  if (tiles == 0) return cudaSuccess;
  const int threads = block_n / 2 > 1024 ? 1024 : (block_n / 2 < 1 ? 1 : block_n / 2);
  const size_t smem = size_t(block_n) * (sizeof(T) + (HAS_RANK ? sizeof(int32_t) : 0));
  auto kernel = &block_kernel<T, HAS_RANK>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<unsigned(tiles), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(r), static_cast<T*>(ox),
      static_cast<int32_t*>(orank), blocks_per_row, block_n);
  return cudaGetLastError();
}

constexpr int kMaxBlockN = 16384;        // bitonic_sort.py:MAX_BLOCK_N
constexpr int kMaxSharedBytes = 232448;  // dynamic shared memory one sm_90 block may use
constexpr int kBarrierBytes = 16;        // two mbarriers after the ring

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
template <typename T, bool HAS_RANK, int E>
cudaError_t launch_merge_e(const void* x, const void* r, void* ox, void* orank, int64_t tiles,
                           int block_n, int log_t, int tiles_per_block, int slots, int smem,
                           int64_t k_mask, cudaStream_t stream) {
  using U = typename KeyBits<T>::U;
  auto kernel = &merge_kernel<T, HAS_RANK, E>;
  const int threads = tiles_per_block << log_t;
  if (threads > merge_max_threads(E)) return cudaErrorInvalidValue;
  int64_t resident = 0;
  const cudaError_t e =
      resident_blocks(reinterpret_cast<const void*>(kernel), threads, smem, &resident);
  if (e != cudaSuccess) return e;
  const int64_t chunks = (tiles + tiles_per_block - 1) / tiles_per_block;
  const int64_t blocks = chunks < resident ? chunks : resident;
  kernel<<<unsigned(blocks), threads, smem, stream>>>(
      static_cast<const U*>(x), static_cast<const int32_t*>(r), static_cast<U*>(ox),
      static_cast<int32_t*>(orank), tiles, block_n, log_t, tiles_per_block, slots, k_mask);
  return cudaGetLastError();
}

// Validates the geometry from _merge_geometry before any launch:
// cudaErrorInvalidValue on a mismatch, cudaErrorMisalignedAddress on a pointer
// the bulk copies and vector stores cannot take.
template <typename T, bool HAS_RANK>
cudaError_t launch_merge(const void* x, const void* r, void* ox, void* orank, int64_t rows,
                         int64_t n, int block_n, int64_t k, int threads_per_tile, int elems,
                         int tiles_per_block, int slots, int smem, cudaStream_t stream) {
  using U = typename KeyBits<T>::U;
  const int64_t chunk = int64_t{tiles_per_block} * block_n;
  const int64_t elem_bytes = sizeof(U) + (HAS_RANK ? 4 : 0);
  const bool ok = is_pow2(block_n) && block_n <= kMaxBlockN && is_pow2(threads_per_tile) &&
                  is_pow2(elems) && elems <= 32 && int64_t{threads_per_tile} * elems == block_n &&
                  threads_per_tile <= 32 * elems && is_pow2(tiles_per_block) &&
                  int64_t{threads_per_tile} * tiles_per_block <= 1024 &&
                  (chunk * int64_t{sizeof(U)}) % 16 == 0 && (slots == 1 || slots == 2) &&
                  int64_t{smem} == slots * chunk * elem_bytes + kBarrierBytes &&
                  smem <= kMaxSharedBytes && is_pow2(n) && n % block_n == 0 && is_pow2(k) &&
                  k > block_n && k <= n;
  if (!ok) return cudaErrorInvalidValue;
  for (const void* ptr : {x, r, static_cast<const void*>(ox), static_cast<const void*>(orank)}) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorMisalignedAddress;
  }
  const int64_t tiles = rows * (n / block_n);
  if (tiles == 0) return cudaSuccess;
  const int log_t = log2_exact(threads_per_tile);
  const int64_t k_mask = k < n ? k : 0;
  switch (elems) {
#define MERGE_CASE(E)                                                                      \
  case E:                                                                                  \
    return launch_merge_e<T, HAS_RANK, E>(x, r, ox, orank, tiles, block_n, log_t,          \
                                          tiles_per_block, slots, smem, k_mask, stream);
    MERGE_CASE(1) MERGE_CASE(2) MERGE_CASE(4) MERGE_CASE(8) MERGE_CASE(16) MERGE_CASE(32)
#undef MERGE_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool HAS_RANK>
cudaError_t launch_global(const void* x, const void* r, void* ox, void* orank, int64_t rows,
                          int64_t n, int64_t j, int64_t k, cudaStream_t stream) {
  const int64_t pairs = rows * (n / 2);
  if (pairs == 0) return cudaSuccess;
  const int threads = 256;
  int64_t blocks = (pairs + threads - 1) / threads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  global_stage_kernel<T, HAS_RANK><<<unsigned(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(r), static_cast<T*>(ox),
      static_cast<int32_t*>(orank), pairs, log2_exact(n / 2), j, k);
  return cudaGetLastError();
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
cudaError_t dispatch_block(int dtype, const void* x, const void* r, void* ox, void* orank,
                           int64_t rows, int64_t n, int block_n, cudaStream_t s) {
  DISPATCH_DTYPE(launch_block, HAS_RANK, x, r, ox, orank, rows, n, block_n, s)
}

template <bool HAS_RANK>
cudaError_t dispatch_merge(int dtype, const void* x, const void* r, void* ox, void* orank,
                           int64_t rows, int64_t n, int block_n, int64_t k, int threads_per_tile,
                           int elems, int tiles_per_block, int slots, int smem, cudaStream_t s) {
  DISPATCH_DTYPE(launch_merge, HAS_RANK, x, r, ox, orank, rows, n, block_n, k, threads_per_tile,
                 elems, tiles_per_block, slots, smem, s)
}

template <bool HAS_RANK>
cudaError_t dispatch_global(int dtype, const void* x, const void* r, void* ox, void* orank,
                            int64_t rows, int64_t n, int64_t j, int64_t k, cudaStream_t s) {
  DISPATCH_DTYPE(launch_global, HAS_RANK, x, r, ox, orank, rows, n, j, k, s)
}

}  // namespace

// Entry points: `r`/`orank` are null for the keys-only kernels.  Each launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int bitonic_block_sort(int dtype, const void* x, const void* r, void* ox,
                                  void* orank, long long rows, long long n, int block_n,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return r ? dispatch_block<true>(dtype, x, r, ox, orank, rows, n, block_n, s)
           : dispatch_block<false>(dtype, x, r, ox, orank, rows, n, block_n, s);
}

// Kernel B with the geometry _merge_geometry computed for (block_n, dtype, ranks).
extern "C" int bitonic_block_merge(int dtype, const void* x, const void* r, void* ox,
                                   void* orank, long long rows, long long n, int block_n,
                                   long long k, int threads_per_tile, int elems,
                                   int tiles_per_block, int slots, int smem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return r ? dispatch_merge<true>(dtype, x, r, ox, orank, rows, n, block_n, k, threads_per_tile,
                                  elems, tiles_per_block, slots, smem, s)
           : dispatch_merge<false>(dtype, x, r, ox, orank, rows, n, block_n, k, threads_per_tile,
                                   elems, tiles_per_block, slots, smem, s);
}

extern "C" int bitonic_global_stage(int dtype, const void* x, const void* r, void* ox,
                                    void* orank, long long rows, long long n, long long j,
                                    long long k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return r ? dispatch_global<true>(dtype, x, r, ox, orank, rows, n, j, k, s)
           : dispatch_global<false>(dtype, x, r, ox, orank, rows, n, j, k, s);
}

extern "C" const char* bitonic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
