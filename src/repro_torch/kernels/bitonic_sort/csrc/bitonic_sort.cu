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
// Design, simple and right first:
//   A / B: one CUDA block per block_n tile; the tile (ranks first, then keys,
//     so the int32 ranks stay aligned) lives in dynamic shared memory; each
//     thread does block_n / 2 / blockDim.x compare-exchanges per substage, with
//     __syncthreads() between substages.  Tiles over 48 KiB raise the dynamic
//     shared memory limit with cudaFuncSetAttribute.  The tile index is folded
//     over (row, block) into blockIdx.x; a block's direction comes from its
//     index *within its row*, as the reference computes it under vmap.
//   C: one thread per compare-exchange pair, grid-stride loop, out of place.
//   Left for later: warp shuffles for j < 32, register-resident tiles,
//   cp.async / TMA loads, fusing C substages that share a tile of L2.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// Kernels A and B (MERGE) on one block_n tile per CUDA block.
template <typename T, bool HAS_RANK, bool MERGE>
__global__ void block_kernel(const T* __restrict__ x, const int32_t* __restrict__ r,
                             T* __restrict__ ox, int32_t* __restrict__ orank,
                             int64_t blocks_per_row, int block_n, int64_t k_merge) {
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
  if constexpr (!MERGE) {
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
  } else {
    // kernel B: substages j = block_n/2 .. 1 of stage k_merge > block_n; the
    // direction is uniform in the block, up iff (block start & k) == 0
    const bool up = ((b * block_n) & k_merge) == 0;
    for (int j = half; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        compare_exchange<T, HAS_RANK>(s_key, s_rank, pair_index(p, j), j, up);
      }
      __syncthreads();
    }
  }

  for (int t = threadIdx.x; t < block_n; t += blockDim.x) {
    ox[base + t] = s_key[t];
    if constexpr (HAS_RANK) orank[base + t] = s_rank[t];
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
                         int64_t n, int block_n, int64_t k_merge, bool merge,
                         cudaStream_t stream) {
  const int64_t blocks_per_row = n / block_n;
  const int64_t tiles = rows * blocks_per_row;
  if (tiles > INT32_MAX) return cudaErrorInvalidConfiguration;
  if (tiles == 0) return cudaSuccess;
  const int threads = block_n / 2 > 1024 ? 1024 : (block_n / 2 < 1 ? 1 : block_n / 2);
  const size_t smem = size_t(block_n) * (sizeof(T) + (HAS_RANK ? sizeof(int32_t) : 0));
  auto kernel = &block_kernel<T, HAS_RANK, false>;
  if (merge) kernel = &block_kernel<T, HAS_RANK, true>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<unsigned(tiles), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(r), static_cast<T*>(ox),
      static_cast<int32_t*>(orank), blocks_per_row, block_n, k_merge);
  return cudaGetLastError();
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

template <bool HAS_RANK>
cudaError_t dispatch_block(int dtype, const void* x, const void* r, void* ox, void* orank,
                           int64_t rows, int64_t n, int block_n, int64_t k, bool merge,
                           cudaStream_t s) {
  switch (dtype) {
    case kFloat32: return launch_block<float, HAS_RANK>(x, r, ox, orank, rows, n, block_n, k, merge, s);
    case kInt32: return launch_block<int32_t, HAS_RANK>(x, r, ox, orank, rows, n, block_n, k, merge, s);
    case kFloat16: return launch_block<__half, HAS_RANK>(x, r, ox, orank, rows, n, block_n, k, merge, s);
    case kBFloat16: return launch_block<__nv_bfloat16, HAS_RANK>(x, r, ox, orank, rows, n, block_n, k, merge, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool HAS_RANK>
cudaError_t dispatch_global(int dtype, const void* x, const void* r, void* ox, void* orank,
                            int64_t rows, int64_t n, int64_t j, int64_t k, cudaStream_t s) {
  switch (dtype) {
    case kFloat32: return launch_global<float, HAS_RANK>(x, r, ox, orank, rows, n, j, k, s);
    case kInt32: return launch_global<int32_t, HAS_RANK>(x, r, ox, orank, rows, n, j, k, s);
    case kFloat16: return launch_global<__half, HAS_RANK>(x, r, ox, orank, rows, n, j, k, s);
    case kBFloat16: return launch_global<__nv_bfloat16, HAS_RANK>(x, r, ox, orank, rows, n, j, k, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Entry points: `r`/`orank` are null for the keys-only kernels.  Each launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int bitonic_block_sort(int dtype, const void* x, const void* r, void* ox,
                                  void* orank, long long rows, long long n, int block_n,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return r ? dispatch_block<true>(dtype, x, r, ox, orank, rows, n, block_n, 0, false, s)
           : dispatch_block<false>(dtype, x, r, ox, orank, rows, n, block_n, 0, false, s);
}

extern "C" int bitonic_block_merge(int dtype, const void* x, const void* r, void* ox,
                                   void* orank, long long rows, long long n, int block_n,
                                   long long k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return r ? dispatch_block<true>(dtype, x, r, ox, orank, rows, n, block_n, k, true, s)
           : dispatch_block<false>(dtype, x, r, ox, orank, rows, n, block_n, k, true, s);
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
