// Hash dropout for Hopper (sm_90a): y[i] = keep(i) ? x[i] * scale : 0 with
//   keep(i) = fmix32(uint32(i) ^ seed_mix) < threshold,
// murmur3's 32-bit finalizer over the flat row-major position i in the
// GLOBAL array, and seed_mix = uint32(seed) * 0x9E3779B9 computed by the
// wrapper.
//
// The global-index form: x is taken as rows of `w` values, part of a global
// array of rows of `width` values, at row `row0` and column `col0`; local
// element f = r * w + c sits at global position
//   i = (row0 + r) * width + col0 + c  (mod 2^32),
// so a rank holding a data-parallel slice of the batch (row0 its first row)
// or a tensor-parallel column slice (col0 its first column) draws the mask
// JAX draws for those elements of the whole array. A whole local tensor is
// row0 = col0 = 0, width = w: i = f. Where col0 = 0 and width = w the index
// is row0 * w + f, one add (the fast path); otherwise each 16-byte pack
// divides once and steps (r, c) across row ends.
//
// Replaces lr2ppo_tpu/ops/hash_dropout.py:hash_dropout (`_apply`), which
// is jnp that XLA fuses, not Pallas. The plain PyTorch version is
// lr2ppo_torch/ops/hash_dropout.py:hash_dropout_reference; forward and
// backward (the same mask on the cotangent) both launch this kernel.
//
// What bounds it: bytes. Each element is read once and written once (2 x
// 616.6 MB for the 308M-element bfloat16 FFN-inner site of the PPO update,
// 0.368 ms at 3.35 TB/s) against ~10 integer operations, far below the
// card's integer rate.
//
// Design: one grid-stride loop; each thread moves 16 bytes per step (4
// float32 or 8 bfloat16 values) with one vector load and one vector store,
// neighbouring threads on neighbouring addresses; the mask is computed in
// registers and never stored. The ragged tail (fewer than one pack) is
// done element by element by the first threads of the grid.

#include "common.cuh"

namespace {

using lr2ppo::Pack;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The shard's place in the global array (see above).
struct Place {
  uint32_t row0, col0, width;
  long long w;
};

// Global position of local element f (the general path).
__device__ __forceinline__ uint32_t global_index(const Place& g, long long r, long long c) {
  return (g.row0 + (uint32_t)r) * g.width + g.col0 + (uint32_t)c;
}

template <typename T, bool kSplit>
__global__ void __launch_bounds__(256)
    hash_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                        uint32_t seed_mix, uint32_t thr, float scale, Place g) {
  constexpr int N = Pack<T>::N;
  const long long packs = n / N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t base = g.row0 * g.width;  // the fast path's offset
  for (long long p = tid; p < packs; p += stride) {
    float v[N];
    Pack<T>::load(x + p * N, v);
    if (kSplit) {
      long long r = (p * N) / g.w, c = p * N - r * g.w;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const uint32_t i = global_index(g, r, c);
        v[j] = lr2ppo::drop(v[j], fmix32(i ^ seed_mix) < thr, scale);
        if (++c == g.w) {
          c = 0;
          ++r;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const uint32_t i = base + (uint32_t)(p * N + j);
        v[j] = lr2ppo::drop(v[j], fmix32(i ^ seed_mix) < thr, scale);
      }
    }
    Pack<T>::store(y + p * N, v);
  }
  const long long tail = packs * N + tid;
  if (tail < n) {
    const uint32_t i = kSplit ? global_index(g, tail / g.w, tail % g.w) : base + (uint32_t)tail;
    const bool keep = fmix32(i ^ seed_mix) < thr;
    y[tail] = lr2ppo::from_f32<T>(lr2ppo::drop(lr2ppo::to_f32(x[tail]), keep, scale));
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, uint32_t seed_mix, uint32_t thr, float scale,
           const Place& g, cudaStream_t stream) {
  const int threads = 256;
  const unsigned grid = lr2ppo::grid_for(n / Pack<T>::N + 1, threads);
  const bool split = g.col0 != 0 || (long long)g.width != g.w;
  if (split)
    hash_dropout_kernel<T, true><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, seed_mix, thr, scale, g);
  else
    hash_dropout_kernel<T, false><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, seed_mix, thr, scale, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x and y are n contiguous values of dtype 0 = float32 or 1 = bfloat16,
// both 16-byte aligned; scale is 1/keep_eff already rounded to the dtype.
// x is rows of w values at (row0, col0) of a global array `width` wide (all
// taken mod 2^32); a whole tensor passes row0 = col0 = 0, width = w.
int lr2ppo_hash_dropout(const void* x, void* y, long long n, uint32_t seed_mix,
                        uint32_t thr, float scale, int dtype, void* stream,
                        uint32_t row0, uint32_t col0, uint32_t width, long long w) {
  if (n <= 0 || (dtype != 0 && dtype != 1) || w <= 0 || n % w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Place g{row0, col0, width, w};
  if (dtype == 0) return launch<float>(x, y, n, seed_mix, thr, scale, g, s);
  return launch<__nv_bfloat16>(x, y, n, seed_mix, thr, scale, g, s);
}

}  // extern "C"
