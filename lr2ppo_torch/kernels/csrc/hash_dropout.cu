// Hash dropout for Hopper (sm_90a): y[i] = keep(i) ? x[i] * scale : 0 with
//   keep(i) = fmix32(uint32(i) ^ seed_mix) < threshold,
// murmur3's 32-bit finalizer over the flat row-major position i, and
// seed_mix = uint32(seed) * 0x9E3779B9 computed by the wrapper.
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

template <typename T>
__global__ void __launch_bounds__(256)
    hash_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                        uint32_t seed_mix, uint32_t thr, float scale) {
  constexpr int N = Pack<T>::N;
  const long long packs = n / N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long p = tid; p < packs; p += stride) {
    float v[N];
    Pack<T>::load(x + p * N, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint32_t i = (uint32_t)(p * N + j);
      v[j] = lr2ppo::drop(v[j], fmix32(i ^ seed_mix) < thr, scale);
    }
    Pack<T>::store(y + p * N, v);
  }
  const long long tail = packs * N + tid;
  if (tail < n) {
    const bool keep = fmix32((uint32_t)tail ^ seed_mix) < thr;
    y[tail] = lr2ppo::from_f32<T>(lr2ppo::drop(lr2ppo::to_f32(x[tail]), keep, scale));
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, uint32_t seed_mix, uint32_t thr, float scale,
           cudaStream_t stream) {
  const int threads = 256;
  const unsigned grid = lr2ppo::grid_for(n / Pack<T>::N + 1, threads);
  hash_dropout_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, seed_mix, thr, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x and y are n contiguous values of dtype 0 = float32 or 1 = bfloat16,
// both 16-byte aligned; scale is 1/keep_eff already rounded to the dtype.
int lr2ppo_hash_dropout(const void* x, void* y, long long n, uint32_t seed_mix,
                        uint32_t thr, float scale, int dtype, void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n, seed_mix, thr, scale, s);
  return launch<__nv_bfloat16>(x, y, n, seed_mix, thr, scale, s);
}

}  // extern "C"
