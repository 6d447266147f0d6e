// Philox dropout for Hopper (sm_90a): y[i] = keep(i) ? x[i] * scale : 0 with
//   keep(i) = philox4x32_10(counter = i / 4, key = (seed, 0))[i % 4] <= thr,
// thr = uint32((1 - rate) * 0xFFFFFFFF) and scale = 1/(1 - rate) rounded to
// the dtype, both from the wrapper. i counts from `offset`, a multiple of 4
// that the wrapper derives from the rank's place in the mesh, so ranks that
// hold other parts of one global array draw other counters.
//
// Replaces lr2ppo_tpu/ops/pallas_dropout.py:tpu_dropout (body
// `_dropout_kernel`), which draws its bits from the TPU's hardware PRNG,
// one stream per 256-row block. Hopper has no such generator, so the bits
// come from the counter-based Philox4x32-10 (Salmon et al., SC'11) written
// here; the backward regenerates the same mask from the same seed and runs
// this kernel on the cotangent. The plain PyTorch version is
// lr2ppo_torch/ops/dropout.py:philox_dropout_reference, the same Philox in
// int64 arithmetic: the two are bit-equal.
//
// What bounds it: bytes. Each element is read once and written once (2 x
// 616.6 MB for the 308M-element bfloat16 FFN-inner site, 0.368 ms at
// 3.35 TB/s). One Philox block (10 rounds of 2 32-bit multiplies) serves
// 4 elements, ~20 integer operations each: still well under the integer
// rate at this byte count.
//
// Design: one grid-stride loop; each thread moves 16 bytes per step (4
// float32 values and one Philox block, or 8 bfloat16 values and two), with
// one vector load and one vector store; the mask lives in registers only.
// The ragged tail (fewer than one pack) is done element by element.

#include "common.cuh"

namespace {

using lr2ppo::Pack;

struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox4x32_10(unsigned long long ctr, uint32_t seed) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32), c2 = 0, c3 = 0;
  uint32_t k0 = seed, k1 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return {c0, c1, c2, c3};
}

__device__ __forceinline__ uint32_t word(const U4& b, int j) {
  return j == 0 ? b.x : j == 1 ? b.y : j == 2 ? b.z : b.w;
}

template <typename T>
__global__ void __launch_bounds__(256)
    philox_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                          uint32_t seed, uint32_t thr, float scale,
                          unsigned long long ctr0) {
  constexpr int N = Pack<T>::N;          // a multiple of 4
  const long long packs = n / N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long p = tid; p < packs; p += stride) {
    float v[N];
    Pack<T>::load(x + p * N, v);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const U4 b = philox4x32_10(ctr0 + (unsigned long long)(p * (N / 4) + q), seed);
      v[4 * q + 0] = lr2ppo::drop(v[4 * q + 0], b.x <= thr, scale);
      v[4 * q + 1] = lr2ppo::drop(v[4 * q + 1], b.y <= thr, scale);
      v[4 * q + 2] = lr2ppo::drop(v[4 * q + 2], b.z <= thr, scale);
      v[4 * q + 3] = lr2ppo::drop(v[4 * q + 3], b.w <= thr, scale);
    }
    Pack<T>::store(y + p * N, v);
  }
  const long long tail = packs * N + tid;
  if (tail < n) {
    const U4 b = philox4x32_10(ctr0 + (unsigned long long)(tail / 4), seed);
    const bool keep = word(b, (int)(tail % 4)) <= thr;
    y[tail] = lr2ppo::from_f32<T>(lr2ppo::drop(lr2ppo::to_f32(x[tail]), keep, scale));
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, uint32_t seed, uint32_t thr, float scale,
           unsigned long long ctr0, cudaStream_t stream) {
  const int threads = 256;
  const unsigned grid = lr2ppo::grid_for(n / Pack<T>::N + 1, threads);
  philox_dropout_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, seed, thr, scale, ctr0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x and y are n contiguous values of dtype 0 = float32 or 1 = bfloat16,
// both 16-byte aligned; element i takes the bits of global position
// offset + i (offset >= 0, a multiple of 4).
int lr2ppo_philox_dropout(const void* x, void* y, long long n, uint32_t seed, uint32_t thr,
                          float scale, int dtype, void* stream, long long offset) {
  if (n <= 0 || (dtype != 0 && dtype != 1) || offset < 0 || offset % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long ctr0 = (unsigned long long)(offset / 4);
  if (dtype == 0) return launch<float>(x, y, n, seed, thr, scale, ctr0, s);
  return launch<__nv_bfloat16>(x, y, n, seed, thr, scale, ctr0, s);
}

}  // extern "C"
