// Narrow-output int8 GEMM with per-row dynamic quantization, for Hopper
// (sm_90a):
//   y = (q(x) s8 . W s8 -> s32) * sx * sw,   sx = max(amax_row, 1e-8) / 127
// where q rounds x / sx half to even and clips to +-127; W is (N, K) int8 with
// a float32 scale per output column; the accumulation is exact in int32
// (127 * 127 * K < 2^31 for every K the shape gate admits).
//
// Replaces lr2ppo_tpu/ops/pallas_int8_matmul.py:pallas_int8_matmul (body
// `_kernel`). The plain PyTorch version is
// lr2ppo_torch/ops/int8_matmul.py:int8_matmul_reference; this kernel
// reproduces its arithmetic operation for operation and is bit-equal to it.
//
// What bounds it. At the rollout's fc2 site (rows = 100,352, K = 3072,
// N = 768, bf16 in and out) one call is 2 * rows * K * N = 473.5 G integer
// operations against 617 MB of x, 154 MB of y and 2.4 MB of W: 0.239 ms at
// the int8 tensor-core peak, 0.231 ms at the memory rate. Both bounds are
// close, so a fast version has to keep the tensor cores busy while it
// streams x once.
//
// Design (simple and right first):
//   * one block per (BM = 128 rows, BN = 128 columns) output tile, 8 warps
//     of 32 rows x 64 columns; the column tiles of one row block are
//     neighbours in the grid, so they read that block's x rows from L2;
//   * prologue: each row's amax over the whole K (the TPU kernel holds the
//     (512, K) block in VMEM; shared memory cannot hold it at large K);
//   * K streamed in tiles of BK = 64: the x tile is quantized as it is
//     staged into shared memory as int8, the W tile copied beside it, and
//     mma.sync m16n8k32 s8 products accumulate in registers. W is read in
//     its (N, K) row-major layout, which is mma's K-contiguous "col"
//     operand as it stands;
//   * epilogue: (acc * sx) * sw rounded once to the out dtype; rows past the
//     end are neither read nor written.
// Every shape with K and N multiples of 128 launches (16 KB of static shared
// memory); the wrapper's gate (`supported`) is the JAX package's.
// What this leaves on the table: x is read twice per column tile (amax, then
// staging), loads and products do not overlap inside a block, and mma.sync
// reaches a fraction of what wgmma with TMA would.
//
// Numerics: built with -fmad=false, written with __fmul_rn/__fdiv_rn; the
// scale is a true division. Never build with --use_fast_math.

#include "common.cuh"

namespace {

using lr2ppo::mma_s8;
using lr2ppo::Pack;
using lr2ppo::quant;
using lr2ppo::row_scale;
using lr2ppo::store2;
using lr2ppo::warp_max;

constexpr int BM = 128;              // rows per block
constexpr int BN = 128;              // columns per block
constexpr int BK = 64;               // K bytes per staged tile; a 64-byte row
                                     // stride keeps fragment loads free of
                                     // bank conflicts
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MT = 2;                // m16 tiles per warp: 32 rows
constexpr int NT = 8;                // n8 tiles per warp: 64 columns

// N (= Pack<T>::N, 4 or 8) int8 values packed into N / 4 words, low byte
// first, and stored at once.
template <int N>
__device__ __forceinline__ void store_q(int8_t* dst, const float (&v)[N], float sc) {
  uint32_t w[N / 4] = {};
#pragma unroll
  for (int i = 0; i < N; ++i)
    w[i / 4] |= (uint32_t)(quant(v[i], sc) & 0xFF) << (8 * (i % 4));
  if constexpr (N == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = w[0];
}

template <int N>
__device__ __forceinline__ void store_zero(int8_t* dst) {
  if constexpr (N == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  else
    *reinterpret_cast<uint32_t*>(dst) = 0u;
}

// (acc * row_scale) * col_scale
__device__ __forceinline__ float rescale(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
    int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ ws, O* __restrict__ y, long long rows, int k,
                       int n) {
  using P = Pack<T>;
  __shared__ __align__(16) int8_t as[BM * BK];
  __shared__ __align__(16) int8_t bs[BN * BK];
  __shared__ float xs[BM];

  const int ntiles = n / BN;
  const long long row0 = (long long)(blockIdx.x / ntiles) * BM;
  const int col0 = (int)(blockIdx.x % ntiles) * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // 1. every row's scale from its amax over the whole K
  for (int r = warp; r < BM; r += WARPS) {
    const long long gr = row0 + r;
    float amax = 0.0f;
    if (gr < rows) {
      const T* xr = x + gr * k;
      for (int c = lane * P::N; c < k; c += 32 * P::N) {
        float v[P::N];
        P::load(xr + c, v);
#pragma unroll
        for (int i = 0; i < P::N; ++i) amax = fmaxf(amax, fabsf(v[i]));
      }
    }
    amax = warp_max(amax);
    if (lane == 0) xs[r] = row_scale(amax);
  }
  __syncthreads();

  const int wm = warp >> 1, wn = warp & 1;   // 4 x 2 warps
  int acc[MT][NT][4] = {};
  for (int k0 = 0; k0 < k; k0 += BK) {
    // 2. stage the x tile quantized (rows past the end as 0) and the W tile
    for (int e = threadIdx.x * P::N; e < BM * BK; e += THREADS * P::N) {
      const int r = e / BK, c = e % BK;
      const long long gr = row0 + r;
      if (gr < rows) {
        float v[P::N];
        P::load(x + gr * k + k0 + c, v);
        store_q<P::N>(as + e, v, xs[r]);
      } else {
        store_zero<P::N>(as + e);
      }
    }
    for (int e = threadIdx.x; e < BN * BK / 16; e += THREADS) {
      const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
      *reinterpret_cast<int4*>(bs + r * BK + c) =
          __ldg(reinterpret_cast<const int4*>(w + (size_t)(col0 + r) * k + k0 + c));
    }
    __syncthreads();

    // 3. the products. K is permuted inside the 64-wide tile, identically
    // for A and B, so each thread reads 16 contiguous bytes of each operand
    // (int8_mlp.cu:gemm_group): the first k-step takes bytes t*16+0..7, the
    // second t*16+8..15. An integer sum does not depend on the order of its
    // terms.
    int4 a[MT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      a[mi][0] = *reinterpret_cast<const int4*>(as + r * BK + t * 16);
      a[mi][1] = *reinterpret_cast<const int4*>(as + (r + 8) * BK + t * 16);
    }
#pragma unroll
    for (int nj = 0; nj < NT; ++nj) {
      const int4 b = *reinterpret_cast<const int4*>(bs + (wn * 64 + nj * 8 + g) * BK + t * 16);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_s8(acc[mi][nj], a[mi][0].x, a[mi][1].x, a[mi][0].y, a[mi][1].y, b.x, b.y);
        mma_s8(acc[mi][nj], a[mi][0].z, a[mi][1].z, a[mi][0].w, a[mi][1].w, b.z, b.w);
      }
    }
    __syncthreads();   // the next tile overwrites as and bs
  }

  // 4. epilogue: c0, c1 are row g, columns 2t and 2t + 1 of the n8 tile;
  // c2, c3 the same columns of row g + 8
#pragma unroll
  for (int nj = 0; nj < NT; ++nj) {
    const int c = col0 + wn * 64 + nj * 8 + t * 2;
    const float cs0 = ws[c], cs1 = ws[c + 1];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + mi * 16 + g + half * 8;
        const long long gr = row0 + r;
        if (gr < rows)
          store2<O>(y + gr * n + c, rescale(acc[mi][nj][2 * half], xs[r], cs0),
                    rescale(acc[mi][nj][2 * half + 1], xs[r], cs1));
      }
    }
  }
}

template <typename T, typename O>
int launch(const void* x, const void* w, const void* ws, void* y, long long rows, int k, int n,
           cudaStream_t stream) {
  const long long blocks = (rows + BM - 1) / BM * (n / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int8_matmul_kernel<T, O><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(ws),
      static_cast<O*>(y), rows, k, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_out(const void* x, const void* w, const void* ws, void* y, long long rows, int k,
               int n, int out_dtype, cudaStream_t stream) {
  if (out_dtype == 0) return launch<T, float>(x, w, ws, y, rows, k, n, stream);
  return launch<T, __nv_bfloat16>(x, w, ws, y, rows, k, n, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x is (rows, k) of in_dtype and y (rows, n) of out_dtype, each 0 = float32
// or 1 = bfloat16, both row-major; w is (n, k) int8 row-major; ws (n,)
// float32. Needs k and n multiples of 128 and 16-byte aligned x and w.
int lr2ppo_int8_matmul(const void* x, const void* w, const void* ws, void* y, long long rows,
                       int k, int n, int in_dtype, int out_dtype, void* stream) {
  if (rows <= 0 || k <= 0 || n <= 0 || k % 128 != 0 || n % 128 != 0 ||
      (in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) return launch_out<float>(x, w, ws, y, rows, k, n, out_dtype, s);
  return launch_out<__nv_bfloat16>(x, w, ws, y, rows, k, n, out_dtype, s);
}

}  // extern "C"
