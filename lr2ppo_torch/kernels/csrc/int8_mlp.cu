// Fused int8 FFN for Hopper (sm_90a):
//   y = q(gelu(q(x) . W1 * s1 + b1) -> out_dtype) . W2 * s2 + b2
// where q is per-row symmetric dynamic int8 quantization (amax / 127,
// round half to even, clip to +-127) and both products are s8 x s8 -> s32.
//
// Replaces lr2ppo_tpu/ops/pallas_int8_mlp.py:pallas_int8_mlp (body `_kernel`).
// The plain PyTorch version is lr2ppo_torch/ops/int8_mlp.py:int8_mlp_reference;
// this kernel reproduces its arithmetic operation for operation.
//
// What bounds it. At the serve shape (rows = 200,704, D = 768, H = 3072) one
// call is 2 * 2 * rows * D * H = 1.9e12 integer operations against only
// x and y in device memory (rows * D each) plus 4.5 MB of weights that stay
// in the 50 MB L2: it is bound by tensor-core operations, not by bytes.
//
// Design (simple and right first):
//   * one launch per call; a block owns BM = 16 rows, 8 warps;
//   * the block quantizes its x rows into shared memory (BM x D int8);
//   * fc1 runs as mma.sync m16n8k32 s8 products over K = D, each warp taking
//     32 output columns at a time, with W1 read from global memory / L2 in
//     torch's (out, in) layout, which is already the K-contiguous "col"
//     operand mma wants;
//   * the f32 epilogue (rescale, bias, GELU with XLA's erf polynomial) stores
//     the hidden row block rounded to out_dtype in shared memory and keeps
//     each row's amax;
//   * the hidden block is quantized to int8 in place, and fc2 runs over
//     K = H the same way, writing out_dtype;
//   * where the hidden block does not fit in a block's 227 KB of shared
//     memory (float32 out above H ~3,300, e.g. D 512, H 4096), it lives in
//     a global scratch instead, one slice per resident block, and the
//     blocks walk the row blocks in a grid-stride loop. Same arithmetic,
//     same result; every shape `supported` passes launches.
// What this leaves on the table: with BM = 16 every block re-reads both
// weights (4.5 MB) from L2, 12,544 times per serve-shape call, so L2
// bandwidth rather than the tensor cores sets the pace; mma.sync issues from
// registers without the wgmma/TMA pipeline, and 1-2 resident blocks per SM
// hide little load latency. Larger row blocks, wgmma, TMA and a persistent
// schedule are the later steps.
//
// Numerics: built with -fmad=false and written with __fmul_rn/__fadd_rn/
// __fdiv_rn, so no multiply-add is contracted into an FMA (XLA and PyTorch's
// elementwise kernels round after every operation). amax / 127 is a true
// division. Never build with --use_fast_math.

#include "common.cuh"

namespace {

constexpr int BM = 16;               // rows per block: one m16 tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NT = 4;                // n8 tiles per warp pass: 32 columns
constexpr int PAD = 64;              // bytes: int8 row strides are 64 mod 128

// XLA's f32 erf: x * P(x^2) / Q(x^2), x clamped to [-4, 4]
// (pallas_int8_mlp.py:_ERF_ALPHA/_ERF_BETA; the constants are the doubles
// rounded to f32, as jnp does with Python floats).
__device__ __constant__ float kAlpha[7] = {
    (float)-2.72614225801306e-10, (float)2.77068142495902e-08,
    (float)-2.10102402082508e-06, (float)-5.69250639462346e-05,
    (float)-7.34990630326855e-04, (float)-2.95459980854025e-03,
    (float)-1.60960333262415e-02};
__device__ __constant__ float kBeta[5] = {
    (float)-1.45660718464996e-05, (float)-2.13374055278905e-04,
    (float)-1.68282697438203e-03, (float)-7.37332916720468e-03,
    (float)-1.42647390514189e-02};

using lr2ppo::from_f32;
using lr2ppo::mma_s8;
using lr2ppo::quant;
using lr2ppo::row_scale;
using lr2ppo::store2;
using lr2ppo::to_f32;
using lr2ppo::warp_max;

__device__ __forceinline__ float erf_poly(float x) {
  x = fminf(fmaxf(x, -4.0f), 4.0f);
  const float x2 = __fmul_rn(x, x);
  float p = kAlpha[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) p = __fadd_rn(__fmul_rn(p, x2), kAlpha[i]);
  float q = kBeta[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) q = __fadd_rn(__fmul_rn(q, x2), kBeta[i]);
  return __fdiv_rn(__fmul_rn(x, p), q);
}

// 0.5 * x * (1 + erf(x / sqrt(2))), evaluated left to right like the JAX code
__device__ __forceinline__ float gelu(float x) {
  const float inv_sqrt2 = (float)0.7071067811865475;
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, erf_poly(__fmul_rn(x, inv_sqrt2))));
}

// ((acc * row_scale) * col_scale) + bias
__device__ __forceinline__ float rescale(int acc, float rs, float cs, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs), b);
}

// acc[j] += A(16 x K, int8 rows `a_lo` = row g and `a_hi` = row g + 8, both
// already offset by t * 16) . B(K x 8, column j of the 32-column group; `b[j]`
// points at weight row n0 + 8j + g, offset by t * 16).
//
// K is permuted inside every 64-wide chunk, identically for A and B, so that
// each thread reads 16 contiguous bytes of each operand: the mma's logical k
// t*4+i maps to physical t*16+i and 16+t*4+i to t*16+4+i (first k-step), and
// the second k-step takes bytes t*16+8..15. An integer sum does not depend on
// the order of its terms.
__device__ __forceinline__ void gemm_group(int (&acc)[NT][4], const int8_t* a_lo,
                                           const int8_t* a_hi, const int8_t* const* b,
                                           int k) {
  for (int k0 = 0; k0 < k; k0 += 64) {
    const int4 lo = *reinterpret_cast<const int4*>(a_lo + k0);
    const int4 hi = *reinterpret_cast<const int4*>(a_hi + k0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(b[j] + k0));
      mma_s8(acc[j], lo.x, hi.x, lo.y, hi.y, w.x, w.y);
      mma_s8(acc[j], lo.z, hi.z, lo.w, hi.w, w.z, w.w);
    }
  }
}

// Bytes of one row block's hidden buffer: BM rows of out_dtype values, plus
// one spare int8 row for the in-place quantization (step 3).
__host__ __device__ inline size_t hidden_bytes(int h, int elem) {
  return (size_t)BM * (h + PAD / elem) * elem + (h + PAD);
}

// kGlobal false: the hidden block stays in shared memory, one block per BM
// rows (the loop below runs once). kGlobal true: each resident block keeps
// its hidden buffer in its own slice of `scratch`, which the wrapper
// allocates, and walks the row blocks in a grid-stride loop.
template <typename T, bool kGlobal>
__global__ void __launch_bounds__(THREADS)
    int8_mlp_kernel(const T* __restrict__ x, const int8_t* __restrict__ w1,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const int8_t* __restrict__ w2, const float* __restrict__ s2,
                    const float* __restrict__ b2, T* __restrict__ y, long long rows, int d,
                    int h, unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float xs[BM], hs[BM], red[WARPS][BM];

  const int sx = d + PAD;                              // bytes per int8 x row
  const int sh = h + PAD / (int)sizeof(T);             // elements per hidden row
  const int sq = h + PAD;                              // bytes per int8 hidden row
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  T* hbuf;
  if constexpr (kGlobal)
    hbuf = reinterpret_cast<T*>(scratch + blockIdx.x * hidden_bytes(h, (int)sizeof(T)));
  else
    hbuf = reinterpret_cast<T*>(smem + BM * sx);
  // int8 hidden rows, in place: row r sits at the end of the hidden buffer
  // (plus one spare int8 row), inside the storage of hidden rows > r only
  int8_t* hq = reinterpret_cast<int8_t*>(hbuf) + BM * (sh * (int)sizeof(T) - sq) + sq;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (long long row0 = (long long)blockIdx.x * BM;; row0 += (long long)gridDim.x * BM) {
    if constexpr (kGlobal) {
      if (row0 >= rows) break;
    }

    // 1. quantize this block's x rows; rows past the end quantize to 0
    for (int r = warp; r < BM; r += WARPS) {
      const long long gr = row0 + r;
      const bool live = gr < rows;
      const T* xr = x + (live ? gr : 0) * d;
      float amax = 0.0f;
      if (live)
        for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(to_f32(xr[c])));
      const float sc = row_scale(warp_max(amax));
      if (lane == 0) xs[r] = sc;
      for (int c = lane; c < d; c += 32)
        xq[r * sx + c] = live ? (int8_t)quant(to_f32(xr[c]), sc) : 0;
    }
    __syncthreads();

    // 2. fc1 + epilogue into the hidden buffer, keeping per-row amax
    float amax_lo = 0.0f, amax_hi = 0.0f;   // rows g and g + 8
    for (int gi = warp; gi < h / 32; gi += WARPS) {
      const int n0 = gi * 32;
      int acc[NT][4] = {};
      const int8_t* b[NT];
  #pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = w1 + (size_t)(n0 + j * 8 + g) * d + t * 16;
      gemm_group(acc, xq + g * sx + t * 16, xq + (g + 8) * sx + t * 16, b, d);
  #pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + j * 8 + t * 2;
  #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (i < 2) ? g : g + 8;
          const int cc = c + (i & 1);
          const T v = from_f32<T>(gelu(rescale(acc[j][i], xs[r], s1[cc], b1[cc])));
          hbuf[r * sh + cc] = v;
          const float a = fabsf(to_f32(v));
          if (i < 2) amax_lo = fmaxf(amax_lo, a); else amax_hi = fmaxf(amax_hi, a);
        }
      }
    }
    // the four threads of a group hold the same rows
    for (int o = 1; o < 4; o <<= 1) {
      amax_lo = fmaxf(amax_lo, __shfl_xor_sync(0xffffffffu, amax_lo, o));
      amax_hi = fmaxf(amax_hi, __shfl_xor_sync(0xffffffffu, amax_hi, o));
    }
    if (t == 0) {
      red[warp][g] = amax_lo;
      red[warp][g + 8] = amax_hi;
    }
    __syncthreads();
    if (threadIdx.x < BM) {
      float m = 0.0f;
      for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red[w][threadIdx.x]);
      hs[threadIdx.x] = row_scale(m);
    }
    __syncthreads();

    // 3. quantize the hidden rows in place, last row first: int8 row r only
    // overwrites hidden rows > r, which earlier passes have consumed
    for (int r = BM - 1; r >= 0; --r) {
      const float sc = hs[r];
      const T* src = hbuf + r * sh;
      int8_t* dst = hq + r * sq;
      for (int c = threadIdx.x * 4; c < h; c += THREADS * 4) {
        char4 q;
        q.x = (signed char)quant(to_f32(src[c]), sc);
        q.y = (signed char)quant(to_f32(src[c + 1]), sc);
        q.z = (signed char)quant(to_f32(src[c + 2]), sc);
        q.w = (signed char)quant(to_f32(src[c + 3]), sc);
        *reinterpret_cast<char4*>(dst + c) = q;
      }
      __syncthreads();
    }

    // 4. fc2 + epilogue straight to y
    for (int gi = warp; gi < d / 32; gi += WARPS) {
      const int n0 = gi * 32;
      int acc[NT][4] = {};
      const int8_t* b[NT];
  #pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = w2 + (size_t)(n0 + j * 8 + g) * h + t * 16;
      gemm_group(acc, hq + g * sq + t * 16, hq + (g + 8) * sq + t * 16, b, h);
  #pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + j * 8 + t * 2;
        const float cs0 = s2[c], cs1 = s2[c + 1], bb0 = b2[c], bb1 = b2[c + 1];
  #pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? g + 8 : g;
          if (row0 + r < rows)
            store2<T>(y + (row0 + r) * d + c, rescale(acc[j][2 * half], hs[r], cs0, bb0),
                      rescale(acc[j][2 * half + 1], hs[r], cs1, bb1));
        }
      }
    }
    if constexpr (!kGlobal) break;
    __syncthreads();  // the next row block rewrites xq, xs, hs and hbuf
  }
}

// Static shared memory of both kernels: xs, hs, red.
constexpr size_t kStaticSmem = sizeof(float) * (2 * BM + WARPS * BM);

size_t smem_bytes(int d, int h, int elem) {
  return (size_t)BM * (d + PAD) + hidden_bytes(h, elem);
}

int max_smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Does the hidden block of this shape fit in one block's shared memory?
bool hidden_in_smem(int d, int h, int elem) {
  return smem_bytes(d, h, elem) + kStaticSmem <= (size_t)max_smem_optin();
}

// Blocks of the global-hidden kernel: as many as can be resident at once.
template <typename T>
long long global_grid(long long rows, int d) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_mlp_kernel<T, true>,
                                                THREADS, (size_t)BM * (d + PAD));
  const long long blocks = (rows + BM - 1) / BM;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return blocks < resident ? blocks : resident;
}

template <typename T>
long long scratch_bytes(long long rows, int d, int h) {
  if (hidden_in_smem(d, h, (int)sizeof(T))) return 0;
  return global_grid<T>(rows, d) * (long long)hidden_bytes(h, (int)sizeof(T));
}

template <typename T>
int launch(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
           const void* s2, const void* b2, void* y, long long rows, int d, int h,
           void* scratch, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int8_t *w1t = static_cast<const int8_t*>(w1), *w2t = static_cast<const int8_t*>(w2);
  const float *s1t = static_cast<const float*>(s1), *b1t = static_cast<const float*>(b1);
  const float *s2t = static_cast<const float*>(s2), *b2t = static_cast<const float*>(b2);
  T* yt = static_cast<T*>(y);
  if (!hidden_in_smem(d, h, (int)sizeof(T))) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)global_grid<T>(rows, d);
    int8_mlp_kernel<T, true><<<grid, THREADS, (size_t)BM * (d + PAD), stream>>>(
        xt, w1t, s1t, b1t, w2t, s2t, b2t, yt, rows, d, h,
        static_cast<unsigned char*>(scratch));
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_bytes(d, h, (int)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      int8_mlp_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)err;
  }
  const unsigned grid = (unsigned)((rows + BM - 1) / BM);
  int8_mlp_kernel<T, false><<<grid, THREADS, smem, stream>>>(xt, w1t, s1t, b1t, w2t, s2t, b2t,
                                                             yt, rows, d, h, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of global scratch `lr2ppo_int8_mlp` needs for this shape on the
// current device: 0 where the hidden block fits in shared memory.
long long lr2ppo_int8_mlp_scratch_bytes(long long rows, int d, int h, int dtype) {
  if (rows <= 0 || d % 128 != 0 || h % 128 != 0) return 0;
  return dtype == 0 ? scratch_bytes<float>(rows, d, h) : scratch_bytes<__nv_bfloat16>(rows, d, h);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x and y are (rows, d) of dtype 0 = float32 or 1 = bfloat16; w1 is (h, d)
// int8, w2 (d, h) int8, both row-major; s1, b1 (h,) and s2, b2 (d,) float32.
// `scratch` holds lr2ppo_int8_mlp_scratch_bytes() bytes, 16-byte aligned,
// or is null where that is 0. Needs d and h multiples of 128 and 16-byte
// aligned weights.
int lr2ppo_int8_mlp(const void* x, const void* w1, const void* s1, const void* b1,
                    const void* w2, const void* s2, const void* b2, void* y, long long rows,
                    int d, int h, int dtype, void* scratch, void* stream) {
  if (rows <= 0 || d % 128 != 0 || h % 128 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w1, s1, b1, w2, s2, b2, y, rows, d, h, scratch, s);
  return launch<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, y, rows, d, h, scratch, s);
}

}  // extern "C"
