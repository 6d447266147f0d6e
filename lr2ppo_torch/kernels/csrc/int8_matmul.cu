// Narrow-output int8 GEMM with per-row dynamic quantization, for Hopper
// (sm_90a):
//   y = (q(x) s8 . W s8 -> s32) * sx * sw,   sx = max(amax_row, 1e-8) / 127
// where q rounds x / sx half to even and clips to +-127; W is (N, K) int8 with
// a float32 scale per output column; the accumulation is exact in int32
// (127 * 127 * K < 2^31 for every K the shape gate admits).
//
// Replaces lr2ppo_tpu/ops/pallas_int8_matmul.py:81 pallas_int8_matmul (call
// :95, body `_kernel` :56). The plain PyTorch version is
// lr2ppo_torch/ops/int8_matmul.py:int8_matmul_reference; this kernel
// reproduces its arithmetic operation for operation and is bit-equal to it.
//
// What bounds it. At the rollout's fc2 site (rows = 100,352, K = 3072,
// N = 768, bf16 in and out) one call is 2 * rows * K * N = 473.5 G integer
// operations against 617 MB of x, 154 MB of y and 2.4 MB of W: 0.239 ms at
// the int8 tensor-core peak (1,979 T op/s), 0.231 ms at the memory rate
// (3.35 TB/s; NVIDIA's H100 SXM data sheet, 700 W). Both bounds are close,
// so a fast version reads x from HBM once, quantizes each row once, and
// keeps the tensor cores fed while it does.
//
// Design: K1's machinery (hopper.cuh), a persistent grid of one block per
// SM (at most one per tile) walking tiles of BM = 128 rows:
//   - a producer warp (warpgroup 0, its registers given up with setmaxnreg)
//     streams K slices of 128 bytes of A (the tile's int8 rows) and of B
//     (256 rows of W, the K-major operand as torch's (N, K) layout has it)
//     by TMA, 128-byte swizzled, into a 4-stage ring with full and empty
//     mbarriers;
//   - two consumer warpgroups, 64 rows of the tile each, run
//     wgmma.mma_async m64n128k32 s8 on the ring's stages (two a K step for
//     the 256 columns of a chunk, 128 s32 accumulators a thread).
// For each tile the consumers:
//   1. quantize the tile's x rows once into the block's slice of a global
//      scratch (BM x K int8; the wrapper allocates grid x BM x K bytes),
//      each row's scale kept in shared memory. A warp takes a row at a
//      time. Where the row fits in the warp's registers (HELD 16-byte words
//      a lane: up to 6,144 bytes, bfloat16 K <= 3,072 or float32 K <=
//      1,536), it is read from HBM once: the amax by warp_max, then the
//      values quantized from registers. Wider rows take two streamed
//      passes, one for the amax and one for the values. x is read with
//      evict-first loads: it is read once, and the L2 is better spent on
//      the int8 rows and W. A fence.proxy.async and a named barrier hand
//      the slice to the producer (TMA reads through the async proxy);
//   2. run the products over N in chunks of 256 columns; a chunk past the
//      last 128 columns (N = 128, 384, ...) skips its second wgmma, and TMA
//      fills those W rows with zeros. The epilogue rescales straight into
//      y; rows past the end are neither read nor written (their A rows in
//      the slice are stale and their sums are dropped).
// Every shape `supported` admits launches: the shared memory (the 192 KB
// ring) and the registers do not depend on K or N, only the scratch does.
// 132 slices of 128 x 3,072 bytes (~52 MB) are about the L2's 50 MB, so
// the int8 rows can be read back from L2 rather than HBM (how many are is
// not measured: ncu does not run on the card's machine).
// What this leaves on the table (PERF.md §6-7 has the times): the
// quantize pass pairs with no products, so the tensor cores idle while it
// reads x; A is re-read from L2 for each of the N / 256 column chunks.
// Three ways to hide the quantize pass were built and were slower on the
// card, so none is kept: the producer warpgroup's three idle warps
// quantizing the next tile into a second slice (three warps keep too few
// loads in flight); the consumers quantizing the next tile's rows between
// their wgmma stages (the rows held across stages spill at the 168
// registers a thread that a 384-thread block leaves); a 2- or 4-block
// cluster multicasting W's tiles (it halves W's reads from L2 but not the
// bytes each SM takes in, and gained nothing).
//
// Numerics: built with -fmad=false, written with __fmul_rn; the scale is
// a true division (row_scale), and the quantization's quotient is
// correctly rounded from one reciprocal a row (hopper.cuh:quant). Integer
// sums do not depend on their order, so only the epilogue's rounding
// could break bit-equality: (float(acc) * sx) * sw, rounded once to the
// out dtype, as the plain version does. Never build with --use_fast_math.

#include "hopper.cuh"

namespace {

using namespace lr2ppo::hopper;
using lr2ppo::Pack;
using lr2ppo::row_scale;
using lr2ppo::smem_addr;
using lr2ppo::store2;
using lr2ppo::warp_max;

// 16-byte words of an x row a lane holds: rows of up to 32 * HELD words
// (6,144 bytes) are read from HBM once
constexpr int HELD = 12;

// (acc * row_scale) * col_scale
__device__ __forceinline__ float rescale(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

template <typename T>
__device__ __forceinline__ float amax_word(const uint4& w) {
  float v[Pack<T>::N];
  unpack<T>(w, v);
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < Pack<T>::N; ++i) m = fmaxf(m, fabsf(v[i]));
  return m;
}

// Step 1: the tile's `live` x rows (row-major, k values each) quantized
// into xq (BM x k int8) with their scales in xs, a warp to a row. Lane l
// takes the row's 16-byte words l, l + 32, ...: HELD of them at a time.
template <typename T>
__device__ __forceinline__ void quantize_tile(const T* __restrict__ x, int live, int k,
                                              int8_t* __restrict__ xq, float* xs) {
  constexpr int N = Pack<T>::N;
  const int words = k / N;
  const bool held = words <= 32 * HELD;
  const int warp = ctid() >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < live; r += THREADS / 32) {
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)r * k);
    int8_t* dst = xq + (size_t)r * k;
    uint4 v[HELD];
    float m = 0.0f;
    for (int w0 = lane; w0 < words; w0 += 32 * HELD) {
#pragma unroll
      for (int i = 0; i < HELD; ++i)
        if (w0 + 32 * i < words) v[i] = __ldcs(src + w0 + 32 * i);
#pragma unroll
      for (int i = 0; i < HELD; ++i)
        if (w0 + 32 * i < words) m = fmaxf(m, amax_word<T>(v[i]));
    }
    const float sc = row_scale(warp_max(m)), y = __frcp_rn(sc);
    if (lane == 0) xs[r] = sc;
    // held: v still holds the whole row; else read it again
    for (int w0 = lane; w0 < words; w0 += 32 * HELD) {
#pragma unroll
      for (int i = 0; i < HELD; ++i) {
        const int w = w0 + 32 * i;
        if (w < words) {
          float f[N];
          unpack<T>(held ? v[i] : __ldcs(src + w), f);
          store_q<N>(dst + (size_t)w * N, f, sc, y);
        }
      }
    }
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(BLOCK, 1)
    int8_matmul_kernel(const __grid_constant__ CUtensorMap map_xq,
                       const __grid_constant__ CUtensorMap map_w, const T* __restrict__ x,
                       const float* __restrict__ ws, O* __restrict__ y, long long rows, int k,
                       int n, int8_t* __restrict__ scratch) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float xs[BM];                 // the tile's row scales
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the ring 1024-byte aligned, as the 128-byte swizzle wants
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  if (threadIdx.x == 0) ring_init(full, empty);
  __syncthreads();

  const long long tiles = (rows + BM - 1) / BM;
  const int slot_row = blockIdx.x * BM;   // the block's rows in the int8 scratch
  const int nchunk = (n + BN - 1) / BN;
  uint32_t it = 0;                        // ring stages walked, by either side

  if (threadIdx.x < 128) {
    // the producer: one thread of warp 0 issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x >= 32) return;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      bar_sync(XQ_READY, 32 + THREADS);
      if (threadIdx.x == 0) produce(&map_xq, slot_row, &map_w, k, nchunk, ring, full, empty, it);
      __syncwarp();
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  int8_t* xq = scratch + (size_t)blockIdx.x * BM * k;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // this thread's rows of the tile: r0 and r0 + 8
  const int r0 = (ctid() / 128) * 64 + ((ctid() / 32) & 3) * 16 + (lane >> 2);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;
    const int live = rows - row0 < BM ? (int)(rows - row0) : BM;

    // 1. the tile's rows quantized into the slice, handed to the producer
    quantize_tile<T>(x + row0 * k, live, k, xq, xs);
    fence_proxy_async();
    consumer_sync();                      // the scales are in
    bar_arrive(XQ_READY, 32 + THREADS);

    // 2. the products, rescaled straight to y's live rows
    const float xs0 = xs[r0], xs1 = xs[r0 + 8];
    O* yt = y + row0 * n;
    consume(k, n, ring, full, empty, it, [&](int c, const int (&acc)[2][64], bool second) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (hf == 1 && !second) break;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = c * BN + hf * HALF + j * 8 + 2 * t;
          const float cs0 = ws[col], cs1 = ws[col + 1];
          if (r0 < live)
            store2<O>(yt + (size_t)r0 * n + col, rescale(acc[hf][4 * j], xs0, cs0),
                      rescale(acc[hf][4 * j + 1], xs0, cs1));
          if (r0 + 8 < live)
            store2<O>(yt + (size_t)(r0 + 8) * n + col, rescale(acc[hf][4 * j + 2], xs1, cs0),
                      rescale(acc[hf][4 * j + 3], xs1, cs1));
        }
      }
    });
    // the next tile's quantize rewrites xs and the slice
    consumer_sync();
  }
}

// The tp entry's product (ops/int8_matmul.py:int8_matmul_tp): acc = xq . W^T
// as exact int32 sums, from int8 rows the caller quantized (a tp rank's K/tp
// columns of each row, scaled by the row's amax over tp) and the rank's
// columns of W; no epilogue, so the parts can be summed over tp exactly
// before one rescale. K1/K2's ring as above, with A streamed by TMA
// straight from xq: no quantize pass, no scratch, no hand-off barrier.
// Rows past the end read as zeros and their sums are not stored.
__global__ void __launch_bounds__(BLOCK, 1)
    int8_dot_s32_kernel(const __grid_constant__ CUtensorMap map_xq,
                        const __grid_constant__ CUtensorMap map_w, int* __restrict__ acc_out,
                        long long rows, int k, int n) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  if (threadIdx.x == 0) ring_init(full, empty);
  __syncthreads();

  const long long tiles = (rows + BM - 1) / BM;
  const int nchunk = (n + BN - 1) / BN;
  uint32_t it = 0;

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x != 0) return;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      produce(&map_xq, (int)(tile * BM), &map_w, k, nchunk, ring, full, empty, it);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = (ctid() / 128) * 64 + ((ctid() / 32) & 3) * 16 + (lane >> 2);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;
    const int live = rows - row0 < BM ? (int)(rows - row0) : BM;
    int* at = acc_out + row0 * n;
    consume(k, n, ring, full, empty, it, [&](int c, const int (&acc)[2][64], bool second) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (hf == 1 && !second) break;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = c * BN + hf * HALF + j * 8 + 2 * t;
          if (r0 < live)
            *reinterpret_cast<int2*>(at + (size_t)r0 * n + col) =
                make_int2(acc[hf][4 * j], acc[hf][4 * j + 1]);
          if (r0 + 8 < live)
            *reinterpret_cast<int2*>(at + (size_t)(r0 + 8) * n + col) =
                make_int2(acc[hf][4 * j + 2], acc[hf][4 * j + 3]);
        }
      }
    });
  }
}

// The tp entry's epilogue: y = (float(acc) * xs[row]) * ws[col], rounded
// once to O, K2's epilogue (rescale) on the int32 sums over tp. Four
// elements a thread a step (n is a multiple of 128): 16 bytes of acc in,
// 8 or 16 bytes of y out. Bytes-bound: 4 + sizeof(O) bytes an element.
template <typename O>
__global__ void s32_epilogue_kernel(const int4* __restrict__ acc, const float* __restrict__ xs,
                                    const float* __restrict__ ws, O* __restrict__ y,
                                    long long quads, int n) {
  const int qn = n / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < quads;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / qn;
    const int c = (int)(i - r * qn) * 4;
    const int4 a = acc[i];
    const float sx = xs[r];
    O* dst = y + r * n + c;
    store2<O>(dst, rescale(a.x, sx, ws[c]), rescale(a.y, sx, ws[c + 1]));
    store2<O>(dst + 2, rescale(a.z, sx, ws[c + 2]), rescale(a.w, sx, ws[c + 3]));
  }
}

template <typename T, typename O>
int launch(const void* x, const void* w, const void* ws, void* y, long long rows, int k, int n,
           void* scratch, cudaStream_t stream) {
  const int err = set_smem(int8_matmul_kernel<T, O>);
  if (err != 0) return err;
  const long long grid = grid_for(rows);
  CUtensorMap mxq, mw;
  if (!make_map(&mxq, scratch, grid * BM, k, BM) || !make_map(&mw, w, n, k, BN))
    return (int)cudaErrorInvalidValue;
  int8_matmul_kernel<T, O><<<(unsigned)grid, BLOCK, SMEM_BYTES, stream>>>(
      mxq, mw, static_cast<const T*>(x), static_cast<const float*>(ws), static_cast<O*>(y), rows,
      k, n, static_cast<int8_t*>(scratch));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_out(const void* x, const void* w, const void* ws, void* y, long long rows, int k,
               int n, int out_dtype, void* scratch, cudaStream_t stream) {
  if (out_dtype == 0) return launch<T, float>(x, w, ws, y, rows, k, n, scratch, stream);
  return launch<T, __nv_bfloat16>(x, w, ws, y, rows, k, n, scratch, stream);
}

}  // namespace

extern "C" {

// Bytes of global scratch `lr2ppo_int8_matmul` needs for `rows` rows of K
// `k` on the current device: one BM x k int8 slice per block.
long long lr2ppo_int8_matmul_scratch_bytes(long long rows, int k) {
  if (rows <= 0 || k <= 0 || k % 128 != 0) return 0;
  return grid_for(rows) * BM * (long long)k;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x is (rows, k) of in_dtype and y (rows, n) of out_dtype, each 0 = float32
// or 1 = bfloat16, both row-major; w is (n, k) int8 row-major; ws (n,)
// float32. `scratch` holds lr2ppo_int8_matmul_scratch_bytes() bytes. Needs
// k and n multiples of 128 and 16-byte aligned x, w and scratch.
int lr2ppo_int8_matmul(const void* x, const void* w, const void* ws, void* y, long long rows,
                       int k, int n, int in_dtype, int out_dtype, void* scratch, void* stream) {
  if (rows <= 0 || k <= 0 || n <= 0 || k % 128 != 0 || n % 128 != 0 || scratch == nullptr ||
      (in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) return launch_out<float>(x, w, ws, y, rows, k, n, out_dtype, scratch, s);
  return launch_out<__nv_bfloat16>(x, w, ws, y, rows, k, n, out_dtype, scratch, s);
}

// The tp entry's product, launched on `stream`; returns cudaGetLastError().
// xq is (rows, k) int8 and w (n, k) int8, both row-major and 16-byte
// aligned; acc is (rows, n) int32. Needs k and n multiples of 128.
int lr2ppo_int8_dot_s32(const void* xq, const void* w, void* acc, long long rows, int k, int n,
                        void* stream) {
  if (rows <= 0 || k <= 0 || n <= 0 || k % 128 != 0 || n % 128 != 0)
    return (int)cudaErrorInvalidValue;
  const int err = set_smem(int8_dot_s32_kernel);
  if (err != 0) return err;
  CUtensorMap mxq, mw;
  if (!make_map(&mxq, xq, rows, k, BM) || !make_map(&mw, w, n, k, BN))
    return (int)cudaErrorInvalidValue;
  int8_dot_s32_kernel<<<(unsigned)grid_for(rows), BLOCK, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(mxq, mw, static_cast<int*>(acc),
                                                             rows, k, n);
  return (int)cudaGetLastError();
}

// The tp entry's epilogue, launched on `stream`; returns cudaGetLastError().
// acc is (rows, n) int32, xs (rows,) and ws (n,) float32, y (rows, n) of
// out_dtype (0 = float32, 1 = bfloat16); n a multiple of 4, every pointer
// 16-byte aligned.
int lr2ppo_int8_s32_epilogue(const void* acc, const void* xs, const void* ws, void* y,
                             long long rows, int n, int out_dtype, void* stream) {
  if (rows <= 0 || n <= 0 || n % 4 != 0 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long quads = rows * (n / 4);
  const unsigned grid = lr2ppo::grid_for(quads, 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* a = static_cast<const int4*>(acc);
  const float* sx = static_cast<const float*>(xs);
  const float* sw = static_cast<const float*>(ws);
  if (out_dtype == 0)
    s32_epilogue_kernel<float><<<grid, 256, 0, s>>>(a, sx, sw, static_cast<float*>(y), quads, n);
  else
    s32_epilogue_kernel<__nv_bfloat16>
        <<<grid, 256, 0, s>>>(a, sx, sw, static_cast<__nv_bfloat16*>(y), quads, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
