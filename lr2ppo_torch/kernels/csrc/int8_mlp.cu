// Fused int8 FFN for Hopper (sm_90a):
//   y = q(gelu(q(x) . W1 * s1 + b1) -> out_dtype) . W2 * s2 + b2
// where q is per-row symmetric dynamic int8 quantization (amax / 127,
// round half to even, clip to +-127) and both products are s8 x s8 -> s32.
//
// Replaces lr2ppo_tpu/ops/pallas_int8_mlp.py:139 pallas_int8_mlp (call :156,
// body `_kernel` :105-123). The plain PyTorch version is
// lr2ppo_torch/ops/int8_mlp.py:int8_mlp_reference; this kernel reproduces its
// arithmetic operation for operation and is bit-equal to it.
//
// What bounds it. At the serve shape (rows = 200,704, D = 768, H = 3072) one
// call is 2 * 2 * rows * D * H = 1.9e12 integer operations, 0.96 ms at the
// int8 tensor-core peak (1,979 T op/s, NVIDIA's H100 SXM data sheet, 700 W),
// against 0.62 GB of x and y (0.18 ms at 3.35 TB/s): bound by operations.
// Below the tensor cores sit the L2 (every weight byte read from it gives 2
// operations per row that shares it) and fc1's GELU epilogue, ~45 float32
// operations an element that must round as XLA's do, on the CUDA cores.
//
// Design: a persistent grid of one block per SM, three warpgroups:
//   - a producer warp (warpgroup 0, its registers given up with setmaxnreg)
//     that walks the block's tiles of BM = 128 rows and, for each product,
//     streams K slices of 128 bytes of A (the tile's int8 rows) and of B
//     (256 rows of the weight, which in torch's (out, in) layout is already
//     the K-major operand wgmma wants) by TMA, 128-byte swizzled, into a
//     4-stage ring with full and empty mbarriers;
//   - two consumer warpgroups, 64 rows of the tile each, that run
//     wgmma.mma_async m64n128k32 s8 on the ring's stages (two a K step for
//     the 256 columns of a chunk, 128 s32 accumulators a thread), one
//     stage's products in flight while the next stage is awaited.
// For each tile the consumers:
//   1. quantize the x rows into the block's slice of a global scratch that
//      the wrapper allocates (the A operand of fc1's TMA): where the tile's
//      rows fit in the idle ring (bfloat16 at D <= 768), in one read, a
//      warp to a row; else streamed through the ring twice, for each row's
//      amax and then for the values;
//   2. run fc1 over the H columns in chunks of 256; the epilogue (rescale,
//      bias, XLA's erf GELU, rounding to out_dtype) writes the hidden values
//      to the slice and keeps each row's amax: a row's columns lie in one
//      quad of one warp, so the amax needs only quad shuffles;
//   3. quantize the hidden rows into int8 in the slice, streamed through
//      the ring: fc2's quantization needs a row's amax over all H values
//      before any of them is quantized, and 128 rows of them (768 KB in
//      bfloat16) do not fit in the 227 KB a block may have;
//   4. run fc2 over K = H in chunks of 256 of the D columns, the epilogue
//      rescaling straight into y.
// Named barriers hand the quantized A of steps 1 and 3 to the producer
// (after a proxy fence, as TMA reads through the async proxy) and keep it
// off the ring while the consumers stream through it.
// L2 and HBM per 128-row tile at the serve shape: both weights once (4.7
// MB from L2, against 59 GB a call when blocks of 16 rows re-read them),
// the int8 x rows once per fc1 chunk (12 x 96 KB) and the int8 hidden
// once per fc2 chunk (3 x 384 KB); the hidden's round trip through the
// scratch (0.77 MB out and back in bfloat16, 0.38 MB of int8 out). 132
// slices hold 165 MB, above the 50 MB L2, so that round trip reaches HBM.
// Every shape `supported` admits launches: shared memory (a 192 KB ring)
// and registers do not depend on D or H, only the scratch does; a chunk
// past the last 128 columns of D or H (D or H not a multiple of 256) skips
// its second half, whose weight rows TMA fills with zeros.
// What this leaves on the table: the GELU epilogue does not overlap the
// products (the tensor cores idle while it runs); the quantize passes pair
// with no products; the hidden's round trip through HBM; fc1's A re-read
// from L2 for every chunk; a 2-block cluster multicasting the weight tiles,
// which would halve their L2 traffic.
//
// Numerics: built with -fmad=false and written with __fmul_rn/__fadd_rn,
// so no multiply-add is contracted into an FMA (XLA and PyTorch's
// elementwise kernels round after every operation). amax / 127 is a true
// division; the erf's and the quantization's divisions go through
// common.cuh's div_rn_bounded and div_by, correctly rounded for their
// operand ranges. Integer sums do not depend on their order. Never build
// with --use_fast_math.

#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;                  // rows per tile
constexpr int BN = 256;                  // output columns per chunk, either product
constexpr int HALF = 128;                // columns per wgmma (m64n128k32)
constexpr int BK = 128;                  // K bytes per ring stage (one swizzle row)
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK;         // a stage: the A slice, then the B slice
constexpr int STAGE_BYTES = A_BYTES + BN * BK;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int THREADS = 256;             // the two consumer warpgroups
constexpr int BLOCK = 128 + THREADS;     // the producer's warpgroup first
constexpr int SLOTS = 4;                 // the ring as slots, for the streamed passes
constexpr int SLOT = RING_BYTES / SLOTS;
constexpr int XQ_READY = 1, HQ_READY = 2, CONSUMERS = 3;  // named barriers

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

using lr2ppo::cp_async16;
using lr2ppo::cp_async_commit;
using lr2ppo::cp_async_wait;
using lr2ppo::div_by;
using lr2ppo::div_rn_bounded;
using lr2ppo::from_f32;
using lr2ppo::Pack;
using lr2ppo::row_scale;
using lr2ppo::smem_addr;
using lr2ppo::store2;
using lr2ppo::to_f32;

__device__ __forceinline__ float erf_poly(float x) {
  x = fminf(fmaxf(x, -4.0f), 4.0f);
  const float x2 = __fmul_rn(x, x);
  float p = kAlpha[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) p = __fadd_rn(__fmul_rn(p, x2), kAlpha[i]);
  float q = kBeta[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) q = __fadd_rn(__fmul_rn(q, x2), kBeta[i]);
  // Q(x^2) lies in [-0.2, -0.014]: the division needs no range check
  return div_rn_bounded(__fmul_rn(x, p), q);
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

// ops/int8.py:quantize_rows's rounding of v / sc, as common.cuh's quant,
// given y = 1 / sc correctly rounded: |v| <= 127 sc and sc >= 1e-8 / 127,
// so the quotient stays in range or rounds to 0
__device__ __forceinline__ int quant(float v, float sc, float y) {
  const float q = rintf(div_by(v, sc, y));
  return (int)fminf(fmaxf(q, -127.0f), 127.0f);
}

// N (= Pack<T>::N, 4 or 8) values quantized with the row scale `sc` (y its
// reciprocal) and stored as N bytes.
template <int N>
__device__ __forceinline__ void store_q(int8_t* dst, const float (&v)[N], float sc, float y) {
  uint32_t w[N / 4] = {};
#pragma unroll
  for (int i = 0; i < N; ++i) w[i / 4] |= (uint32_t)(quant(v[i], sc, y) & 0xFF) << (8 * (i % 4));
  if constexpr (N == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = w[0];
}

// A block's scratch: the int8 x rows (BM x d), the hidden rows in T
// (BM x h), the int8 hidden rows (BM x h). The scratch holds each part of
// every block's slice together (the blocks' int8 x rows, then their hidden
// rows, then their int8 hidden rows), so the int8 parts are two matrices
// of grid * BM rows for TMA.
__host__ __device__ inline size_t slice_bytes(int d, int h, int elem) {
  return (size_t)BM * ((size_t)d + (size_t)h * (elem + 1));
}

// A consumer thread's index among the consumers.
__device__ __forceinline__ int ctid() { return (int)threadIdx.x - 128; }

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void consumer_sync() { bar_sync(CONSUMERS, THREADS); }

// Generic-proxy writes (global or shared) made visible to the async proxy
// (TMA) of this thread's later-ordered accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();   // a lost arrival: fail, do not hang
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// A 2D TMA load of the box at (column c0, row c1) of `map` into `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile with 128-byte rows,
// 128-byte swizzled as TMA writes it: 8-row groups 1024 bytes apart. The
// tile starts 1024-byte aligned; a K step of 32 bytes adds 2.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (+)= A . B^T for a 64 x 128 tile, K = 32 bytes, s32 accumulation; d is
// overwritten where `accumulate` is 0. Thread (warp w, lane 4g + t) of the
// warpgroup holds rows 16w + g (+ 8) and columns 8j + 2t (+ 1) in
// d[4j .. 4j + 3].
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keep the compiler from moving reads of the accumulators above the
// wgmma_wait that completes them.
__device__ __forceinline__ void fence_acc(int (&acc)[2][64]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 64; ++j) asm volatile("" : "+r"(acc[i][j])::"memory");
}

// A 16-byte word of T values as float32s.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& w, float (&v)[Pack<T>::N]) {
  if constexpr (Pack<T>::N == 8) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  } else {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
}

// Stream bytes [0, n) of `src` (16-byte aligned, n a multiple of 16)
// through the ring, SLOTS - 1 slots in flight, and call f(off, live, word)
// for the 16-byte word at each byte offset: every consumer thread the same
// number of times, `live` false past n. The passes that quantize x and the
// hidden rows read this way: many loads in flight, and no registers held
// for them.
template <class F>
__device__ __forceinline__ void stream_words(const unsigned char* __restrict__ src, int n,
                                             unsigned char* ring, F&& f) {
  const int pieces = (n + SLOT - 1) / SLOT;
  auto load = [&](int p) {
    unsigned char* dst = ring + (p % SLOTS) * SLOT;
    for (int i = ctid() * 16; i < SLOT; i += THREADS * 16)
      if (p * SLOT + i < n) cp_async16(dst + i, src + (size_t)p * SLOT + i, 16);
  };
  for (int p = 0; p < SLOTS - 1; ++p) {
    if (p < pieces) load(p);
    cp_async_commit();
  }
  for (int p = 0; p < pieces; ++p) {
    cp_async_wait<SLOTS - 2>();
    consumer_sync();              // piece p is in; piece p - 1 is consumed
    if (p + SLOTS - 1 < pieces) load(p + SLOTS - 1);
    cp_async_commit();
    const unsigned char* sl = ring + (p % SLOTS) * SLOT;
    for (int i = ctid() * 16; i < SLOT; i += THREADS * 16) {
      const int off = p * SLOT + i;
      f(off, off < n, *reinterpret_cast<const uint4*>(sl + i));
    }
  }
  cp_async_wait<0>();
  consumer_sync();                // the ring is free
}

// Step 1 where the tile's x rows fit in the ring at once (D * sizeof(T) <=
// 1,536 bytes): one read of x, then each warp quantizes whole rows, a
// row's amax a warp-wide max. Rows past `live` get a scale, not values.
template <typename T>
__device__ __forceinline__ void quantize_x_whole(const unsigned char* __restrict__ xb, int live,
                                                 int d, unsigned char* ring, int8_t* xq, float* xs,
                                                 float* xr) {
  constexpr int N = Pack<T>::N;
  const int rb = d * (int)sizeof(T), words = rb / 16;
  for (int i = ctid() * 16; i < live * rb; i += THREADS * 16) cp_async16(ring + i, xb + i, 16);
  cp_async_commit();
  cp_async_wait<0>();
  consumer_sync();
  const int warp = ctid() >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < live; r += THREADS / 32) {
    const uint4* row = reinterpret_cast<const uint4*>(ring + r * rb);
    float m = 0.0f;
    for (int w = lane; w < words; w += 32) {
      float v[N];
      unpack<T>(row[w], v);
#pragma unroll
      for (int i = 0; i < N; ++i) m = fmaxf(m, fabsf(v[i]));
    }
    const float sc = row_scale(lr2ppo::warp_max(m)), y = __frcp_rn(sc);
    if (lane == 0) {
      xs[r] = sc;
      xr[r] = y;
    }
    for (int w = lane; w < words; w += 32) {
      float v[N];
      unpack<T>(row[w], v);
      store_q<N>(xq + (size_t)r * d + w * N, v, sc, y);
    }
  }
  if (ctid() >= live && ctid() < BM) {
    xs[ctid()] = row_scale(0.0f);
    xr[ctid()] = __frcp_rn(xs[ctid()]);
  }
  consumer_sync();                // the scales are in; the ring is free
}

// The producer's side of one product: for each chunk of BN weight rows and
// each K slice, wait for the stage to be empty, then load A's BM rows from
// row a_row of `ma` and B's BN rows from row c * BN of `mb` into it. Odd
// chunks walk K backwards, so a chunk starts on the A slices its
// predecessor read last (integer sums do not depend on the order).
__device__ __forceinline__ void produce(const CUtensorMap* ma, int a_row, const CUtensorMap* mb,
                                        int kb, int nchunk, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, uint32_t& it) {
  const int ksteps = kb / BK;
  for (int c = 0; c < nchunk; ++c)
    for (int k = 0; k < ksteps; ++k, ++it) {
      const int ks = (c & 1) ? ksteps - 1 - k : k;
      const int s = it % STAGES;
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[s], STAGE_BYTES);
      unsigned char* st = ring + s * STAGE_BYTES;
      tma_load(st, ma, &full[s], ks * BK, a_row);
      tma_load(st + A_BYTES, mb, &full[s], ks * BK, c * BN);
    }
}

// The consumers' side of one product: acc = A . B^T over K = kb bytes for
// each chunk c of BN output columns (n columns in all) in turn, then
// epi(c, acc, second) with `second` false where the chunk's last HALF
// columns lie past n.
template <class Epi>
__device__ __forceinline__ void consume(int kb, int n, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, uint32_t& it, Epi&& epi) {
  const int ksteps = kb / BK, nchunk = (n + BN - 1) / BN;
  const int wg = ctid() / 128, lane = threadIdx.x & 31;
  int acc[2][64];
  for (int c = 0; c < nchunk; ++c) {
    const bool second = c * BN + HALF < n;
    for (int k = 0; k < ksteps; ++k, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = ring + s * STAGE_BYTES;
      const uint64_t da = desc_sw128(st + wg * 64 * BK);
      const uint64_t db = desc_sw128(st + A_BYTES);
      const uint64_t db1 = desc_sw128(st + A_BYTES + HALF * BK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const int accumulate = (k > 0 || kk > 0) ? 1 : 0;
        wgmma_s8(acc[0], da + 2 * kk, db + 2 * kk, accumulate);
        if (second) wgmma_s8(acc[1], da + 2 * kk, db1 + 2 * kk, accumulate);
      }
      wgmma_commit();
      // the previous stage's products are done: give its slot back
      wgmma_wait<1>();
      if (k > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    fence_acc(acc);
    epi(c, acc, second);
  }
}

template <typename T>
__global__ void __launch_bounds__(BLOCK, 1)
    int8_mlp_kernel(const __grid_constant__ CUtensorMap map_xq,
                    const __grid_constant__ CUtensorMap map_w1,
                    const __grid_constant__ CUtensorMap map_hq,
                    const __grid_constant__ CUtensorMap map_w2, const T* __restrict__ x,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const float* __restrict__ s2, const float* __restrict__ b2,
                    T* __restrict__ y, long long rows, int d, int h,
                    unsigned char* __restrict__ scratch) {
  extern __shared__ unsigned char smem_raw[];
  // the tile's row scales and their reciprocals, the x rows' amax as the
  // bits of |x|
  __shared__ float xs[BM], hs[BM], xr[BM], hr[BM];
  __shared__ unsigned xbits[BM];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the ring 1024-byte aligned, as the 128-byte swizzle wants
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);          // the producer's arrival with its bytes
      mbar_init(&empty[s], 8);         // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long tiles = (rows + BM - 1) / BM;
  const int slot_row = blockIdx.x * BM;   // the block's rows in the int8 scratch
  uint32_t it = 0;                        // ring stages walked, by either side

  if (threadIdx.x < 128) {
    // the producer: one thread of warp 0 issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x >= 32) return;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      bar_sync(XQ_READY, 32 + THREADS);
      if (threadIdx.x == 0)
        produce(&map_xq, slot_row, &map_w1, d, (h + BN - 1) / BN, ring, full, empty, it);
      __syncwarp();
      bar_sync(HQ_READY, 32 + THREADS);
      if (threadIdx.x == 0)
        produce(&map_hq, slot_row, &map_w2, h, (d + BN - 1) / BN, ring, full, empty, it);
      __syncwarp();
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const size_t slots = gridDim.x;
  int8_t* xq = reinterpret_cast<int8_t*>(scratch) + (size_t)blockIdx.x * BM * d;
  T* hid = reinterpret_cast<T*>(scratch + slots * BM * d) + (size_t)blockIdx.x * BM * h;
  int8_t* hq = reinterpret_cast<int8_t*>(scratch + slots * BM * d + slots * BM * h * sizeof(T)) +
               (size_t)blockIdx.x * BM * h;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows of the tile: r0 and r0 + 8
  const int r0 = (ctid() / 128) * 64 + ((ctid() / 32) & 3) * 16 + g;
  constexpr int N = Pack<T>::N;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;

    // 1. the tile's x rows, quantized: in one read where they fit in the
    // ring; else streamed twice, for each row's amax (a warp's lanes on one
    // row meet in one shared-memory atomic), then for the values. Rows past
    // the end quantize to 0
    const int live = rows - row0 < BM ? (int)(rows - row0) : BM;
    const int rb = d * (int)sizeof(T);                 // bytes an x row
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(x + row0 * d);
    if (BM * rb <= RING_BYTES) {
      quantize_x_whole<T>(xb, live, d, ring, xq, xs, xr);
    } else {
      if (ctid() < BM) xbits[ctid()] = 0u;
      consumer_sync();
      stream_words(xb, live * rb, ring, [&](int off, bool in, const uint4& w) {
        float v[N];
        unpack<T>(w, v);
        float m = 0.0f;
#pragma unroll
        for (int i = 0; i < N; ++i) m = fmaxf(m, fabsf(v[i]));
        const int r = in ? off / rb : -1;
        const unsigned grp = __match_any_sync(0xffffffffu, r);
        const unsigned mb = __reduce_max_sync(grp, __float_as_uint(m));
        if (in && lane == __ffs(grp) - 1) atomicMax(&xbits[r], mb);
      });
      if (ctid() < BM) {
        const float sc = row_scale(__uint_as_float(xbits[ctid()]));
        xs[ctid()] = sc;
        xr[ctid()] = __frcp_rn(sc);
      }
      consumer_sync();
      stream_words(xb, live * rb, ring, [&](int off, bool in, const uint4& w) {
        if (!in) return;
        float v[N];
        unpack<T>(w, v);
        const int r = off / rb;
        store_q<N>(xq + off / (int)sizeof(T), v, xs[r], xr[r]);
      });
    }
    for (int i = live * d + ctid() * 16; i < BM * d; i += THREADS * 16)
      *reinterpret_cast<uint4*>(xq + i) = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();             // for TMA: xq, and the ring it refills
    bar_arrive(XQ_READY, 32 + THREADS);

    // 2. fc1 + epilogue into the hidden slice, this thread's rows' amax
    // kept in m0, m1
    float m0 = 0.0f, m1 = 0.0f;
    const float xs0 = xs[r0], xs1 = xs[r0 + 8];
    consume(d, h, ring, full, empty, it, [&](int c, const int (&acc)[2][64], bool second) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (hf == 1 && !second) break;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = c * BN + hf * HALF + j * 8 + 2 * t;
          const float cs0 = s1[col], cs1 = s1[col + 1], bb0 = b1[col], bb1 = b1[col + 1];
          const float v00 = to_f32(from_f32<T>(gelu(rescale(acc[hf][4 * j], xs0, cs0, bb0))));
          const float v01 = to_f32(from_f32<T>(gelu(rescale(acc[hf][4 * j + 1], xs0, cs1, bb1))));
          const float v10 = to_f32(from_f32<T>(gelu(rescale(acc[hf][4 * j + 2], xs1, cs0, bb0))));
          const float v11 = to_f32(from_f32<T>(gelu(rescale(acc[hf][4 * j + 3], xs1, cs1, bb1))));
          store2<T>(hid + (size_t)r0 * h + col, v00, v01);
          store2<T>(hid + (size_t)(r0 + 8) * h + col, v10, v11);
          m0 = fmaxf(m0, fmaxf(fabsf(v00), fabsf(v01)));
          m1 = fmaxf(m1, fmaxf(fabsf(v10), fabsf(v11)));
        }
      }
    });

    // 3. each row's scale from its amax (a quad holds all of a row's
    // columns), then the hidden slice quantized into int8
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    if (t == 0) {
      hs[r0] = row_scale(m0);
      hr[r0] = __frcp_rn(hs[r0]);
      hs[r0 + 8] = row_scale(m1);
      hr[r0 + 8] = __frcp_rn(hs[r0 + 8]);
    }
    consumer_sync();                 // the scales and the hidden rows are in
    const int hb = h * (int)sizeof(T);                 // bytes a hidden row
    stream_words(reinterpret_cast<const unsigned char*>(hid), BM * hb, ring,
                 [&](int off, bool in, const uint4& w) {
                   if (!in) return;
                   float v[N];
                   unpack<T>(w, v);
                   const int r = off / hb;
                   store_q<N>(hq + off / (int)sizeof(T), v, hs[r], hr[r]);
                 });
    fence_proxy_async();
    bar_arrive(HQ_READY, 32 + THREADS);

    // 4. fc2 + epilogue straight to y's live rows
    const float hs0 = hs[r0], hs1 = hs[r0 + 8];
    T* yt = y + row0 * d;
    consume(h, d, ring, full, empty, it, [&](int c, const int (&acc)[2][64], bool second) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (hf == 1 && !second) break;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = c * BN + hf * HALF + j * 8 + 2 * t;
          const float cs0 = s2[col], cs1 = s2[col + 1], bb0 = b2[col], bb1 = b2[col + 1];
          if (r0 < live)
            store2<T>(yt + (size_t)r0 * d + col, rescale(acc[hf][4 * j], hs0, cs0, bb0),
                      rescale(acc[hf][4 * j + 1], hs0, cs1, bb1));
          if (r0 + 8 < live)
            store2<T>(yt + (size_t)(r0 + 8) * d + col, rescale(acc[hf][4 * j + 2], hs1, cs0, bb0),
                      rescale(acc[hf][4 * j + 3], hs1, cs1, bb1));
        }
      }
    });
    // the next tile's first barrier orders xs, hs and the slice's reuse
    consumer_sync();
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// The map of a row-major int8 matrix (rows x cols) read in boxes of
// box_rows x 128 bytes, 128-byte swizzled; rows past the end read as 0.
bool make_map(CUtensorMap* m, const void* base, long long rows, int cols, int box_rows) {
  const EncodeFn enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int SMEM_BYTES = RING_BYTES + 1024;   // room to align the ring

template <typename T>
int set_smem() {
  const cudaError_t err = cudaFuncSetAttribute(
      int8_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) cudaGetLastError();  // clear it, or the next launch would report it
  return (int)err;
}

// Blocks of the persistent grid: one per SM, at most one per tile.
long long grid_for(long long rows) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (rows + BM - 1) / BM;
  return tiles < sms ? tiles : sms;
}

template <typename T>
int launch(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
           const void* s2, const void* b2, void* y, long long rows, int d, int h,
           void* scratch, cudaStream_t stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int err = set_smem<T>();
  if (err != 0) return err;
  const long long grid = grid_for(rows);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const long long srows = grid * BM;
  CUtensorMap mxq, mw1, mhq, mw2;
  if (!make_map(&mxq, sc, srows, d, BM) || !make_map(&mw1, w1, h, d, BN) ||
      !make_map(&mhq, sc + srows * d + srows * h * (long long)sizeof(T), srows, h, BM) ||
      !make_map(&mw2, w2, d, h, BN))
    return (int)cudaErrorInvalidValue;
  int8_mlp_kernel<T><<<(unsigned)grid, BLOCK, SMEM_BYTES, stream>>>(
      mxq, mw1, mhq, mw2, static_cast<const T*>(x), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(y), rows, d, h, sc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of global scratch `lr2ppo_int8_mlp` needs for this shape on the
// current device: one slice per block.
long long lr2ppo_int8_mlp_scratch_bytes(long long rows, int d, int h, int dtype) {
  if (rows <= 0 || d % 128 != 0 || h % 128 != 0) return 0;
  return grid_for(rows) * (long long)slice_bytes(d, h, dtype == 0 ? 4 : 2);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x and y are (rows, d) of dtype 0 = float32 or 1 = bfloat16, 16-byte
// aligned; w1 is (h, d) int8, w2 (d, h) int8, both row-major and 16-byte
// aligned; s1, b1 (h,) and s2, b2 (d,) float32. `scratch` holds
// lr2ppo_int8_mlp_scratch_bytes() bytes, 16-byte aligned. Needs d and h
// multiples of 128.
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
