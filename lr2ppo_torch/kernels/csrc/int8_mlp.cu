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
// The ring, the producer's and the consumers' loops, the TMA maps and the
// quantization helpers are hopper.cuh's, shared with K2 (int8_matmul.cu).
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

#include "hopper.cuh"

namespace {

using namespace lr2ppo::hopper;

constexpr int SLOTS = 4;                 // the ring as slots, for the streamed passes
constexpr int SLOT = RING_BYTES / SLOTS;
constexpr int HQ_READY = 2;              // named barrier: the int8 hidden rows are in

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

// A block's scratch: the int8 x rows (BM x d), the hidden rows in T
// (BM x h), the int8 hidden rows (BM x h). The scratch holds each part of
// every block's slice together (the blocks' int8 x rows, then their hidden
// rows, then their int8 hidden rows), so the int8 parts are two matrices
// of grid * BM rows for TMA.
__host__ __device__ inline size_t slice_bytes(int d, int h, int elem) {
  return (size_t)BM * ((size_t)d + (size_t)h * (elem + 1));
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

  if (threadIdx.x == 0) ring_init(full, empty);
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

template <typename T>
int launch(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
           const void* s2, const void* b2, void* y, long long rows, int d, int h,
           void* scratch, cudaStream_t stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int err = set_smem(int8_mlp_kernel<T>);
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