// Hopper (sm_90a) machinery shared by the int8 GEMM kernels, K1
// (int8_mlp.cu) and K2 (int8_matmul.cu): a persistent grid of one block an
// SM, each block a producer warp that streams K slices of A and B by TMA
// into a ring of shared-memory stages with full and empty mbarriers, and
// two consumer warpgroups that run wgmma.mma_async m64n128k32 s8 on the
// stages; the per-row int8 quantization both kernels write into a global
// scratch that TMA reads back; the host side that encodes the TMA maps and
// sizes the grid. Hash dropout (hash_dropout.cu) streams through the 1-D
// bulk copies and the mbarrier helpers.
//
// The ring's geometry: a tile of BM = 128 rows (64 a consumer warpgroup);
// output columns in chunks of BN = 256 (two m64n128k32 a K step, 128 s32
// accumulators a thread); a stage holds 128 bytes of K (one 128-byte
// swizzle row) of the tile's A rows and of 256 rows of B, which in torch's
// (out, in) weight layout is already the K-major operand wgmma wants.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace lr2ppo {
namespace hopper {

constexpr int BM = 128;                  // rows per tile
constexpr int BN = 256;                  // output columns per chunk
constexpr int HALF = 128;                // columns per wgmma (m64n128k32)
constexpr int BK = 128;                  // K bytes per ring stage (one swizzle row)
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK;         // a stage: the A slice, then the B slice
constexpr int STAGE_BYTES = A_BYTES + BN * BK;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int THREADS = 256;             // the two consumer warpgroups
constexpr int BLOCK = 128 + THREADS;     // the producer's warpgroup first
constexpr int SMEM_BYTES = RING_BYTES + 1024;   // room to align the ring
// named barriers: the tile's int8 A rows handed to the producer, and the
// consumers among themselves (0 is __syncthreads')
constexpr int XQ_READY = 1, CONSUMERS = 3;

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

// The ring's full and empty barriers, set up by thread 0 before the
// block's first __syncthreads.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(&full[s], 1);          // the producer's arrival with its bytes
    mbar_init(&empty[s], 8);         // one arrival from each consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
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

// The 1-D bulk copies (no tensor map): `bytes` a multiple of 16, both
// addresses 16-byte aligned. A load global -> shared completes on `bar`
// (armed with mbar_expect_tx for the bytes) and reads under the L2 cache
// `policy` (l2_policy); a store shared -> global joins this thread's bulk
// group, closed with bulk_commit and waited on with bulk_wait_read (its
// shared source read) or bulk_wait (written).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
// Wait until at most N of this thread's bulk groups are still incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}
// An L2 cache policy for the lines an access touches: evict them first
// (bytes read once from an array larger than the L2), or as usual.
__device__ __forceinline__ uint64_t l2_policy(bool evict_first) {
  uint64_t policy;
  if (evict_first)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}
// This thread's generic-proxy writes to shared memory made visible to the
// async proxy (a bulk store that reads them after a barrier).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// ops/int8.py:quantize_rows's rounding of v / sc, as __fdiv_rn would give
// the quotient, from y = 1 / sc correctly rounded: |v| <= 127 sc and
// sc >= 1e-8 / 127, so the quotient stays in range or rounds to 0
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

// ---- host side ----

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeFn encode_fn() {
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
inline bool make_map(CUtensorMap* m, const void* base, long long rows, int cols, int box_rows) {
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

// Let `kernel` take the ring's dynamic shared memory.
template <class Kernel>
int set_smem(Kernel* kernel) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) cudaGetLastError();  // clear it, or the next launch would report it
  return (int)err;
}

// Blocks of the persistent grid: one per SM, at most one per tile.
inline long long grid_for(long long rows) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (rows + BM - 1) / BM;
  return tiles < sms ? tiles : sms;
}

}  // namespace hopper
}  // namespace lr2ppo
