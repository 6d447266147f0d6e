// The backward of the latent tower's causal attention (ops/mla_attention.py)
// on Hopper: dK, dV and dQ in one pass over the (key, query) tiles at or
// below the diagonal, each product computed once.
//
// It replaces no TPU kernel: the JAX package has no latent attention. q and
// k are Dqk = 192 wide, v, o and dO Dv = 128, all bfloat16; the forward's
// log-sum-exp (log2 units of the scaled scores) is float32. The work is
// 2 x 832 operations a (query, key) pair at or below the diagonal (the five
// products S = QK^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K), about
// 2,700 operations a byte at 8,192 tokens: bound by the tensor cores.
//
// The design, one block of two warpgroups per 128 keys of one (batch, head):
//   - each warpgroup owns 64 keys and holds their dK and dV (64 x 320
//     float32, 160 registers a thread) for the whole walk. K (192 wide) and
//     V (128) are loaded once by TMA; the query tiles, 64 queries a stage
//     (Q, dO, and the rows' log-sum-exp and delta), stream from the diagonal
//     to the end through a ring of 2 stages with full mbarriers, each stage
//     refilled by thread 0 as soon as both warpgroups are past it;
//   - for each query tile a warpgroup computes S^T = K Q^T, and dP^T =
//     V dO^T while it turns S^T into P^T = exp2(S^T c - lse), with the keys
//     as wgmma's M: P^T comes out in the layout of wgmma's register A
//     operand, so dV += P^T dO reads it from registers, and runs while
//     dS^T = P^T (dP^T - delta) is computed into shared memory, from which
//     dK += dS^T Q reads it;
//   - once both warpgroups' halves of dS^T are in, each computes dQ = dS K
//     for 96 of the 192 columns over all 128 keys, stages it in shared
//     memory in wgmma's fragment order, and one thread adds it to a float32
//     accumulator in global memory with a single TMA bulk reduce (16-byte
//     vector atomics cost twice as much: the L2 pays by the operation);
//   - only the tiles on the diagonal (and a ragged last tile) compute the
//     causal mask. Blocks run head by head, each head's key tiles
//     heaviest first (key tile 0 walks every query tile), so the heads in
//     flight keep their dQ accumulators and their Q and dO in the L2
//     (ordered key tile first, the same kernel takes twice as long).
// There is no producer warp: a block of 256 threads puts 2 warps on each of
// the SM's four register files, so a thread may hold up to 255 registers
// (this kernel takes about 250); a third warpgroup caps every thread at
// 168, and ptxas does not allocate past that after setmaxnreg. K sits in
// shared memory with the 64-byte swizzle (boxes of 32 columns), so each
// warpgroup's 96 dQ columns start on a swizzle atom; Q, dO, V and dS^T with
// the 128-byte swizzle. A pre-pass writes delta = rowsum(dO o O) and zeroes
// the accumulator; a last pass writes dQ x scale in bfloat16.
#include "hopper.cuh"

namespace lr2ppo {
namespace mla {

using bf16 = __nv_bfloat16;
using hopper::bar_sync;
using hopper::bulk_commit;
using hopper::bulk_load;
using hopper::bulk_wait;
using hopper::bulk_wait_read;
using hopper::encode_fn;
using hopper::EncodeFn;
using hopper::fence_proxy_async_shared;
using hopper::l2_policy;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int DQK = 192, DV = 128;
constexpr int BN = 128;       // keys a block, 64 a consumer warpgroup
constexpr int BM = 64;        // queries a stage
constexpr int STAGES = 2;
// two warpgroups, 2 warps on each of the SM's four register files, so a
// thread may hold up to 255 registers (a third warpgroup would cap them at
// 168)
constexpr int THREADS = 256;
// shared memory: every tile 1024-byte aligned
constexpr int K_BOX = BN * 32 * 2;          // 32 columns of the keys (64-byte swizzle)
constexpr int V_BOX = BN * 64 * 2;          // 64 columns of the keys' values
constexpr int Q_BOX = BM * 64 * 2;          // 64 columns of a stage's queries
constexpr int Q_BYTES = 3 * Q_BOX, DO_BYTES = 2 * Q_BOX;
constexpr int DS_BYTES = BN * BM * 2;       // dS^T, keys x queries
constexpr int ROW_BYTES = BM * 4;           // a stage's lse or delta
constexpr int OFF_V = 6 * K_BOX;
constexpr int OFF_Q = OFF_V + 2 * V_BOX;
constexpr int OFF_DO = OFF_Q + STAGES * Q_BYTES;
constexpr int OFF_DS = OFF_DO + STAGES * DO_BYTES;
constexpr int OFF_DQ = OFF_DS + DS_BYTES;   // a tile's dQ, staged for the bulk reduce
constexpr int OFF_LSE = OFF_DQ + BM * DQK * 4;
constexpr int OFF_DELTA = OFF_LSE + STAGES * ROW_BYTES;
constexpr int OFF_BAR = OFF_DELTA + STAGES * ROW_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 64 + 1024;   // room to align the base
constexpr unsigned KV_TX = 6 * K_BOX + 2 * V_BOX;
constexpr unsigned STAGE_TX = Q_BYTES + DO_BYTES + 2 * ROW_BYTES;
// the dQ accumulator: a query tile's 64 x 192 float32 as [warpgroup][12][128 threads][4]
constexpr int ACC_TILE = BM * DQK;
constexpr uint64_t SW128 = 1, SW64 = 2;

// wgmma's shared-memory descriptor: the start, the leading and stride byte
// offsets, the swizzle. K-major tiles ignore the leading offset; an MN-major
// tile's leading offset steps to its next swizzle atom along M or N, and
// the stride offset to its next 8 rows along K.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo, uint64_t sw) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (sw << 62);
}

// A 4D TMA load of the box at (column c0, row c1, head c2, batch c3).
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Keep the compiler from touching registers an in-flight wgmma reads or
// writes before the wgmma_wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// bf16 in, float32 accumulators: n64 both operands K-major in shared memory
// (S^T, dP^T); n192_kmn A K-major and B MN-major (dK); n96_mn both MN-major
// (dQ); rs_n128 A (64 x 16) from four registers a thread, B MN-major (dV).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n192_kmn(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n96_mn(float (&d)[48], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// dst (global) += src (shared), `bytes` float32 added by the TMA unit; joins
// this thread's bulk group.
__device__ __forceinline__ void bulk_reduce_add(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

struct Strides {
  long long b, h, s;
};

__global__ void __launch_bounds__(THREADS, 1)
    bwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ acc_g, bf16* __restrict__ dk,
               bf16* __restrict__ dv, Strides sk, Strides sv, int heads, int seq, int ktiles,
               float qk_scale, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + OFF_BAR);
  uint64_t* dq_done = full + STAGES;    // both warpgroups' dQ products read dS^T
  uint64_t* kv_full = dq_done + 1;

  const int bh = blockIdx.x / ktiles, kt = blockIdx.x % ktiles;
  const int b = bh / heads, h = bh % heads;
  const int qtiles = (seq + BM - 1) / BM;
  const int m0 = kt * (BN / BM);     // the query tile on the diagonal
  const int n = qtiles - m0;
  const size_t rows = (size_t)bh * qtiles * BM;   // the head's first row of lse and delta

  // Thread 0 issues every load: a stage's Q, dO, lse and delta for
  // iteration `it` of the walk, completing on full[it % STAGES].
  auto load_stage = [&](int it) {
    const int s = it % STAGES, row = (m0 + it) * BM;
    mbar_expect_tx(&full[s], STAGE_TX);
    for (int c = 0; c < 3; ++c)
      tma_load4(sm + OFF_Q + s * Q_BYTES + c * Q_BOX, &map_q, &full[s], 64 * c, row, h, b);
    for (int c = 0; c < 2; ++c)
      tma_load4(sm + OFF_DO + s * DO_BYTES + c * Q_BOX, &map_do, &full[s], 64 * c, row, h, b);
    const uint64_t policy = l2_policy(false);
    bulk_load(sm + OFF_LSE + s * ROW_BYTES, lse + rows + row, ROW_BYTES, &full[s], policy);
    bulk_load(sm + OFF_DELTA + s * ROW_BYTES, delta + rows + row, ROW_BYTES, &full[s], policy);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(dq_done, 2);
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(kv_full, KV_TX);
    for (int c = 0; c < 6; ++c) tma_load4(sm + c * K_BOX, &map_k, kv_full, 32 * c, kt * BN, h, b);
    for (int c = 0; c < 2; ++c)
      tma_load4(sm + OFF_V + c * V_BOX, &map_v, kv_full, 64 * c, kt * BN, h, b);
    for (int it = 0; it < STAGES && it < n; ++it) load_stage(it);
  }
  __syncthreads();

  const int w = threadIdx.x >> 7;   // keys 64w .. 64w + 63 of the block
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // this thread's keys (wgmma's rows): key + 0 and key + 8
  const int key = kt * BN + 64 * w + 16 * warp + g;
  // descriptors of the fixed tiles; a step within a tile adds its byte
  // offset / 16 to the start address
  const uint64_t k_a = desc(sm + w * 64 * 64, 16, 512, SW64);            // K, A of S^T
  const uint64_t v_a = desc(sm + OFF_V + w * 64 * 128, 16, 1024, SW128);  // V, A of dP^T
  const uint64_t k_b = desc(sm + 3 * w * K_BOX, K_BOX, 512, SW64);        // K, B of dQ
  // the thread's rows of dS^T: row0 and row0 + 8
  const int row0 = 64 * w + 16 * warp + g;
  float dk_acc[96], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 96; ++i) dk_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) dv_acc[i] = 0.0f;

  // dQ of iteration j (the tile's 64 queries, columns 96w .. 96w + 95) =
  // dS K over the 128 keys, staged in shared memory in wgmma's fragment
  // order and added to the accumulator by one bulk reduce a warpgroup
  float4* stage_dq = reinterpret_cast<float4*>(sm + OFF_DQ) + w * (ACC_TILE / 8);
  auto dq_tile = [&](int j) {
    const uint64_t ds_mn = desc(sm + OFF_DS, 8192, 1024, SW128);   // A
    float qacc[48];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_n96_mn(qacc, ds_mn + kk * 2048 / 16, k_b + kk * 1024 / 16, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(qacc);
    if (tid == 0) {
      mbar_arrive(dq_done);    // this warpgroup is done with dS^T
      bulk_wait_read<0>();     // the previous tile's reduce has read the stage
    }
    bar_sync(1 + w, 128);
#pragma unroll
    for (int i = 0; i < 12; ++i)
      stage_dq[128 * i + tid] =
          make_float4(qacc[4 * i], qacc[4 * i + 1], qacc[4 * i + 2], qacc[4 * i + 3]);
    fence_proxy_async_shared();
    bar_sync(1 + w, 128);
    if (tid == 0) {
      bulk_reduce_add(acc_g + ((size_t)bh * qtiles + m0 + j) * ACC_TILE + w * (ACC_TILE / 2),
                      stage_dq, ACC_TILE * 2);
      bulk_commit();
    }
  };

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES, m = m0 + it;
    const float* lse_s = reinterpret_cast<const float*>(sm + OFF_LSE + s * ROW_BYTES);
    const float* delta_s = reinterpret_cast<const float*>(sm + OFF_DELTA + s * ROW_BYTES);
    unsigned char* ds = sm + OFF_DS;
    const uint64_t q_b = desc(sm + OFF_Q + s * Q_BYTES, 16, 1024, SW128);       // B of S^T
    const uint64_t q_mn = desc(sm + OFF_Q + s * Q_BYTES, Q_BOX, 1024, SW128);   // B of dK
    const uint64_t do_b = desc(sm + OFF_DO + s * DO_BYTES, 16, 1024, SW128);    // B of dP^T
    const uint64_t do_mn = desc(sm + OFF_DO + s * DO_BYTES, Q_BOX, 1024, SW128);  // B of dV
    const uint64_t ds_k = desc(ds + w * 64 * 128, 16, 1024, SW128);             // A of dK
    mbar_wait(&full[s], (it / STAGES) & 1);

    // S^T = K Q^T over the 192 columns; dP^T = V dO^T over the 128 then
    // runs while P^T is computed
    float acc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 12; ++kk)
      wgmma_n64(acc, k_a + ((kk >> 1) * K_BOX + (kk & 1) * 32) / 16,
                q_b + ((kk >> 2) * Q_BOX + (kk & 3) * 32) / 16, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_n64(dp, v_a + ((kk >> 2) * V_BOX + (kk & 3) * 32) / 16,
                do_b + ((kk >> 2) * Q_BOX + (kk & 3) * 32) / 16, kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);

    // P^T = exp2(S^T c - lse), as bf16 A fragments: acc[4j + i] is key
    // + 8 (i >> 1), query 8j + 2t + (i & 1); pa[2j + h] holds the pair
    // acc[4j + 2h], acc[4j + 2h + 1], so k step kk is pa[4kk .. 4kk + 3]
    const bool masked = m < m0 + BN / BM || (m + 1) * BM > seq;
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = ex2(__fmaf_rn(acc[4 * j + i], qk_scale, -((i & 1) ? l.y : l.x)));
        if (masked) {
          const int q = m * BM + 8 * j + 2 * t + (i & 1);
          if (q < key + 8 * (i >> 1) || q >= seq) p = 0.0f;
        }
        acc[4 * j + i] = p;
      }
      pa[2 * j] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }

    // dV += P^T dO over the tile's 64 queries runs while dS^T = P^T
    // (dP^T - delta) is computed, from P^T as rounded to bf16, into
    // shared memory: 128-byte swizzled, the pair at 16-byte chunk j ^ g of
    // rows row0 and row0 + 8
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128(dv_acc, pa + 4 * kk, do_mn + kk * 2048 / 16);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dp);
    // dS^T is rewritten: both warpgroups' dQ of the previous tile must
    // have read it
    if (it > 0) mbar_wait(dq_done, (it - 1) & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const uint32_t pw = pa[2 * j + h2];
        const float p0 = __uint_as_float(pw << 16), p1 = __uint_as_float(pw & 0xFFFF0000u);
        *reinterpret_cast<uint32_t*>(ds + (row0 + 8 * h2) * 128 + ((j ^ g) << 4) + 4 * t) =
            pack_bf16(__fmul_rn(p0, __fsub_rn(dp[4 * j + 2 * h2], d.x)),
                      __fmul_rn(p1, __fsub_rn(dp[4 * j + 2 * h2 + 1], d.y)));
      }
    }
    fence_proxy_async_shared();

    // dK += dS^T Q over the tile's 64 queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n192_kmn(dk_acc, ds_k + kk * 2, q_mn + kk * 2048 / 16, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);

    // both warpgroups' dS^T are in, and both are done with the stage's Q,
    // dO, lse and delta: refill it for iteration it + STAGES
    __syncthreads();
    if (threadIdx.x == 0 && it + STAGES < n) load_stage(it + STAGES);
    dq_tile(it);
  }

  if (tid == 0) bulk_wait<0>();
  // dK x scale and dV in bf16; rows past the end are not stored
  fence_regs(dk_acc);
  fence_regs(dv_acc);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = key + 8 * half;
    if (row >= seq) continue;
    bf16* pk = dk + b * sk.b + h * sk.h + row * sk.s + 2 * t;
    bf16* pv = dv + b * sv.b + h * sv.h + row * sv.s + 2 * t;
#pragma unroll
    for (int j = 0; j < 24; ++j)
      store2(pk + 8 * j, __fmul_rn(dk_acc[4 * j + 2 * half], scale),
             __fmul_rn(dk_acc[4 * j + 2 * half + 1], scale));
#pragma unroll
    for (int j = 0; j < 16; ++j) store2(pv + 8 * j, dv_acc[4 * j + 2 * half], dv_acc[4 * j + 2 * half + 1]);
  }
}

// delta = rowsum(dO o O) in float32 and the log-sum-exp, both padded to
// whole query tiles (0 past the end), and the tile's dQ accumulator zeroed:
// one block a (query tile, batch x head), 4 threads a row.
__global__ void __launch_bounds__(256)
    pre_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ lse_pad,
               float* __restrict__ delta, float* __restrict__ acc, Strides so, Strides sd,
               int heads, int seq) {
  const int m = blockIdx.x, bh = blockIdx.y, qtiles = gridDim.x;
  const int b = bh / heads, h = bh % heads;
  const int row = m * BM + threadIdx.x / 4, part = threadIdx.x % 4;
  float sum = 0.0f;
  if (row < seq) {
    const bf16* po = o + b * so.b + h * so.h + row * so.s + 32 * part;
    const bf16* pd = dout + b * sd.b + h * sd.h + row * sd.s + 32 * part;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float x[8], y[8];
      Pack<bf16>::load(po + 8 * c, x);
      Pack<bf16>::load(pd + 8 * c, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum = __fadd_rn(sum, __fmul_rn(x[i], y[i]));
    }
  }
  sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
  sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
  if (part == 0) {
    const size_t i = (size_t)bh * qtiles * BM + row;
    delta[i] = row < seq ? sum : 0.0f;
    lse_pad[i] = row < seq ? lse[(size_t)bh * seq + row] : 0.0f;
  }
  float4* z = reinterpret_cast<float4*>(acc + ((size_t)bh * qtiles + m) * ACC_TILE);
  for (int i = threadIdx.x; i < ACC_TILE / 4; i += 256) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dQ x scale in bf16 from a query tile's accumulator: back from the
// fragment order through shared memory, then 16-byte row stores.
__global__ void __launch_bounds__(256)
    dq_kernel(const float* __restrict__ acc, bf16* __restrict__ dq, Strides sq, int heads,
              int seq, float scale) {
  constexpr int PITCH = DQK + 8;   // bf16 a row, 16-byte aligned, spread over the banks
  __shared__ __align__(16) bf16 tile[BM * PITCH];
  const int m = blockIdx.x, bh = blockIdx.y, qtiles = gridDim.x;
  const int b = bh / heads, h = bh % heads;
  const float4* src = reinterpret_cast<const float4*>(acc + ((size_t)bh * qtiles + m) * ACC_TILE);
  for (int i = threadIdx.x; i < ACC_TILE / 4; i += 256) {
    const float4 v = src[i];
    // i = (warpgroup * 12 + j) * 128 + thread: rows r, r + 8, columns c, c + 1
    const int th = i & 127, wj = i >> 7, lane = th & 31;
    const int r = 16 * (th >> 5) + (lane >> 2);
    const int c = 96 * (wj / 12) + 8 * (wj % 12) + 2 * (lane & 3);
    store2(tile + r * PITCH + c, __fmul_rn(v.x, scale), __fmul_rn(v.y, scale));
    store2(tile + (r + 8) * PITCH + c, __fmul_rn(v.z, scale), __fmul_rn(v.w, scale));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * DQK / 8; i += 256) {
    const int r = i / (DQK / 8), c = 8 * (i % (DQK / 8));
    const int row = m * BM + r;
    if (row < seq)
      *reinterpret_cast<uint4*>(dq + b * sq.b + h * sq.h + row * sq.s + c) =
          *reinterpret_cast<const uint4*>(tile + r * PITCH + c);
  }
}

// The map of a (B, H, S, d) bf16 tensor with strides st (batch, head, row;
// elements) read in boxes of box_d columns x box_rows rows.
inline bool make_map4(CUtensorMap* m, const void* base, int d, int seq, int heads, int batch,
                      const long long* st, int box_d, int box_rows, CUtensorMapSwizzle sw) {
  const EncodeFn enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Let the main kernel take its dynamic shared memory.
inline int allow_smem() {
  const cudaError_t err =
      cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) cudaGetLastError();  // clear it, or the next launch would report it
  return (int)err;
}

}  // namespace mla
}  // namespace lr2ppo

extern "C" {

// Float32 scratch elements lr2ppo_mla_attention_bwd needs: the dQ
// accumulator (192 a row), the padded log-sum-exp and delta (1 each), for
// every row of whole 64-row query tiles.
long long lr2ppo_mla_attention_bwd_scratch(int batch, int heads, int seq) {
  const long long rows = (long long)batch * heads * ((seq + 63) / 64) * 64;
  return rows * (192 + 2);
}

// The backward on `stream`, three launches; returns cudaGetLastError().
// q, k (B, H, S, 192), v, o, dout (B, H, S, 128), dq, dk (B, H, S, 192) and
// dv (B, H, S, 128) bf16, any strides with the last dim contiguous, every
// stride a multiple of 8 elements and every base 16-byte aligned; lse
// (B, H, S) float32 contiguous, in log2 units of the scores x qk_scale.
// `strides` is 24 int64 on the host: (batch, head, row) of q, k, v, o,
// dout, dq, dk, dv. `scratch` holds lr2ppo_mla_attention_bwd_scratch()
// float32s.
int lr2ppo_mla_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* lse, const void* dout, void* dq, void* dk, void* dv,
                             void* scratch, int batch, int heads, int seq, const void* strides,
                             float qk_scale, float scale, void* stream) {
  using namespace lr2ppo::mla;
  if (batch <= 0 || heads <= 0 || seq <= 0 || scratch == nullptr || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  // The tensor maps are encoded through the driver, which wants the device's
  // context current in this thread (autograd's device thread may not have
  // made a runtime call yet).
  cudaPointerAttributes where;
  if (cudaPointerGetAttributes(&where, q) != cudaSuccess || cudaSetDevice(where.device) != cudaSuccess)
    return (int)cudaGetLastError();
  const long long* st = static_cast<const long long*>(strides);
  auto str = [&](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map4(&mq, q, DQK, seq, heads, batch, st, 64, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map4(&mk, k, DQK, seq, heads, batch, st + 3, 32, BN, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map4(&mv, v, DV, seq, heads, batch, st + 6, 64, BN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map4(&mdo, dout, DV, seq, heads, batch, st + 12, 64, BM, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  if (const int err = allow_smem()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qtiles = (seq + BM - 1) / BM, ktiles = (seq + BN - 1) / BN;
  const long long rows = (long long)batch * heads * qtiles * BM;
  float* acc = static_cast<float*>(scratch);
  float* lse_pad = acc + rows * DQK;
  float* delta = lse_pad + rows;
  const dim3 tiles(qtiles, batch * heads);
  pre_kernel<<<tiles, 256, 0, s>>>(static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                                   static_cast<const float*>(lse), lse_pad, delta, acc, str(3),
                                   str(4), heads, seq);
  bwd_kernel<<<batch * heads * ktiles, THREADS, SMEM_BYTES, s>>>(
      mq, mk, mv, mdo, lse_pad, delta, acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      str(6), str(7), heads, seq, ktiles, qk_scale, scale);
  dq_kernel<<<tiles, 256, 0, s>>>(acc, static_cast<bf16*>(dq), str(5), heads, seq, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
