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
// divides once and steps (r, c) across row ends (the split path).
//
// Replaces lr2ppo_tpu/ops/hash_dropout.py:89 hash_dropout (`_apply`), which
// is jnp that XLA fuses, not Pallas. The plain PyTorch version is
// lr2ppo_torch/ops/hash_dropout.py:hash_dropout_reference; forward and
// backward (the same mask on the cotangent) both launch this kernel.
//
// What bounds it: bytes. Each element is read once and written once: 2 x
// 616.6 MB for the 308M-element bfloat16 FFN-inner site of the PPO update,
// 0.368 ms at 3.35 TB/s; the card's own copy of those bytes takes ~0.41
// ms. Its integer operations, ~12 a value as fmix32 is written, are a
// third of the SMs' integer issue rate at that speed, so the threads must
// hash while the bytes move.
//
// Design: two paths, both hand-written, chosen by size. An input larger
// than the L2 (the update's site) streams through a persistent kernel on
// Hopper's 1-D bulk copies: BLOCKS_PER_SM blocks an SM walk the array in
// chunks of CHUNK bytes (block b takes chunks b, b + grid, ...), each
// block holding a ring of STAGES chunks in dynamic shared memory. One
// thread issues a bulk load (global -> shared, completing on the stage's
// mbarrier, evict-first in the L2) for each stage ahead; every thread
// hashes and scales its 16-byte packs of the stage in place; after a proxy
// fence and a barrier the same thread issues the chunk's bulk store
// (shared -> global) and, once the previous chunk's store has read its
// stage, refills that stage with the chunk STAGES - 1 ahead. So (STAGES -
// 1) x BLOCKS_PER_SM chunks (96 KB) of loads and the stores behind them
// are in flight on each SM, where a load-hash-store loop kept one 16-byte
// pack a thread, and no thread spends an instruction or a register on
// moving bytes. An input the L2 holds (the tower sites, 3-50 MB) is a few
// chunks a block, where each chunk's wait, barrier and store would be
// paid in series: it takes the register path, a grid-stride loop of one
// 16-byte pack a thread a step (measured faster there than the ring and
// than 4 packs a thread in flight, PERF.md §6). The hash is cut to
// ~8 integer operations a value (`mix`, drop_pack), as bfloat16 brings two
// values a 4-byte word. On either path only the final fewer than 16 bytes
// are done element by element, by block 0. Both plans (the ring's chunks,
// stage order and refills; the register path's strides; each pack's first
// global index; the hash as drop_pack splits it; the tail) are walked in
// plain PyTorch by lr2ppo_torch/ops/hash_dropout.py:plan_keep_mask, which
// the CPU tests hold equal to the plain version and to JAX's `_apply`.

#include "hopper.cuh"

namespace {

using lr2ppo::Pack;
namespace hop = lr2ppo::hopper;

// The geometry, mirrored in ops/hash_dropout.py and reported by
// lr2ppo_hash_dropout_geometry: the ring's chunk, stages and blocks an SM;
// the threads of a block on both paths; the register path's blocks an SM.
constexpr int CHUNK = 16384;          // bytes a stage, a multiple of 16
constexpr int STAGES = 4;
constexpr int BLOCKS_PER_SM = 2;
constexpr int THREADS = 256;
constexpr int REG_BLOCKS_PER_SM = 8;
constexpr int SMEM_BYTES = STAGES * CHUNK + STAGES * 8;   // the ring, then its mbarriers
constexpr int MAX_DEVICES = 64;

// murmur3's fmix32(i ^ seed_mix), from s1 = seed_mix ^ (seed_mix >> 16):
// the finalizer's first step (i ^ m) ^ ((i ^ m) >> 16) is i ^ (i >> 16) ^ s1,
// one three-input xor. `rest` is the finalizer after its first step.
__device__ __forceinline__ uint32_t rest(uint32_t h) {
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}
__device__ __forceinline__ uint32_t mix(uint32_t i, uint32_t s1) {
  return rest(i ^ (i >> 16) ^ s1);
}

// The shard's place in the global array (see above).
struct Place {
  uint32_t row0, col0, width;
  long long w;
};

// Global position of local element f = r * w + c (the split path).
__device__ __forceinline__ uint32_t global_index(const Place& g, long long r, long long c) {
  return (g.row0 + (uint32_t)r) * g.width + g.col0 + (uint32_t)c;
}

// The N values of the pack at local element f, masked and scaled in v. On
// the fast path a pack whose first index i0 is a multiple of N (N a power
// of 2: 4 or 8) holds i0 ^ j for j < N, all with i0's bits above 16, so
// its first mixing step is t ^ j for one t a pack.
template <int N, bool kSplit>
__device__ __forceinline__ void drop_pack(float (&v)[N], long long f, uint32_t base,
                                          uint32_t s1, uint32_t thr, float scale,
                                          const Place& g) {
  if (kSplit) {
    // a 32-bit division where both fit, as they do below 2^32 values
    long long r = (f | g.w) < (1LL << 32) ? (long long)((uint32_t)f / (uint32_t)g.w) : f / g.w;
    long long c = f - r * g.w;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[j] = lr2ppo::drop(v[j], mix(global_index(g, r, c), s1) < thr, scale);
      if (++c == g.w) {
        c = 0;
        ++r;
      }
    }
  } else {
    const uint32_t i0 = base + (uint32_t)f;
    if ((i0 & (N - 1)) == 0) {
      const uint32_t t = i0 ^ (i0 >> 16) ^ s1;
#pragma unroll
      for (int j = 0; j < N; ++j)
        v[j] = lr2ppo::drop(v[j], rest(t ^ (uint32_t)j) < thr, scale);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        v[j] = lr2ppo::drop(v[j], mix(i0 + (uint32_t)j, s1) < thr, scale);
    }
  }
}

// 16 bytes of T from and to N floats (common.cuh's Pack), bfloat16 rounded
// a pair at a time: cvt.rn.bf16x2.f32 rounds each as __float2bfloat16_rn.
template <typename T>
__device__ __forceinline__ void store_pack(T* p, const float (&v)[Pack<T>::N]) {
  Pack<T>::store(p, v);
}
template <>
__device__ __forceinline__ void store_pack<__nv_bfloat16>(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The final values, fewer than one pack, by block 0.
template <typename T, bool kSplit>
__device__ __forceinline__ void drop_tail(const T* __restrict__ x, T* __restrict__ y, long long n,
                                          uint32_t base, uint32_t s1, uint32_t thr, float scale,
                                          const Place& g) {
  const long long f = n / Pack<T>::N * Pack<T>::N + threadIdx.x;
  if (blockIdx.x == 0 && f < n) {
    float v[1] = {lr2ppo::to_f32(x[f])};
    drop_pack<1, kSplit>(v, f, base, s1, thr, scale, g);
    y[f] = lr2ppo::from_f32<T>(v[0]);
  }
}

// The ring (see above).
template <typename T, bool kSplit>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    hash_dropout_ring(const T* __restrict__ x, T* __restrict__ y, long long n, uint32_t seed_mix,
                      uint32_t thr, float scale, Place g, bool evict_first) {
  constexpr int N = Pack<T>::N;                       // values a 16-byte pack
  constexpr long long PER_CHUNK = CHUNK / sizeof(T);  // values a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * CHUNK);
  const uint32_t base = g.row0 * g.width;             // the fast path's offset
  const uint32_t s1 = seed_mix ^ (seed_mix >> 16);
  const long long ring = n / N * N;                   // values through the ring
  const long long chunks = (ring + PER_CHUNK - 1) / PER_CHUNK;
  drop_tail<T, kSplit>(x, y, n, base, s1, thr, scale, g);
  if ((long long)blockIdx.x >= chunks) return;
  // this block's chunks: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long mine = (chunks - 1 - blockIdx.x) / gridDim.x + 1;
  const bool leader = threadIdx.x == 0;
  auto chunk_of = [&](long long it) { return (long long)blockIdx.x + it * gridDim.x; };
  auto bytes_of = [&](long long c) {
    const long long left = ring - c * PER_CHUNK;
    return (unsigned)((left < PER_CHUNK ? left : PER_CHUNK) * (long long)sizeof(T));
  };
  const uint64_t policy = hop::l2_policy(evict_first);
  auto load = [&](long long it) {
    const int s = (int)(it % STAGES);
    const long long c = chunk_of(it);
    const unsigned bytes = bytes_of(c);
    hop::mbar_expect_tx(&full[s], bytes);
    hop::bulk_load(smem + s * CHUNK, x + c * PER_CHUNK, bytes, &full[s], policy);
  };
  if (leader) {
    for (int s = 0; s < STAGES; ++s) hop::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long it = 0; it < STAGES && it < mine; ++it) load(it);
  }
  __syncthreads();

  for (long long it = 0; it < mine; ++it) {
    const int s = (int)(it % STAGES);
    const long long c = chunk_of(it);
    const unsigned bytes = bytes_of(c);
    T* stage = reinterpret_cast<T*>(smem + s * CHUNK);
    hop::mbar_wait(&full[s], (unsigned)((it / STAGES) & 1));
    const int packs = (int)(bytes / 16);
#pragma unroll 4
    for (int p = threadIdx.x; p < packs; p += THREADS) {
      float v[N];
      Pack<T>::load(stage + p * N, v);
      drop_pack<N, kSplit>(v, c * PER_CHUNK + (long long)p * N, base, s1, thr, scale, g);
      store_pack<T>(stage + p * N, v);
    }
    hop::fence_proxy_async_shared();
    __syncthreads();
    if (leader) {
      hop::bulk_store(y + c * PER_CHUNK, stage, bytes);
      hop::bulk_commit();
      // the previous chunk's stage, once its store has read it, takes the
      // chunk STAGES - 1 ahead of this one
      if (it >= 1 && it - 1 + STAGES < mine) {
        hop::bulk_wait_read<1>();
        load(it - 1 + STAGES);
      }
    }
  }
  if (leader) hop::bulk_wait<0>();
}

// The register path: thread t of a grid of `stride` threads takes packs t,
// t + stride, ...
template <typename T, bool kSplit>
__global__ void __launch_bounds__(THREADS)
    hash_dropout_regs(const T* __restrict__ x, T* __restrict__ y, long long n, uint32_t seed_mix,
                      uint32_t thr, float scale, Place g) {
  constexpr int N = Pack<T>::N;
  const uint32_t base = g.row0 * g.width;
  const uint32_t s1 = seed_mix ^ (seed_mix >> 16);
  const long long packs = n / N;
  drop_tail<T, kSplit>(x, y, n, base, s1, thr, scale, g);
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < packs; p += stride) {
    float v[N];
    Pack<T>::load(x + p * N, v);
    drop_pack<N, kSplit>(v, p * N, base, s1, thr, scale, g);
    store_pack<T>(y + p * N, v);
  }
}

// Per device, read on its first launch: the SM count and the L2's bytes.
struct Card {
  int sms = 0, l2 = 0;
};
const Card& card(int dev) {
  static Card cards[MAX_DEVICES];
  Card& c = cards[dev];
  if (c.sms == 0) {
    cudaDeviceGetAttribute(&c.l2, cudaDevAttrL2CacheSize, dev);
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return c;
}

// Inputs of more than this many bytes take the ring; -1: the card's L2
// (lr2ppo_hash_dropout_ring_from sets it, for the tests of the ring at
// small sizes).
long long ring_from = -1;

template <typename T, bool kSplit>
int launch(const void* x, void* y, long long n, uint32_t seed_mix, uint32_t thr, float scale,
           const Place& g, cudaStream_t stream) {
  static bool ready[MAX_DEVICES] = {};   // the ring may take its shared memory
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const Card& c = card(dev);
  const long long bytes = n * (long long)sizeof(T);
  if (bytes <= (ring_from < 0 ? (long long)c.l2 : ring_from)) {
    const long long blocks = (n / Pack<T>::N + THREADS - 1) / THREADS;
    const long long cap = (long long)REG_BLOCKS_PER_SM * c.sms;
    hash_dropout_regs<T, kSplit><<<(unsigned)(blocks < 1 ? 1 : blocks < cap ? blocks : cap),
                                   THREADS, 0, stream>>>(static_cast<const T*>(x),
                                                         static_cast<T*>(y), n, seed_mix, thr,
                                                         scale, g);
    return (int)cudaGetLastError();
  }
  auto kernel = hash_dropout_ring<T, kSplit>;
  if (!ready[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return (int)err;
    }
    ready[dev] = true;
  }
  const long long per_chunk = CHUNK / (long long)sizeof(T);
  const long long chunks = (n / Pack<T>::N * Pack<T>::N + per_chunk - 1) / per_chunk;
  const long long cap = (long long)BLOCKS_PER_SM * c.sms;
  const unsigned grid = (unsigned)(chunks < 1 ? 1 : chunks < cap ? chunks : cap);
  // an input larger than the L2 is read evict-first: 0.433 against 0.448 ms
  // at the update's site (PERF.md §6)
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), n,
                                                seed_mix, thr, scale, g, bytes > c.l2);
  return (int)cudaGetLastError();
}

int dispatch(const void* x, void* y, long long n, uint32_t seed_mix, uint32_t thr, float scale,
             int dtype, void* stream, const Place& g, bool split) {
  if (n <= 0 || (dtype != 0 && dtype != 1) || g.w <= 0 || n % g.w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return split ? launch<float, true>(x, y, n, seed_mix, thr, scale, g, s)
                 : launch<float, false>(x, y, n, seed_mix, thr, scale, g, s);
  return split ? launch<__nv_bfloat16, true>(x, y, n, seed_mix, thr, scale, g, s)
               : launch<__nv_bfloat16, false>(x, y, n, seed_mix, thr, scale, g, s);
}

}  // namespace

extern "C" {

// Launches on `stream` (a stream of the current device) and returns
// cudaGetLastError() (0 on success). x and y are n contiguous values of
// dtype 0 = float32 or 1 = bfloat16, both 16-byte aligned; scale is
// 1/keep_eff already rounded to the dtype. x is the whole array: i = f.
int lr2ppo_hash_dropout(const void* x, void* y, long long n, uint32_t seed_mix, uint32_t thr,
                        float scale, int dtype, void* stream) {
  return dispatch(x, y, n, seed_mix, thr, scale, dtype, stream, Place{0, 0, 0, n}, false);
}

// The same, x being rows of w values at (row0, col0) of a global array
// `width` wide (all taken mod 2^32).
int lr2ppo_hash_dropout_place(const void* x, void* y, long long n, uint32_t seed_mix,
                              uint32_t thr, float scale, int dtype, void* stream, uint32_t row0,
                              uint32_t col0, uint32_t width, long long w) {
  return dispatch(x, y, n, seed_mix, thr, scale, dtype, stream, Place{row0, col0, width, w},
                  col0 != 0 || (long long)width != w);
}

// The geometry: 0 the ring's chunk bytes, 1 its stages, 2 its blocks an
// SM, 3 the threads a block, 4 the register path's blocks an SM.
int lr2ppo_hash_dropout_geometry(int what) {
  const int g[5] = {CHUNK, STAGES, BLOCKS_PER_SM, THREADS, REG_BLOCKS_PER_SM};
  return what >= 0 && what < 5 ? g[what] : -1;
}

// Inputs of more than `bytes` take the ring from now on (-1: more than the
// card's L2, the default); returns the setting it replaces.
long long lr2ppo_hash_dropout_ring_from(long long bytes) {
  const long long before = ring_from;
  ring_from = bytes < 0 ? -1 : bytes;
  return before;
}

}  // extern "C"
