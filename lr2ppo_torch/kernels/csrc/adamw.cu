// AdamW's update of one parameter tensor in one pass, for Hopper (sm_90a):
//   g' = norm < clip ? g : g / norm * clip          (where a norm is given)
//   m  = m * b1 + g' * (1 - b1)
//   v  = v * b2 + g'^2 * (1 - b2)
//   u  = m * step_scale / (sqrt(v) + eps) [+ p * wd where the tensor decays]
//   p += (u * -lr) rounded to p's dtype;  m, v stored in their dtype.
//
// Replaces no TPU kernel: in the JAX package (lr2ppo_tpu/train/optim.py) the
// update is optax's chain, which XLA fuses into its own passes. The port ran
// it as AdamW.step's eager loop, ~22 float32 kernels a parameter tensor; the
// plain PyTorch version, lr2ppo_torch/ops/adamw.py:adamw_reference, is that
// loop's body, and this kernel gives its bits: every operation of the eager
// path in its order, each rounded to float32 (the library builds with
// -fmad=false, so nothing is contracted into an FMA), IEEE sqrt and
// division, the hyperparameters as the float32 values PyTorch makes of the
// Python doubles, bfloat16 stores rounded to nearest even, and the
// parameter's add done as PyTorch adds two bfloat16 tensors (in float32,
// rounded once more).
//
// What bounds it: bytes. Each element of p, g, m and v is read once and p,
// m and v written once: 20 bytes an element for the PPO trainer under
// --profile fast (float32 parameters and gradients, the compute being
// bfloat16, and bfloat16 moments), 28 for tower pretraining (all float32),
// 14 where all four are bfloat16. The ~20 float32 operations an element are
// far below the card's rate at that speed.
//
// Design: a thread takes 8 neighbouring values of a row a step, so every
// tensor moves in 16-byte loads and stores (two for a float32 tensor), and
// keeps all of the arithmetic in registers. Each tensor is rows of `cols`
// contiguous values with a row stride of its own, which covers contiguous
// tensors (one row) and a zero1 rank's slice along any one dim (a view into
// the parameter, the moments contiguous). In each row the vector steps start
// at the first column where all four tensors are 16-byte aligned; the
// columns before it and the fewer than 8 after the last step are done one by
// one by one thread, and a row where no such column exists (a view at an
// offset the others do not share) goes one by one throughout. Blocks walk
// the row's steps with a grid stride, and the grid holds as many blocks as
// the card keeps resident (the occupancy the compiler's registers allow),
// split over rows where there are several.

#include "common.cuh"

namespace {

using lr2ppo::Pack;
using lr2ppo::from_f32;
using lr2ppo::to_f32;

constexpr int THREADS = 256;
constexpr int VEC = 8;  // values a thread takes a step
constexpr int MAX_DEVICES = 64;
constexpr long long MAX_GRID_Y = 65535;

struct Hyper {
  float neg_lr, b1, omb1, b2, omb2, eps, wd, step_scale, clip;
  int decay;
};

struct Plane {
  void* p;
  const void* g;  // null: a zero gradient
  void* m;
  void* v;
  const float* norm;  // null: no clipping
  long long rows, cols, p_rs, g_rs, m_rs, v_rs;
};

// 8 values at a 16-byte aligned address, and back
template <typename T> __device__ __forceinline__ void load8(const T* s, float (&v)[VEC]);
template <> __device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* s,
                                                                 float (&v)[VEC]) {
  Pack<__nv_bfloat16>::load(s, v);
}
template <> __device__ __forceinline__ void load8<float>(const float* s, float (&v)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <typename T> __device__ __forceinline__ void store8(T* d, const float (&v)[VEC]);
template <> __device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* d,
                                                                  const float (&v)[VEC]) {
  Pack<__nv_bfloat16>::store(d, v);
}
template <> __device__ __forceinline__ void store8<float>(float* d, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(d + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// One element: m and v updated in place; returns p after its add, in
// float32 (the caller rounds it to p's dtype).
template <typename TP>
__device__ __forceinline__ float adamw1(const Hyper& h, bool clipping, float norm, float g,
                                        float& m, float& v, float p) {
  if (clipping) g = __fmul_rn(__fdiv_rn(g, norm), h.clip);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  float u = __fdiv_rn(__fmul_rn(m, h.step_scale), __fadd_rn(__fsqrt_rn(v), h.eps));
  if (h.decay) u = __fadd_rn(u, __fmul_rn(p, h.wd));
  // (u * -lr).to(p.dtype), then p.add_ in float32
  return __fadd_rn(p, to_f32<TP>(from_f32<TP>(__fmul_rn(u, h.neg_lr))));
}

__device__ __forceinline__ bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

template <typename TP, typename TG, typename TM>
__global__ void __launch_bounds__(THREADS)
    adamw_kernel(const Plane t, const Hyper h) {
  bool clipping = false;
  float norm = 0.0f;
  if (t.norm != nullptr) {
    norm = *t.norm;
    clipping = !(norm < h.clip);
  }
  const long long slots = t.cols / VEC + 1;  // vector steps, and one for the rest
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long r = blockIdx.y; r < t.rows; r += gridDim.y) {
    TP* __restrict__ p = static_cast<TP*>(t.p) + r * t.p_rs;
    const TG* __restrict__ g = t.g ? static_cast<const TG*>(t.g) + r * t.g_rs : nullptr;
    TM* __restrict__ m = static_cast<TM*>(t.m) + r * t.m_rs;
    TM* __restrict__ v = static_cast<TM*>(t.v) + r * t.v_rs;
    int head = -1;  // the first column where all four are 16-byte aligned
    for (int c = 0; c < VEC && head < 0; ++c)
      if (aligned16(p + c) && (!g || aligned16(g + c)) && aligned16(m + c) && aligned16(v + c))
        head = c;
    const long long vecs = head >= 0 && t.cols > head ? (t.cols - head) / VEC : 0;
    auto one = [&](long long c) {
      float mc = to_f32<TM>(m[c]), vc = to_f32<TM>(v[c]);
      const float pc = adamw1<TP>(h, clipping, norm, g ? to_f32<TG>(g[c]) : 0.0f, mc, vc,
                                  to_f32<TP>(p[c]));
      p[c] = from_f32<TP>(pc);
      m[c] = from_f32<TM>(mc);
      v[c] = from_f32<TM>(vc);
    };
    for (long long s = (long long)blockIdx.x * THREADS + threadIdx.x; s < slots; s += stride) {
      if (head < 0) {  // no common alignment: 8 columns one by one
        const long long end = s * VEC + VEC < t.cols ? s * VEC + VEC : t.cols;
        for (long long c = s * VEC; c < end; ++c) one(c);
      } else if (s < vecs) {
        const long long c = head + s * VEC;
        float pv[VEC], gv[VEC], mv[VEC], vv[VEC];
        load8<TP>(p + c, pv);
        if (g) {
          load8<TG>(g + c, gv);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) gv[i] = 0.0f;
        }
        load8<TM>(m + c, mv);
        load8<TM>(v + c, vv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) pv[i] = adamw1<TP>(h, clipping, norm, gv[i], mv[i], vv[i], pv[i]);
        store8<TP>(p + c, pv);
        store8<TM>(m + c, mv);
        store8<TM>(v + c, vv);
      } else if (s == vecs) {  // the columns before the first step and after the last
        const long long lead = head < t.cols ? head : t.cols;
        for (long long c = 0; c < lead; ++c) one(c);
        for (long long c = head + vecs * VEC; c < t.cols; ++c) one(c);
      }
    }
  }
}

template <typename TP, typename TG, typename TM>
int launch(const Plane& t, const Hyper& h, cudaStream_t stream) {
  static int resident[MAX_DEVICES] = {};  // blocks the card keeps resident
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adamw_kernel<TP, TG, TM>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long gy = t.rows < MAX_GRID_Y ? t.rows : MAX_GRID_Y;
  const long long need = (t.cols / VEC + 1 + THREADS - 1) / THREADS;  // blocks to cover a row
  long long gx = (resident[dev] + gy - 1) / gy;
  if (gx > need) gx = need;
  if (gx < 1) gx = 1;
  adamw_kernel<TP, TG, TM><<<dim3((unsigned)gx, (unsigned)gy), THREADS, 0, stream>>>(t, h);
  return (int)cudaGetLastError();
}

template <typename TP, typename TG>
int by_moments(const Plane& t, const Hyper& h, int mv_dtype, cudaStream_t s) {
  return mv_dtype == 0 ? launch<TP, TG, float>(t, h, s) : launch<TP, TG, __nv_bfloat16>(t, h, s);
}

template <typename TP>
int by_grad(const Plane& t, const Hyper& h, int g_dtype, int mv_dtype, cudaStream_t s) {
  return g_dtype == 0 ? by_moments<TP, float>(t, h, mv_dtype, s)
                      : by_moments<TP, __nv_bfloat16>(t, h, mv_dtype, s);
}

}  // namespace

extern "C" {

// Launches on `stream` (a stream of the current device) and returns
// cudaGetLastError() (0 on success). p, g, m and v are `rows` rows of `cols`
// contiguous values, row r of each at its pointer + r * its row stride (in
// values); dtype 0 = float32, 1 = bfloat16, m and v of one dtype. g null is
// a zero gradient (g_dtype then unread); norm, where not null, is a float32
// on the device that the gradient is clipped by (against clip). The floats
// are the hyperparameters as float32: -lr, b1, 1 - b1, b2, 1 - b2, eps, the
// weight decay, the bias correction's step scale and the clip; decay 0 skips
// the decay term.
int lr2ppo_adamw(void* p, const void* g, void* m, void* v, const void* norm, long long rows,
                 long long cols, long long p_rs, long long g_rs, long long m_rs, long long v_rs,
                 int p_dtype, int g_dtype, int mv_dtype, float neg_lr, float b1, float omb1,
                 float b2, float omb2, float eps, float wd, float step_scale, float clip,
                 int decay, void* stream) {
  if (rows <= 0 || cols <= 0 || p == nullptr || m == nullptr || v == nullptr ||
      (p_dtype != 0 && p_dtype != 1) || (mv_dtype != 0 && mv_dtype != 1) ||
      (g != nullptr && g_dtype != 0 && g_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Plane t{p, g, m, v, static_cast<const float*>(norm), rows, cols, p_rs, g_rs, m_rs, v_rs};
  const Hyper h{neg_lr, b1, omb1, b2, omb2, eps, wd, step_scale, clip, decay};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g == nullptr) g_dtype = p_dtype;
  return p_dtype == 0 ? by_grad<float>(t, h, g_dtype, mv_dtype, s)
                      : by_grad<__nv_bfloat16>(t, h, g_dtype, mv_dtype, s);
}

}  // extern "C"
