// AdamW's update of one parameter leaf: the moments mu and nu, bias
// correction, weight decay, written into the parameter and the moments in
// place.
//
// Replaces no Pallas kernel: the JAX package leaves its optimizer
// (src/repro/train/optimizer.py, apply_updates' AdamW branch) to XLA,
// which fuses it.  In eager PyTorch the same formula was about twenty
// float32 elementwise kernels a leaf, each a full pass over it, after a
// float32 copy of every gradient for the global norm and a second one for
// the clip.  Same math, float32 throughout, in train/optimizer.py's order:
//   g' = g scale
//   m2 = b1 m + (1 - b1) g'
//   v2 = b2 v + ((1 - b2) g') g'
//   step = (m2 / bc1) / (sqrt(v2 / bc2) + eps) + wd p
//   p <- p - lr step,  m <- m2,  v <- v2
// each operation rounded once, as the separate PyTorch kernels round it:
// the _rn intrinsics keep nvcc from contracting a product and a sum into
// one fused multiply-add, and the division and square root are IEEE's (no
// --use_fast_math).  Stores round to the leaf's dtype and the moments'
// dtype to nearest even, as copy_ does.  So one element's update is the
// plain chain's to the bit, given the same scale.
//
// What bounds it on the H100: bytes.  One step needs two passes over a
// leaf, because the clip scale needs every leaf's gradient norm:
//   1. adamw_sumsq reads the gradient once and writes one float32 partial
//      of its sum of squares a block; adamw_reduce adds the partials in a
//      fixed order into the leaf's 0-d total (no float atomics: the same
//      bits every run on one card);
//   2. (after the global norm) adamw_apply reads p, g, mu and nu once and
//      writes p, mu and nu once.
// That is 2 + 22 = 24 bytes a bf16 parameter with float32 moments (p 2 + 2,
// g 2 + 2, mu and nu 4 + 4 each), 73.6 GB for rwkv6-3b's 3.07 G parameters
// in 22 ms at 3.35 TB/s, against about 218 bytes a parameter before.  The
// elements are walked as vectors of VEC = 8 (one 16-byte load of a bf16
// leaf, two of a float32 one) where every pointer is 16-byte aligned, the
// last n % 8 elements one at a time; else one element a thread throughout.
// The grids are persistent (the blocks the card holds at once, each walking
// vectors a grid's width apart), so pass 1's partials are few.  No host
// synchronisation: the scale, learning rate and bias corrections are read
// from 0-d device tensors.  Offsets are 64-bit: rwkv6-3b's stacked
// channel-mix leaf holds 734 M elements, 2.9 GB in float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// VEC consecutive elements as float32: VEC = 8 reads 16 bytes of bf16 or 32
// of float32 (the caller guarantees 16-byte alignment), VEC = 1 one element
template <int VEC>
__device__ __forceinline__ void load(const bf16* p, float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    x[0] = to_f(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    x[0] = *p;
  }
}

// store rounds to nearest even, as a float32 -> bf16 copy_ does
template <int VEC>
__device__ __forceinline__ void store(bf16* p, const float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    put(p, x[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    *p = x[0];
  }
}

// The sum of v over the block in a fixed order; thread 0 gets it.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  return total;
}

// Pass 1: parts[block] = the block's sum of g^2.  Thread t of the grid
// takes vectors t, t + T, ... (T the grid's threads) of the first n / VEC
// vectors, then the tail's elements n / VEC * VEC + t, + T, ...  Each
// vector's squares are added pairwise before they join the thread's sum.
template <typename G, int VEC>
__global__ void __launch_bounds__(kThreads)
adamw_sumsq(const G* __restrict__ g, long long n, float* __restrict__ parts) {
  __shared__ float warp_sums[kWarps];
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long T = (long long)gridDim.x * kThreads;
  const long long nv = n / VEC;
  float acc = 0.f;
  for (long long i = t; i < nv; i += T) {
    float x[VEC];
    load<VEC>(g + i * VEC, x);
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = x[k] * x[k];
#pragma unroll
    for (int w = VEC / 2; w > 0; w >>= 1)
#pragma unroll
      for (int k = 0; k < w; ++k) x[k] += x[k + w];
    acc += x[0];
  }
  for (long long i = nv * VEC + t; i < n; i += T) {
    const float x = to_f(g[i]);
    acc += x * x;
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) parts[blockIdx.x] = acc;
}

// *sq = the sum of pass 1's nparts partials, one block, a fixed order.
__global__ void __launch_bounds__(kThreads)
adamw_reduce(const float* __restrict__ parts, int nparts,
             float* __restrict__ sq) {
  __shared__ float warp_sums[kWarps];
  float v = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kThreads) v += parts[i];
  v = block_sum(v, warp_sums);
  if (threadIdx.x == 0) *sq = v;
}

struct Hyper {
  const float *scale, *lr, *bc1, *bc2;   // 0-d on the device
  float b1, omb1, b2, omb2, eps, wd;     // omb = 1 - b, rounded from double
};

// One element's update, each operation rounded once (see the note above).
__device__ __forceinline__ void adamw_elem(float g, float& p, float& m,
                                           float& v, float scale, float lr,
                                           float bc1, float bc2,
                                           const Hyper& h) {
  const float gs = __fmul_rn(g, scale);
  const float m2 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, gs));
  const float v2 =
      __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, gs), gs));
  const float step = __fadd_rn(
      __fdiv_rn(__fdiv_rn(m2, bc1),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, bc2)), h.eps)),
      __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, step));
  m = m2;
  v = v2;
}

// Pass 2: the same walk as pass 1 over p, g, mu and nu together.
template <typename G, typename P, typename M, int VEC>
__global__ void __launch_bounds__(kThreads)
adamw_apply(const G* __restrict__ g, P* __restrict__ p, M* __restrict__ mu,
            M* __restrict__ nu, long long n, Hyper h) {
  const float scale = *h.scale, lr = *h.lr, bc1 = *h.bc1, bc2 = *h.bc2;
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long T = (long long)gridDim.x * kThreads;
  const long long nv = n / VEC;
  for (long long i = t; i < nv; i += T) {
    const long long at = i * VEC;
    float x[VEC], w[VEC], m[VEC], v[VEC];
    load<VEC>(g + at, x);
    load<VEC>(p + at, w);
    load<VEC>(mu + at, m);
    load<VEC>(nu + at, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      adamw_elem(x[k], w[k], m[k], v[k], scale, lr, bc1, bc2, h);
    store<VEC>(p + at, w);
    store<VEC>(mu + at, m);
    store<VEC>(nu + at, v);
  }
  for (long long i = nv * VEC + t; i < n; i += T) {
    float w = to_f(p[i]), m = to_f(mu[i]), v = to_f(nu[i]);
    adamw_elem(to_f(g[i]), w, m, v, scale, lr, bc1, bc2, h);
    put(p + i, w);
    put(mu + i, m);
    put(nu + i, v);
  }
}

// ---------------------------------------------------------------------------
//  host side
// ---------------------------------------------------------------------------

// The blocks of kernel K the current card holds at once (at least one an
// SM), the occupancy asked once per kernel.
template <auto K>
int resident() {
  static const int per_sm = [] {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, K, kThreads,
                                                      0) != cudaSuccess)
      blocks = 1;
    return blocks > 0 ? blocks : 1;
  }();
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per_sm * sms;
}

// A persistent grid of kernel K over n elements, VEC a thread, at most cap
// blocks: no more blocks than the vectors (or the tail) need.
template <auto K, int VEC>
int grid_of(long long n, int cap) {
  long long vecs = n / VEC > n % VEC ? n / VEC : n % VEC;
  long long need = (vecs + kThreads - 1) / kThreads;
  long long g = resident<K>();
  if (need < g) g = need;
  if (cap < g) g = cap;
  return (int)(g > 0 ? g : 1);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename G, int VEC>
int sumsq(const void* g, long long n, float* parts, int cap, cudaStream_t s) {
  const int grid = grid_of<&adamw_sumsq<G, VEC>, VEC>(n, cap);
  adamw_sumsq<G, VEC><<<grid, kThreads, 0, s>>>(static_cast<const G*>(g), n,
                                                parts);
  return grid;
}

template <typename G, typename P, typename M, int VEC>
void apply(const void* g, void* p, void* mu, void* nu, long long n,
           const Hyper& h, cudaStream_t s) {
  const int grid = grid_of<&adamw_apply<G, P, M, VEC>, VEC>(n, 1 << 30);
  adamw_apply<G, P, M, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const G*>(g), static_cast<P*>(p), static_cast<M*>(mu),
      static_cast<M*>(nu), n, h);
}

template <typename G, typename P, typename M>
void apply_vec(const void* g, void* p, void* mu, void* nu, long long n,
               int vec, const Hyper& h, cudaStream_t s) {
  if (vec == 8) apply<G, P, M, 8>(g, p, mu, nu, n, h, s);
  else apply<G, P, M, 1>(g, p, mu, nu, n, h, s);
}

template <typename G, typename P>
void apply_m(const void* g, void* p, void* mu, void* nu, int m_f32,
             long long n, int vec, const Hyper& h, cudaStream_t s) {
  if (m_f32) apply_vec<G, P, float>(g, p, mu, nu, n, vec, h, s);
  else apply_vec<G, P, bf16>(g, p, mu, nu, n, vec, h, s);
}

}  // namespace

// Pass 1 of one leaf: g (n elements, contiguous), bf16 (g_f32 = 0) or
// float32; *sq (float32) gets the sum of g^2 through parts (cap floats,
// one a block).  vec 8 needs g 16-byte aligned, vec 1 takes any g.
// Returns a cudaError_t (0 on success).
extern "C" int repro_adamw_sumsq(const void* g, int g_f32, long long n,
                                 int vec, void* parts, int cap, void* sq,
                                 void* stream) {
  if (n < 1 || cap < 1 || (vec != 1 && vec != 8) ||
      (vec == 8 && !aligned(g)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(parts);
  int grid;
  if (vec == 8)
    grid = g_f32 ? sumsq<float, 8>(g, n, pp, cap, s)
                 : sumsq<bf16, 8>(g, n, pp, cap, s);
  else
    grid = g_f32 ? sumsq<float, 1>(g, n, pp, cap, s)
                 : sumsq<bf16, 1>(g, n, pp, cap, s);
  adamw_reduce<<<1, kThreads, 0, s>>>(pp, grid, static_cast<float*>(sq));
  return (int)cudaGetLastError();
}

// Pass 2 of one leaf, after the global norm: p (n elements) updated in
// place from g, mu and nu (the moments, float32 with m_f32 = 1, else bf16)
// likewise; p and g bf16 or float32 each (p_f32, g_f32), all contiguous.
// scale, lr, bc1 and bc2 0-d float32 on the device; b1, omb1 = 1 - b1, b2,
// omb2 = 1 - b2, eps and wd the step's constants.  vec 8 needs all four
// pointers 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int repro_adamw_apply(const void* g, int g_f32, void* p, int p_f32,
                                 void* mu, void* nu, int m_f32, long long n,
                                 int vec, const void* scale, const void* lr,
                                 const void* bc1, const void* bc2, float b1,
                                 float omb1, float b2, float omb2, float eps,
                                 float wd, void* stream) {
  if (n < 1 || (vec != 1 && vec != 8) ||
      (vec == 8 && !(aligned(g) && aligned(p) && aligned(mu) && aligned(nu))))
    return (int)cudaErrorInvalidValue;
  const Hyper h{static_cast<const float*>(scale),
                static_cast<const float*>(lr),
                static_cast<const float*>(bc1),
                static_cast<const float*>(bc2),
                b1, omb1, b2, omb2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_f32 && p_f32) apply_m<float, float>(g, p, mu, nu, m_f32, n, vec, h, s);
  else if (g_f32) apply_m<float, bf16>(g, p, mu, nu, m_f32, n, vec, h, s);
  else if (p_f32) apply_m<bf16, float>(g, p, mu, nu, m_f32, n, vec, h, s);
  else apply_m<bf16, bf16>(g, p, mu, nu, m_f32, n, vec, h, s);
  return (int)cudaGetLastError();
}
