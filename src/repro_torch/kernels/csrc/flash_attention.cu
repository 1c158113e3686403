// K2 flash_attention: GQA attention forward, causal or not.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// function flash_attention (its _kernel body).  Same math: online softmax
// over blocks of keys with float32 m / l / acc, the G = H / Hkv query heads
// of a group reading the same k / v head, key blocks that lie wholly past
// the causal frontier skipped.  With a sliding window (window > 0) key j is
// kept for query i only when i + S - T - window < j <= i + S - T (the
// model's _mask_bias, src/repro/models/layers.py, bottom-right aligned as
// below), and key tiles wholly below the window are skipped as well, so a
// windowed prefill reads about window keys per query.  Two differences,
// both toward
// src/repro/kernels/ref.py::attention: the causal mask is bottom-right
// aligned (key j is seen by query i when j <= i + S - T; the Pallas mask
// j <= i agrees only when T == S), and ragged tails of T and S are masked
// here where the Pallas grid floor-divides them away.
//
// What bounds it on the H100: operations.  A causal prefill of B=1, H=16,
// T=S=1024, hd=128 does ~4.3 GFLOP on ~12.6 MB, far above the card's ridge
// of ~295 flop/byte, so the bound is the flops over the 989 TFLOP/s bf16
// tensor-core peak.
//
// Design (simple and right first): one block of 256 threads per
// (b * H + h, tile of 64 queries).  The block stages the scaled query tile
// once, then walks 64-key tiles of k and v through shared memory as
// float32 (k rows padded by one word against bank conflicts) up to the
// causal frontier.  Each warp owns 8 query rows: it computes their 64
// scores on CUDA cores, keeps m / l in registers, reduces row max and sum
// with warp shuffles, writes p to its own rows of shared memory and folds
// p @ v into register accumulators.  Every tensor is read through its
// strides, so the model's (B, T, H, hd) projections are passed as permuted
// views and never copied.  This runs on CUDA cores at a small fraction of
// the tensor-core bound; wgmma tiles fed by TMA are the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kRows = kBQ / (kThreads / 32);   // query rows per warp: 8
constexpr int kCols = kBK / 32;                // score columns per lane: 2
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int Tq, int S, int causal, int window,
                       float scale,
                       long long q_sb, long long q_sh, long long q_st,
                       long long k_sb, long long k_sh, long long k_ss,
                       long long v_sb, long long v_sh, long long v_ss,
                       long long o_sb, long long o_sh, long long o_st) {
  constexpr int HDP = HD + 1;
  constexpr int kDim = HD / 32;        // accumulator columns per lane
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [kBQ][HD]
  float* k_s = q_s + kBQ * HD;         // [kBK][HD + 1]
  float* v_s = k_s + kBK * HDP;        // [kBK][HD]
  float* p_s = v_s + kBK * HD;         // [kBQ][kBK]

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const int qi = q0 + r;
    q_s[i] = qi < Tq ? to_f32(qb[qi * q_st + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDim];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < kDim; ++e) acc[a][e] = 0.f;
  }

  const int offset = S - Tq;           // bottom-right aligned causal mask
  int kend = S;
  if (causal) {
    const int last = min(q0 + kBQ, Tq) - 1;
    kend = min(S, last + offset + 1);
  }
  int kbeg = 0;                        // the first query's lowest key
  if (window > 0) kbeg = max(0, (q0 + offset - window + 1) / kBK * kBK);

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();                   // q_s ready; previous tile consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i - j * HD;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < S) {
        kv = to_f32(kb[kj * k_ss + d]);
        vv = to_f32(vb[kj * v_ss + d]);
      }
      k_s[j * HDP + d] = kv;
      v_s[j * HD + d] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = k_s[(tx + 32 * c) * HDP + d];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const float qv = q_s[(ty + 8 * a) * HD + d];
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[a][c] = fmaf(qv, kv[c], s[a][c]);
      }
    }

#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = ty + 8 * a;
      const int qi = q0 + r;
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kj = k0 + tx + 32 * c;
        const bool ok = kj < S && (!causal || kj <= qi + offset) &&
                        (window <= 0 || kj > qi + offset - window);
        if (!ok) s[a][c] = kNegInf;
        rmax = fmaxf(rmax, s[a][c]);
      }
      rmax = warp_max(rmax);
      const float m_new = fmaxf(m[a], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        // a masked key weighs 0, also in a row with no key in this tile
        const float p = s[a][c] == kNegInf ? 0.f : __expf(s[a][c] - m_new);
        p_s[r * kBK + tx + 32 * c] = p;
        rsum += p;
      }
      rsum = warp_sum(rsum);
      const float corr = __expf(m[a] - m_new);
      l[a] = l[a] * corr + rsum;
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < kDim; ++e) acc[a][e] *= corr;
    }
    __syncwarp();                      // this warp's p rows are written

#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float vv[kDim];
#pragma unroll
      for (int e = 0; e < kDim; ++e) vv[e] = v_s[j * HD + tx + 32 * e];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const float p = p_s[(ty + 8 * a) * kBK + j];
#pragma unroll
        for (int e = 0; e < kDim; ++e) acc[a][e] = fmaf(p, vv[e], acc[a][e]);
      }
    }
  }

  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int qi = q0 + ty + 8 * a;
    if (qi < Tq) {
      const float lv = fmaxf(l[a], 1e-30f);
#pragma unroll
      for (int e = 0; e < kDim; ++e)
        ob[qi * o_st + tx + 32 * e] = from_f32<T>(acc[a][e] / lv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Tq, int S, int causal, int window,
           const long long* st, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBQ * HD + (size_t)kBK * (HD + 1) + (size_t)kBK * HD +
       (size_t)kBQ * kBK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, Tq, S, causal,
      window, (float)pow((double)HD, -0.5), st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out, int B,
                int H, int Hkv, int Tq, int S, int hd, int causal, int window,
                const long long* st, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, Hkv, Tq, S, causal, window,
                             st, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, Hkv, Tq, S, causal, window,
                             st, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, Hkv, Tq, S, causal, window,
                             st, s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, H, Hkv, Tq, S, causal, window,
                             st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {32, 64, 128, 256}; window 0
// means none, else it needs causal.  strides
// (elements): q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, out_sb,
// out_sh, out_st; the head-dim stride of every tensor is 1.  Returns a
// cudaError_t (0 on success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int Hkv, int Tq, int S, int hd,
                                     int causal, int window,
                                     const long long* strides, void* stream) {
  if (H % Hkv != 0 || (causal && Tq > S) || window < 0 ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, B, H, Hkv, Tq, S, hd, causal,
                              window, strides, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Tq, S, hd,
                                      causal, window, strides, s);
  return (int)cudaErrorInvalidValue;
}
