// K1 decode_attention: one query token per sequence against its KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py,
// function decode_attention (its _kernel body).  Same math: GQA, where the
// G = H / Hkv query heads of a group share one read of the cache; online
// softmax with float32 m / l / acc; positions >= lengths[b] are masked and
// the loop stops at lengths[b], so tiles past the length are never read.
//
// What bounds it on the H100: bytes.  It reads k and v once (2 * len * hd
// elements per (b, kv-head)) and does 4 * G flops per element read, far
// below the ~295 flop/byte ridge of the card, so the bound is the cache
// bytes over the 3.35 TB/s of HBM3.
//
// Design (simple and right first): one block of 128 threads per
// (b, kv-head, slice of gb query heads of the group).  The gb pre-scaled
// queries stay in shared memory as float32.  The block walks the cache in
// tiles of TK keys: it stages the k and v tile in shared memory (float32,
// k rows padded by one word so that the threads of a warp reading
// different rows hit different banks), computes the gb x TK scores,
// updates m / l per head with one warp per head, and folds p @ v into
// accumulators that each thread keeps in registers (gb * hd <= 2048).  k
// and v are read through their strides, so the model's (B, S, Hkv, hd)
// cache is passed as a permuted view and never copied.  The launch splits
// each group's G heads over G / gb blocks, gb the largest divisor of G
// whose accumulators fit and that still gives a block for each of the 132
// SMs (or gb = 1): MQA with G * hd = 16 * 256 = 4096 runs as 16 blocks per
// kv head, each block reading the cache of its group (the later blocks of
// a group mostly from L2).  Each thread stages its share of a tile with one
// 2-byte load per loop step, so this kernel is latency-bound and far from
// the byte bound; 16-byte loads and a split over the sequence with a
// combine pass are the next steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTK = 64;        // keys per tile
constexpr int kMaxAcc = 16;    // accumulators per thread: gb * hd <= 2048
constexpr int kMaxElems = kThreads * kMaxAcc;
constexpr int kMinBlocks = 132; // one block per SM of the H100
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int Hkv, int S, int hd, int gb, float scale,
                        long long q_sb, long long q_sh,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh) {
  const int G = H / Hkv;
  const int nsplit = G / gb;
  const int kvh = blockIdx.x / nsplit;
  const int head0 = kvh * G + (blockIdx.x - kvh * nsplit) * gb;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int hdp = hd + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                         // [gb][hd]
  float* k_s = q_s + gb * hd;                // [kTK][hd + 1]
  float* v_s = k_s + kTK * hdp;              // [kTK][hd]
  float* p_s = v_s + kTK * hd;               // [gb][kTK]
  float* m_s = p_s + gb * kTK;               // [gb]
  float* l_s = m_s + gb;                     // [gb]
  float* c_s = l_s + gb;                     // [gb] correction of this tile

  int len = lengths[b];
  if (len > S) len = S;

  const T* qb = q + b * q_sb + (long long)head0 * q_sh;
  for (int i = tid; i < gb * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    q_s[i] = to_f32(qb[g * q_sh + d]) * scale;
  }
  for (int g = tid; g < gb; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  float acc[kMaxAcc];
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int start = 0; start < len; start += kTK) {
    __syncthreads();   // previous tile fully consumed; q_s / m_s ready
    for (int i = tid; i < kTK * hd; i += kThreads) {
      const int j = i / hd, d = i - j * hd;
      const int s = start + j;
      float kv = 0.f, vv = 0.f;
      if (s < len) {
        kv = to_f32(kb[s * k_ss + d]);
        vv = to_f32(vb[s * v_ss + d]);
      }
      k_s[j * hdp + d] = kv;
      v_s[j * hd + d] = vv;
    }
    __syncthreads();
    // scores: one (head, key) pair per thread and step
    for (int i = tid; i < gb * kTK; i += kThreads) {
      const int g = i / kTK, j = i - g * kTK;
      float sc = kNegInf;
      if (start + j < len) {
        const float* qr = q_s + g * hd;
        const float* kr = k_s + j * hdp;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    // online softmax update: one warp per head
    for (int g = warp; g < gb; g += nwarps) {
      float* row = p_s + g * kTK;
      float tmax = kNegInf;
      for (int j = lane; j < kTK; j += 32) tmax = fmaxf(tmax, row[j]);
      tmax = warp_max(tmax);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.f;
      for (int j = lane; j < kTK; j += 32) {
        const float p = __expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ v for the (head, dim) elements this thread owns
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int e = tid + a * kThreads;
      if (e < gb * hd) {
        const int g = e / hd, d = e - g * hd;
        const float* pr = p_s + g * kTK;
        float s = acc[a] * c_s[g];
        for (int j = 0; j < kTK; ++j) s = fmaf(pr[j], v_s[j * hd + d], s);
        acc[a] = s;
      }
    }
  }
  __syncthreads();
  T* ob = out + b * o_sb + (long long)head0 * o_sh;
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int e = tid + a * kThreads;
    if (e < gb * hd) {
      const int g = e / hd, d = e - g * hd;
      const float l = fmaxf(l_s[g], 1e-30f);
      ob[g * o_sh + d] = from_f32<T>(acc[a] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int H, int Hkv, int S, int hd,
           const long long* st, cudaStream_t stream) {
  const int G = H / Hkv;
  int gb = G;                  // query heads per block: see the design note
  while (gb > 1 && (G % gb != 0 || gb * hd > kMaxElems ||
                    (long long)B * H / gb < kMinBlocks))
    --gb;
  if (gb * hd > kMaxElems) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      ((size_t)gb * hd + (size_t)kTK * (hd + 1) + (size_t)kTK * hd +
       (size_t)gb * kTK + 3 * (size_t)gb);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv * (G / gb), B);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), H, Hkv, S, hd,
      gb, (float)pow((double)hd, -0.5), st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides (elements): q_sb, q_sh,
// k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, out_sb, out_sh; the head-dim stride
// of every tensor is 1.  Returns a cudaError_t (0 on success).
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int B, int H, int Hkv, int S,
                                      int hd, const long long* strides,
                                      void* stream) {
  if (H % Hkv != 0 || hd > kMaxElems) return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, len, out, B, H, Hkv, S, hd, strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, len, out, B, H, Hkv, S, hd, strides,
                                 s);
  return (int)cudaErrorInvalidValue;
}
