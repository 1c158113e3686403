// K4 rwkv_scan: the WKV6 recurrence of RWKV6's time-mix, chunked.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv_scan.py, function
// rwkv_scan (its _kernel body).  Same math, the chunk form of the model's
// _wkv_chunk (src/repro/models/rwkv.py): per chunk of C steps, with cs the
// inclusive cumsum of logw along time,
//   q_in = r * exp(cs - logw)      k_in = k * exp(-cs)
//   o    = tril(q_in k_in^T, -1) v + (r . u . k) v + q_in S
//   S    = exp(cs_last) S + (k * exp(cs_last - cs))^T v
// Every exponent is relative to the chunk start and bounded by
// C * 0.105 (the model's DECAY_SCALE), so e^6.7 ~ 800 at most in float32.
// Three differences from the Pallas kernel, all toward the model: the scan
// starts from S0 (zeros when none is given), so a decode step (T == 1, the
// model's plain recurrence exactly) and a continued prefill run here too;
// a ragged T is masked (the Pallas grid floor-divides it away); the chunk
// is the model's CHUNK = 64.
//
// What bounds it on the H100: bytes.  A prefill of B=1, H=40, T=1024, M=64
// reads bf16 r/k/v and float32 logw and writes float32 o (~38 MB) for
// ~0.8 GFLOP, and a decode step reads and writes S (float32, 64 x 64 per
// head), both far below the card's ~295 flop/byte ridge.
//
// Design (simple and right first): one block of 256 threads per (b, h).
// S (M x M float32) stays in shared memory for the whole sequence; the
// chunks run in order inside the block.  A chunk's r, k, v and logw are
// staged in shared memory as float32 (rows padded by one word so that the
// threads of a warp reading different rows hit different banks); one
// thread per column takes the cumsum and the decayed q_in / k_in / k_tail;
// the scores, the output and the state update are each one loop in which
// a thread owns a few (row, column) elements and sums over 64 on CUDA
// cores.  Only the n valid rows of a chunk are computed, so a decode step
// costs one row.  Every input is read through its strides (unit stride on
// the last dim), so the model's (B, T, H, M) projections are passed as
// permuted views and o is written into a (B, T, H, M) buffer, never copied.
// With B * H = 40 blocks for 132 SMs at the prefill shape this is far from
// the byte bound; splitting the value columns over blocks and tensor-core
// products are the next steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kC = 64;          // chunk: the model's CHUNK
constexpr int kMaxM = 64;       // head size

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Element strides, in the order of the C interface below.
enum { R_SB, R_SH, R_ST, K_SB, K_SH, K_ST, V_SB, V_SH, V_ST, W_SB, W_SH, W_ST,
       O_SB, O_SH, O_ST, S0_SB, S0_SH, S_SB, S_SH, kNStrides };
struct Strides {
  long long s[kNStrides];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ o, float* __restrict__ s_out, int H,
                 int Tn, int M, Strides st) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int MP = M + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [kC][MP]  r, then q_in
  float* k_s = q_s + kC * MP;         // [kC][MP]  k, then k_in
  float* kt_s = k_s + kC * MP;        // [kC][MP]  k * exp(cs_last - cs)
  float* v_s = kt_s + kC * MP;        // [kC][MP]  v
  float* w_s = v_s + kC * MP;         // [kC][MP]  logw
  float* sc_s = w_s + kC * MP;        // [kC][kC + 1] scores
  float* S_s = sc_s + kC * (kC + 1);  // [M][MP]   state
  float* u_s = S_s + M * MP;          // [M]
  float* dec_s = u_s + M;             // [M]       exp(cs_last)
  float* dg_s = dec_s + M;            // [kC]      bonus r . u . k

  const T* rb = r + b * st.s[R_SB] + h * st.s[R_SH];
  const T* kb = k + b * st.s[K_SB] + h * st.s[K_SH];
  const T* vb = v + b * st.s[V_SB] + h * st.s[V_SH];
  const float* wb = logw + b * st.s[W_SB] + h * st.s[W_SH];
  float* ob = o + b * st.s[O_SB] + h * st.s[O_SH];

  for (int i = tid; i < M * M; i += kThreads) {
    const int m = i / M, j = i - m * M;
    S_s[m * MP + j] = s0 ? s0[b * st.s[S0_SB] + h * st.s[S0_SH] + i] : 0.f;
  }
  for (int m = tid; m < M; m += kThreads) u_s[m] = u[h * M + m];

  for (int t0 = 0; t0 < Tn; t0 += kC) {
    const int n = min(kC, Tn - t0);     // valid rows of this chunk
    __syncthreads();                     // previous chunk fully consumed
    for (int i = tid; i < n * M; i += kThreads) {
      const int t = i / M, m = i - t * M;
      const long long tt = t0 + t;
      q_s[t * MP + m] = to_f32(rb[tt * st.s[R_ST] + m]);
      k_s[t * MP + m] = to_f32(kb[tt * st.s[K_ST] + m]);
      v_s[t * MP + m] = to_f32(vb[tt * st.s[V_ST] + m]);
      w_s[t * MP + m] = wb[tt * st.s[W_ST] + m];
    }
    __syncthreads();
    // bonus on the diagonal: one warp per row
    for (int t = warp; t < n; t += nwarps) {
      float s = 0.f;
      for (int m = lane; m < M; m += 32)
        s += q_s[t * MP + m] * u_s[m] * k_s[t * MP + m];
      s = warp_sum(s);
      if (lane == 0) dg_s[t] = s;
    }
    __syncthreads();
    // one thread per column: cumsum of logw, decayed q_in / k_in / k_tail
    for (int m = tid; m < M; m += kThreads) {
      float cs = 0.f;
      for (int t = 0; t < n; ++t) {
        const float lw = w_s[t * MP + m];
        q_s[t * MP + m] *= expf(cs);          // r * exp(cs_t - logw_t)
        cs += lw;
        w_s[t * MP + m] = cs;                 // keep cs_t for k_tail
        kt_s[t * MP + m] = k_s[t * MP + m];
        k_s[t * MP + m] *= expf(-cs);         // k * exp(-cs_t)
      }
      for (int t = 0; t < n; ++t)
        kt_s[t * MP + m] *= expf(cs - w_s[t * MP + m]);
      dec_s[m] = expf(cs);
    }
    __syncthreads();
    // scores: strictly lower triangle, the bonus on the diagonal
    for (int i = tid; i < n * kC; i += kThreads) {
      const int t = i / kC, s = i - t * kC;
      float val = 0.f;
      if (s < t) {
        const float* qr = q_s + t * MP;
        const float* kr = k_s + s * MP;
        for (int m = 0; m < M; ++m) val = fmaf(qr[m], kr[m], val);
      } else if (s == t) {
        val = dg_s[t];
      }
      sc_s[t * (kC + 1) + s] = val;
    }
    __syncthreads();
    // o = scores @ v + q_in @ S   (S as it was at the chunk start)
    for (int i = tid; i < n * M; i += kThreads) {
      const int t = i / M, j = i - t * M;
      const float* sr = sc_s + t * (kC + 1);
      const float* qr = q_s + t * MP;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc = fmaf(sr[s], v_s[s * MP + j], acc);
      for (int m = 0; m < M; ++m) acc = fmaf(qr[m], S_s[m * MP + j], acc);
      ob[(long long)(t0 + t) * st.s[O_ST] + j] = acc;
    }
    __syncthreads();
    // S = exp(cs_last) S + k_tail^T v
    for (int i = tid; i < M * M; i += kThreads) {
      const int m = i / M, j = i - m * M;
      float acc = dec_s[m] * S_s[m * MP + j];
      for (int t = 0; t < n; ++t)
        acc = fmaf(kt_s[t * MP + m], v_s[t * MP + j], acc);
      S_s[m * MP + j] = acc;
    }
  }
  __syncthreads();
  float* sb = s_out + b * st.s[S_SB] + h * st.s[S_SH];
  for (int i = tid; i < M * M; i += kThreads) {
    const int m = i / M, j = i - m * M;
    sb[i] = S_s[m * MP + j];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, float* o, float* s_out, int B,
           int H, int Tn, int M, const Strides& st, cudaStream_t stream) {
  const int MP = M + 1;
  const size_t smem = sizeof(float) *
      (5 * (size_t)kC * MP + (size_t)kC * (kC + 1) + (size_t)M * MP +
       2 * (size_t)M + kC);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv_scan_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, o, s_out, H, Tn, M, st);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of r/k/v: 0 = float32, 1 = bfloat16; logw, u, S0, o and S are
// float32.  s0 may be null (start from zeros).  strides (elements): r_sb,
// r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, logw_sb, logw_sh,
// logw_st, o_sb, o_sh, o_st, s0_sb, s0_sh, s_sb, s_sh; the last dim of
// every tensor has unit stride, u is (H, M) contiguous and each (M, M)
// state is contiguous.  Returns a cudaError_t (0 on success).
extern "C" int repro_rwkv_scan(int dtype, const void* r, const void* k,
                               const void* v, const void* logw,
                               const void* u, const void* s0, void* o,
                               void* s_out, int B, int H, int Tn, int M,
                               const long long* strides, void* stream) {
  if (M < 1 || M > kMaxM || Tn < 1) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < kNStrides; ++i) st.s[i] = strides[i];
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* of = static_cast<float*>(o);
  float* sf = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, lw, uu, s0f, of, sf, B, H, Tn, M, st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, lw, uu, s0f, of, sf, B, H, Tn, M,
                                 st, s);
  return (int)cudaErrorInvalidValue;
}
