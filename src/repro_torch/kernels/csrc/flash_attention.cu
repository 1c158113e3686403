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
// both toward src/repro/kernels/ref.py::attention: the causal mask is
// bottom-right aligned (key j is seen by query i when j <= i + S - T; the
// Pallas mask j <= i agrees only when T == S), and ragged tails of T and S
// are masked here where the Pallas grid floor-divides them away.
//
// What bounds it on the H100: operations.  A causal prefill of B=1, H=16,
// T=S=1024, hd=128 does ~4.3 GFLOP on ~12.6 MB, far above the card's ridge
// of ~295 flop/byte, so the bound is the flops over the 989 TFLOP/s bf16
// tensor-core peak.
//
// bf16 design (flash_attention_tc): both products on the bf16 tensor cores
// with mma.sync.m16n8k16 (float32 accumulators), FlashAttention-2 style.
// One block of 4 warps per (b * H + h, tile of 64 queries), the tiles with
// the most keys launched first; each warp owns 16 query rows.  The query
// tile is copied once into shared memory and, for hd <= 128, loaded into
// registers as A fragments (hd 160 and 256 read them from shared memory
// per key tile, to leave registers for their 80 and 128 accumulators).
// Keys and values walk a two-stage ring of BK-key tiles (64 keys for
// hd <= 128, 32 above), filled by cp.async 16-byte copies with the next
// tile in flight while the current one is multiplied; rows whose address
// is not 16-byte aligned are copied element by element instead, and rows
// past S are zero-filled.  Tiles are XOR-swizzled by 16-byte chunk (swz in
// mma_sync.cuh: chunk c of row r sits at c ^ (r mod 8) within its group of
// 8; a trailing group of 4, as in 64-byte rows or the 20 chunks of hd 160,
// at c ^ ((r / 2) mod 4) within itself), so ldmatrix reads them without
// bank conflicts and every chunk stays in its row: plain ldmatrix gives the
// B fragments of k for S = Q K^T, ldmatrix.trans those of v for O += P V.
// The scores stay in registers; the online softmax takes row maxima and
// sums across the four lanes that share a row, and P is packed from the S
// accumulators into bf16 A fragments for P V without passing through
// shared memory.  Masks are evaluated only on tiles that cross the causal
// frontier, the window's edge or S.  The next step is wgmma fed by TMA
// with warp specialisation.
//
// float32 design (flash_attention_kernel, unchanged): CUDA cores, so the
// float32 callers keep full float32 products (TF32 would carry about three
// decimal digits).  One block of 256 threads per (b * H + h, tile of 64
// queries) stages the scaled query tile, then walks 64-key tiles of k and
// v through shared memory as float32 (k rows padded by one word); each warp
// owns 8 query rows, computes their scores, reduces with warp shuffles and
// folds p @ v into register accumulators.
//
// lse: when the caller passes a (B, H, Tq) float32 buffer, both designs
// write each query row's m + log(l), the logsumexp of its scaled, masked
// scores, where they normalise; the backward (flash_attention_bwd.cu)
// recomputes P from it.  Serving and prefill pass null.
//
// Every tensor is read through its strides, so the model's (B, T, H, hd)
// projections are passed as permuted views and never copied.  The dynamic
// shared-memory attribute is set once per instantiation and device, not
// per launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kRows = kBQ / (kThreads / 32);   // query rows per warp: 8
constexpr int kCols = kBK / 32;                // score columns per lane: 2
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int H,
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
      if (lse != nullptr && tx == 0)
        lse[((long long)b * H + h) * Tq + qi] = m[a] + logf(lv);
    }
  }
}

// ---------------------------------------------------------------------------
//  bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 128;   // 4 warps, 16 query rows each
constexpr int kTcBQ = 64;

template <int HD>
struct TcShape {
  static constexpr int BK = HD <= 128 ? 64 : 32;   // keys per tile
  static constexpr bool kQRegs = HD <= 128;         // Q fragments in regs
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) * ((size_t)kTcBQ * HD + 4 * (size_t)BK * HD);
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int H, int Hkv, int Tq,
                   int S, int causal, int window, float scale,
                   long long q_sb, long long q_sh, long long q_st,
                   long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss,
                   long long o_sb, long long o_sh, long long o_st) {
  constexpr int BK = TcShape<HD>::BK;
  constexpr int CPR = HD / 8;
  constexpr int NT = BK / 8;          // score n-tiles of 8 keys
  constexpr int DT = HD / 8;          // output n-tiles of 8 dims
  constexpr int KS = HD / 16;         // k-steps of S = Q K^T
  constexpr bool kQRegs = TcShape<HD>::kQRegs;

  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* ring = q_s + kTcBQ * HD;   // [stage][k, v][BK][HD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;   // longest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, its row

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  const int offset = S - Tq;          // bottom-right aligned causal mask
  int kend = S;
  if (causal) kend = min(S, min(q0 + kTcBQ, Tq) - 1 + offset + 1);
  int kbeg = 0;
  if (window > 0) kbeg = max(0, (q0 + offset - window + 1) / BK * BK);
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  load_tile<HD, kTcBQ, kTcThreads>(q_s, qb, q_st, q0, Tq);
  if (ntiles > 0) {
    load_tile<HD, BK, kTcThreads>(ring, kb, k_ss, kbeg, S);
    load_tile<HD, BK, kTcThreads>(ring + BK * HD, vb, v_ss, kbeg, S);
  }
  cp_commit();

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  unsigned qf[kQRegs ? KS : 1][4];
  const int qrow = warp * 16 + (mi & 1) * 8 + mr;   // this lane's ldmatrix row

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kbeg + t * BK;
    if (t + 1 < ntiles) {
      __nv_bfloat16* nk = ring + ((t + 1) & 1) * 2 * BK * HD;
      load_tile<HD, BK, kTcThreads>(nk, kb, k_ss, k0 + BK, S);
      load_tile<HD, BK, kTcThreads>(nk + BK * HD, vb, v_ss, k0 + BK, S);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const __nv_bfloat16* ks = ring + (t & 1) * 2 * BK * HD;
    const __nv_bfloat16* vs = ks + BK * HD;
    if constexpr (kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qf[kk], q_s + swz<CPR>(qrow, kk * 2 + (mi >> 1)));
      }
    }

    // S = Q K^T for this warp's 16 rows and BK keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, q_s + swz<CPR>(qrow, kk * 2 + (mi >> 1)));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bf[4];
        ldsm_x4(bf, ks + swz<CPR>(np * 16 + (mi >> 1) * 8 + mr,
                                  kk * 2 + (mi & 1)));
        mma16816(s[2 * np], a, bf[0], bf[1]);
        mma16816(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // scale, then mask where the tile crosses S, the frontier or the window
    const bool edge = k0 + BK > S ||
                      (causal && k0 + BK - 1 > q0 + offset) ||
                      (window > 0 && k0 <= q0 + kTcBQ - 1 + offset - window);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int qi = q0 + warp * 16 + g + (e >> 1) * 8;
          const int kj = k0 + n * 8 + 2 * t4 + (e & 1);
          const bool ok = kj < S && (!causal || kj <= qi + offset) &&
                          (window <= 0 || kj > qi + offset - window);
          if (!ok) x = kNegInf;
        }
        s[n][e] = x;
      }

    // online softmax for the lane's two rows (g and g + 8)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * rr], s[n][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[rr], mx);
      const float corr = __expf(mrow[rr] - m_new);
      mrow[rr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          // a masked key weighs 0, also in a row with no key in this tile
          const float p = s[n][e] == kNegInf ? 0.f : __expf(s[n][e] - m_new);
          s[n][e] = p;
          sum += p;
        }
      lrow[rr] = lrow[rr] * corr + sum;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * rr] *= corr;
        o[d][2 * rr + 1] *= corr;
      }
    }

    // O += P V, P packed from the score accumulators into A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        unsigned bf[4];
        ldsm_x4_t(bf, vs + swz<CPR>(kk * 16 + (mi & 1) * 8 + mr,
                                    dp * 2 + (mi >> 1)));
        mma16816(o[2 * dp], a, bf[0], bf[1]);
        mma16816(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();                  // this stage may be refilled
  }
  cp_wait_all();

  __nv_bfloat16* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = lrow[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int qi = q0 + warp * 16 + g + rr * 8;
    if (lse != nullptr && t4 == 0 && qi < Tq)
      lse[((long long)b * H + h) * Tq + qi] = mrow[rr] + logf(fmaxf(l, 1e-30f));
    if (qi < Tq) {
      __nv_bfloat16* orow = ob + qi * o_st;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        orow[d * 8 + 2 * t4] = __float2bfloat16(o[d][2 * rr] * inv);
        orow[d * 8 + 2 * t4 + 1] = __float2bfloat16(o[d][2 * rr + 1] * inv);
      }
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int H, int Hkv, int Tq, int S, int causal,
              int window, const long long* st, cudaStream_t stream) {
  static unsigned done = 0;
  const size_t smem = TcShape<HD>::smem;
  cudaError_t err =
      smem_once((const void*)flash_attention_tc<HD>, smem, &done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kTcBQ - 1) / kTcBQ, B * H);
  flash_attention_tc<HD><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, H, Hkv, Tq, S, causal, window, (float)pow((double)HD, -0.5), st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int H, int Hkv, int Tq, int S, int causal, int window,
           const long long* st, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBQ * HD + (size_t)kBK * (HD + 1) + (size_t)kBK * HD +
       (size_t)kBQ * kBK);
  static unsigned done = 0;
  cudaError_t err =
      smem_once((const void*)flash_attention_kernel<T, HD>, smem, &done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, Hkv, Tq, S,
      causal, window, (float)pow((double)HD, -0.5), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

// bf16 goes to the tensor cores, float32 to the CUDA-core kernel.
template <int HD>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* out, float* lse, int B, int H, int Hkv, int Tq, int S,
                 int causal, int window, const long long* st,
                 cudaStream_t s) {
  if (dtype == 0)
    return launch<float, HD>(q, k, v, out, lse, B, H, Hkv, Tq, S, causal,
                             window, st, s);
  if (dtype == 1)
    return launch_tc<HD>(q, k, v, out, lse, B, H, Hkv, Tq, S, causal, window,
                         st, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {32, 64, 128, 160, 256}; window 0
// means none, else it needs causal.  lse: null, or (B, H, Tq) float32,
// contiguous, where each query row's m + log(l) (the logsumexp of its
// scaled, masked scores) is written for the backward.  strides
// (elements): q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, out_sb,
// out_sh, out_st; the head-dim stride of every tensor is 1.  Returns a
// cudaError_t (0 on success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     int B, int H, int Hkv, int Tq, int S,
                                     int hd, int causal, int window,
                                     const long long* strides, void* stream) {
  if (H % Hkv != 0 || (causal && Tq > S) || window < 0 ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_K2_HD(HD)                                                     \
  case HD:                                                                  \
    return launch_dtype<HD>(dtype, q, k, v, out, lse, B, H, Hkv, Tq, S,     \
                            causal, window, strides, s);
  switch (hd) {
    REPRO_K2_HD(32)
    REPRO_K2_HD(64)
    REPRO_K2_HD(128)
    REPRO_K2_HD(160)
    REPRO_K2_HD(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_K2_HD
}
