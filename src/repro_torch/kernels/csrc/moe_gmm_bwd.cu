// K3 moe_gmm, backward: the gradients of y[e] = x[e] @ w[e] over the live
// rows, for x (E, C, D), w (E, D, F) and the gradient dy (E, C, F):
//   dx[e] = dy[e] @ w[e]^T   (E, C, D), rows c >= rows[e] zeros
//   dw[e] = x[e]^T @ dy[e]   (E, D, F), summed over c < rows[e] only
// In the forward a row c >= rows[e] of y is a constant zero
// (kernels/ref.py::moe_gmm), so it passes no gradient to x or w.
//
// The Pallas TPU kernel src/repro/kernels/moe_gmm.py has no backward: the
// JAX package differentiates the plain einsum with jax.grad.  This is the
// port's own kernel, behind kernels/moe_gmm.py::MoeGmm.
//
// Both products are one grouped kernel, Y[e] (M x N) = A[e] (M x K) @
// B[e] (K x N), taking each operand in either layout:
//   dx: M = C, N = D, K = F; A = dy read as rows of K (row-major), B = w
//       read "NK" (w[e] is D x F: a row of N holds K contiguous);
//       live rows mlim = rows[e] along M, all of K.
//   dw: M = D, N = F, K = C; A = x read "KM" (x[e] is C x D: a row of K
//       holds M contiguous), B = dy row-major in K;
//       all of M, live rows klim = rows[e] along K, so an expert with no
//       live row runs no stage and writes zeros.
// The sum over K stays in the block (no atomics, a fixed order), in
// float32, and is rounded once to x.dtype / w.dtype.
//
// What bounds it on the H100: operations.  At qwen3-moe-235b-a22b's
// training shapes (E = 128, C = 640, D = 4096, F = 1536) each product is
// 2 E C D F = 1.03 TFLOP, 1.04 ms at the 989 TFLOP/s of bf16, against
// about 2.7 GB of operands (0.81 ms at 3.35 TB/s).
//
// bf16 (gmm_bwd_tc): mma.sync.m16n8k16 with float32 accumulators.  A block
// of 8 warps owns a 128 x 128 tile of Y, each warp 64 x 32 (four m16 by
// four n8 tiles); K streams through a four-stage ring of 32-deep stages
// filled by cp.async 16-byte copies (element copies with zero fill where
// a chunk would cross a bound or is not 16-byte aligned).  Each operand's
// stage is kept in its global layout, XOR-swizzled (mma_sync.cuh), and its
// fragments come from ldmatrix: plain for a tile whose rows run along K
// on the fragment's own axis (A row-major, B "NK"), .trans for a tile
// whose rows run along K across it (A "KM", B row-major, the forward's
// w), so neither operand is transposed in memory.  m16 tiles wholly past
// the live rows skip their products; a block wholly past them writes
// zeros and reads nothing.
//
// float32 (gmm_bwd_f32): CUDA cores, as the forward's float32 kernel, so
// float32 gradients keep full float32 products.  A 256-thread block owns a
// 64 x 64 tile of Y, each thread 4 x 4, and walks K in stages of 16 loaded
// element by element with zero fill.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

// One product's operands: element (m, k) of A[e] at a + e * a_se + (A_KM ?
// k * lda + m : m * lda + k), element (k, n) of B[e] at b + e * b_se +
// (B_NK ? n * ldb + k : k * ldb + n), Y[e] row-major with row stride ldy.
// Rows m >= mlim of Y are zeros and only k < klim is summed; mlim and klim
// are M and K, or rows[e] where rows_m / rows_k say so.
struct Gemm {
  const void* a;
  const void* b;
  void* y;
  const int* rows;
  int M, N, K;
  bool rows_m, rows_k;
  long long a_se, lda, b_se, ldb, y_se, ldy;
};

__device__ __forceinline__ int live(const int* rows, int e, int n) {
  return min(max(rows[e], 0), n);
}

// ---------------------------------------------------------------------------
//  bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kStages = 4;
constexpr int kStageEl = kBM * kBK + kBK * kBN;   // elements of one stage
constexpr size_t kSmemTc = sizeof(__nv_bfloat16) * kStages * kStageEl;

// Stage one R x CL tile of rows (CL/8 chunks a row) of a matrix whose row
// r lies at src + r * ld, rows past nr zero and each row cut at nc
// elements, into the swizzled tile s.
template <int R, int CL>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* s,
                                           const __nv_bfloat16* src,
                                           long long ld, int nr, int nc) {
  constexpr int CPR = CL / 8;
#pragma unroll
  for (int j = 0; j < R * CPR / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / CPR, c = i % CPR;
    stage8(s + swz<CPR>(r, c), src + (long long)r * ld + c * 8,
           r < nr ? nc - c * 8 : 0);
  }
}

template <bool A_KM, bool B_NK>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_tc(Gemm g) {
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int mlim = g.rows_m ? live(g.rows, e, g.M) : g.M;
  const int klim = g.rows_k ? live(g.rows, e, g.K) : g.K;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(g.y) + e * g.y_se;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix: matrix, its row
  const int wm = warp >> 2, wn = warp & 3;    // 2 x 4 warps of 64 x 32

  if (m0 >= mlim) {                           // no live row: zeros
    const int nr = min(kBM, g.M - m0), nc = min(kBN, g.N - n0);
    for (int i = tid; i < nr * nc; i += kThreads)
      y[(long long)(m0 + i / nc) * g.ldy + n0 + i % nc] =
          __float2bfloat16(0.f);
    return;
  }
  const int live_mt = (min(kBM, mlim - m0) - wm * 64 + 15) / 16;
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(g.a) +
                           e * g.a_se;
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(g.b) +
                           e * g.b_se;

  auto load = [&](int kt) {
    __nv_bfloat16* as = ring + (kt % kStages) * kStageEl;
    __nv_bfloat16* bs = as + kBM * kBK;
    const int k0 = kt * kBK;
    if constexpr (A_KM)      // [k][m]: rows k0.., columns m0..
      stage_tile<kBK, kBM>(as, a + (long long)k0 * g.lda + m0, g.lda,
                           klim - k0, mlim - m0);
    else                     // [m][k]
      stage_tile<kBM, kBK>(as, a + (long long)m0 * g.lda + k0, g.lda,
                           mlim - m0, klim - k0);
    if constexpr (B_NK)      // [n][k]
      stage_tile<kBN, kBK>(bs, b + (long long)n0 * g.ldb + k0, g.ldb,
                           g.N - n0, klim - k0);
    else                     // [k][n]
      stage_tile<kBK, kBN>(bs, b + (long long)k0 * g.ldb + n0, g.ldb,
                           klim - k0, g.N - n0);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][n][q] = 0.f;

  const int nk = (klim + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();           // stage kt has landed (this thread)
    __syncthreads();                  // ... for every thread; kt - 1 is free
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_commit();
    const __nv_bfloat16* as = ring + (kt % kStages) * kStageEl;
    const __nv_bfloat16* bs = as + kBM * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned bq[4][2];              // this warp's four n8 tiles
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned f[4];
        const int nb = wn * 32 + np * 16;
        if constexpr (B_NK)
          ldsm_x4(f, bs + swz<kBK / 8>(nb + (mi >> 1) * 8 + mr,
                                       kk * 2 + (mi & 1)));
        else
          ldsm_x4_t(f, bs + swz<kBN / 8>(kk * 16 + (mi & 1) * 8 + mr,
                                         nb / 8 + (mi >> 1)));
        bq[2 * np][0] = f[0];
        bq[2 * np][1] = f[1];
        bq[2 * np + 1][0] = f[2];
        bq[2 * np + 1][1] = f[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < live_mt) {
          unsigned af[4];
          const int mb = wm * 64 + mt * 16;
          if constexpr (A_KM)
            ldsm_x4_t(af, as + swz<kBM / 8>(kk * 16 + (mi >> 1) * 8 + mr,
                                            mb / 8 + (mi & 1)));
          else
            ldsm_x4(af, as + swz<kBK / 8>(mb + (mi & 1) * 8 + mr,
                                          kk * 2 + (mi >> 1)));
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma16816(acc[mt][n], af, bq[n][0], bq[n][1]);
        }
      }
    }
  }
  cp_wait_all();                      // only empty groups remain

  // accumulator (mt, n): rows gq and gq + 8, columns 2 t4 and 2 t4 + 1
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * 64 + mt * 16 + gq + hh * 8;
      if (row >= g.M) continue;
      __nv_bfloat16* yr = y + (long long)row * g.ldy;
      const bool on = row < mlim;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = n0 + wn * 32 + n * 8 + 2 * t4;
        const float v0 = on ? acc[mt][n][2 * hh] : 0.f;
        const float v1 = on ? acc[mt][n][2 * hh + 1] : 0.f;
        if (col + 1 < g.N && (reinterpret_cast<uintptr_t>(yr + col) & 3) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < g.N) yr[col] = __float2bfloat16(v0);
          if (col + 1 < g.N) yr[col + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
//  float32 on CUDA cores
// ---------------------------------------------------------------------------
constexpr int kFT = 64;        // tile of Y: kFT x kFT
constexpr int kFK = 16;        // depth of a stage

template <bool A_KM, bool B_NK>
__global__ void __launch_bounds__(256)
gmm_bwd_f32(Gemm g) {
  __shared__ __align__(16) float As[kFK][kFT];   // [k][m]
  __shared__ __align__(16) float Bs[kFK][kFT];   // [k][n]
  const int e = blockIdx.z, m0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  const int mlim = g.rows_m ? live(g.rows, e, g.M) : g.M;
  const int klim = g.rows_k ? live(g.rows, e, g.K) : g.K;
  const float* a = static_cast<const float*>(g.a) + e * g.a_se;
  const float* b = static_cast<const float*>(g.b) + e * g.b_se;
  float* y = static_cast<float*>(g.y) + e * g.y_se;
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;     // rows 4 tm.., columns 4 tn..
  float acc[4][4] = {};
  if (m0 < mlim) {
    for (int k0 = 0; k0 < klim; k0 += kFK) {
#pragma unroll
      for (int j = 0; j < kFK * kFT / 256; ++j) {
        const int i = tid + j * 256;
        const int kk = i / kFT, x = i % kFT;  // x: m or n in the tile
        const int k = k0 + kk, m = m0 + x, n = n0 + x;
        float av = 0.f, bv = 0.f;
        if (k < klim && m < mlim)
          av = A_KM ? a[(long long)k * g.lda + m] : a[(long long)m * g.lda + k];
        if (k < klim && n < g.N)
          bv = B_NK ? b[(long long)n * g.ldb + k] : b[(long long)k * g.ldb + n];
        As[kk][x] = av;
        Bs[kk][x] = bv;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][4 * tm]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][4 * tn]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * tm + i;
    if (row >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tn + j;
      if (col < g.N) y[(long long)row * g.ldy + col] = row < mlim ? acc[i][j] : 0.f;
    }
  }
}

template <bool A_KM, bool B_NK>
int launch(int elem_bytes, const Gemm& g, int E, cudaStream_t s) {
  if (elem_bytes == 2) {
    static unsigned done = 0;
    cudaError_t err = smem_once((const void*)gmm_bwd_tc<A_KM, B_NK>, kSmemTc,
                                &done);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, E);
    gmm_bwd_tc<A_KM, B_NK><<<grid, kThreads, kSmemTc, s>>>(g);
  } else {
    const dim3 grid((g.N + kFT - 1) / kFT, (g.M + kFT - 1) / kFT, E);
    gmm_bwd_f32<A_KM, B_NK><<<grid, 256, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 4 = float32, 2 = bfloat16 (x, w, dy, dx and dw all of it).
// rows: null, or (E,) int32 on the device.  strides (elements): x_se, x_sc, w_se, w_sd, dy_se, dy_sc,
// dx_se, dx_sc, dw_se, dw_sd; the last dimension of every tensor has unit
// stride.  Two launches (dx, then dw).  Returns a cudaError_t (0 on
// success).
extern "C" int repro_moe_gmm_bwd(int elem_bytes, const void* x, const void* w,
                                 const void* dy, const void* rows, void* dx,
                                 void* dw, int E, int C, int D, int F,
                                 const long long* st, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  // dx[e] (C x D) = dy[e] (C x F) @ w[e]^T
  const Gemm gx{dy, w, dx, r, C, D, F, r != nullptr, false,
                st[4], st[5], st[2], st[3], st[6], st[7]};
  const int err = launch<false, true>(elem_bytes, gx, E, s);
  if (err) return err;
  // dw[e] (D x F) = x[e]^T (D x C) @ dy[e]
  const Gemm gw{x, dy, dw, r, D, F, C, false, r != nullptr,
                st[0], st[1], st[4], st[5], st[8], st[9]};
  return launch<true, false>(elem_bytes, gw, E, s);
}
