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
// Both products are one grouped GEMM, Y[e] (M x N) = A[e] (M x K) @
// B[e] (K x N), taking each operand in its global layout:
//   dx: M = C, N = D, K = F; A = dy, K-major (a row of M holds K
//       contiguous); B = w, K-major too (w[e] is D x F: a row of N holds
//       K contiguous); live rows mlim = rows[e] along M, all of K.
//   dw: M = D, N = F, K = C; A = x, M-major (x[e] is C x D: a row of K
//       holds M contiguous); B = dy, N-major; all of M, live rows
//       klim = rows[e] along K, so an expert with no live row runs no
//       stage and writes zeros.
// The sum over K stays in the block (no atomics, a fixed order), in
// float32, and is rounded once to x.dtype / w.dtype.  Two launches a call:
// dx, then dw.
//
// What bounds it on the H100: operations.  At qwen3-moe-235b-a22b's
// training shapes (E = 128, C = 640, D = 4096, F = 1536) each product is
// 2 E C D F = 1.03 TFLOP, 1.04 ms at the 989 TFLOP/s of bf16 (2.08 ms for
// both), against 4.8 GB of operands read once and results written once
// (1.44 ms at 3.35 TB/s).
//
// bf16 where TMA can read every operand (gmm_bwd_wgmma; the wrapper's
// _route: 16-byte aligned bases and strides): warpgroup wgmma fed by TMA,
// the grouped main loop of gmm_wgmma.cuh (its design note there), dx as
// <A K-major, B K-major> and dw as <A M-major, B N-major>.
//
// Other bf16 calls (gmm_bwd_tc: unaligned rows such as F = 259, or an
// unaligned view): mma.sync.m16n8k16 with float32 accumulators.  A block
// of 8 warps owns a 128 x 128 tile of Y, each warp 64 x 32 (four m16 by
// four n8 tiles); K streams through a four-stage ring of 32-deep stages
// filled by cp.async 16-byte copies (element copies with zero fill where
// a chunk would cross a bound or is not 16-byte aligned).  Each operand's
// stage is kept in its global layout, XOR-swizzled (mma_sync.cuh), and its
// fragments come from ldmatrix: plain for a tile whose rows run along K
// on the fragment's own axis (A row-major, B "NK"), .trans for a tile
// whose rows run along K across it (A "KM", B row-major, the forward's
// w).  m16 tiles wholly past the live rows skip their products; a block
// wholly past them writes zeros and reads nothing.
//
// Ragged (starts beside rows: x (M, D), dy (M, F) and dx (M, D) packed,
// expert e owning the rows starts[e] .. + rows[e]): dx's rows are tiled
// as the forward's (ragged_tile in ragged.cuh) and its stores stop at the
// segment's end, and dw[e] sums over the expert's segment only, the rows
// past its end zeroed (those rows are the next expert's data, not zeros):
// on wgmma the boxes start at the segment's first row and the last dw
// stage's rows past its end are zeroed in shared memory (gmm_wgmma.cuh);
// on mma.sync and in float32 the loads past its end are zero filled.
//
// float32 (gmm_bwd_ffma): CUDA cores, so float32 gradients keep full
// float32 products: the grouped float32 main loop of gmm_f32.cuh (its
// design note there), dx as <A K-contiguous, B K-contiguous> with the
// block height following the rows an expert as the forward's, dw as <A
// M-major, B N-major> in 128 x 128 tiles.  It replaces 64 x 64 tiles of
// element loads without prefetch, which reached a fifth of the
// float32 bound (and half of two float32 torch._grouped_mm) at the
// all-to-all dispatch's shape.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gmm_f32.cuh"          // the float32 main loop
#include "gmm_wgmma.cuh"        // Gemm, Ragged, Tile, the wgmma main loop
#include "mma_sync.cuh"
#include "ragged.cuh"

namespace {

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

template <bool A_KM, bool B_NK, Ragged R>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_tc(Gemm g) {
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  Tile tl;
  if (!tile_of<R>(tl, g, kBM, kBN)) return;
  const int m0 = tl.m0, n0 = tl.n0, M = tl.mrows;
  const int mlim = tl.mlim, klim = tl.klim;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(g.y) + tl.yo;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix: matrix, its row
  const int wm = warp >> 2, wn = warp & 3;    // 2 x 4 warps of 64 x 32

  if (m0 >= mlim) {                           // no live row: zeros
    const int nr = min(kBM, M - m0), nc = min(kBN, g.N - n0);
    for (int i = tid; i < nr * nc; i += kThreads)
      y[(long long)(m0 + i / nc) * g.ldy + n0 + i % nc] =
          __float2bfloat16(0.f);
    return;
  }
  const int live_mt = (min(kBM, mlim - m0) - wm * 64 + 15) / 16;
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(g.a) + tl.ao;
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(g.b) + tl.bo;

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
      if (row >= M) continue;
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
// dx (A_KM false, B_NK true) or dw (A_KM true, B_NK false) on gmm_f32.cuh's
// main loop.
template <bool A_KM, bool B_NK, Ragged R, int BM>
__global__ void __launch_bounds__(kFfThreads, kFfMinBlocks)
gmm_bwd_ffma(Gemm g) {
  gmm_ffma<A_KM, B_NK, R, BM>(g);
}

template <bool A_KM, bool B_NK, Ragged R, int BM>
int launch_ffma(const Gemm& g, cudaStream_t s) {
  static unsigned done = 0;
  return ffma_launch<BM, R>(gmm_bwd_ffma<A_KM, B_NK, R, BM>, &done, g, s);
}

// dx's tile follows the rows an expert (R: C, or ragged the mean
// ceil(M / E)); dw's M is D, in tiles of 128.
template <bool A_KM, bool B_NK, Ragged R>
int dispatch_ffma(const Gemm& g, int rows_an_expert, cudaStream_t s) {
  if constexpr (A_KM) {
    return launch_ffma<A_KM, B_NK, R, 128>(g, s);
  } else {
    switch (ffma_bm(rows_an_expert, R != Ragged::kNo)) {
      case 64: return launch_ffma<A_KM, B_NK, R, 64>(g, s);
      case 80: return launch_ffma<A_KM, B_NK, R, 80>(g, s);
      case 96: return launch_ffma<A_KM, B_NK, R, 96>(g, s);
      default: return launch_ffma<A_KM, B_NK, R, 128>(g, s);
    }
  }
}

// ---------------------------------------------------------------------------
//  bf16 on wgmma, fed by TMA
// ---------------------------------------------------------------------------
// One block per (N tile of 256, M tile of 128, expert), or ragged along M
// per (ragged_tile's tile, N tile): gmm_wgmma.cuh's main loop.
template <bool A_KM, bool B_NK, Ragged R>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_bwd_wgmma(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb, Gemm g) {
  gmm_wgmma<A_KM, B_NK, R>(ta, tb, g);
}

// dx, then dw, on wgmma: x, w and dy with 16-byte aligned bases and
// strides.  Ragged (RX = kM, RW = kK): x and dy are packed (C, *)
// matrices, mapped with E = 1.
template <Ragged RX, Ragged RW>
int launch_wgmma(const void* x, const void* w, const void* dy, const Gemm& gx,
                 const Gemm& gw, int E, int C, int D, int F,
                 const long long* st, cudaStream_t s) {
  static unsigned done_x = 0, done_w = 0;
  constexpr bool packed = RX != Ragged::kNo;
  const int Ep = packed ? 1 : E;
  const long long x_se = packed ? C * st[1] : st[0];
  const long long dy_se = packed ? C * st[5] : st[4];
  CUtensorMap dy_k, w_k, x_m, dy_n;
  if (!tensor_map(&dy_k, dy, Ep, C, F, dy_se, st[5], kWgBK, kWgBM) ||
      !tensor_map(&w_k, w, E, D, F, st[2], st[3], kWgBK, kWgBN) ||
      !tensor_map(&x_m, x, Ep, C, D, x_se, st[1], 64, kWgBK) ||
      !tensor_map(&dy_n, dy, Ep, C, F, dy_se, st[5], 64, kWgBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = smem_once((const void*)gmm_bwd_wgmma<false, true, RX>,
                              kWgSmem, &done_x);
  if (err == cudaSuccess)
    err = smem_once((const void*)gmm_bwd_wgmma<true, false, RW>, kWgSmem,
                    &done_w);
  if (err != cudaSuccess) return (int)err;
  gmm_bwd_wgmma<false, true, RX>
      <<<grid_of<RX>(gx, kWgBM, kWgBN), kWgThreads, kWgSmem, s>>>(dy_k, w_k,
                                                                  gx);
  gmm_bwd_wgmma<true, false, RW>
      <<<grid_of<RW>(gw, kWgBM, kWgBN), kWgThreads, kWgSmem, s>>>(x_m, dy_n,
                                                                  gw);
  return (int)cudaGetLastError();
}

template <bool A_KM, bool B_NK, Ragged R>
int launch_as(int elem_bytes, const Gemm& g, int rows_an_expert,
              cudaStream_t s) {
  if (elem_bytes == 4)
    return dispatch_ffma<A_KM, B_NK, R>(g, rows_an_expert, s);
  static unsigned done = 0;
  cudaError_t err = smem_once((const void*)gmm_bwd_tc<A_KM, B_NK, R>,
                              kSmemTc, &done);
  if (err != cudaSuccess) return (int)err;
  gmm_bwd_tc<A_KM, B_NK, R>
      <<<grid_of<R>(g, kBM, kBN), kThreads, kSmemTc, s>>>(g);
  return (int)cudaGetLastError();
}

// dx (A row-major) tiles the packed rows, dw (A M-major) sums over them.
template <bool A_KM, bool B_NK>
int launch(int elem_bytes, const Gemm& g, int rows_an_expert,
           cudaStream_t s) {
  constexpr Ragged r = A_KM ? Ragged::kK : Ragged::kM;
  return g.starts
             ? launch_as<A_KM, B_NK, r>(elem_bytes, g, rows_an_expert, s)
             : launch_as<A_KM, B_NK, Ragged::kNo>(elem_bytes, g,
                                                  rows_an_expert, s);
}

}  // namespace

// elem_bytes: 4 = float32, 2 = bfloat16 (x, w, dy, dx and dw all of it).
// wgmma: 1 takes the TMA / wgmma kernel (bf16, every base and every
// stride but the unit one 16-byte aligned), 0 the mma.sync or float32 one.
// rows: null, or (E,) int32 on the device.  starts: null (dense), or (E,)
// int32 on the device with rows (ragged: x (C, D), dy (C, F) and dx (C, D)
// packed, expert e's rows starts[e] .. + rows[e], not overlapping; dx's
// rows of no expert are left as they are, so the caller allocates dx as
// zeros; on wgmma x and dy are mapped as (C, *) matrices).  strides
// (elements): x_se, x_sc, w_se, w_sd, dy_se, dy_sc, dx_se, dx_sc, dw_se,
// dw_sd; the last dimension of every tensor has unit stride.  Two launches
// (dx, then dw).  Returns a cudaError_t (0 on success).
extern "C" int repro_moe_gmm_bwd(int elem_bytes, int wgmma, const void* x,
                                 const void* w, const void* dy,
                                 const void* rows, const void* starts,
                                 void* dx, void* dw, int E, int C, int D,
                                 int F, const long long* st, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 ||
      (elem_bytes != 2 && elem_bytes != 4) || (wgmma && elem_bytes != 2) ||
      (starts && !rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  const int* sp = static_cast<const int*>(starts);
  // dx[e] (C x D) = dy[e] (C x F) @ w[e]^T
  const Gemm gx{dy, w, dx, r, sp, E, C, D, F, r != nullptr, false,
                st[4], st[5], st[2], st[3], st[6], st[7]};
  // dw[e] (D x F) = x[e]^T (D x C) @ dy[e]
  const Gemm gw{x, dy, dw, r, sp, E, D, F, C, false, r != nullptr,
                st[0], st[1], st[4], st[5], st[8], st[9]};
  if (wgmma)
    return sp ? launch_wgmma<Ragged::kM, Ragged::kK>(x, w, dy, gx, gw, E, C,
                                                     D, F, st, s)
              : launch_wgmma<Ragged::kNo, Ragged::kNo>(x, w, dy, gx, gw, E,
                                                       C, D, F, st, s);
  const int R = sp ? (C + E - 1) / E : C;      // rows an expert
  const int err = launch<false, true>(elem_bytes, gx, R, s);
  if (err) return err;
  return launch<true, false>(elem_bytes, gw, R, s);
}
