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
// _route: 16-byte aligned bases and strides): warpgroup wgmma.mma_async
// (m64n256k16, bf16 in, float32 accumulators), the only way to the tensor
// cores' full rate on Hopper, fed by TMA (cp.async.bulk.tensor) through a
// ring of 4 stages, each 64 deep along K, under mbarriers.  A block of 384
// threads owns a 128 x 256 tile of Y: one producer warpgroup (40 registers
// a thread after setmaxnreg; one thread issues the loads) and two consumer
// warpgroups of 64 rows each (232 registers: a 64 x 256 float32
// accumulator is 128 a thread).  A stage is 48 KB (A 128 x 64, B 256 x 64
// bf16), 192 KB in all, in TMA's 128-byte swizzle, which wgmma's
// descriptors read directly: a K-major operand as one box of rows of 64 K
// (128 bytes), a k-step of 16 advancing the descriptor by 32 bytes; an
// MN-major operand as boxes of 64 (M or N) x 64 K, one per 64 of M or N
// (the descriptor's leading offset steps between them, its stride offset
// between groups of 8 K rows), a k-step advancing by 16 rows, and
// wgmma's transpose bits set.  So nothing is transposed in device memory.
// The tensor maps are 3-D (E, rows, cols), built on the host for each
// call with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda), passed as __grid_constant__.
// TMA fills zeros past a tensor's bounds (ragged M, N, K), but not past
// rows[e]: a dx tile wholly past rows[e] loads nothing and writes zeros,
// and its rows past rows[e] are written as zeros; in dw the K loop stops
// at ceil(rows[e] / 64), and the consumers zero the last stage's K rows
// >= rows[e] of both operands in shared memory (generic stores, then
// fence.proxy.async before wgmma's async-proxy reads) before its wgmma.
// Each consumer keeps one wgmma group in flight and frees the previous
// stage when it completes.  Results go from the accumulators straight to
// global memory as bf16 pairs.  A persistent form (one block a SM
// striding over the tiles, the ring running on from tile to tile) was
// slower on the H100 at the gate/up training shape: the card's own block
// scheduling balances the SMs better than a fixed stride.
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
// float32 (gmm_bwd_f32): CUDA cores, as the forward's float32 kernel, so
// float32 gradients keep full float32 products.  A 256-thread block owns a
// 64 x 64 tile of Y, each thread 4 x 4, and walks K in stages of 16 loaded
// element by element with zero fill.
#include <cuda.h>               // CUtensorMap and its enums (no -lcuda)
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

// ---------------------------------------------------------------------------
//  bf16 on wgmma, fed by TMA
// ---------------------------------------------------------------------------
constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 64;
constexpr int kWgStages = 4;
constexpr int kWgThreads = 384;      // consumer warpgroups 0 and 1, producer 2
constexpr int kWgBox = 64 * 64 * 2;  // bytes of a 64 x 64 MN-major box
constexpr int kWgABytes = kWgBM * kWgBK * 2;
constexpr int kWgStageBytes = kWgABytes + kWgBN * kWgBK * 2;
constexpr size_t kWgSmem =           // 1024-byte alignment slack, barriers
    1024 + (size_t)kWgStages * kWgStageBytes + 2 * kWgStages * 8;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` of bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// The box of map at (c0, c1, c2) (columns, rows, expert) into dst; its
// bytes complete a transaction of bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}
// wgmma's shared-memory matrix descriptor of a 128-byte-swizzled operand
// at p (1024-byte aligned atoms): leading and stride byte offsets.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32 |
         1ull << 62;
}
// Keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (the warpgroup's 64 x 256 float32 accumulator fragment) += A (64 x
// 16) B (16 x 256), bf16, both read from shared memory through the
// descriptors da and db; TA / TB: A / B is MN-major ("transposed") rather
// than K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// One block per (N tile of 256, M tile of 128, expert).  A_KM: A is
// M-major (dw's x); B_NK: B is K-major (dx's w).  ta, tb: the operands'
// tensor maps, boxes of 64 K x 128 rows (A) or 256 rows (B) when K-major,
// 64 x 64 when MN-major.
template <bool A_KM, bool B_NK>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_bwd_wgmma(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb, Gemm g) {
  extern __shared__ __align__(16) uint8_t smem_wg[];
  uint8_t* base = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base +
                                               kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  const int e = blockIdx.z, m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * kWgBN;
  const int mlim = g.rows_m ? live(g.rows, e, g.M) : g.M;
  const int klim = g.rows_k ? live(g.rows, e, g.K) : g.K;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(g.y) + e * g.y_se;
  const int tid = threadIdx.x;

  if (m0 >= mlim) {                           // no live row: zeros
    const int nr = min(kWgBM, g.M - m0), nc = min(kWgBN, g.N - n0);
    for (int i = tid; i < nr * nc; i += kWgThreads)
      y[(long long)(m0 + i / nc) * g.ldy + n0 + i % nc] =
          __float2bfloat16(0.f);
    return;
  }
  const int nk = (klim + kWgBK - 1) / kWgBK;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);                 // the producer's expect_tx
      mbar_init(&empty[s], 2);                // one thread per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer warpgroup: one thread keeps the ring's loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kWgStages, k0 = kb * kWgBK;
        mbar_wait(&empty[s], ((kb / kWgStages) & 1) ^ 1);
        uint8_t* as = base + s * kWgStageBytes;
        uint8_t* bs = as + kWgABytes;
        mbar_expect_tx(&full[s], kWgStageBytes);
        if constexpr (A_KM) {
          tma_load(as, &ta, &full[s], m0, k0, e);
          tma_load(as + kWgBox, &ta, &full[s], m0 + 64, k0, e);
        } else {
          tma_load(as, &ta, &full[s], k0, m0, e);
        }
        if constexpr (B_NK) {
          tma_load(bs, &tb, &full[s], k0, n0, e);
        } else {
#pragma unroll
          for (int j = 0; j < kWgBN / 64; ++j)
            tma_load(bs + j * kWgBox, &tb, &full[s], n0 + 64 * j, k0, e);
        }
      }
    }
  } else {
    // consumer warpgroups: rows wg * 64 .. of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    const int rem = klim - (nk - 1) * kWgBK;  // live K rows of the last stage
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % kWgStages;
      mbar_wait(&full[s], (kb / kWgStages) & 1);
      uint8_t* as = base + s * kWgStageBytes;
      uint8_t* bs = as + kWgABytes;
      if constexpr (A_KM && !B_NK) {
        if (g.rows_k && kb == nk - 1 && rem < kWgBK) {
          // dw: K rows >= rows[e] of the last stage are zeroed in both
          // operands (six MN-major boxes, a K row = 128 bytes of each)
          const int dead = (kWgBK - rem) * 8;   // 16-byte chunks per box
          for (int i = tid; i < 6 * dead; i += 256) {
            const int box = i / dead, c = i - box * dead;
            uint8_t* p = (box < 2 ? as + box * kWgBox
                                  : bs + (box - 2) * kWgBox) +
                         rem * 128 + c * 16;
            *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync 1, 256;\n" ::: "memory");
        }
      }
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint64_t da =
            A_KM ? gmma_desc(as + wg * kWgBox + kk * 16 * 128, kWgBox, 1024)
                 : gmma_desc(as + wg * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = B_NK ? gmma_desc(bs + kk * 32, 16, 1024)
                                 : gmma_desc(bs + kk * 16 * 128, kWgBox, 1024);
        wgmma_256<A_KM ? 1 : 0, B_NK ? 0 : 1>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      // the previous stage's products are done: its buffers may refill
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (kb > 0 && (tid & 127) == 0)
        mbar_arrive(&empty[(kb - 1) % kWgStages]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // acc[4 j + 2 h + c]: row 16 w + lane / 4 + 8 h of the warpgroup's 64,
    // column 8 j + 2 (lane % 4) + c
    const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wg * 64 + warp * 16 + (lane >> 2) + hh * 8;
      if (row >= g.M) continue;
      __nv_bfloat16* yr = y + (long long)row * g.ldy;
      const bool on = row < mlim;
#pragma unroll
      for (int j = 0; j < kWgBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        const float v0 = on ? acc[4 * j + 2 * hh] : 0.f;
        const float v1 = on ? acc[4 * j + 2 * hh + 1] : 0.f;
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
}

// cuTensorMapEncodeTiled, from the driver through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 3-D map (columns, rows, E) of a bf16 tensor at p with unit column
// stride, row stride sr and expert stride se (elements), read in boxes of
// bc columns x br rows, 128-byte swizzled, zeros past its bounds.
bool tensor_map(CUtensorMap* m, const void* p, int E, int rows, int cols,
                long long se, long long sr, int bc, int br) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)sr * 2, (cuuint64_t)se * 2};
  const cuuint32_t box[3] = {(cuuint32_t)bc, (cuuint32_t)br, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dx, then dw, on wgmma: x, w and dy with 16-byte aligned bases and strides
int launch_wgmma(const void* x, const void* w, const void* dy, const Gemm& gx,
                 const Gemm& gw, int E, int C, int D, int F,
                 const long long* st, cudaStream_t s) {
  static unsigned done_x = 0, done_w = 0;
  CUtensorMap dy_k, w_k, x_m, dy_n;
  if (!tensor_map(&dy_k, dy, E, C, F, st[4], st[5], kWgBK, kWgBM) ||
      !tensor_map(&w_k, w, E, D, F, st[2], st[3], kWgBK, kWgBN) ||
      !tensor_map(&x_m, x, E, C, D, st[0], st[1], 64, kWgBK) ||
      !tensor_map(&dy_n, dy, E, C, F, st[4], st[5], 64, kWgBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = smem_once((const void*)gmm_bwd_wgmma<false, true>,
                              kWgSmem, &done_x);
  if (err == cudaSuccess)
    err = smem_once((const void*)gmm_bwd_wgmma<true, false>, kWgSmem,
                    &done_w);
  if (err != cudaSuccess) return (int)err;
  gmm_bwd_wgmma<false, true>
      <<<dim3((D + kWgBN - 1) / kWgBN, (C + kWgBM - 1) / kWgBM, E),
         kWgThreads, kWgSmem, s>>>(dy_k, w_k, gx);
  gmm_bwd_wgmma<true, false>
      <<<dim3((F + kWgBN - 1) / kWgBN, (D + kWgBM - 1) / kWgBM, E),
         kWgThreads, kWgSmem, s>>>(x_m, dy_n, gw);
  return (int)cudaGetLastError();
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
// wgmma: 1 takes the TMA / wgmma kernel (bf16, every base and every
// stride but the unit one 16-byte aligned), 0 the mma.sync or float32 one.
// rows: null, or (E,) int32 on the device.  strides (elements): x_se,
// x_sc, w_se, w_sd, dy_se, dy_sc, dx_se, dx_sc, dw_se, dw_sd; the last
// dimension of every tensor has unit stride.  Two launches (dx, then dw).
// Returns a cudaError_t (0 on success).
extern "C" int repro_moe_gmm_bwd(int elem_bytes, int wgmma, const void* x,
                                 const void* w, const void* dy,
                                 const void* rows, void* dx, void* dw, int E,
                                 int C, int D, int F, const long long* st,
                                 void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 ||
      (elem_bytes != 2 && elem_bytes != 4) || (wgmma && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  // dx[e] (C x D) = dy[e] (C x F) @ w[e]^T
  const Gemm gx{dy, w, dx, r, C, D, F, r != nullptr, false,
                st[4], st[5], st[2], st[3], st[6], st[7]};
  // dw[e] (D x F) = x[e]^T (D x C) @ dy[e]
  const Gemm gw{x, dy, dw, r, D, F, C, false, r != nullptr,
                st[0], st[1], st[4], st[5], st[8], st[9]};
  if (wgmma) return launch_wgmma(x, w, dy, gx, gw, E, C, D, F, st, s);
  const int err = launch<false, true>(elem_bytes, gx, E, s);
  if (err) return err;
  return launch<true, false>(elem_bytes, gw, E, s);
}
