// K3's float32 grouped GEMM on the CUDA cores, shared by the float32
// forward (csrc/moe_gmm.cu, moe_gmm_ffma) and both float32 backward
// products (csrc/moe_gmm_bwd.cu, gmm_bwd_ffma): Y[e] (M x N) = A[e]
// (M x K) @ B[e] (K x N), each operand read in its global layout (Gemm,
// gmm_wgmma.cuh), the products full float32 fmaf summed in float32.
//
// It replaces the first float32 backward (64 x 64 tiles, 4 x 4 outputs a
// thread, element loads into static shared memory, no prefetch: 19% of
// the float32 bound at the all-to-all dispatch's shape) and the first
// float32 forward but its dense decode tiles (moe_gmm.cu): its C > 32
// tiles (register-staged loads, at most 6 x 8 outputs a thread, x read
// from shared memory one scalar per row: 34%) and its ragged split-D
// tiles.  The float32 routes are the port's parity checks, so TF32
// (about three decimal digits) is not used.
//
// What bounds it on the H100: operations.  At the all-to-all dispatch's
// shape (E = 128, M = 8,192 packed rows, about 64 an expert, D = 4096,
// F = 1536) each product is 103 GFLOP, 1.54 ms at the 67 TFLOP/s of the
// float32 CUDA cores, against about 0.96 ms for its largest operand (all
// of w read, or all of dw written) at 3.35 TB/s.  So the loop is built to
// keep the FMA pipes fed:
//   - A block of 256 threads owns a BM x 128 tile of Y; each thread TM x
//     8 of it (TM = BM / 16: 4, 5, 6 or 8), up to 64 float32
//     accumulators, at most 128 registers so that two blocks share a SM.
//     A warp owns 4 threads along M by 8 along N, so each of its shared
//     reads of either operand touches 128 distinct bytes at most.
//   - K runs through a ring of 4 stages, each 16 deep, filled by
//     cp.async (3 stages in flight while one is multiplied), coalesced in
//     each operand's own layout: 4 threads read one row's 64 bytes of a
//     K-contiguous operand, 32 threads 512 bytes of an N- or M-contiguous
//     one.  An operand whose base and row stride are 16-byte aligned is
//     copied in 16-byte chunks without a branch, the tail of a chunk that
//     crosses a bound (M, N, K, the live rows, a segment's end) zero
//     filled through cp.async's src-size; else (F = 259, an odd row
//     stride) a chunk is up to four 4-byte copies, its floats outside the
//     operand stored as zeros.
//   - Each stage keeps its operands' layouts, so nothing is transposed (a
//     cp.async cannot scatter).  A K-outer operand (dw's x, the forward's
//     w, dw's dy) is [k][x]: at each k a thread reads float4s along its
//     4 + 4 rows or columns.  A K-contiguous one (the forward's x, dx's dy
//     and w^T) is [x][k], XOR-swizzled (kin): a thread reads a float2
//     along k for each of its rows or columns, two steps of k at once.
//     Per two steps of k a thread issues 16 TM fmaf against 4 + 4, TM + 4
//     or TM + 8 shared reads.
//   - The block's height follows the rows an expert (ffma_bm: C dense,
//     the mean ceil(M / E) ragged raised by a quarter for the counts'
//     spread), so that an expert's rows fit one tile where they can and
//     its weights are read once.  A K-contiguous A's rows are contiguous
//     per warp, and a warp whose rows are all past the live rows skips its
//     products (it still loads and meets the barriers): a tile's dead
//     rows cost loads only, and those are zero fills that read nothing.
//   - Stores are float4 where 4 columns are inside and 16-byte aligned.
//   - No atomics: every sum stays in one thread, in a fixed order, so a
//     call gives the same bits every time.
// On the H100 (PERF.md) the all-to-all dispatch's forward and dx run at
// about 40% of the float32 peak, on 80-row tiles for about 64 rows an
// expert, and dw at about half, 4 stages a block, where its set-up and
// stores weigh.
//
// Ragged (the all-to-all dispatch's packed buffer, ragged.cuh; the rules
// of gmm_wgmma.cuh):
//   kM (the forward, dx): Y's rows are the packed ones, tiled as
//     ragged_tile says; A's rows past the segment's end are zero filled
//     and the store stops at the segment's end (the rows past it are
//     another expert's, or rows of no expert that the caller zeroed).
//   kK (dw): the sum runs over the segment's rows in stages of 16 from its
//     first row, the loads of both operands zero filled past its end (not
//     past M: those rows are the next expert's data); an expert with no
//     row runs no stage and writes a zero dw[e].
// Dense, rows c >= rows[e] of Y are written as zeros (the forward, dx) and
// dw sums only c < rows[e].
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_wgmma.cuh"        // Gemm, Ragged, Tile, tile_of, grid_of
#include "mma_sync.cuh"         // cp.async, smem_once

namespace {

constexpr int kFfThreads = 256;
constexpr int kFfBN = 128;            // columns of Y a block
constexpr int kFfBK = 16;             // depth of one stage
constexpr int kFfStages = 4;          // ring: three stages in flight
constexpr int kFfMinBlocks = 2;       // blocks a SM: at most 128 registers
constexpr int kFfCPR = kFfBK / 4;     // 16-byte chunks of a K-contiguous row

template <int BM>
constexpr size_t ffma_smem() {
  return sizeof(float) * kFfStages * (size_t)(BM + kFfBN) * kFfBK;
}

// The block height for R rows an expert (C dense, the mean ceil(M / E)
// ragged, raised by a quarter there for the spread of the counts): 64 up
// to 64 rows, else whichever of 128, 96, 80 and 64 pads R least, the
// taller on a tie.
inline int ffma_bm(int R, bool ragged) {
  if (ragged) R += R / 4;
  if (R <= 64) return 64;
  const int heights[3] = {96, 80, 64};
  int best = 128, best_pad = (R + 127) / 128 * 128 - R;
  for (int bm : heights) {
    const int pad = (R + bm - 1) / bm * bm - R;
    if (pad < best_pad) best = bm, best_pad = pad;
  }
  return best;
}

// Float offset of chunk c (floats 4 c .. 4 c + 3 along k) of row x in a
// K-contiguous [x][k] stage of 16-float rows, read by the threads of key
// (x / G) mod 8.  PAIR (B, G = 4: a thread's columns 4 t + j): rows x and
// x ^ 1 share a 128-byte line whose 8 chunks are XORed with the key, so
// the 8 rows 4 apart that a warp reads at once hit 8 bank groups.  Else
// (A, G = TM: a thread's rows): a row's 4 chunks XORed with the key's low
// bits, so the rows of a warp's 4 threads along M hit 4.
template <int G, bool PAIR>
__device__ __forceinline__ int kin(int x, int c) {
  static_assert(kFfBK == 16, "the layout of 16-float rows");
  const int key = (x / G) & 7;
  if constexpr (PAIR)
    return (x >> 1) * 32 + 4 * ((((x & 1) << 2) | c) ^ key);
  else
    return x * kFfBK + 4 * (c ^ (key & 3));
}

// The 4 floats at src, of which the first n lie inside the operand, into
// the 16 bytes at dst, for an operand that is not 16-byte aligned: four
// 4-byte cp.async, the floats past n stored as zeros (all four where
// n <= 0).  src is read only inside the operand.
__device__ __forceinline__ void ff_chunk(float* dst, const float* src,
                                         int n) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_u32(dst + j)),
                   "l"(src + j));
    else
      dst[j] = 0.f;
  }
}

// One kFfBK-deep stage of a BX-wide operand tile into s, p at its element
// (k0, x0): K-outer, element (k, x) at p + k * ld + x, stored [k][x];
// else element (x, k) at p + x * ld + k, stored [x][k] (kin<G, PAIR>).  Rows
// along K past nk and along X past nx are zeros.  aligned: p and ld are
// 16-byte aligned, so every chunk is one 16-byte copy, its tail zero
// filled, with no branch (p stands in for a chunk wholly outside).
template <int BX, bool KOUTER, int G = 4, bool PAIR = true>
__device__ __forceinline__ void ff_stage(float* s, const float* p,
                                         long long ld, int nx, int nk,
                                         bool aligned) {
  constexpr int CPR = KOUTER ? BX / 4 : kFfCPR;      // chunks a row
  constexpr int N = KOUTER ? kFfBK * CPR : BX * CPR;
#pragma unroll
  for (int j = 0; j < (N + kFfThreads - 1) / kFfThreads; ++j) {
    const int i = (int)threadIdx.x + j * kFfThreads;
    if (N % kFfThreads != 0 && i >= N) break;
    const int r = i / CPR, c = i % CPR;
    const int n = KOUTER ? (r < nk ? nx - 4 * c : 0)
                         : (r < nx ? nk - 4 * c : 0);
    float* dst = s + (KOUTER ? r * BX + 4 * c : kin<G, PAIR>(r, c));
    const float* src = p + (long long)r * ld + 4 * c;
    if (aligned)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(dst)),
                   "l"(n > 0 ? src : p), "r"(4 * min(max(n, 0), 4)));
    else
      ff_chunk(dst, src, n);
  }
}

// The body of a kernel of kFfThreads threads and ffma_smem<BM>() bytes of
// dynamic shared memory, launched on grid_of<R>(g, BM, kFfBN).  A_KM: A
// is M-major (dw's x; then BM = 128); B_NK: B is K-major (dx's w).  A
// thread owns TM = BM / 16 rows, tr * TM + i of a K-contiguous A (4 tr + i
// and BM / 2 + 4 tr + i of an M-major one), and columns 4 tc + j and
// BN / 2 + 4 tc + j, for tr and tc in 0 .. 15.
template <bool A_KM, bool B_NK, Ragged R, int BM>
__device__ __forceinline__ void gmm_ffma(const Gemm& g) {
  constexpr int BN = kFfBN, TM = BM / 16, TC = BN / 8;
  static_assert(BM % 16 == 0 && TC * 16 == kFfThreads && (!A_KM || TM == 8),
                "tile shape");
  constexpr int kStage = (BM + BN) * kFfBK;       // floats of a stage
  extern __shared__ __align__(16) float smem_ff[];
  Tile tl;
  if (!tile_of<R>(tl, g, BM, BN)) return;
  const int m0 = tl.m0, n0 = tl.n0, mlim = tl.mlim, klim = tl.klim;
  float* y = static_cast<float*>(g.y) + tl.yo;
  const int tid = threadIdx.x;

  if (m0 >= mlim) {                               // no live row: zeros
    const int nr = min(BM, tl.mrows - m0), nc = min(BN, g.N - n0);
    for (int i = tid; i < nr * nc; i += kFfThreads)
      y[(long long)(m0 + i / nc) * g.ldy + n0 + i % nc] = 0.f;
    return;
  }
  const float* a = static_cast<const float*>(g.a) + tl.ao;
  const float* b = static_cast<const float*>(g.b) + tl.bo;
  // a warp owns 4 tr by 8 tc, so that its reads of each operand touch 128
  // distinct bytes; over a K-contiguous A its rows are 4 wr TM .. + 4 TM,
  // and it skips its products when they all lie past the live rows
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = warp / (TC / 8);
  const int tr = 4 * wr + (lane >> 3);
  const int tc = 8 * (warp % (TC / 8)) + (lane & 7);
  const bool live = A_KM || 4 * wr * TM < mlim - m0;

  const bool a16 = ((reinterpret_cast<uintptr_t>(a) | g.lda * 4) & 15) == 0;
  const bool b16 = ((reinterpret_cast<uintptr_t>(b) | g.ldb * 4) & 15) == 0;
  auto load = [&](int kt) {
    float* as = smem_ff + (kt % kFfStages) * kStage;
    float* bs = as + BM * kFfBK;
    const int k0 = kt * kFfBK;
    if constexpr (A_KM)
      ff_stage<BM, true>(as, a + (long long)k0 * g.lda + m0, g.lda,
                         mlim - m0, klim - k0, a16);
    else
      ff_stage<BM, false, TM, false>(as, a + (long long)m0 * g.lda + k0,
                                     g.lda, mlim - m0, klim - k0, a16);
    if constexpr (B_NK)
      ff_stage<BN, false>(bs, b + (long long)n0 * g.ldb + k0, g.ldb,
                          g.N - n0, klim - k0, b16);
    else
      ff_stage<BN, true>(bs, b + (long long)k0 * g.ldb + n0, g.ldb,
                         g.N - n0, klim - k0, b16);
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (klim + kFfBK - 1) / kFfBK;
#pragma unroll
  for (int s = 0; s < kFfStages - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  // the shared offsets of this thread's K-contiguous reads: A's row
  // tr * TM + i at chunk q is ra + i * kFfBK + 4 (q ^ ka); B's column
  // 4 tc + j (+ BN / 2) at chunk q is rb + (its row's) + 4 ((h | q) ^ kb)
  const int ka = tr & 3, kb = tc & 7;
  const int ra = tr * TM * kFfBK, rb = 64 * tc;
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kFfStages - 2>();         // stage kt has landed (this thread)
    __syncthreads();                  // ... for every thread; kt - 1 is free
    if (kt + kFfStages - 1 < nk) load(kt + kFfStages - 1);
    cp_commit();
    if (!live) continue;
    const float* as = smem_ff + (kt % kFfStages) * kStage;
    const float* bs = as + BM * kFfBK;
#pragma unroll
    for (int p = 0; p < kFfBK / 2; ++p) {      // 2 steps of k: 2 p, 2 p + 1
      const int q = p >> 1, h2 = 2 * (p & 1);  // chunk q, its half h2
      float av[TM][2], bv[8][2];
      if constexpr (A_KM) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* r = as + (2 * p + kk) * BM + 4 * tr;
          const float4 lo = *reinterpret_cast<const float4*>(r);
          const float4 hi = *reinterpret_cast<const float4*>(r + BM / 2);
          av[0][kk] = lo.x; av[1][kk] = lo.y; av[2][kk] = lo.z;
          av[3][kk] = lo.w; av[4][kk] = hi.x; av[5][kk] = hi.y;
          av[6][kk] = hi.z; av[7][kk] = hi.w;
        }
      } else {
        const float* r = as + ra + 4 * (q ^ ka) + h2;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(r + i * kFfBK);
          av[i][0] = v.x; av[i][1] = v.y;
        }
      }
      if constexpr (B_NK) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // column (j < 4 ? 0 : BN / 2) + 4 tc + (j & 3)
          const int half = j < 4 ? 0 : BN / 2 * kFfBK;
          const int jj = j & 3;
          const int off = 32 * (jj >> 1) + 4 * ((((jj & 1) << 2) | q) ^ kb);
          const float2 v =
              *reinterpret_cast<const float2*>(bs + rb + half + off + h2);
          bv[j][0] = v.x; bv[j][1] = v.y;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* r = bs + (2 * p + kk) * BN + 4 * tc;
          const float4 lo = *reinterpret_cast<const float4*>(r);
          const float4 hi = *reinterpret_cast<const float4*>(r + BN / 2);
          bv[0][kk] = lo.x; bv[1][kk] = lo.y; bv[2][kk] = lo.z;
          bv[3][kk] = lo.w; bv[4][kk] = hi.x; bv[5][kk] = hi.y;
          bv[6][kk] = hi.z; bv[7][kk] = hi.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i][kk], bv[j][kk], acc[i][j]);
    }
  }
  cp_wait_all();                      // only empty groups remain

  // rows past mrows are not the expert's: the store stops there (ragged
  // M: the next expert's rows); rows past mlim are zeros (dense rows)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + (A_KM ? (i < 4 ? 0 : BM / 2) + 4 * tr + (i & 3)
                               : tr * TM + i);
    if (row >= tl.mrows) continue;
    float* yr = y + (long long)row * g.ldy;
    const bool on = row < mlim;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * (BN / 2) + 4 * tc;
      const float4 v = on ? make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                        acc[i][4 * h + 2], acc[i][4 * h + 3])
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      if (col + 3 < g.N && (reinterpret_cast<uintptr_t>(yr + col) & 15) == 0) {
        *reinterpret_cast<float4*>(yr + col) = v;
      } else {
        if (col < g.N) yr[col] = v.x;
        if (col + 1 < g.N) yr[col + 1] = v.y;
        if (col + 2 < g.N) yr[col + 2] = v.z;
        if (col + 3 < g.N) yr[col + 3] = v.w;
      }
    }
  }
}

// Launch kern, a __global__ wrapper of gmm_ffma<..., R, BM> (done: its
// once-per-device shared-memory flag), on grid_of<R>.
template <int BM, Ragged R>
int ffma_launch(void (*kern)(Gemm), unsigned* done, const Gemm& g,
                cudaStream_t s) {
  constexpr size_t smem = ffma_smem<BM>();
  const cudaError_t err = smem_once((const void*)kern, smem, done);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid_of<R>(g, BM, kFfBN), kFfThreads, smem, s>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace
