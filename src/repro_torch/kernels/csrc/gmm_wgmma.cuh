// K3's grouped GEMM on warpgroup wgmma fed by TMA, shared by the ragged
// bf16 forward (csrc/moe_gmm.cu, moe_gmm_wgmma) and the bf16 backward
// (csrc/moe_gmm_bwd.cu, gmm_bwd_wgmma): Y[e] (M x N) = A[e] (M x K) @
// B[e] (K x N), each operand read in its global layout, float32 sums
// rounded once to bf16.
//
// Warpgroup wgmma.mma_async (m64n256k16, bf16 in, float32 accumulators),
// the only way to the tensor cores' full rate on Hopper, fed by TMA
// (cp.async.bulk.tensor) through a ring of 4 stages, each 64 deep along K,
// under mbarriers.  A block of 384 threads owns a 128 x 256 tile of Y: one
// producer warpgroup (40 registers a thread after setmaxnreg; one thread
// issues the loads) and two consumer warpgroups of 64 rows each (232
// registers: a 64 x 256 float32 accumulator is 128 a thread).  A stage is
// 48 KB (A 128 x 64, B 256 x 64 bf16), 192 KB in all, in TMA's 128-byte
// swizzle, which wgmma's descriptors read directly: a K-major operand as
// one box of rows of 64 K (128 bytes), a k-step of 16 advancing the
// descriptor by 32 bytes; an MN-major operand as boxes of 64 (M or N) x 64
// K, one per 64 of M or N (the descriptor's leading offset steps between
// them, its stride offset between groups of 8 K rows), a k-step advancing
// by 16 rows, and wgmma's transpose bits set.  So nothing is transposed in
// device memory.  The tensor maps are 3-D (E, rows, cols), built on the
// host for each call with cuTensorMapEncodeTiled (hopper.cuh), passed as
// __grid_constant__; an operand packed along a ragged dimension is one
// (rows, cols) matrix, mapped with E = 1.  TMA fills zeros past a
// tensor's bounds (ragged M, N, K), but not past rows[e]: a tile wholly
// past rows[e] loads nothing and writes zeros, and its rows past rows[e]
// are written as zeros; where the live rows run along K the K loop stops
// at ceil(rows[e] / 64), and the consumers zero the last stage's K rows
// >= rows[e] of both operands in shared memory (generic stores, then
// fence.proxy.async before wgmma's async-proxy reads) before its wgmma.
// Each consumer keeps one wgmma group in flight and frees the previous
// stage when it completes.  Results go from the accumulators straight to
// global memory as bf16 pairs.  A persistent form (one block a SM striding
// over the tiles, the ring running on from tile to tile) was slower on the
// H100 at the backward's gate/up training shape: the card's own block
// scheduling balances the SMs better than a fixed stride.
//
// Ragged (the all-to-all dispatch's packed buffer: expert e owns the rows
// starts[e] .. + rows[e] of one (M, *) operand, ragged.cuh).  A TMA box
// may start at any row, so a box starts at the segment's first row plus
// the tile's or stage's offset and may run past the segment's end:
//   kM (the forward, dx): Y's rows are the packed ones, tiled as
//     ragged_tile says.  A box of A past the segment's end reads the next
//     expert's rows; each output row depends on its own input row only, so
//     the store just stops at the segment's end.  It must: the rows past
//     it are another expert's output, or rows of no expert that the
//     caller zeroed, and writing zeros there (the dense store's rows >=
//     rows[e]) would race with the block that owns them.
//   kK (dw): the sum over K runs over the segment's rows in stages of 64
//     from its first row; the last stage's rows past the segment's end
//     are another expert's data and are zeroed in both operands.  An
//     expert with no row runs no stage (the producer loads nothing, no
//     consumer waits) and writes a zero dw[e].
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"           // mbarriers, TMA, wgmma, tensor maps
#include "ragged.cuh"

namespace {

// One product's operands: element (m, k) of A[e] at a + e * a_se + (A_KM ?
// k * lda + m : m * lda + k), element (k, n) of B[e] at b + e * b_se +
// (B_NK ? n * ldb + k : k * ldb + n), Y[e] row-major with row stride ldy.
// Rows m >= mlim of Y are zeros and only k < klim is summed; mlim and klim
// are M and K, or rows[e] where rows_m / rows_k say so.  Ragged (starts
// not null): the dimension rows_m / rows_k names is a packed one of M / K
// rows in which expert e owns the segment starts[e] .. + rows[e]; along M
// (the forward, dx) A is row-major and A and Y start at the segment's
// first row, along K (dw) A is M-major and A and B start there, and the
// a_se / b_se / y_se of a packed operand are unused.
struct Gemm {
  const void* a;
  const void* b;
  void* y;
  const int* rows;
  const int* starts;
  int E, M, N, K;
  bool rows_m, rows_k;
  long long a_se, lda, b_se, ldb, y_se, ldy;
};

__device__ __forceinline__ int live(const int* rows, int e, int n) {
  return min(max(rows[e], 0), n);
}

// How a kernel's M and K are laid out: dense (every expert's own (M, K)
// operands), or ragged along M (Y's rows are the packed ones) or along K
// (the sum runs over the packed rows).  A template argument, so the dense
// kernels carry none of the ragged code or its shared memory.
enum class Ragged { kNo, kM, kK };

// Where a block of a bm x bn tile of Y works: expert e, its first row m0
// (within the expert's segment when M is ragged) and column n0, the first
// row s0 of the expert's segment along the ragged dimension (0 dense), the
// offsets of A, B and Y for the expert, the rows of Y that are the
// expert's (mrows: M, or the segment's), the live rows mlim along M and
// klim along K.  Blocks: (N tiles, M tiles, E), or ragged along M
// (ragged_tile's tiles, N tiles); false for a block past the last tile.
struct Tile {
  int e, m0, n0, s0, mrows, mlim, klim;
  long long ao, bo, yo;
};

template <Ragged R>
__device__ __forceinline__ bool tile_of(Tile& t, const Gemm& g, int bm,
                                        int bn) {
  if constexpr (R == Ragged::kM) {
    const int2 r = ragged_tile(g.rows, g.starts, g.E, g.M, bm, blockIdx.x);
    if (r.x < 0) return false;
    const Segment sg = segment(g.rows, g.starts, r.x, g.M);
    t = {r.x, r.y, (int)blockIdx.y * bn, sg.start, sg.rows, sg.rows, g.K,
         sg.start * g.lda, r.x * g.b_se, sg.start * g.ldy};
    return true;
  }
  const int e = blockIdx.z;
  t = {e, (int)blockIdx.y * bm, (int)blockIdx.x * bn, 0, g.M,
       g.rows_m ? live(g.rows, e, g.M) : g.M,
       g.rows_k ? live(g.rows, e, g.K) : g.K,
       e * g.a_se, e * g.b_se, e * g.y_se};
  if constexpr (R == Ragged::kK) {  // the sum runs over the segment's rows
    const Segment sg = segment(g.rows, g.starts, e, g.K);
    t.s0 = sg.start;
    t.klim = sg.rows;
    t.ao = sg.start * g.lda;
    t.bo = sg.start * g.ldb;
  }
  return true;
}

// The grid of a bm x bn tiling of Y: (N tiles, M tiles, E), or ragged
// along M ceil(M / bm) + E row tiles by N tiles.
template <Ragged R>
inline dim3 grid_of(const Gemm& g, int bm, int bn) {
  return R == Ragged::kM
             ? dim3((g.M + bm - 1) / bm + g.E, (g.N + bn - 1) / bn, 1)
             : dim3((g.N + bn - 1) / bn, (g.M + bm - 1) / bm, g.E);
}

constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 64;
constexpr int kWgStages = 4;
constexpr int kWgThreads = 384;      // consumer warpgroups 0 and 1, producer 2
constexpr int kWgBox = 64 * 64 * 2;  // bytes of a 64 x 64 MN-major box
constexpr int kWgABytes = kWgBM * kWgBK * 2;
constexpr int kWgStageBytes = kWgABytes + kWgBN * kWgBK * 2;
constexpr size_t kWgSmem =           // 1024-byte alignment slack, barriers
    1024 + (size_t)kWgStages * kWgStageBytes + 2 * kWgStages * 8;

// The body of a kernel of kWgThreads threads and kWgSmem bytes of dynamic
// shared memory, launched on grid_of<R>(g, kWgBM, kWgBN).  A_KM: A is
// M-major (dw's x); B_NK: B is K-major (dx's w).  ta, tb: the operands'
// tensor maps (__grid_constant__ parameters of the kernel), boxes of 64 K
// x 128 rows (A) or 256 rows (B) when K-major, 64 x 64 when MN-major;
// with R, the map of an operand packed along the ragged dimension has E =
// 1 (kM: A; kK: A and B).
template <bool A_KM, bool B_NK, Ragged R>
__device__ __forceinline__ void gmm_wgmma(const CUtensorMap& ta,
                                          const CUtensorMap& tb,
                                          const Gemm& g) {
  extern __shared__ __align__(16) uint8_t smem_wg[];
  uint8_t* base = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base +
                                               kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  Tile tl;
  if (!tile_of<R>(tl, g, kWgBM, kWgBN)) return;
  const int e = tl.e, m0 = tl.m0, n0 = tl.n0;
  const int mlim = tl.mlim, klim = tl.klim;
  // the maps' coordinates: A's expert and its first row along M (K-major
  // A), B's expert, and the first row along K of both
  const int ae = R == Ragged::kNo ? e : 0;
  const int be = R == Ragged::kK ? 0 : e;
  const int am = m0 + (R == Ragged::kM ? tl.s0 : 0);
  const int ks = R == Ragged::kK ? tl.s0 : 0;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(g.y) + tl.yo;
  const int tid = threadIdx.x;

  if (m0 >= mlim) {                           // no live row: zeros
    const int nr = min(kWgBM, tl.mrows - m0), nc = min(kWgBN, g.N - n0);
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
        const int s = kb % kWgStages, k0 = ks + kb * kWgBK;
        mbar_wait(&empty[s], ((kb / kWgStages) & 1) ^ 1);
        uint8_t* as = base + s * kWgStageBytes;
        uint8_t* bs = as + kWgABytes;
        mbar_expect_tx(&full[s], kWgStageBytes);
        if constexpr (A_KM) {
          tma_load(as, &ta, &full[s], m0, k0, ae);
          tma_load(as + kWgBox, &ta, &full[s], m0 + 64, k0, ae);
        } else {
          tma_load(as, &ta, &full[s], k0, am, ae);
        }
        if constexpr (B_NK) {
          tma_load(bs, &tb, &full[s], k0, n0, be);
        } else {
#pragma unroll
          for (int j = 0; j < kWgBN / 64; ++j)
            tma_load(bs + j * kWgBox, &tb, &full[s], n0 + 64 * j, k0, be);
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
      fence_regs<128>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint64_t da =
            A_KM ? gmma_desc(as + wg * kWgBox + kk * 16 * 128, kWgBox, 1024)
                 : gmma_desc(as + wg * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = B_NK ? gmma_desc(bs + kk * 32, 16, 1024)
                                 : gmma_desc(bs + kk * 16 * 128, kWgBox, 1024);
        wgmma_256<A_KM ? 1 : 0, B_NK ? 0 : 1>(acc, da, db);
      }
      wgmma_commit();
      fence_regs<128>(acc);
      // the previous stage's products are done: its buffers may refill
      wgmma_wait<1>();
      fence_regs<128>(acc);
      if (kb > 0 && (tid & 127) == 0)
        mbar_arrive(&empty[(kb - 1) % kWgStages]);
    }
    wgmma_wait<0>();
    fence_regs<128>(acc);

    // acc[4 j + 2 h + c]: row 16 w + lane / 4 + 8 h of the warpgroup's 64,
    // column 8 j + 2 (lane % 4) + c.  Rows past mrows are not the
    // expert's: the store stops there (ragged M: the next expert's rows).
    const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wg * 64 + warp * 16 + (lane >> 2) + hh * 8;
      if (row >= tl.mrows) continue;
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

// The 3-D map (columns, rows, E) of a bf16 tensor at p with unit column
// stride, row stride sr and expert stride se (elements), read in boxes of
// bc columns x br rows, 128-byte swizzled, zeros past its bounds.  A
// packed (rows, cols) matrix is mapped with E = 1 and se = rows * sr.
inline bool tensor_map(CUtensorMap* m, const void* p, int E, int rows,
                       int cols, long long se, long long sr, int bc, int br) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)E};
  const long long strides[2] = {sr, se};
  const cuuint32_t box[3] = {(cuuint32_t)bc, (cuuint32_t)br, 1};
  return bf16_map(m, p, 3, dims, strides, box);
}

}  // namespace
