// K3 moe_gmm: the per-expert batched matmul of the MoE block,
// y[e] = x[e] @ w[e] for x (E, C, D) and w (E, D, F) -> y (E, C, F).
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py, function
// moe_gmm (its _kernel body).  Same math: the products are summed in
// float32 over all of D and rounded once to the input type at the end
// (bf16 or float32).  Two differences: ragged C, D and F are masked here,
// where the Pallas grid floor-divides them away; and an optional rows (E,)
// int32 on the device says how many leading rows of each expert's C are
// live (the MoE block's kept tokens come first): rows c >= rows[e] are
// written as zeros and no weight is read for them, and a block whose whole
// C tile lies past rows[e] writes its zeros and exits after one load.
// rows == null is the Pallas kernel's function exactly.
//
// Ragged (starts (E,) int32 beside rows: the all-to-all MoE dispatch's
// form): x is one packed (M, D) buffer sorted by expert, expert e owning
// its rows starts[e] .. starts[e] + rows[e], and y is (M, F); each row is
// multiplied once, by its own expert's weights, where the reference masks
// every row through every local expert.  The grid is ceil(M / BM) + E row
// tiles by the F tiles, enough for any counts; each block finds its
// expert and tile from the counts on the device (ragged.cuh) and the
// blocks past the last tile exit.  Loads past a segment's end are zero
// filled (mma.sync, float32) or multiplied and not stored (wgmma: those
// rows are the next expert's) and stores stop there; rows of no expert are
// never written (the wrapper allocates y as zeros).  The mma.sync and
// float32 tile height follows the mean rows an expert, ceil(M / E).
//
// What bounds it on the H100: bytes.  Each expert's w is read once per C
// tile and used for only C rows; at the serving shapes (C = 4 in decode,
// C = 80 in a T = 1024 prefill) the flops per weight byte are 4 and 80,
// below the card's ~295 flop/byte bf16 ridge, so the bound is the live
// experts' weight bytes over the 3.35 TB/s of HBM3.
//
// bf16 (moe_gmm_tc): the products on the bf16 tensor cores with
// mma.sync.m16n8k16 and float32 accumulators; a bf16 x bf16 product is
// exact in float32, so only the order of the float32 sum differs from the
// plain version.  One block per (expert, tile of BM = 16 * MT rows of C,
// BN columns of F), each warp owning 32 columns (four n8 tiles) for all of
// the block's rows.  Prefill (C > 32): MT = ceil(C / 16) up to 8, so
// C = 80 is one tile of five m16 rows and no padding row is multiplied,
// and 8 warps (BN = 256), so the x tile is read from L2 once per 256
// columns; 16 warps per SM hide the latency of each stage's fragment
// loads and products, which 8 warps per SM did not (PERF.md).  Decode
// (C <= 32): MT = 1 or 2 and 4 warps (BN = 128), so the few experts that
// received a token still spread over many blocks.  D streams through a
// four-stage ring of BK = 32-deep stages filled by cp.async 16-byte
// copies, three stages in flight while one is multiplied: the w stage
// (32 x BN, row-major in D) reaches the B fragments through ldmatrix.trans
// and the x stage (BM x 32) the A fragments through ldmatrix, both from
// XOR-swizzled tiles (mma_sync.cuh).  Where a 16-byte copy would cross D,
// F or the live rows, or its address is not 16-byte aligned (a ragged F,
// a strided x), the chunk is copied element by element with zero fill.
// m16 tiles wholly past the live rows skip their products.
//
// bf16 ragged where TMA can read x and w (moe_gmm_wgmma; the wrapper's
// _route: 16-byte aligned bases and strides): warpgroup wgmma fed by TMA,
// the grouped main loop of gmm_wgmma.cuh (its design note there) with A =
// x K-major (boxes of 64 D x 128 rows from the segment's first row) and
// B = w[e] N-major (boxes of 64 F x 64 D): tiles of 128 rows by 256
// columns of F, D in stages of 64, the ragged grid of ragged.cuh, and
// stores that stop at the segment's end.  Its bound at the all-to-all
// dispatch's training shapes is operations (hundreds of rows an expert),
// where mma.sync ran at about a fifth of the bf16 peak.  The dense bf16
// forward stays on moe_gmm_tc.
//
// float32: CUDA cores, so the callers that hold the MoE in float32 keep
// full float32 products (TF32 would carry about three decimal digits).
// Every float32 call but the dense decode's runs the grouped float32 main
// loop of gmm_f32.cuh (moe_gmm_ffma; its design note there), A = x
// row-major (K-contiguous), B = w[e] D x F row-major, the block height
// following the rows an expert; it replaces the register-staged 64- to
// 96-row tiles, which reached a third of the float32 bound at the
// all-to-all dispatch's shape.  Dense with 32 rows an expert or fewer
// (decode, bound by the weights' bytes: 4 flops a weight byte at C = 4)
// keeps the split-D tiles (moe_gmm_kernel), on which the H100 ran the
// decode check's shapes 1.7x faster than on the loop, where two of a
// 64-row tile's eight warps do all of its products (PERF.md): one
// 256-thread block per (expert, tile of BM = 4 RS rows, 128 columns of
// F) walks D in stages of 64 rows, 8 elements per register-staged load
// (16-byte loads wherever aligned and inside the tensor; element loads
// with zero fill at the ragged edges), and the 16 / RS thread groups that
// would otherwise share a row split each stage's depth, their partial
// sums added through shared memory at the end (C = 4: BM = 4, a 16-way
// split of D), so the few rows still spread the weights' bytes over many
// blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gmm_f32.cuh"          // the float32 main loop
#include "gmm_wgmma.cuh"        // Gemm, Ragged, the wgmma main loop
#include "mma_sync.cuh"
#include "ragged.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;      // columns of F per block
constexpr int kChunk = 8;     // elements per global load

// 8 consecutive floats of a row.
struct Chunk {
  float v[kChunk];

  // The first n of the 8 elements at p; the rest are zero.  p is only
  // dereferenced where it lies inside the row.
  __device__ __forceinline__ void load(const float* p, int n) {
    if (n >= kChunk && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) v[j] = j < n ? p[j] : 0.f;
    }
  }
};

// Rows of expert e that are live: all C without rows, else rows[e] clamped
// to [0, C].
__device__ __forceinline__ int live_rows(const int* rows, int e, int C) {
  return rows ? min(max(rows[e], 0), C) : C;
}

// Where a block works: expert e, its first row c0 among the expert's rows
// and first column f0, the offsets of the expert's row 0 in x and y, the
// expert's live rows nv and the rows cy of y that are the expert's (C,
// or the segment's rows when ragged).  Dense: blocks (F tiles, C tiles,
// E).  Ragged (starts): blocks (ragged_tile's tiles, F tiles), the rows
// of expert e starting at row starts[e] of the packed x and y; false for
// a block past the last tile.  RAGGED is a template argument, so the
// dense kernels carry none of the ragged code (nor its registers: a
// runtime branch took the bf16 prefill tile, MT = 5, from 2 blocks a SM
// to 1).
struct Place {
  int e, c0, f0, nv, cy;
  long long xo, yo;
};

template <bool RAGGED>
__device__ __forceinline__ bool place(Place& p, const int* rows,
                                      const int* starts, int E, int C, int BM,
                                      int BN, long long x_se, long long x_sc,
                                      long long y_se, long long y_sc) {
  if constexpr (RAGGED) {
    const int2 t = ragged_tile(rows, starts, E, C, BM, blockIdx.x);
    if (t.x < 0) return false;
    const Segment sg = segment(rows, starts, t.x, C);
    p = {t.x, t.y, (int)blockIdx.y * BN, sg.rows, sg.rows,
         sg.start * x_sc, sg.start * y_sc};
  } else {
    const int e = blockIdx.z;
    p = {e, (int)blockIdx.y * BM, (int)blockIdx.x * BN, live_rows(rows, e, C),
         C, e * x_se, e * y_se};
  }
  return true;
}

// The grid of a launch: dense (F tiles, C tiles, E); ragged (C = M packed
// rows) ceil(M / BM) + E row tiles by F tiles.
inline dim3 grid_of(bool ragged, int E, int C, int F, int BM, int BN) {
  return ragged ? dim3((C + BM - 1) / BM + E, (F + BN - 1) / BN, 1)
                : dim3((F + BN - 1) / BN, (C + BM - 1) / BM, E);
}

// A block with no live row writes zeros over its (rows c0.., columns f0..)
// tile of y and reads no weight.
template <typename T>
__device__ void zero_tile(T* y, long long yb, long long y_sc, int c0, int BM,
                          int C, int f0, int BN, int F) {
  const int nr = min(BM, C - c0), nc = min(BN, F - f0);
  for (int i = threadIdx.x; i < nr * nc; i += blockDim.x)
    y[yb + (long long)(c0 + i / nc) * y_sc + f0 + i % nc] = T(0.f);
}

// The split-D tiles (dense, up to 32 rows an expert): TM rows a thread,
// stages of BK rows of D.
constexpr int kSplitTM = 4, kSplitBK = 64;

template <int RS>
constexpr size_t smem_bytes() {
  constexpr int KS = 16 / RS, BM = RS * kSplitTM;
  constexpr size_t stage =
      (size_t)kSplitBK * kBN + (size_t)kSplitBK * (BM + 1);
  constexpr size_t red = (size_t)KS * BM * kBN;
  return sizeof(float) * (stage > red ? stage : red);
}

// RS: thread groups across the rows of the tile; BM = RS * kSplitTM rows
// per block; KS = 16 / RS groups split each stage's depth.
template <int RS>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, const int* __restrict__ rows, int E,
               int C, int D, int F,
               long long x_se, long long x_sc, long long w_se, long long w_sd,
               long long y_se, long long y_sc) {
  constexpr int TM = kSplitTM, BK = kSplitBK;
  constexpr int KS = 16 / RS;
  constexpr int BM = RS * TM;
  constexpr int XST = BM + 1;                 // x tile row stride (banks)
  constexpr int KCH = BK / kChunk;            // chunks along a stage's depth
  constexpr int XCH = BM * KCH;               // x chunks per stage
  constexpr int XPT = (XCH + kThreads - 1) / kThreads;
  constexpr int WPT = BK * (kBN / kChunk) / kThreads;  // w chunks per thread
  static_assert(KS > 1 && BK % KS == 0, "tile shape");

  extern __shared__ float smem[];
  float* ws = smem;                           // [BK][kBN]
  float* xs = ws + BK * kBN;                  // [BK][XST], k-major

  Place pl;
  place<false>(pl, rows, nullptr, E, C, BM, kBN, x_se, x_sc, y_se, y_sc);
  const int c0 = pl.c0, f0 = pl.f0, cy = pl.cy;
  const int tid = threadIdx.x;
  const float* xe = x + pl.xo;
  const float* we = w + pl.e * w_se;
  const long long yb = pl.yo;
  const int nv = pl.nv;                       // rows >= nv are zeros
  if (c0 >= nv) {
    zero_tile(y, yb, y_sc, c0, BM, cy, f0, kBN, F);
    return;
  }

  Chunk wr[WPT], xr[XPT];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int q = tid + j * kThreads;
      const int row = k0 + q / (kBN / kChunk);
      const int col = f0 + (q % (kBN / kChunk)) * kChunk;
      wr[j].load(we + (long long)row * w_sd + col, row < D ? F - col : 0);
    }
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int q = tid + j * kThreads;
      const int row = c0 + q / KCH;
      const int col = k0 + (q % KCH) * kChunk;
      if (q < XCH)
        xr[j].load(xe + (long long)row * x_sc + col, row < nv ? D - col : 0);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int q = tid + j * kThreads;
      float* dst = ws + (q / (kBN / kChunk)) * kBN + (q % (kBN / kChunk)) *
                   kChunk;
      const float* v = wr[j].v;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int q = tid + j * kThreads;
      if (q < XCH) {
        const int m = q / KCH, k = (q % KCH) * kChunk;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) xs[(k + i) * XST + m] = xr[j].v[i];
      }
    }
  };

  // this thread's outputs: rows rg*TM .. +TM, columns 4cg .. +4 and
  // 64 + 4cg .. +4 (so 8 neighbouring threads read 128 distinct bytes)
  const int cg = tid % 16;
  const int rest = tid / 16;
  const int rg = rest % RS;
  const int ks = rest / RS;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  const int nk = (D + BK - 1) / BK;
  load(0);
  for (int t = 0; t < nk; ++t) {
    __syncthreads();                 // the previous stage is consumed
    stash();
    __syncthreads();
    if (t + 1 < nk) load((t + 1) * BK);   // in flight during the products
#pragma unroll 4
    for (int kk = 0; kk < BK / KS; ++kk) {
      const int k = kk * KS + ks;
      const float4 a = *reinterpret_cast<const float4*>(ws + k * kBN + 4 * cg);
      const float4 b =
          *reinterpret_cast<const float4*>(ws + k * kBN + 64 + 4 * cg);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xv_ = xs[k * XST + rg * TM + i];
        acc[i][0] = fmaf(xv_, a.x, acc[i][0]);
        acc[i][1] = fmaf(xv_, a.y, acc[i][1]);
        acc[i][2] = fmaf(xv_, a.z, acc[i][2]);
        acc[i][3] = fmaf(xv_, a.w, acc[i][3]);
        acc[i][4] = fmaf(xv_, b.x, acc[i][4]);
        acc[i][5] = fmaf(xv_, b.y, acc[i][5]);
        acc[i][6] = fmaf(xv_, b.z, acc[i][6]);
        acc[i][7] = fmaf(xv_, b.w, acc[i][7]);
      }
    }
  }

  // KS groups hold partial sums over disjoint parts of D: add them up
  __syncthreads();
  float* red = smem;                          // [KS][BM][kBN]
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* r = red + ((ks * BM) + rg * TM + i) * kBN;
    *reinterpret_cast<float4*>(r + 4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(r + 64 + 4 * cg) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  for (int o = tid; o < BM * kBN; o += kThreads) {
    const int row = c0 + o / kBN, col = f0 + o % kBN;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < KS; ++g) s += red[g * BM * kBN + o];
    if (row < cy && col < F)
      y[yb + row * y_sc + col] = row < nv ? s : 0.f;
  }
}

// The arguments every launch passes on: x, w, y, rows, starts (null:
// dense), E, C, D, F, the six strides and the stream.
struct Args {
  const void* x;
  const void* w;
  void* y;
  const int* rows;
  const int* starts;
  int E, C, D, F;
  const long long* st;
  cudaStream_t s;
};

template <int RS>
int launch_split(const Args& a) {
  constexpr int BM = RS * kSplitTM;
  constexpr size_t smem = smem_bytes<RS>();
  static unsigned done = 0;
  cudaError_t err = smem_once((const void*)moe_gmm_kernel<RS>, smem, &done);
  if (err != cudaSuccess) return (int)err;
  const long long* st = a.st;
  moe_gmm_kernel<RS><<<grid_of(false, a.E, a.C, a.F, BM, kBN), kThreads,
                       smem, a.s>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w),
      static_cast<float*>(a.y), a.rows, a.E, a.C, a.D, a.F, st[0], st[1],
      st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

// y[e] = x[e] w[e] on gmm_f32.cuh's main loop: A = x, K-contiguous.
template <int BM, Ragged R>
__global__ void __launch_bounds__(kFfThreads, kFfMinBlocks)
moe_gmm_ffma(Gemm g) {
  gmm_ffma<false, false, R, BM>(g);
}

template <int BM, Ragged R>
int launch_ffma(const Gemm& g, cudaStream_t s) {
  static unsigned done = 0;
  return ffma_launch<BM, R>(moe_gmm_ffma<BM, R>, &done, g, s);
}

template <Ragged R>
int dispatch_ffma(const Gemm& g, int rows_an_expert, cudaStream_t s) {
  switch (ffma_bm(rows_an_expert, R != Ragged::kNo)) {
    case 64: return launch_ffma<64, R>(g, s);
    case 80: return launch_ffma<80, R>(g, s);
    case 96: return launch_ffma<96, R>(g, s);
    default: return launch_ffma<128, R>(g, s);
  }
}

// float32: R rows an expert (C, or ragged the mean ceil(M / E)); see the
// design note.
int dispatch_f32(const Args& a, int R) {
  if (!a.starts) {
    if (R <= 4) return launch_split<1>(a);
    if (R <= 8) return launch_split<2>(a);
    if (R <= 16) return launch_split<4>(a);
    if (R <= 32) return launch_split<8>(a);
  }
  const long long* st = a.st;
  const Gemm g{a.x, a.w, a.y, a.rows, a.starts, a.E, a.C, a.F, a.D,
               a.rows != nullptr, false, st[0], st[1], st[2], st[3], st[4],
               st[5]};
  return a.starts ? dispatch_ffma<Ragged::kM>(g, R, a.s)
                  : dispatch_ffma<Ragged::kNo>(g, R, a.s);
}

// ---------------------------------------------------------------------------
//  bf16, C > 32: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kTcWarps = 8;       // warps per block, 32 columns of F each
constexpr int kTcBK = 32;         // depth of one stage
constexpr int kTcStages = 4;      // ring: three stages in flight
constexpr int kTcMaxMT = 8;       // m16 tiles per block: BM <= 128

template <int MT, int W>
constexpr size_t tc_smem() {
  return sizeof(__nv_bfloat16) * kTcStages *
         ((size_t)kTcBK * 32 * W + (size_t)16 * MT * kTcBK);
}

// MT m16 tiles of rows, W warps of 32 columns each.
template <int MT, int W, bool RAGGED>
__global__ void __launch_bounds__(32 * W)
moe_gmm_tc(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y,
           const int* __restrict__ rows, const int* __restrict__ starts, int E,
           int C, int D, int F, long long x_se, long long x_sc, long long w_se,
           long long w_sd, long long y_se, long long y_sc) {
  constexpr int BM = 16 * MT;
  constexpr int NT = 32 * W;          // threads
  constexpr int BN = 32 * W;          // columns of F per block
  constexpr int WCH = BN / 8;         // 16-byte chunks of a w stage row
  constexpr int XCH = kTcBK / 8;      // 16-byte chunks of an x stage row
  constexpr int W_EL = kTcBK * BN;    // elements of a w stage
  constexpr int X_EL = BM * kTcBK;    // elements of an x stage

  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);

  Place pl;
  if (!place<RAGGED>(pl, rows, starts, E, C, BM, BN, x_se, x_sc, y_se, y_sc))
    return;
  const int c0 = pl.c0, f0 = pl.f0, cy = pl.cy, nv = pl.nv;
  const long long yb = pl.yo;
  if (c0 >= nv) {
    zero_tile(y, yb, y_sc, c0, BM, cy, f0, BN, F);
    return;
  }
  const int nrow = min(BM, nv - c0);          // live rows of this tile
  const int live_mt = (nrow + 15) / 16;
  const __nv_bfloat16* xb = x + pl.xo + (long long)c0 * x_sc;
  const __nv_bfloat16* wb = w + pl.e * w_se + f0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix: matrix, its row

  // stage kt: w rows k0.. (the block's columns) and x columns k0.. (BM rows)
  auto load = [&](int kt) {
    __nv_bfloat16* ws = ring + (kt % kTcStages) * (W_EL + X_EL);
    __nv_bfloat16* xs = ws + W_EL;
    const int k0 = kt * kTcBK;
#pragma unroll
    for (int j = 0; j < kTcBK * WCH / NT; ++j) {
      const int i = tid + j * NT;
      const int r = i / WCH, c = i % WCH;
      stage8(ws + swz<WCH>(r, c), wb + (long long)(k0 + r) * w_sd + c * 8,
             k0 + r < D ? F - f0 - c * 8 : 0);
    }
#pragma unroll
    for (int j = 0; j < (BM * XCH + NT - 1) / NT; ++j) {
      const int i = tid + j * NT;
      if ((BM * XCH) % NT != 0 && i >= BM * XCH) break;
      const int r = i / XCH, c = i % XCH;
      stage8(xs + swz<XCH>(r, c), xb + (long long)r * x_sc + k0 + c * 8,
             r < nrow ? D - k0 - c * 8 : 0);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][n][q] = 0.f;

  const int nk = (D + kTcBK - 1) / kTcBK;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kTcStages - 2>();         // stage kt has landed (this thread)
    __syncthreads();                  // ... for every thread; kt - 1 is free
    if (kt + kTcStages - 1 < nk) load(kt + kTcStages - 1);
    cp_commit();
    const __nv_bfloat16* ws = ring + (kt % kTcStages) * (W_EL + X_EL);
    const __nv_bfloat16* xs = ws + W_EL;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      unsigned b[4][2];               // this warp's four n8 tiles
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bf[4];
        ldsm_x4_t(bf, ws + swz<WCH>(kk * 16 + (mi & 1) * 8 + mr,
                                    warp * 4 + np * 2 + (mi >> 1)));
        b[2 * np][0] = bf[0];
        b[2 * np][1] = bf[1];
        b[2 * np + 1][0] = bf[2];
        b[2 * np + 1][1] = bf[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < live_mt) {
          unsigned a[4];
          ldsm_x4(a, xs + swz<XCH>(mt * 16 + (mi & 1) * 8 + mr,
                                   kk * 2 + (mi >> 1)));
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma16816(acc[mt][n], a, b[n][0], b[n][1]);
        }
      }
    }
  }
  cp_wait_all();                      // only empty groups remain

  // accumulator (mt, n): rows g and g + 8, columns 2 t4 and 2 t4 + 1
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + g + hh * 8;
      if (c0 + r >= cy) continue;
      __nv_bfloat16* yr = y + yb + (long long)(c0 + r) * y_sc;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = f0 + warp * 32 + n * 8 + 2 * t4;
        const float v0 = r < nrow ? acc[mt][n][2 * hh] : 0.f;
        const float v1 = r < nrow ? acc[mt][n][2 * hh + 1] : 0.f;
        if (col + 1 < F && (reinterpret_cast<uintptr_t>(yr + col) & 3) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < F) yr[col] = __float2bfloat16(v0);
          if (col + 1 < F) yr[col + 1] = __float2bfloat16(v1);
        }
      }
    }
}

template <int MT, int W, bool RAGGED>
int launch_tc_as(const Args& a) {
  static unsigned done = 0;
  constexpr size_t smem = tc_smem<MT, W>();
  cudaError_t err =
      smem_once((const void*)moe_gmm_tc<MT, W, RAGGED>, smem, &done);
  if (err != cudaSuccess) return (int)err;
  const long long* st = a.st;
  moe_gmm_tc<MT, W, RAGGED>
      <<<grid_of(RAGGED, a.E, a.C, a.F, 16 * MT, 32 * W), 32 * W, smem,
         a.s>>>(static_cast<const __nv_bfloat16*>(a.x),
                static_cast<const __nv_bfloat16*>(a.w),
                static_cast<__nv_bfloat16*>(a.y), a.rows, a.starts, a.E, a.C,
                a.D, a.F, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

template <int MT, int W = kTcWarps>
int launch_tc(const Args& a) {
  return a.starts ? launch_tc_as<MT, W, true>(a)
                  : launch_tc_as<MT, W, false>(a);
}

// bf16: R rows an expert (C, or ragged the mean ceil(M / E)) in m16
// tiles.  R <= 32 (decode) in one block of 4 warps, so the few live
// experts still spread over many blocks; R > 32 in ceil(R / 16) tiles of
// 8 warps up to 8 tiles, else split evenly over the fewest blocks of at
// most 8 (3..8).
int dispatch_tc(const Args& a, int R) {
  const int m16 = (R + 15) / 16;
  if (m16 == 1) return launch_tc<1, 4>(a);
  if (m16 == 2) return launch_tc<2, 4>(a);
  const int nb = (m16 + kTcMaxMT - 1) / kTcMaxMT;
  switch ((m16 + nb - 1) / nb) {
    case 3: return launch_tc<3>(a);
    case 4: return launch_tc<4>(a);
    case 5: return launch_tc<5>(a);
    case 6: return launch_tc<6>(a);
    case 7: return launch_tc<7>(a);
    case 8: return launch_tc<8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
//  bf16 ragged: wgmma fed by TMA
// ---------------------------------------------------------------------------
// One block per (ragged_tile's tile of 128 rows, N tile of 256): y = x w[e]
// as gmm_wgmma.cuh's <A K-major, B N-major> along a ragged M.
__global__ void __launch_bounds__(kWgThreads, 1)
moe_gmm_wgmma(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw, Gemm g) {
  gmm_wgmma<false, false, Ragged::kM>(tx, tw, g);
}

// x (C, D) packed, w (E, D, F), y (C, F): bases and strides but the unit
// ones 16-byte aligned (the wrapper's _route)
int launch_wgmma(const Args& a) {
  static unsigned done = 0;
  const long long* st = a.st;
  CUtensorMap tx, tw;
  if (!tensor_map(&tx, a.x, 1, a.C, a.D, a.C * st[1], st[1], kWgBK, kWgBM) ||
      !tensor_map(&tw, a.w, a.E, a.D, a.F, st[2], st[3], 64, kWgBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = smem_once((const void*)moe_gmm_wgmma, kWgSmem, &done);
  if (err != cudaSuccess) return (int)err;
  const Gemm g{a.x, a.w, a.y, a.rows, a.starts, a.E, a.C, a.F, a.D, true,
               false, 0, st[1], st[2], st[3], 0, st[5]};
  moe_gmm_wgmma<<<grid_of<Ragged::kM>(g, kWgBM, kWgBN), kWgThreads, kWgSmem,
                  a.s>>>(tx, tw, g);
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 4 = float32, 2 = bfloat16 (x, w and y all of it).  wgmma: 1
// takes the TMA / wgmma kernel (bf16 and ragged only, every base and every
// stride but the unit one 16-byte aligned), 0 the mma.sync or float32 one.
// rows: null, or (E,) int32 on the device, the live rows of each expert.
// starts: null (dense: x (E, C, D), y (E, C, F)), or (E,) int32 on the
// device with rows (ragged: x (C, D) and y (C, F) packed, expert e's rows
// starts[e] .. starts[e] + rows[e], not overlapping; y's rows of no expert
// are left as they are, so the caller allocates y as zeros).  strides
// (elements): x_se, x_sc, w_se, w_sd, y_se, y_sc (x_se, y_se unused
// ragged); the last dimension of every tensor has unit stride.  Returns a
// cudaError_t (0 on success).
extern "C" int repro_moe_gmm(int elem_bytes, int wgmma, const void* x,
                             const void* w, void* y, const void* rows,
                             const void* starts, int E, int C, int D, int F,
                             const long long* strides, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 || (starts && !rows) ||
      (wgmma && (elem_bytes != 2 || !starts)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, y, static_cast<const int*>(rows),
               static_cast<const int*>(starts), E, C, D, F, strides,
               static_cast<cudaStream_t>(stream)};
  if (wgmma) return launch_wgmma(a);
  const int R = starts ? (C + E - 1) / E : C;
  if (elem_bytes == 4) return dispatch_f32(a, R);
  if (elem_bytes == 2) return dispatch_tc(a, R);
  return (int)cudaErrorInvalidValue;
}
