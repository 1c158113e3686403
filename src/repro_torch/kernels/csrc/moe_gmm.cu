// K3 moe_gmm: the per-expert batched matmul of the MoE block,
// y[e] = x[e] @ w[e] for x (E, C, D) and w (E, D, F) -> y (E, C, F).
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py, function
// moe_gmm (its _kernel body).  Same math: the products are summed in
// float32 over all of D and rounded once to the input type at the end
// (bf16 or float32).  One difference: ragged C, D and F are masked here,
// where the Pallas grid floor-divides them away.
//
// What bounds it on the H100: bytes.  Each expert's w is read once per C
// tile and used for only C rows; at the serving shapes (C = 4 in decode,
// C = 80 in a T = 1024 prefill) the flops per weight byte are 4 and 80,
// far below the card's ~295 flop/byte ridge in bf16, so the bound is the
// expert weights' bytes over the 3.35 TB/s of HBM3.
//
// Design (simple and right first): one 256-thread block per (expert, tile
// of BM rows of C, tile of 128 columns of F).  The block walks D in stages
// of BK rows: it loads the stage's w tile (BK x 128) and x tile (BM x BK)
// from device memory into registers, 8 elements per load (one 16-byte
// load for bf16, two for float32, wherever the address is aligned and the
// 8 elements lie inside the tensor; element loads with zero fill at the
// ragged edges), stores them to shared memory as float32, and while the
// threads multiply the stage out of shared memory the next stage's loads
// are already in flight.  Neighbouring threads load neighbouring 16 bytes
// of a w row, so every warp reads whole 128-byte lines.  The float32 sums
// stay in registers: each thread owns TM rows by 8 columns.  The BM rows
// adapt to C so that decode does not multiply padding: for C <= 32 a block
// has BM = 4 * RS rows and the 16 / RS thread groups that would otherwise
// share a row split each stage's depth instead, their partial sums added
// through shared memory at the end (C = 4: BM = 4, 16-way split of D).
// For larger C, BM is 64, 80 or 96, whichever pads C least (C = 80 in
// prefill is one tile).  The products run on CUDA cores in float32, so a
// prefill call is bound by those operations; bf16 tensor cores (mma.sync
// or wgmma fed by TMA) and skipping experts that received no token are the
// next steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;      // columns of F per block
constexpr int kChunk = 8;     // elements per global load

template <int kB> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };   // bf16 bits
template <> struct Raw<4> { using type = unsigned int; };     // float bits

// 8 consecutive elements of a row, kept as raw 32-bit words.
template <int kB>
struct Chunk {
  using R = typename Raw<kB>::type;
  static constexpr int kWords = kChunk * kB / 4;   // 4 (bf16) or 8 (float)
  unsigned w[kWords];

  // The first n of the 8 elements at p; the rest are zero.  p is only
  // dereferenced where it lies inside the row.
  __device__ __forceinline__ void load(const R* p, int n) {
    if (n >= kChunk && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 u = q[i];
        w[4 * i] = u.x;
        w[4 * i + 1] = u.y;
        w[4 * i + 2] = u.z;
        w[4 * i + 3] = u.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        if constexpr (kB == 4) {
          w[j] = j < n ? (unsigned)p[j] : 0u;
        } else {
          const unsigned lo = 2 * j < n ? (unsigned)p[2 * j] : 0u;
          const unsigned hi = 2 * j + 1 < n ? (unsigned)p[2 * j + 1] : 0u;
          w[j] = lo | (hi << 16);
        }
      }
    }
  }

  __device__ __forceinline__ float get(int i) const {
    if constexpr (kB == 4) {
      return __uint_as_float(w[i]);
    } else {
      const unsigned u = w[i >> 1];          // bf16 -> float: the top half
      return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
    }
  }
};

template <int kB> __device__ __forceinline__ void store(void* y, long long i,
                                                        float v);
template <> __device__ __forceinline__ void store<4>(void* y, long long i,
                                                     float v) {
  static_cast<float*>(y)[i] = v;
}
template <> __device__ __forceinline__ void store<2>(void* y, long long i,
                                                     float v) {
  static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v);  // nearest even
}

template <int RS, int TM, int BK>
constexpr size_t smem_bytes() {
  constexpr int KS = 16 / RS, BM = RS * TM;
  constexpr size_t stage = (size_t)BK * kBN + (size_t)BK * (BM + 1);
  constexpr size_t red = KS > 1 ? (size_t)KS * BM * kBN : 0;
  return sizeof(float) * (stage > red ? stage : red);
}

// RS: thread groups across the rows of the tile; TM: rows per thread;
// BK: depth of one stage.  BM = RS * TM rows per block; KS = 16 / RS groups
// split each stage's depth.
template <int kB, int RS, int TM, int BK>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
               void* __restrict__ y, int C, int D, int F, long long x_se,
               long long x_sc, long long w_se, long long w_sd, long long y_se,
               long long y_sc) {
  using R = typename Raw<kB>::type;
  constexpr int KS = 16 / RS;
  constexpr int BM = RS * TM;
  constexpr int XST = BM + 1;                 // x tile row stride (banks)
  constexpr int KCH = BK / kChunk;            // chunks along a stage's depth
  constexpr int XCH = BM * KCH;               // x chunks per stage
  constexpr int XPT = (XCH + kThreads - 1) / kThreads;
  constexpr int WPT = BK * (kBN / kChunk) / kThreads;  // w chunks per thread
  static_assert(WPT >= 1 && BK % KS == 0, "tile shape");

  extern __shared__ float smem[];
  float* ws = smem;                           // [BK][kBN]
  float* xs = ws + BK * kBN;                  // [BK][XST], k-major

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const R* x = static_cast<const R*>(xv) + e * x_se;
  const R* w = static_cast<const R*>(wv) + e * w_se;

  Chunk<kB> wr[WPT], xr[XPT];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int q = tid + j * kThreads;
      const int row = k0 + q / (kBN / kChunk);
      const int col = f0 + (q % (kBN / kChunk)) * kChunk;
      wr[j].load(w + (long long)row * w_sd + col, row < D ? F - col : 0);
    }
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int q = tid + j * kThreads;
      const int row = c0 + q / KCH;
      const int col = k0 + (q % KCH) * kChunk;
      if (q < XCH)
        xr[j].load(x + (long long)row * x_sc + col, row < C ? D - col : 0);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int q = tid + j * kThreads;
      float* dst = ws + (q / (kBN / kChunk)) * kBN + (q % (kBN / kChunk)) *
                   kChunk;
      *reinterpret_cast<float4*>(dst) = make_float4(
          wr[j].get(0), wr[j].get(1), wr[j].get(2), wr[j].get(3));
      *reinterpret_cast<float4*>(dst + 4) = make_float4(
          wr[j].get(4), wr[j].get(5), wr[j].get(6), wr[j].get(7));
    }
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int q = tid + j * kThreads;
      if (q < XCH) {
        const int m = q / KCH, k = (q % KCH) * kChunk;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) xs[(k + i) * XST + m] = xr[j].get(i);
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

  const long long yb = e * y_se;
  if constexpr (KS == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = c0 + rg * TM + i;
      if (row >= C) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = f0 + (c < 4 ? 4 * cg + c : 64 + 4 * cg + c - 4);
        if (col < F) store<kB>(y, yb + row * y_sc + col, acc[i][c]);
      }
    }
  } else {
    // KS groups hold partial sums over disjoint parts of D: add them up
    __syncthreads();
    float* red = smem;                        // [KS][BM][kBN]
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
      if (row < C && col < F) store<kB>(y, yb + row * y_sc + col, s);
    }
  }
}

template <int kB, int RS, int TM, int BK>
int launch(const void* x, const void* w, void* y, int E, int C, int D, int F,
           const long long* st, cudaStream_t stream) {
  constexpr int BM = RS * TM;
  constexpr size_t smem = smem_bytes<RS, TM, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_kernel<kB, RS, TM, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((F + kBN - 1) / kBN, (C + BM - 1) / BM, E);
  moe_gmm_kernel<kB, RS, TM, BK><<<grid, kThreads, smem, stream>>>(
      x, w, y, C, D, F, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

// The tile for C rows: see the design note.
template <int kB>
int dispatch(const void* x, const void* w, void* y, int E, int C, int D,
             int F, const long long* st, cudaStream_t s) {
  if (C <= 4) return launch<kB, 1, 4, 64>(x, w, y, E, C, D, F, st, s);
  if (C <= 8) return launch<kB, 2, 4, 64>(x, w, y, E, C, D, F, st, s);
  if (C <= 16) return launch<kB, 4, 4, 64>(x, w, y, E, C, D, F, st, s);
  if (C <= 32) return launch<kB, 8, 4, 64>(x, w, y, E, C, D, F, st, s);
  int best = 4;                              // rows per thread: BM = 16 TM
  for (int tm = 5; tm <= 6; ++tm) {
    const int pad = (C + 16 * tm - 1) / (16 * tm) * 16 * tm;
    const int best_pad = (C + 16 * best - 1) / (16 * best) * 16 * best;
    if (pad < best_pad) best = tm;
  }
  if (best == 5) return launch<kB, 16, 5, 32>(x, w, y, E, C, D, F, st, s);
  if (best == 6) return launch<kB, 16, 6, 32>(x, w, y, E, C, D, F, st, s);
  return launch<kB, 16, 4, 32>(x, w, y, E, C, D, F, st, s);
}

}  // namespace

// elem_bytes: 4 = float32, 2 = bfloat16 (x, w and y all of it).  strides
// (elements): x_se, x_sc, w_se, w_sd, y_se, y_sc; the last dimension of
// every tensor has unit stride.  Returns a cudaError_t (0 on success).
extern "C" int repro_moe_gmm(int elem_bytes, const void* x, const void* w,
                             void* y, int E, int C, int D, int F,
                             const long long* strides, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return dispatch<4>(x, w, y, E, C, D, F, strides, s);
  if (elem_bytes == 2) return dispatch<2>(x, w, y, E, C, D, F, strides, s);
  return (int)cudaErrorInvalidValue;
}
