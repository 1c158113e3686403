// K2 flash_attention, backward: dq, dk and dv of K2's forward
// (flash_attention.cu) from q, k, v, the forward's out and lse, and dout.
//
// No Pallas kernel has this role: the JAX package differentiates attention
// with jax.grad through XLA (src/repro/models/layers.py::attention), while
// on the card the forward is K2, so its gradient is a kernel too.  The math
// is the explicit formula of src/repro_torch/kernels/ref.py::
// attention_backward, FlashAttention-2's: with P = exp(scale q k^T - lse)
// recomputed tile by tile, D = rowsum(dout * out), dS = P * (dout v^T - D),
//   dq = scale dS k,   dk = scale dS^T q,   dv = P^T dout,
// dk and dv summed over the G = H / Hkv query heads of each kv head.  The
// masks are the forward's: causal bottom-right aligned (key j is seen by
// query i when j <= i + S - T), an optional sliding window (and
// j > i + S - T - window), ragged tails masked; a masked entry contributes
// exactly 0 (P is selected to 0, never computed from -1e30).
//
// Three launches per call:
//   (a) bwd_dot:  D (B, H, T) float32, one warp per query row;
//   (b) dk / dv:  one block per (b, kv head, key tile); it loops over the G
//       heads of its group and over the query tiles that see the tile (the
//       causal frontier bounds them below, the window above), so the GQA
//       sum happens in the block's registers: no atomics, deterministic;
//   (c) dq:       one block per (b, head, query tile), looping over the key
//       tiles the queries see, as the forward does.
// dS is formed in float32 (in bf16, dP - D would cancel).
//
// What bounds it on the H100: operations.  qwen3-0.6b training (B=8, H=16,
// Hkv=8, T=S=1024, hd=128, causal, bf16) does five products of T S hd / 2
// multiply-adds per head, 85.9 GFLOP, on about 201 MB: 0.087 ms at the
// 989 TFLOP/s bf16 tensor-core peak against 0.060 ms at 3.35 TB/s.
//
// bf16 at hd <= 128 (bwd_dkdv_tc, bwd_dq_tc): the products on the tensor
// cores with mma.sync.m16n8k16 and float32 accumulators, in the forward's
// fragment layouts (mma_sync.cuh: swizzled tiles, cp.async, ldmatrix).  In
// (b) each of 4 warps owns 16 keys; per query tile S^T = K Q^T and
// dP^T = V dO^T take K and V as A fragments and the Q and dO tiles as B
// fragments (plain ldmatrix), then dV += P^T dO and dK += dS^T Q take P^T
// and dS^T packed from the accumulators as A fragments and dO and Q through
// ldmatrix.trans.  Q / dO tiles and their lse / D walk a two-stage ring, the
// next tile in flight while one is multiplied.  (c) is the forward's block
// with dP = dO V^T beside S = Q K^T and dQ += dS K in place of O += P V.
// Registers hold the dk and dv (or dq) accumulators; hd 160 and 256 would
// need more than a thread has, so they take the CUDA-core kernels below.
//
// float32, and bf16 at hd 160 and 256 (bwd_dkdv_cc, bwd_dq_cc): CUDA
// cores in float32, 256 threads per block, 32 keys x 32 queries a tile,
// all four tiles in shared memory as float32 (rows padded by one word).
// Each thread computes 4 scores of one row and owns hd / 8 columns of one
// row of the accumulators.  Simple, and far from the bound: the float32
// callers are parity checks.
//
// Every input is read through its strides (the model hands K2 transposed
// views, and dout comes with whatever strides autograd gives it); dq, dk
// and dv are written contiguous.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Geo {                     // one call: shapes, masks and strides
  int H, Hkv, Tq, S, causal, window;
  float scale;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_st, d_sb, d_sh, d_st;   // out, dout
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Query qi sees key kj (both inside their tensors) under the masks.
__device__ __forceinline__ bool visible(const Geo& g, int qi, int kj) {
  const int off = g.S - g.Tq;
  return qi < g.Tq && kj < g.S && (!g.causal || kj <= qi + off) &&
         (g.window <= 0 || kj > qi + off - g.window);
}

// The query tiles of BQ rows that see keys [k0, k0 + BK): first tile's
// start and the number of tiles.
template <int BK, int BQ>
__device__ __forceinline__ int2 query_tiles(const Geo& g, int k0) {
  const int off = g.S - g.Tq;
  const int qbeg = (g.causal ? max(0, k0 - off) : 0) / BQ * BQ;
  int qend = g.Tq;
  if (g.window > 0) qend = min(qend, min(k0 + BK, g.S) - 1 - off + g.window);
  return make_int2(qbeg, qend > qbeg ? (qend - qbeg + BQ - 1) / BQ : 0);
}

// The key tiles of BK keys that queries [q0, q0 + BQ) see.
template <int BK, int BQ>
__device__ __forceinline__ int2 key_tiles(const Geo& g, int q0) {
  const int off = g.S - g.Tq;
  int kend = g.S;
  if (g.causal) kend = min(g.S, min(q0 + BQ, g.Tq) - 1 + off + 1);
  int kbeg = 0;
  if (g.window > 0) kbeg = max(0, (q0 + off - g.window + 1) / BK * BK);
  return make_int2(kbeg, kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0);
}

// (a) D = rowsum(dout * out), float32 (B, H, Tq), one warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_dot(const T* __restrict__ out, const T* __restrict__ dout,
        float* __restrict__ D, int rows, int hd, Geo g) {
  const int row = (int)((blockIdx.x * 256u + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int bh = row / g.Tq, t = row - bh * g.Tq;
  const int b = bh / g.H, h = bh - b * g.H;
  const T* o = out + b * g.o_sb + h * g.o_sh + t * g.o_st;
  const T* d = dout + b * g.d_sb + h * g.d_sh + t * g.d_st;
  float s = 0.f;
  for (int e = lane; e < hd; e += 32) s = fmaf(ld(o + e), ld(d + e), s);
  for (int o2 = 16; o2 > 0; o2 >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o2);
  if (lane == 0) D[row] = s;
}

// ---------------------------------------------------------------------------
//  CUDA cores: float32, and bf16 at hd 160 / 256
// ---------------------------------------------------------------------------
constexpr int kCcThreads = 256;
constexpr int kCcT = 32;              // keys and queries per tile

template <int HD>
constexpr size_t cc_smem() {          // four row tiles, two score tiles
  return sizeof(float) *
         (4 * (size_t)kCcT * (HD + 1) + 2 * (size_t)kCcT * (kCcT + 1) +
          2 * (size_t)kCcT);
}

// rows row0 .. row0 + 31 of g (row stride rs) as float32 into s (pitch
// HD + 1), zeros past nvalid
template <typename T, int HD>
__device__ __forceinline__ void cc_rows(float* s, const T* g, long long rs,
                                        int row0, int nvalid) {
  for (int x = threadIdx.x; x < kCcT * HD; x += kCcThreads) {
    const int r = x / HD, d = x - r * HD;
    s[r * (HD + 1) + d] =
        row0 + r < nvalid ? ld(g + (long long)(row0 + r) * rs + d) : 0.f;
  }
}

// (b) one block per (key tile, b * Hkv + kv head)
template <typename T, int HD>
__global__ void __launch_bounds__(kCcThreads)
bwd_dkdv_cc(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            T* __restrict__ dk, T* __restrict__ dv, Geo g) {
  constexpr int P = HD + 1, E = HD / 8, PS = kCcT + 1;
  extern __shared__ float sm_cc[];
  float* k_s = sm_cc;
  float* v_s = k_s + kCcT * P;
  float* q_s = v_s + kCcT * P;
  float* do_s = q_s + kCcT * P;
  float* p_s = do_s + kCcT * P;       // [key][query]
  float* ds_s = p_s + kCcT * PS;
  float* l_s = ds_s + kCcT * PS;
  float* dd_s = l_s + kCcT;

  const int b = blockIdx.y / g.Hkv, kvh = blockIdx.y - b * g.Hkv;
  const int k0 = blockIdx.x * kCcT;
  const int G = g.H / g.Hkv;
  const int tid = threadIdx.x, j = tid >> 3, c0 = tid & 7;

  cc_rows<T, HD>(k_s, k + b * g.k_sb + kvh * g.k_sh, g.k_ss, k0, g.S);
  cc_rows<T, HD>(v_s, v + b * g.v_sb + kvh * g.v_sh, g.v_ss, k0, g.S);
  float dka[E], dva[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dka[e] = dva[e] = 0.f;

  const int2 qt = query_tiles<kCcT, kCcT>(g, k0);
  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    const long long row = ((long long)b * g.H + h) * g.Tq;
    for (int t = 0; t < qt.y; ++t) {
      const int q0 = qt.x + t * kCcT;
      __syncthreads();                // k / v loaded; last tile consumed
      cc_rows<T, HD>(q_s, q + b * g.q_sb + h * g.q_sh, g.q_st, q0, g.Tq);
      cc_rows<T, HD>(do_s, dout + b * g.d_sb + h * g.d_sh, g.d_st, q0, g.Tq);
      if (tid < kCcT) {
        const int qi = q0 + tid;
        l_s[tid] = qi < g.Tq ? lse[row + qi] : 0.f;
        dd_s[tid] = qi < g.Tq ? D[row + qi] : 0.f;
      }
      __syncthreads();
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float kd = k_s[j * P + d], vd = v_s[j * P + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c0 + 8 * c;
          s[c] = fmaf(kd, q_s[i * P + d], s[c]);
          dp[c] = fmaf(vd, do_s[i * P + d], dp[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c0 + 8 * c;
        const float p = visible(g, q0 + i, k0 + j)
                            ? __expf(s[c] * g.scale - l_s[i]) : 0.f;
        p_s[j * PS + i] = p;
        ds_s[j * PS + i] = p * (dp[c] - dd_s[i]);
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kCcT; ++i) {
        const float p = p_s[j * PS + i], ds = ds_s[j * PS + i];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = c0 + 8 * e;
          dva[e] = fmaf(p, do_s[i * P + d], dva[e]);
          dka[e] = fmaf(ds, q_s[i * P + d], dka[e]);
        }
      }
    }
  }
  const int kj = k0 + j;
  if (kj < g.S) {
    const long long o = (((long long)b * g.Hkv + kvh) * g.S + kj) * HD;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      st(dk + o + c0 + 8 * e, dka[e] * g.scale);
      st(dv + o + c0 + 8 * e, dva[e]);
    }
  }
}

// (c) one block per (query tile, b * H + head)
template <typename T, int HD>
__global__ void __launch_bounds__(kCcThreads)
bwd_dq_cc(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          T* __restrict__ dq, Geo g) {
  constexpr int P = HD + 1, E = HD / 8, PS = kCcT + 1;
  extern __shared__ float sm_cc[];
  float* q_s = sm_cc;
  float* do_s = q_s + kCcT * P;
  float* k_s = do_s + kCcT * P;
  float* v_s = k_s + kCcT * P;
  float* ds_s = v_s + kCcT * P;       // [query][key]
  float* l_s = ds_s + kCcT * PS;
  float* dd_s = l_s + kCcT;

  const int b = blockIdx.y / g.H, h = blockIdx.y - b * g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int q0 = blockIdx.x * kCcT;
  const int tid = threadIdx.x, i = tid >> 3, c0 = tid & 7;
  const long long row = ((long long)b * g.H + h) * g.Tq;

  cc_rows<T, HD>(q_s, q + b * g.q_sb + h * g.q_sh, g.q_st, q0, g.Tq);
  cc_rows<T, HD>(do_s, dout + b * g.d_sb + h * g.d_sh, g.d_st, q0, g.Tq);
  if (tid < kCcT) {
    const int qi = q0 + tid;
    l_s[tid] = qi < g.Tq ? lse[row + qi] : 0.f;
    dd_s[tid] = qi < g.Tq ? D[row + qi] : 0.f;
  }
  float dqa[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dqa[e] = 0.f;

  const int2 kt = key_tiles<kCcT, kCcT>(g, q0);
  for (int t = 0; t < kt.y; ++t) {
    const int k0 = kt.x + t * kCcT;
    __syncthreads();                  // q / dO loaded; last tile consumed
    cc_rows<T, HD>(k_s, k + b * g.k_sb + kvh * g.k_sh, g.k_ss, k0, g.S);
    cc_rows<T, HD>(v_s, v + b * g.v_sb + kvh * g.v_sh, g.v_ss, k0, g.S);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = q_s[i * P + d], dd = do_s[i * P + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = c0 + 8 * c;
        s[c] = fmaf(qd, k_s[j * P + d], s[c]);
        dp[c] = fmaf(dd, v_s[j * P + d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = c0 + 8 * c;
      const float p = visible(g, q0 + i, k0 + j)
                          ? __expf(s[c] * g.scale - l_s[i]) : 0.f;
      ds_s[i * PS + j] = p * (dp[c] - dd_s[i]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kCcT; ++j) {
      const float ds = ds_s[i * PS + j];
#pragma unroll
      for (int e = 0; e < E; ++e)
        dqa[e] = fmaf(ds, k_s[j * P + c0 + 8 * e], dqa[e]);
    }
  }
  const int qi = q0 + i;
  if (qi < g.Tq) {
    const long long o = (row + qi) * HD;
#pragma unroll
    for (int e = 0; e < E; ++e) st(dq + o + c0 + 8 * e, dqa[e] * g.scale);
  }
}

// ---------------------------------------------------------------------------
//  bf16 at hd <= 128: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 128;       // 4 warps, 16 rows each
constexpr int kTcRows = 64;           // keys of a (b) block, queries of (c)

template <int HD>
struct TcBwd {
  static constexpr int BQ = HD <= 64 ? 64 : 32;   // (b): queries per tile
  static constexpr int BK = 64;                   // (c): keys per tile
  static constexpr size_t dkdv_smem =             // k, v; ring of q, dO
      sizeof(bf16) * (2 * (size_t)kTcRows * HD + 4 * (size_t)BQ * HD) +
      sizeof(float) * 4 * BQ;                     // ring of lse, D
  static constexpr size_t dq_smem =               // q, dO; ring of k, v
      sizeof(bf16) * (2 * (size_t)kTcRows * HD + 4 * (size_t)BK * HD);
};

// (b) one block per (key tile of 64, b * Hkv + kv head)
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            bf16* __restrict__ dk, bf16* __restrict__ dv, Geo g) {
  constexpr int BQ = TcBwd<HD>::BQ;
  constexpr int CPR = HD / 8;
  constexpr int NT = BQ / 8;          // score n-tiles of 8 queries
  constexpr int DT = HD / 8;          // accumulator n-tiles of 8 dims
  constexpr int KS = HD / 16;         // k-steps over hd

  extern __shared__ uint4 smem_tc[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_tc);
  bf16* v_s = k_s + kTcRows * HD;
  bf16* ring = v_s + kTcRows * HD;    // [stage][q, dO][BQ][HD]
  float* lring = reinterpret_cast<float*>(ring + 4 * BQ * HD);  // [st][l, D]

  const int b = blockIdx.y / g.Hkv, kvh = blockIdx.y - b * g.Hkv;
  const int k0 = blockIdx.x * kTcRows;
  const int G = g.H / g.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;

  const int2 qt = query_tiles<kTcRows, BQ>(g, k0);
  const int total = G * qt.y;         // (head of the group, query tile)

  // tile `it` of the walk into ring stage `stage`
  auto issue = [&](int it, int stage) {
    const int h = kvh * G + it / qt.y;
    const int q0 = qt.x + (it % qt.y) * BQ;
    bf16* qs = ring + stage * 2 * BQ * HD;
    load_tile<HD, BQ, kTcThreads>(qs, q + b * g.q_sb + h * g.q_sh, g.q_st,
                                  q0, g.Tq);
    load_tile<HD, BQ, kTcThreads>(qs + BQ * HD, dout + b * g.d_sb +
                                  h * g.d_sh, g.d_st, q0, g.Tq);
    if (tid < BQ) {
      const int qi = q0 + tid;
      const long long r = ((long long)b * g.H + h) * g.Tq + qi;
      float* ls = lring + stage * 2 * BQ;
      ls[tid] = qi < g.Tq ? lse[r] : 0.f;
      ls[BQ + tid] = qi < g.Tq ? D[r] : 0.f;
    }
  };

  load_tile<HD, kTcRows, kTcThreads>(k_s, k + b * g.k_sb + kvh * g.k_sh,
                                     g.k_ss, k0, g.S);
  load_tile<HD, kTcRows, kTcThreads>(v_s, v + b * g.v_sb + kvh * g.v_sh,
                                     g.v_ss, k0, g.S);
  if (total > 0) issue(0, 0);
  cp_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  const int krow = warp * 16 + (mi & 1) * 8 + mr;   // A rows: this warp's keys

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) issue(it + 1, (it + 1) & 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const bf16* qs = ring + (it & 1) * 2 * BQ * HD;
    const bf16* dos = qs + BQ * HD;
    const float* ls = lring + (it & 1) * 2 * BQ;
    const int q0 = qt.x + (it % qt.y) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned ka[4], va[4];
      ldsm_x4(ka, k_s + swz<CPR>(krow, kk * 2 + (mi >> 1)));
      ldsm_x4(va, v_s + swz<CPR>(krow, kk * 2 + (mi >> 1)));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int br = np * 16 + (mi >> 1) * 8 + mr, bc = kk * 2 + (mi & 1);
        unsigned bq[4], bd[4];
        ldsm_x4(bq, qs + swz<CPR>(br, bc));
        ldsm_x4(bd, dos + swz<CPR>(br, bc));
        mma16816(s[2 * np], ka, bq[0], bq[1]);
        mma16816(s[2 * np + 1], ka, bq[2], bq[3]);
        mma16816(dp[2 * np], va, bd[0], bd[1]);
        mma16816(dp[2 * np + 1], va, bd[2], bd[3]);
      }
    }

    // P^T, and dS^T = P^T (dP^T - D) in float32
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + warp * 16 + gq + (e >> 1) * 8;
        const int i = n * 8 + 2 * t4 + (e & 1);
        const float p = visible(g, q0 + i, kj)
                            ? __expf(s[n][e] * g.scale - ls[i]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - ls[BQ + i]);
      }

    // dV += P^T dO and dK += dS^T Q, A fragments packed from the scores
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2],
                                        dp[2 * kk + 1][3])};
#pragma unroll
      for (int dpi = 0; dpi < DT / 2; ++dpi) {
        const int br = kk * 16 + (mi & 1) * 8 + mr, bc = dpi * 2 + (mi >> 1);
        unsigned bf[4];
        ldsm_x4_t(bf, dos + swz<CPR>(br, bc));
        mma16816(dva[2 * dpi], pa, bf[0], bf[1]);
        mma16816(dva[2 * dpi + 1], pa, bf[2], bf[3]);
        ldsm_x4_t(bf, qs + swz<CPR>(br, bc));
        mma16816(dka[2 * dpi], da, bf[0], bf[1]);
        mma16816(dka[2 * dpi + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();                  // this stage may be refilled
  }
  cp_wait_all();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kj = k0 + warp * 16 + gq + rr * 8;
    if (kj < g.S) {
      const long long o = (((long long)b * g.Hkv + kvh) * g.S + kj) * HD;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int c = d * 8 + 2 * t4;
        dk[o + c] = __float2bfloat16(dka[d][2 * rr] * g.scale);
        dk[o + c + 1] = __float2bfloat16(dka[d][2 * rr + 1] * g.scale);
        dv[o + c] = __float2bfloat16(dva[d][2 * rr]);
        dv[o + c + 1] = __float2bfloat16(dva[d][2 * rr + 1]);
      }
    }
  }
}

// (c) one block per (query tile of 64, b * H + head), longest first
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          bf16* __restrict__ dq, Geo g) {
  constexpr int BK = TcBwd<HD>::BK;
  constexpr int CPR = HD / 8;
  constexpr int NT = BK / 8;          // score n-tiles of 8 keys
  constexpr int DT = HD / 8;
  constexpr int KS = HD / 16;

  extern __shared__ uint4 smem_tc[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_tc);
  bf16* do_s = q_s + kTcRows * HD;
  bf16* ring = do_s + kTcRows * HD;   // [stage][k, v][BK][HD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int b = blockIdx.y / g.H, h = blockIdx.y - b * g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;

  const bf16* kb = k + b * g.k_sb + kvh * g.k_sh;
  const bf16* vb = v + b * g.v_sb + kvh * g.v_sh;
  const int2 kt = key_tiles<BK, kTcRows>(g, q0);

  load_tile<HD, kTcRows, kTcThreads>(q_s, q + b * g.q_sb + h * g.q_sh,
                                     g.q_st, q0, g.Tq);
  load_tile<HD, kTcRows, kTcThreads>(do_s, dout + b * g.d_sb + h * g.d_sh,
                                     g.d_st, q0, g.Tq);
  if (kt.y > 0) {
    load_tile<HD, BK, kTcThreads>(ring, kb, g.k_ss, kt.x, g.S);
    load_tile<HD, BK, kTcThreads>(ring + BK * HD, vb, g.v_ss, kt.x, g.S);
  }
  cp_commit();

  // this lane's two query rows (gq and gq + 8 of the warp's 16)
  const long long row = ((long long)b * g.H + h) * g.Tq;
  float lr[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + warp * 16 + gq + rr * 8;
    lr[rr] = qi < g.Tq ? lse[row + qi] : 0.f;
    dr[rr] = qi < g.Tq ? D[row + qi] : 0.f;
  }
  float dqa[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[d][e] = 0.f;
  const int arow = warp * 16 + (mi & 1) * 8 + mr;   // A rows: warp's queries

  for (int t = 0; t < kt.y; ++t) {
    const int k0 = kt.x + t * BK;
    if (t + 1 < kt.y) {
      bf16* nk = ring + ((t + 1) & 1) * 2 * BK * HD;
      load_tile<HD, BK, kTcThreads>(nk, kb, g.k_ss, k0 + BK, g.S);
      load_tile<HD, BK, kTcThreads>(nk + BK * HD, vb, g.v_ss, k0 + BK, g.S);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const bf16* ks = ring + (t & 1) * 2 * BK * HD;
    const bf16* vs = ks + BK * HD;

    // S = Q K^T and dP = dO V^T: 16 queries x BK keys per warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned qa[4], oa[4];
      ldsm_x4(qa, q_s + swz<CPR>(arow, kk * 2 + (mi >> 1)));
      ldsm_x4(oa, do_s + swz<CPR>(arow, kk * 2 + (mi >> 1)));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int br = np * 16 + (mi >> 1) * 8 + mr, bc = kk * 2 + (mi & 1);
        unsigned bk[4], bv[4];
        ldsm_x4(bk, ks + swz<CPR>(br, bc));
        ldsm_x4(bv, vs + swz<CPR>(br, bc));
        mma16816(s[2 * np], qa, bk[0], bk[1]);
        mma16816(s[2 * np + 1], qa, bk[2], bk[3]);
        mma16816(dp[2 * np], oa, bv[0], bv[1]);
        mma16816(dp[2 * np + 1], oa, bv[2], bv[3]);
      }
    }

    // dS = P (dP - D) in float32
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int qi = q0 + warp * 16 + gq + rr * 8;
        const int kj = k0 + n * 8 + 2 * t4 + (e & 1);
        const float p = visible(g, qi, kj)
                            ? __expf(s[n][e] * g.scale - lr[rr]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dr[rr]);
      }

    // dQ += dS K, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2],
                                        dp[2 * kk + 1][3])};
#pragma unroll
      for (int dpi = 0; dpi < DT / 2; ++dpi) {
        unsigned bf[4];
        ldsm_x4_t(bf, ks + swz<CPR>(kk * 16 + (mi & 1) * 8 + mr,
                                    dpi * 2 + (mi >> 1)));
        mma16816(dqa[2 * dpi], da, bf[0], bf[1]);
        mma16816(dqa[2 * dpi + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();                  // this stage may be refilled
  }
  cp_wait_all();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + warp * 16 + gq + rr * 8;
    if (qi < g.Tq) {
      const long long o = (row + qi) * HD;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int c = d * 8 + 2 * t4;
        dq[o + c] = __float2bfloat16(dqa[d][2 * rr] * g.scale);
        dq[o + c + 1] = __float2bfloat16(dqa[d][2 * rr + 1] * g.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
//  launches
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* D;
  void *dq, *dk, *dv;
  int B;
};

template <typename T, int HD>
int launch_cc(const Args& a, const Geo& g, cudaStream_t s) {
  static unsigned done_kv = 0, done_q = 0;
  const size_t smem = cc_smem<HD>();
  cudaError_t err =
      smem_once((const void*)bwd_dkdv_cc<T, HD>, smem, &done_kv);
  if (err == cudaSuccess)
    err = smem_once((const void*)bwd_dq_cc<T, HD>, smem, &done_q);
  if (err != cudaSuccess) return (int)err;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *d = static_cast<const T*>(a.dout);
  bwd_dkdv_cc<T, HD>
      <<<dim3((g.S + kCcT - 1) / kCcT, a.B * g.Hkv), kCcThreads, smem, s>>>(
          q, k, v, d, a.lse, a.D, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), g);
  bwd_dq_cc<T, HD>
      <<<dim3((g.Tq + kCcT - 1) / kCcT, a.B * g.H), kCcThreads, smem, s>>>(
          q, k, v, d, a.lse, a.D, static_cast<T*>(a.dq), g);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc(const Args& a, const Geo& g, cudaStream_t s) {
  static unsigned done_kv = 0, done_q = 0;
  cudaError_t err = smem_once((const void*)bwd_dkdv_tc<HD>,
                              TcBwd<HD>::dkdv_smem, &done_kv);
  if (err == cudaSuccess)
    err = smem_once((const void*)bwd_dq_tc<HD>, TcBwd<HD>::dq_smem, &done_q);
  if (err != cudaSuccess) return (int)err;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *d = static_cast<const bf16*>(a.dout);
  bwd_dkdv_tc<HD><<<dim3((g.S + kTcRows - 1) / kTcRows, a.B * g.Hkv),
                    kTcThreads, TcBwd<HD>::dkdv_smem, s>>>(
      q, k, v, d, a.lse, a.D, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), g);
  bwd_dq_tc<HD><<<dim3((g.Tq + kTcRows - 1) / kTcRows, a.B * g.H),
                  kTcThreads, TcBwd<HD>::dq_smem, s>>>(
      q, k, v, d, a.lse, a.D, static_cast<bf16*>(a.dq), g);
  return (int)cudaGetLastError();
}

// (a), then (b) and (c): bf16 at hd <= 128 on the tensor cores, the rest
// on CUDA cores.
template <int HD>
int launch_hd(int dtype, const Args& a, const Geo& g, cudaStream_t s) {
  const int rows = a.B * g.H * g.Tq;
  const dim3 grid((rows + 7) / 8);    // 8 warps of 256 threads, a row each
  if (dtype == 0) {
    bwd_dot<float><<<grid, 256, 0, s>>>(static_cast<const float*>(a.out),
                                        static_cast<const float*>(a.dout),
                                        a.D, rows, HD, g);
    const int err = (int)cudaGetLastError();
    return err ? err : launch_cc<float, HD>(a, g, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  bwd_dot<bf16><<<grid, 256, 0, s>>>(static_cast<const bf16*>(a.out),
                                     static_cast<const bf16*>(a.dout), a.D,
                                     rows, HD, g);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if constexpr (HD <= 128)
    return launch_tc<HD>(a, g, s);
  else
    return launch_cc<bf16, HD>(a, g, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor but lse and D); hd in
// {32, 64, 128, 160, 256}; masks as repro_flash_attention's.  lse: the
// forward's (B, H, Tq) float32; D: (B, H, Tq) float32 scratch; dq
// (B, H, Tq, hd) and dk, dv (B, Hkv, S, hd) contiguous outputs.  strides
// (elements): q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, out_sb,
// out_sh, out_st, dout_sb, dout_sh, dout_st; the head-dim stride of every
// input is 1.  Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* D, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int Tq, int S, int hd, int causal,
    int window, const long long* st, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || Tq < 1 || S < 1 ||
      (causal && Tq > S) || window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  const Geo g{H, Hkv, Tq, S, causal, window, (float)pow((double)hd, -0.5),
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
              st[9], st[10], st[11], st[12], st[13], st[14]};
  const Args a{q, k, v, out, dout, lse, D, dq, dk, dv, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<32>(dtype, a, g, s);
    case 64: return launch_hd<64>(dtype, a, g, s);
    case 128: return launch_hd<128>(dtype, a, g, s);
    case 160: return launch_hd<160>(dtype, a, g, s);
    case 256: return launch_hd<256>(dtype, a, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
