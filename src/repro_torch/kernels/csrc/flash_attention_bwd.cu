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
// exactly 0 (P is selected to 0, never computed from -1e30).  dS is formed
// in float32 (in bf16, dP - D would cancel).
//
// Launches per call, three, or four when the group's heads are split:
//   (a) bwd_dot:  D (B, H, T) float32, one warp per query row;
//   (b) dk / dv:  one block per (key tile, b * Hkv + kv head, split z); it
//       walks G / splits heads of its group (heads z G / splits ..) and the
//       query tiles that see its keys (the causal frontier bounds them
//       below, the window above), so the GQA sum happens in the block's
//       registers.  With splits = 1 it writes dk and dv; else it writes its
//       float32 partial sums into the workspace ws (2, splits, B, Hkv, S,
//       hd), and
//   (s) bwd_dkdv_sum adds the splits' partials in order z = 0, 1, .. and
//       rounds once to the output type.  No atomics anywhere: the result
//       is the same bit for bit from run to run.  The wrapper picks splits
//       (kernels/flash_attention.py::_dkdv_splits): 1 unless B Hkv S / 64
//       blocks are fewer than two waves of the card's 132 SMs, as with MQA,
//       and then enough for four waves (recurrentgemma-9b: B = 8, Hkv = 1,
//       S = 1024 gives 128 blocks, so 8 splits of its 16 heads, 1,024
//       blocks, which also even out the causal mask's unequal blocks);
//   (c) dq:       one block per (query tile, b * H + head), longest first,
//       looping over the key tiles its queries see, as the forward does.
//
// What bounds it on the H100: operations.  Five products of T S hd / 2
// multiply-adds per head under the causal mask: qwen3-0.6b training (B=8,
// H=16, Hkv=8, T=S=1024, hd=128) is 85.9 GFLOP on about 201 MB, 0.087 ms
// at the 989 TFLOP/s bf16 tensor-core peak against 0.060 ms at 3.35 TB/s;
// recurrentgemma-9b's (H=16, Hkv=1, hd=256) is 172 GFLOP, 0.174 ms.
//
// bf16 at hd 128 where TMA can read q, k, v and dout (bwd_dkdv_wgmma,
// bwd_dq_wgmma; the wrapper's _bwd_route: every base and stride 16-byte
// aligned): warpgroup wgmma fed by TMA, in the FlashAttention-3 manner
// but deterministic.  A block is 384 threads: consumer warpgroups 0 and 1
// (setmaxnreg 240) and a producer warpgroup (24) of which one warp loads.
// Inputs are read by 4-D tensor maps (hd, rows, heads, B) built from the
// strides (hopper.cuh), in boxes of 64 hd (128 bytes, 128-byte swizzle).
//   (b) a block owns 128 keys (64 a warpgroup) of one kv head and split;
//       K and V arrive once, then a two-stage ring of (head, 64-query
//       tile) stages: Q and dO by TMA, lse (times log2 e) and D by the
//       producer warp's 32 lanes, which arrive on the stage's mbarrier
//       with the TMA's transaction.  Per tile, S^T = K Q^T and dP^T = V
//       dO^T are wgmma m64n64k16 with both operands K-major in shared
//       memory, in two commit groups; P^T is formed while dP^T is still
//       multiplied and dV += P^T dO issued (m64n128k16, P^T as the
//       register A operand: the accumulator layout is the A layout, so it
//       is packed to bf16 in place; dO read MN-major through the
//       descriptor's transpose bit) under dS^T's arithmetic, then dK +=
//       dS^T Q.  A tile wholly inside the mask takes a path without the
//       index tests, which would otherwise run on every element of every
//       tile (a large share of the kernel's time when tried on the card);
//       exp is ex2.approx.  The key tiles are the launch's last grid
//       dimension, so that the longest blocks (the first keys, under the
//       causal mask) start first.
//   (c) a block owns 128 queries of one head (64 a warpgroup); Q and dO
//       arrive once, then a two-stage ring of 64-key K and V tiles: S and
//       dP as in (b), dQ += dS K with K read MN-major.
// Each consumer thread holds 2 x 64 float32 accumulators (dK, dV) or 64
// (dQ) beside 2 x 32 for the scores.
//
// Other bf16 calls at hd <= 128 (bwd_dkdv_tc, bwd_dq_tc): mma.sync.m16n8k16
// with float32 accumulators in the forward's fragment layouts (mma_sync.cuh:
// swizzled tiles, cp.async, ldmatrix), 4 warps.  In (b) each warp owns 16
// keys and all of hd: per query tile S^T = K Q^T and dP^T = V dO^T take K
// and V as A fragments and the Q and dO tiles as B fragments (plain
// ldmatrix), then dV += P^T dO and dK += dS^T Q take P^T and dS^T packed
// from the accumulators as A fragments and dO and Q through
// ldmatrix.trans.  Q / dO tiles and their lse / D walk a two-stage ring,
// the next tile in flight while one is multiplied.  (c) is the forward's
// block with dP = dO V^T beside S = Q K^T and dQ += dS K in place of
// O += P V.  A thread holds 2 x hd / 2 (dk, dv) or hd / 2 (dq) float32
// accumulators: 128 registers at hd 128.
//
// bf16 at hd 160 and 256 (bwd_dkdv_wide, bwd_dq_wide): the same products
// on the tensor cores, but a 64-key block's dK and dV at hd 256 are
// 64 x 256 x 2 float32, 128 KB: 256 registers a thread at 4 warps, more
// than a thread has.  So 8 warps (256 threads, one block per SM) split the
// work two ways.  For the scores (S^T, dP^T in (b); S, dP in (c)) the
// warps are 4 rows of 16 keys (queries) by 2 halves of the 64 queries
// (keys) of a tile, each summing over all of hd: no product is done twice.
// P^T and dS^T (dS in (c)) go to shared memory as bf16, and for the
// accumulating products the same 8 warps are 4 rows by 2 halves of hd:
// each holds dK and dV (dQ) for 16 rows x hd / 2 columns, 2 x 16 x 128 /
// 32 = 128 float32 registers a thread at hd 256 (80 at 160; dQ 64 / 40),
// reading P^T / dS^T (dS) as A fragments through ldmatrix and dO, Q (K)
// through ldmatrix.trans.  Tiles are 64 x 64, so a key tile's K and V
// (64 KB at hd 256), a two-stage ring of Q / dO tiles (128 KB) and P^T,
// dS^T (16 KB) take 209 KB of the 227 KB a block may have; (c) 200 KB.
// Two barriers a tile: one after the stage has landed, which also frees
// the other stage and P^T / dS^T (the next tile's loads are issued
// after it), and one after P^T / dS^T are written.
//
// float32 (bwd_dkdv_cc, bwd_dq_cc): CUDA cores in float32, 256 threads per
// block, 32 keys x 32 queries a tile, all four tiles in shared memory as
// float32 (rows padded by one word).  Each thread computes 4 scores of one
// row and owns hd / 8 columns of one row of the accumulators.  Simple, and
// far from the bound: the float32 callers are parity checks.
//
// Every input is read through its strides (the model hands K2 transposed
// views, and dout comes with whatever strides autograd gives it); dq, dk
// and dv are written contiguous.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Geo {                     // one call: shapes, masks and strides
  int H, Hkv, Tq, S, causal, window;
  float scale;
  int splits;                    // blocks a kv head's G heads are split over
  long long n_kv;                // elements of dk: B * Hkv * S * hd
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_st, d_sb, d_sh, d_st;   // out, dout
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

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
//  CUDA cores: float32
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


// Columns c, c + 1 of row offset o of dk (already scaled) and dv: bf16 into
// dk / dv when one block sums the whole group (splits = 1), else float32
// into split z's partials of ws (dk's, then dv's).
__device__ __forceinline__ void put_kv(const Geo& g, bf16* dk, bf16* dv,
                                       float* ws, int z, long long o,
                                       float k0, float k1, float v0,
                                       float v1) {
  if (g.splits == 1) {
    *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(k0, k1);
    *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(v0, v1);
  } else {
    float* p = ws + (long long)z * g.n_kv + o;
    *reinterpret_cast<float2*>(p) = make_float2(k0, k1);
    *reinterpret_cast<float2*>(p + (long long)g.splits * g.n_kv) =
        make_float2(v0, v1);
  }
}

// (s) dk, dv = the sum of the splits' partials, in order, rounded once
__global__ void __launch_bounds__(256)
bwd_dkdv_sum(const float* __restrict__ ws, bf16* __restrict__ dk,
             bf16* __restrict__ dv, long long n, int splits) {
  const long long n4 = n / 4;                 // hd is a multiple of 32
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256) {
    float4 a = reinterpret_cast<const float4*>(ws)[i];
    float4 c = reinterpret_cast<const float4*>(ws + splits * n)[i];
    for (int z = 1; z < splits; ++z) {
      const float4 x = reinterpret_cast<const float4*>(ws + z * n)[i];
      const float4 y =
          reinterpret_cast<const float4*>(ws + (splits + z) * n)[i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(dk + 4 * i);
    __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(dv + 4 * i);
    pk[0] = __floats2bfloat162_rn(a.x, a.y);
    pk[1] = __floats2bfloat162_rn(a.z, a.w);
    pv[0] = __floats2bfloat162_rn(c.x, c.y);
    pv[1] = __floats2bfloat162_rn(c.z, c.w);
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

// (b) one block per (key tile of 64, b * Hkv + kv head, split)
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            bf16* __restrict__ dk, bf16* __restrict__ dv,
            float* __restrict__ ws, Geo g) {
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
  const int G = g.H / g.Hkv, Gs = G / g.splits;
  const int h0 = kvh * G + blockIdx.z * Gs;       // this block's heads
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;

  const int2 qt = query_tiles<kTcRows, BQ>(g, k0);
  const int total = Gs * qt.y;        // (head of the block, query tile)

  // tile `it` of the walk into ring stage `stage`
  auto issue = [&](int it, int stage) {
    const int h = h0 + it / qt.y;
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
      const long long o =
          (((long long)b * g.Hkv + kvh) * g.S + kj) * HD + 2 * t4;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        put_kv(g, dk, dv, ws, blockIdx.z, o + d * 8,
               dka[d][2 * rr] * g.scale, dka[d][2 * rr + 1] * g.scale,
               dva[d][2 * rr], dva[d][2 * rr + 1]);
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
//  bf16 at hd 160 and 256: mma.sync, 8 warps, hd split in halves
// ---------------------------------------------------------------------------
constexpr int kWideThreads = 256;     // 8 warps: 4 rows of 16 x 2 halves
constexpr int kWideRows = 64;         // keys of a (b) block, queries of (c)
constexpr int kWideT = 64;            // queries (b) / keys (c) of a tile

template <int HD>
struct WideBwd {
  static constexpr size_t dkdv_smem =     // k, v; ring of q, dO; P^T, dS^T
      sizeof(bf16) * (2 * (size_t)kWideRows * HD + 4 * (size_t)kWideT * HD +
                      2 * (size_t)kWideRows * kWideT) +
      sizeof(float) * 4 * kWideT;         // ring of lse, D
  static constexpr size_t dq_smem =       // q, dO; ring of k, v; dS
      sizeof(bf16) * (2 * (size_t)kWideRows * HD + 4 * (size_t)kWideT * HD +
                      (size_t)kWideRows * kWideT);
};

// (b) one block per (key tile of 64, b * Hkv + kv head, split).  Warp w:
// rows wr = w % 4 (keys wr * 16 ..), half wh = w / 4 (queries wh * 32 ..
// of a tile for the scores, columns wh * hd / 2 .. for dK and dV).
template <int HD>
__global__ void __launch_bounds__(kWideThreads, 1)
bwd_dkdv_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ D,
              bf16* __restrict__ dk, bf16* __restrict__ dv,
              float* __restrict__ ws, Geo g) {
  constexpr int R = kWideRows, BQ = kWideT;
  constexpr int CPR = HD / 8;
  constexpr int KS = HD / 16;         // k-steps over hd
  constexpr int HT = HD / 16;         // n8 tiles (and chunks) of half of hd
  constexpr int TPR = BQ / 8;         // chunks of a P^T / dS^T row

  extern __shared__ uint4 smem_w[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_w);
  bf16* v_s = k_s + R * HD;
  bf16* ring = v_s + R * HD;          // [stage][q, dO][BQ][HD]
  bf16* pt_s = ring + 4 * BQ * HD;    // P^T [key][query]
  bf16* dst_s = pt_s + R * BQ;        // dS^T [key][query]
  float* lring = reinterpret_cast<float*>(dst_s + R * BQ);  // [st][l, D]

  const int b = blockIdx.y / g.Hkv, kvh = blockIdx.y - b * g.Hkv;
  const int k0 = blockIdx.x * R;
  const int G = g.H / g.Hkv, Gs = G / g.splits;
  const int h0 = kvh * G + blockIdx.z * Gs;       // this block's heads
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int wr = warp & 3, wh = warp >> 2;

  const int2 qt = query_tiles<R, BQ>(g, k0);
  const int total = Gs * qt.y;        // (head of the block, query tile)

  auto issue = [&](int it, int stage) {
    const int h = h0 + it / qt.y;
    const int q0 = qt.x + (it % qt.y) * BQ;
    bf16* qs = ring + stage * 2 * BQ * HD;
    load_tile<HD, BQ, kWideThreads>(qs, q + b * g.q_sb + h * g.q_sh, g.q_st,
                                    q0, g.Tq);
    load_tile<HD, BQ, kWideThreads>(qs + BQ * HD, dout + b * g.d_sb +
                                    h * g.d_sh, g.d_st, q0, g.Tq);
    if (tid < BQ) {
      const int qi = q0 + tid;
      const long long r = ((long long)b * g.H + h) * g.Tq + qi;
      float* ls = lring + stage * 2 * BQ;
      ls[tid] = qi < g.Tq ? lse[r] : 0.f;
      ls[BQ + tid] = qi < g.Tq ? D[r] : 0.f;
    }
  };

  load_tile<HD, R, kWideThreads>(k_s, k + b * g.k_sb + kvh * g.k_sh, g.k_ss,
                                 k0, g.S);
  load_tile<HD, R, kWideThreads>(v_s, v + b * g.v_sb + kvh * g.v_sh, g.v_ss,
                                 k0, g.S);
  if (total > 0) issue(0, 0);
  cp_commit();

  float dka[HT][4], dva[HT][4];
#pragma unroll
  for (int d = 0; d < HT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  const int krow = wr * 16 + (mi & 1) * 8 + mr;     // A rows: this row's keys

  for (int it = 0; it < total; ++it) {
    cp_wait_all();
    __syncthreads();                  // the stage has landed; the other
                                      // stage, P^T and dS^T are free
    if (it + 1 < total) issue(it + 1, (it + 1) & 1);
    cp_commit();
    const bf16* qs = ring + (it & 1) * 2 * BQ * HD;
    const bf16* dos = qs + BQ * HD;
    const float* ls = lring + (it & 1) * 2 * BQ;
    const int q0 = qt.x + (it % qt.y) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries, all of hd
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned ka[4], va[4];
      ldsm_x4(ka, k_s + swz<CPR>(krow, kk * 2 + (mi >> 1)));
      ldsm_x4(va, v_s + swz<CPR>(krow, kk * 2 + (mi >> 1)));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int br = wh * 32 + np * 16 + (mi >> 1) * 8 + mr;
        const int bc = kk * 2 + (mi & 1);
        unsigned bq[4], bd[4];
        ldsm_x4(bq, qs + swz<CPR>(br, bc));
        ldsm_x4(bd, dos + swz<CPR>(br, bc));
        mma16816(s[2 * np], ka, bq[0], bq[1]);
        mma16816(s[2 * np + 1], ka, bq[2], bq[3]);
        mma16816(dp[2 * np], va, bd[0], bd[1]);
        mma16816(dp[2 * np + 1], va, bd[2], bd[3]);
      }
    }

    // P^T and dS^T = P^T (dP^T - D) in float32, to shared memory as bf16
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = wr * 16 + gq + rr * 8;          // key of the block
        const int i = wh * 32 + n * 8 + 2 * t4;       // query of the tile
        float p[2], d[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          p[c] = visible(g, q0 + i + c, k0 + r)
                     ? __expf(s[n][2 * rr + c] * g.scale - ls[i + c]) : 0.f;
          d[c] = p[c] * (dp[n][2 * rr + c] - ls[BQ + i + c]);
        }
        const int o = swz<TPR>(r, i >> 3) + (i & 7);
        *reinterpret_cast<unsigned*>(pt_s + o) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<unsigned*>(dst_s + o) = pack_bf16(d[0], d[1]);
      }
    __syncthreads();                  // P^T and dS^T are written

    // dV += P^T dO and dK += dS^T Q on this warp's half of hd
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      unsigned pa[4], da[4];
      ldsm_x4(pa, pt_s + swz<TPR>(krow, kk * 2 + (mi >> 1)));
      ldsm_x4(da, dst_s + swz<TPR>(krow, kk * 2 + (mi >> 1)));
#pragma unroll
      for (int dpi = 0; dpi < HT / 2; ++dpi) {
        const int br = kk * 16 + (mi & 1) * 8 + mr;
        const int bc = wh * HT + dpi * 2 + (mi >> 1);
        unsigned bf[4];
        ldsm_x4_t(bf, dos + swz<CPR>(br, bc));
        mma16816(dva[2 * dpi], pa, bf[0], bf[1]);
        mma16816(dva[2 * dpi + 1], pa, bf[2], bf[3]);
        ldsm_x4_t(bf, qs + swz<CPR>(br, bc));
        mma16816(dka[2 * dpi], da, bf[0], bf[1]);
        mma16816(dka[2 * dpi + 1], da, bf[2], bf[3]);
      }
    }
  }
  cp_wait_all();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kj = k0 + wr * 16 + gq + rr * 8;
    if (kj < g.S) {
      const long long o = (((long long)b * g.Hkv + kvh) * g.S + kj) * HD +
                          wh * (HD / 2) + 2 * t4;
#pragma unroll
      for (int d = 0; d < HT; ++d)
        put_kv(g, dk, dv, ws, blockIdx.z, o + d * 8,
               dka[d][2 * rr] * g.scale, dka[d][2 * rr + 1] * g.scale,
               dva[d][2 * rr], dva[d][2 * rr + 1]);
    }
  }
}

// (c) one block per (query tile of 64, b * H + head), longest first.  Warp
// w: rows wr = w % 4 (queries wr * 16 ..), half wh = w / 4 (keys wh * 32 ..
// of a tile for the scores, columns wh * hd / 2 .. for dQ).
template <int HD>
__global__ void __launch_bounds__(kWideThreads, 1)
bwd_dq_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            bf16* __restrict__ dq, Geo g) {
  constexpr int R = kWideRows, BK = kWideT;
  constexpr int CPR = HD / 8;
  constexpr int KS = HD / 16;
  constexpr int HT = HD / 16;
  constexpr int TPR = BK / 8;

  extern __shared__ uint4 smem_w[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_w);
  bf16* do_s = q_s + R * HD;
  bf16* ring = do_s + R * HD;         // [stage][k, v][BK][HD]
  bf16* ds_s = ring + 4 * BK * HD;    // dS [query][key]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int b = blockIdx.y / g.H, h = blockIdx.y - b * g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int wr = warp & 3, wh = warp >> 2;

  const bf16* kb = k + b * g.k_sb + kvh * g.k_sh;
  const bf16* vb = v + b * g.v_sb + kvh * g.v_sh;
  const int2 kt = key_tiles<BK, R>(g, q0);

  load_tile<HD, R, kWideThreads>(q_s, q + b * g.q_sb + h * g.q_sh, g.q_st,
                                 q0, g.Tq);
  load_tile<HD, R, kWideThreads>(do_s, dout + b * g.d_sb + h * g.d_sh,
                                 g.d_st, q0, g.Tq);
  if (kt.y > 0) {
    load_tile<HD, BK, kWideThreads>(ring, kb, g.k_ss, kt.x, g.S);
    load_tile<HD, BK, kWideThreads>(ring + BK * HD, vb, g.v_ss, kt.x, g.S);
  }
  cp_commit();

  // this lane's two query rows (gq and gq + 8 of the row's 16)
  const long long row = ((long long)b * g.H + h) * g.Tq;
  float lr[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + wr * 16 + gq + rr * 8;
    lr[rr] = qi < g.Tq ? lse[row + qi] : 0.f;
    dr[rr] = qi < g.Tq ? D[row + qi] : 0.f;
  }
  float dqa[HT][4];
#pragma unroll
  for (int d = 0; d < HT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[d][e] = 0.f;
  const int arow = wr * 16 + (mi & 1) * 8 + mr;     // A rows: row's queries

  for (int t = 0; t < kt.y; ++t) {
    const int k0 = kt.x + t * BK;
    cp_wait_all();
    __syncthreads();                  // the stage has landed; the other
                                      // stage and dS are free
    if (t + 1 < kt.y) {
      bf16* nk = ring + ((t + 1) & 1) * 2 * BK * HD;
      load_tile<HD, BK, kWideThreads>(nk, kb, g.k_ss, k0 + BK, g.S);
      load_tile<HD, BK, kWideThreads>(nk + BK * HD, vb, g.v_ss, k0 + BK,
                                      g.S);
    }
    cp_commit();
    const bf16* ks = ring + (t & 1) * 2 * BK * HD;
    const bf16* vs = ks + BK * HD;

    // S = Q K^T and dP = dO V^T: 16 queries x 32 keys, all of hd
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned qa[4], oa[4];
      ldsm_x4(qa, q_s + swz<CPR>(arow, kk * 2 + (mi >> 1)));
      ldsm_x4(oa, do_s + swz<CPR>(arow, kk * 2 + (mi >> 1)));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int br = wh * 32 + np * 16 + (mi >> 1) * 8 + mr;
        const int bc = kk * 2 + (mi & 1);
        unsigned bk[4], bv[4];
        ldsm_x4(bk, ks + swz<CPR>(br, bc));
        ldsm_x4(bv, vs + swz<CPR>(br, bc));
        mma16816(s[2 * np], qa, bk[0], bk[1]);
        mma16816(s[2 * np + 1], qa, bk[2], bk[3]);
        mma16816(dp[2 * np], oa, bv[0], bv[1]);
        mma16816(dp[2 * np + 1], oa, bv[2], bv[3]);
      }
    }

    // dS = P (dP - D) in float32, to shared memory as bf16
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = wr * 16 + gq + rr * 8;          // query of the block
        const int j = wh * 32 + n * 8 + 2 * t4;       // key of the tile
        float d[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = visible(g, q0 + r, k0 + j + c)
                              ? __expf(s[n][2 * rr + c] * g.scale - lr[rr])
                              : 0.f;
          d[c] = p * (dp[n][2 * rr + c] - dr[rr]);
        }
        *reinterpret_cast<unsigned*>(ds_s + swz<TPR>(r, j >> 3) + (j & 7)) =
            pack_bf16(d[0], d[1]);
      }
    __syncthreads();                  // dS is written

    // dQ += dS K on this warp's half of hd, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned da[4];
      ldsm_x4(da, ds_s + swz<TPR>(arow, kk * 2 + (mi >> 1)));
#pragma unroll
      for (int dpi = 0; dpi < HT / 2; ++dpi) {
        unsigned bf[4];
        ldsm_x4_t(bf, ks + swz<CPR>(kk * 16 + (mi & 1) * 8 + mr,
                                    wh * HT + dpi * 2 + (mi >> 1)));
        mma16816(dqa[2 * dpi], da, bf[0], bf[1]);
        mma16816(dqa[2 * dpi + 1], da, bf[2], bf[3]);
      }
    }
  }
  cp_wait_all();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + wr * 16 + gq + rr * 8;
    if (qi < g.Tq) {
      const long long o = (row + qi) * HD + wh * (HD / 2) + 2 * t4;
#pragma unroll
      for (int d = 0; d < HT; ++d)
        *reinterpret_cast<__nv_bfloat162*>(dq + o + d * 8) =
            __floats2bfloat162_rn(dqa[d][2 * rr] * g.scale,
                                  dqa[d][2 * rr + 1] * g.scale);
    }
  }
}

// ---------------------------------------------------------------------------
//  bf16 at hd 128: warpgroup wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 384;       // consumer warpgroups 0, 1; producer 2
constexpr int kWgStages = 2;          // ring of tiles the blocks walk
constexpr int kWgRows = 128;          // keys of a (b) block, queries of (c)
constexpr int kWgT = 64;              // queries of a (b) tile, keys of (c)
constexpr int kWgHd = 128;
constexpr int kWgBlockBytes = kWgRows * kWgHd * 2;  // a 128-row operand
constexpr int kWgTileBytes = kWgT * kWgHd * 2;      // a 64-row operand
constexpr size_t kWgSmem =                // alignment slack, the block's two
    1024 + 2 * (size_t)kWgBlockBytes +    // operands, the ring, lse / D rows
    kWgStages * (2 * (size_t)kWgTileBytes + 2 * kWgT * sizeof(float)) +
    (2 * kWgStages + 1) * 8;              // and the barriers
constexpr float kLog2e = 1.4426950408889634f;

// wgmma descriptor of k-step kk (16 of hd) of a K-major operand of `rows`
// rows x 128 hd in two TMA boxes of 64 hd (rows x 128 bytes each), from
// row r0 on
__device__ __forceinline__ uint64_t kmajor(const uint8_t* p, int rows, int r0,
                                           int kk) {
  return gmma_desc(p + (kk >> 2) * rows * 128 + r0 * 128 + (kk & 3) * 32, 16,
                   1024);
}
// wgmma descriptor of k-step kk (rows 16 kk ..) of a 64-row operand read
// MN-major (rows are the product's K, hd its N): the two boxes of 64 hd
// are the leading offset apart
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* p, int kk) {
  return gmma_desc(p + kk * 16 * 128, kWgT * 128, 1024);
}
// 2^x in one MUFU instruction (flush to zero: P underflows to 0 anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void wg_sync(int wg) {   // one warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// (b) one block per (b * Hkv + kv head, split, key tile of 128), the key
// tiles last so that the launch order runs the longest (first) tiles
// first.  Warpgroup wg owns keys k0 + 64 wg ..; the producer warp keeps
// the ring of (head, query tile) stages full: Q and dO by TMA, lse (times
// log2 e) and D by its 32 lanes, each lane arriving on the stage's barrier.
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ D,
               bf16* __restrict__ dk, bf16* __restrict__ dv,
               float* __restrict__ ws, Geo g) {
  extern __shared__ __align__(16) uint8_t smem_wgk[];
  uint8_t* base = smem_wgk + ((1024 - (smem_u32(smem_wgk) & 1023)) & 1023);
  uint8_t* k_s = base;
  uint8_t* v_s = k_s + kWgBlockBytes;
  uint8_t* ring = v_s + kWgBlockBytes;      // [stage][Q, dO][64][128]
  float* lring = reinterpret_cast<float*>(ring + kWgStages * 2 *
                                          kWgTileBytes);  // [stage][l, D]
  uint64_t* full = reinterpret_cast<uint64_t*>(lring + kWgStages * 2 * kWgT);
  uint64_t* empty = full + kWgStages;
  uint64_t* kvbar = empty + kWgStages;

  const int b = blockIdx.x / g.Hkv, kvh = blockIdx.x - b * g.Hkv;
  const int z = blockIdx.y, k0 = blockIdx.z * kWgRows;
  const int G = g.H / g.Hkv, Gs = G / g.splits;
  const int h0 = kvh * G + z * Gs;                // this block's heads
  const int2 qt = query_tiles<kWgRows, kWgT>(g, k0);
  const int total = Gs * qt.y;                    // (head, query tile)
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(&full[st], 33);           // the expect_tx and 32 lanes
      mbar_init(&empty[st], 2);           // one thread per consumer
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer: warp 8 loads, the other three leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid < 288) {
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * kWgBlockBytes);
        for (int hh = 0; hh < 2; ++hh) {
          tma_load(k_s + hh * kWgRows * 128, &tk, kvbar, 64 * hh, k0, kvh, b);
          tma_load(v_s + hh * kWgRows * 128, &tv, kvbar, 64 * hh, k0, kvh, b);
        }
      }
      for (int it = 0; it < total; ++it) {
        const int st = it % kWgStages;
        const int h = h0 + it / qt.y, q0 = qt.x + (it % qt.y) * kWgT;
        mbar_wait(&empty[st], ((it / kWgStages) & 1) ^ 1);
        uint8_t* qs = ring + st * 2 * kWgTileBytes;
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * kWgTileBytes);
          for (int hh = 0; hh < 2; ++hh) {
            tma_load(qs + hh * kWgT * 128, &tq, &full[st], 64 * hh, q0, h, b);
            tma_load(qs + kWgTileBytes + hh * kWgT * 128, &tdo, &full[st],
                     64 * hh, q0, h, b);
          }
        }
        float* ls = lring + st * 2 * kWgT;
        const long long row = ((long long)b * g.H + h) * g.Tq;
        for (int i = lane; i < kWgT; i += 32) {
          const int qi = q0 + i;
          ls[i] = qi < g.Tq ? lse[row + qi] * kLog2e : 0.f;
          ls[kWgT + i] = qi < g.Tq ? D[row + qi] : 0.f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumers: warpgroup wg, keys kw ..; lane's rows gq, gq + 8 of its
    // warp's 16, columns 2 t4, 2 t4 + 1 of each 8
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int gq = lane >> 2, t4 = lane & 3;
    const int kw = k0 + wg * 64;
    const int off = g.S - g.Tq;
    const float sl2 = g.scale * kLog2e;
    float dka[64], dva[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kvbar, 0);

    for (int it = 0; it < total; ++it) {
      const int st = it % kWgStages;
      const int q0 = qt.x + (it % qt.y) * kWgT;
      mbar_wait(&full[st], (it / kWgStages) & 1);
      const uint8_t* qs = ring + st * 2 * kWgTileBytes;
      const uint8_t* dos = qs + kWgTileBytes;
      const float* ls = lring + st * 2 * kWgT;

      // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries over all of hd,
      // in two groups: P^T is formed while dP^T is still being multiplied
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgHd / 16; ++kk)
        wgmma_64_ss(s, kmajor(k_s, kWgRows, wg * 64, kk),
                    kmajor(qs, kWgT, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kWgHd / 16; ++kk)
        wgmma_64_ss(dp, kmajor(v_s, kWgRows, wg * 64, kk),
                    kmajor(dos, kWgT, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<32>(s);

      // P^T in float32 (kept in s), packed to bf16 as the A fragments
      // (k-steps of 16 queries) of dV += P^T dO
      const bool whole =
          q0 + kWgT - 1 < g.Tq && kw + 63 < g.S &&
          (!g.causal || kw + 63 <= q0 + off) &&
          (g.window <= 0 || kw > q0 + kWgT - 1 + off - g.window);
      unsigned pa[4][4], da[4][4];
      if (whole) {                        // a tile wholly inside the mask
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = ex2(fmaf(s[e], sl2, -ls[8 * (e >> 2) + 2 * t4 + (e & 1)]));
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = 8 * (e >> 2) + 2 * t4 + (e & 1);
          const int kj = kw + warp * 16 + gq + 8 * ((e >> 1) & 1);
          s[e] = visible(g, q0 + i, kj) ? ex2(fmaf(s[e], sl2, -ls[i])) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          pa[j >> 1][(j & 1) * 2 + hh] =
              pack_bf16(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]);
      // dV += P^T dO, dO read MN-major, under dS^T's arithmetic
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgT / 16; ++kk)
        wgmma_128_rs(dva, pa[kk], mnmajor(dos, kk));
      wgmma_commit();
      wgmma_wait<1>();                    // dP^T
      fence_regs<32>(dp);

      // dS^T = P^T (dP^T - D) in float32, then dK += dS^T Q (Q MN-major)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float d[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 8 * j + 2 * t4 + c, e = 4 * j + 2 * hh + c;
            d[c] = s[e] * (dp[e] - ls[kWgT + i]);
          }
          da[j >> 1][(j & 1) * 2 + hh] = pack_bf16(d[0], d[1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgT / 16; ++kk)
        wgmma_128_rs(dka, da[kk], mnmajor(qs, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(dva);
      fence_regs<64>(dka);
      fence_regs<16>(&pa[0][0]);
      fence_regs<16>(&da[0][0]);
      wg_sync(wg);                        // every warp is done with the stage
      if ((tid & 127) == 0) mbar_arrive(&empty[st]);
    }

    // dka[4 j + 2 hh + c]: key kw + 16 warp + gq + 8 hh, column 8 j + 2 t4 + c
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kj = kw + warp * 16 + gq + 8 * hh;
      if (kj < g.S) {
        const long long o =
            (((long long)b * g.Hkv + kvh) * g.S + kj) * kWgHd + 2 * t4;
#pragma unroll
        for (int j = 0; j < kWgHd / 8; ++j)
          put_kv(g, dk, dv, ws, z, o + 8 * j, dka[4 * j + 2 * hh] * g.scale,
                 dka[4 * j + 2 * hh + 1] * g.scale, dva[4 * j + 2 * hh],
                 dva[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// (c) one block per (b * H + head, query tile of 128), the query tiles
// last and the longest (last) first.  Warpgroup wg owns queries q0 + 64 wg
// ..; the producer thread loads Q and dO once, then keeps the ring of K
// and V tiles full.
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const float* __restrict__ lse, const float* __restrict__ D,
             bf16* __restrict__ dq, Geo g) {
  extern __shared__ __align__(16) uint8_t smem_wgq[];
  uint8_t* base = smem_wgq + ((1024 - (smem_u32(smem_wgq) & 1023)) & 1023);
  uint8_t* q_s = base;
  uint8_t* do_s = q_s + kWgBlockBytes;
  uint8_t* ring = do_s + kWgBlockBytes;     // [stage][K, V][64][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * 2 *
                                               kWgTileBytes);
  uint64_t* empty = full + kWgStages;
  uint64_t* qbar = empty + kWgStages;

  const int b = blockIdx.x / g.H, h = blockIdx.x - b * g.H;
  const int kvh = h / (g.H / g.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;
  const int2 kt = key_tiles<kWgT, kWgRows>(g, q0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      mbar_expect_tx(qbar, 2 * kWgBlockBytes);
      for (int hh = 0; hh < 2; ++hh) {
        tma_load(q_s + hh * kWgRows * 128, &tq, qbar, 64 * hh, q0, h, b);
        tma_load(do_s + hh * kWgRows * 128, &tdo, qbar, 64 * hh, q0, h, b);
      }
      for (int t = 0; t < kt.y; ++t) {
        const int st = t % kWgStages, k0 = kt.x + t * kWgT;
        mbar_wait(&empty[st], ((t / kWgStages) & 1) ^ 1);
        uint8_t* ks = ring + st * 2 * kWgTileBytes;
        mbar_expect_tx(&full[st], 2 * kWgTileBytes);
        for (int hh = 0; hh < 2; ++hh) {
          tma_load(ks + hh * kWgT * 128, &tk, &full[st], 64 * hh, k0, kvh, b);
          tma_load(ks + kWgTileBytes + hh * kWgT * 128, &tv, &full[st],
                   64 * hh, k0, kvh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int gq = lane >> 2, t4 = lane & 3;
    const int qw = q0 + wg * 64;
    const int off = g.S - g.Tq;
    const float sl2 = g.scale * kLog2e;
    const long long row = ((long long)b * g.H + h) * g.Tq;
    float l2[2], dr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = qw + warp * 16 + gq + 8 * hh;
      l2[hh] = qi < g.Tq ? lse[row + qi] * kLog2e : 0.f;
      dr[hh] = qi < g.Tq ? D[row + qi] : 0.f;
    }
    float dqa[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dqa[i] = 0.f;
    mbar_wait(qbar, 0);

    for (int t = 0; t < kt.y; ++t) {
      const int st = t % kWgStages, k0 = kt.x + t * kWgT;
      mbar_wait(&full[st], (t / kWgStages) & 1);
      const uint8_t* ks = ring + st * 2 * kWgTileBytes;
      const uint8_t* vs = ks + kWgTileBytes;

      // S = Q K^T and dP = dO V^T, 64 queries x 64 keys over all of hd, in
      // two groups: P is formed while dP is still being multiplied
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgHd / 16; ++kk)
        wgmma_64_ss(s, kmajor(q_s, kWgRows, wg * 64, kk),
                    kmajor(ks, kWgT, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kWgHd / 16; ++kk)
        wgmma_64_ss(dp, kmajor(do_s, kWgRows, wg * 64, kk),
                    kmajor(vs, kWgT, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<32>(s);
      const bool whole =
          qw + 63 < g.Tq && k0 + kWgT - 1 < g.S &&
          (!g.causal || k0 + kWgT - 1 <= qw + off) &&
          (g.window <= 0 || k0 > qw + 63 + off - g.window);
      if (whole) {                        // a tile wholly inside the mask
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = ex2(fmaf(s[e], sl2, -l2[(e >> 1) & 1]));
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qi = qw + warp * 16 + gq + 8 * ((e >> 1) & 1);
          const int kj = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
          s[e] = visible(g, qi, kj) ? ex2(fmaf(s[e], sl2, -l2[(e >> 1) & 1]))
                                    : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs<32>(dp);

      // dS = P (dP - D) in float32, packed as the A fragments of dQ += dS K
      unsigned da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float d[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * hh + c;
            d[c] = s[e] * (dp[e] - dr[hh]);
          }
          da[j >> 1][(j & 1) * 2 + hh] = pack_bf16(d[0], d[1]);
        }

      // dQ += dS K, K read MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgT / 16; ++kk)
        wgmma_128_rs(dqa, da[kk], mnmajor(ks, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(dqa);
      fence_regs<16>(&da[0][0]);
      wg_sync(wg);
      if ((tid & 127) == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = qw + warp * 16 + gq + 8 * hh;
      if (qi < g.Tq) {
        bf16* o = dq + (row + qi) * kWgHd + 2 * t4;
#pragma unroll
        for (int j = 0; j < kWgHd / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
              __floats2bfloat162_rn(dqa[4 * j + 2 * hh] * g.scale,
                                    dqa[4 * j + 2 * hh + 1] * g.scale);
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
  float* ws;
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

// (s), when the group's heads were split
void launch_sum(const Args& a, const Geo& g, cudaStream_t s) {
  if (g.splits == 1) return;
  const long long blocks = (g.n_kv / 4 + 255) / 256;
  bwd_dkdv_sum<<<(unsigned)(blocks < 132 * 8 ? blocks : 132 * 8), 256, 0,
                 s>>>(a.ws, static_cast<bf16*>(a.dk),
                      static_cast<bf16*>(a.dv), g.n_kv, g.splits);
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
  bwd_dkdv_tc<HD>
      <<<dim3((g.S + kTcRows - 1) / kTcRows, a.B * g.Hkv, g.splits),
         kTcThreads, TcBwd<HD>::dkdv_smem, s>>>(
          q, k, v, d, a.lse, a.D, static_cast<bf16*>(a.dk),
          static_cast<bf16*>(a.dv), a.ws, g);
  launch_sum(a, g, s);
  bwd_dq_tc<HD><<<dim3((g.Tq + kTcRows - 1) / kTcRows, a.B * g.H),
                  kTcThreads, TcBwd<HD>::dq_smem, s>>>(
      q, k, v, d, a.lse, a.D, static_cast<bf16*>(a.dq), g);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_wide(const Args& a, const Geo& g, cudaStream_t s) {
  static unsigned done_kv = 0, done_q = 0;
  cudaError_t err = smem_once((const void*)bwd_dkdv_wide<HD>,
                              WideBwd<HD>::dkdv_smem, &done_kv);
  if (err == cudaSuccess)
    err = smem_once((const void*)bwd_dq_wide<HD>, WideBwd<HD>::dq_smem,
                    &done_q);
  if (err != cudaSuccess) return (int)err;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *d = static_cast<const bf16*>(a.dout);
  bwd_dkdv_wide<HD>
      <<<dim3((g.S + kWideRows - 1) / kWideRows, a.B * g.Hkv, g.splits),
         kWideThreads, WideBwd<HD>::dkdv_smem, s>>>(
          q, k, v, d, a.lse, a.D, static_cast<bf16*>(a.dk),
          static_cast<bf16*>(a.dv), a.ws, g);
  launch_sum(a, g, s);
  bwd_dq_wide<HD><<<dim3((g.Tq + kWideRows - 1) / kWideRows, a.B * g.H),
                    kWideThreads, WideBwd<HD>::dq_smem, s>>>(
      q, k, v, d, a.lse, a.D, static_cast<bf16*>(a.dq), g);
  return (int)cudaGetLastError();
}

// The 4-D map (hd, rows, heads, B) of a (B, heads, rows, 128) bf16 input
// with element strides (row, head, batch), in boxes of 64 hd x box_rows.
bool head_map(CUtensorMap* m, const void* p, int rows, int heads, int B,
              long long sr, long long sh, long long sb, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)kWgHd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const long long strides[3] = {sr, sh, sb};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  return bf16_map(m, p, 4, dims, strides, box);
}

// (b), (s) and (c) on wgmma: bf16 at hd 128, every base and stride of q,
// k, v and dout 16-byte aligned (the wrapper's _bwd_route)
int launch_wgmma(const Args& a, const Geo& g, cudaStream_t s) {
  static unsigned done_kv = 0, done_q = 0;
  CUtensorMap k128, v128, q64, do64, q128, do128, k64, v64;
  const int B = a.B;
  if (!head_map(&k128, a.k, g.S, g.Hkv, B, g.k_ss, g.k_sh, g.k_sb, 128) ||
      !head_map(&v128, a.v, g.S, g.Hkv, B, g.v_ss, g.v_sh, g.v_sb, 128) ||
      !head_map(&q64, a.q, g.Tq, g.H, B, g.q_st, g.q_sh, g.q_sb, 64) ||
      !head_map(&do64, a.dout, g.Tq, g.H, B, g.d_st, g.d_sh, g.d_sb, 64) ||
      !head_map(&q128, a.q, g.Tq, g.H, B, g.q_st, g.q_sh, g.q_sb, 128) ||
      !head_map(&do128, a.dout, g.Tq, g.H, B, g.d_st, g.d_sh, g.d_sb, 128) ||
      !head_map(&k64, a.k, g.S, g.Hkv, B, g.k_ss, g.k_sh, g.k_sb, 64) ||
      !head_map(&v64, a.v, g.S, g.Hkv, B, g.v_ss, g.v_sh, g.v_sb, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = smem_once((const void*)bwd_dkdv_wgmma, kWgSmem, &done_kv);
  if (err == cudaSuccess)
    err = smem_once((const void*)bwd_dq_wgmma, kWgSmem, &done_q);
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_wgmma<<<dim3(B * g.Hkv, g.splits, (g.S + kWgRows - 1) / kWgRows),
                   kWgThreads, kWgSmem, s>>>(
      k128, v128, q64, do64, a.lse, a.D, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.ws, g);
  launch_sum(a, g, s);
  bwd_dq_wgmma<<<dim3(B * g.H, (g.Tq + kWgRows - 1) / kWgRows), kWgThreads,
                 kWgSmem, s>>>(q128, do128, k64, v64, a.lse, a.D,
                               static_cast<bf16*>(a.dq), g);
  return (int)cudaGetLastError();
}

// (a), then (b), (s) and (c): bf16 on the tensor cores (hd 128 on wgmma
// where the wrapper says so, else hd <= 128 with 4 warps of mma.sync, 160
// and 256 with 8), float32 on CUDA cores.
template <int HD>
int launch_hd(int dtype, int wgmma, const Args& a, const Geo& g,
              cudaStream_t s) {
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
  if constexpr (HD == kWgHd)
    return wgmma ? launch_wgmma(a, g, s) : launch_tc<HD>(a, g, s);
  else if constexpr (HD < kWgHd)
    return launch_tc<HD>(a, g, s);
  else
    return launch_wide<HD>(a, g, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor but lse, D and ws); hd in
// {32, 64, 128, 160, 256}; masks as repro_flash_attention's.  lse: the
// forward's (B, H, Tq) float32; D: (B, H, Tq) float32 scratch; dq
// (B, H, Tq, hd) and dk, dv (B, Hkv, S, hd) contiguous outputs.  splits:
// the blocks each kv head's H / Hkv query heads are split over (a divisor
// of H / Hkv; more than 1 only in bf16), and ws: null when splits is 1,
// else (2, splits, B, Hkv, S, hd) float32 scratch for their partial sums.
// wgmma: 1 takes the TMA / wgmma kernels (bf16, hd 128, every base and
// stride but the unit one 16-byte aligned), 0 the others.
// strides (elements): q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
// out_sb, out_sh, out_st, dout_sb, dout_sh, dout_st; the head-dim stride
// of every input is 1.  Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* D, void* dq, void* dk,
    void* dv, float* ws, int B, int H, int Hkv, int Tq, int S, int hd,
    int causal, int window, int splits, int wgmma, const long long* st,
    void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || Tq < 1 || S < 1 ||
      (causal && Tq > S) || window < 0 || (window > 0 && !causal) ||
      splits < 1 || (H / Hkv) % splits != 0 ||
      (splits > 1 && (dtype != 1 || ws == nullptr)) ||
      (wgmma && (dtype != 1 || hd != kWgHd)))
    return (int)cudaErrorInvalidValue;
  const Geo g{H, Hkv, Tq, S, causal, window, (float)pow((double)hd, -0.5),
              splits, (long long)B * Hkv * S * hd,
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
              st[9], st[10], st[11], st[12], st[13], st[14]};
  const Args a{q, k, v, out, dout, lse, D, dq, dk, dv, ws, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<32>(dtype, wgmma, a, g, s);
    case 64: return launch_hd<64>(dtype, wgmma, a, g, s);
    case 128: return launch_hd<128>(dtype, wgmma, a, g, s);
    case 160: return launch_hd<160>(dtype, wgmma, a, g, s);
    case 256: return launch_hd<256>(dtype, wgmma, a, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
