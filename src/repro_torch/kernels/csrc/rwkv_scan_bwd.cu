// K4 rwkv_scan, backward: the gradients of the WKV6 recurrence
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// (w_t = exp(logw_t), S_{-1} = S0) with respect to r, k, v, logw, u and S0,
// from the gradients do of o and dS_T of the final state (null: zeros).
//
// The Pallas TPU kernel src/repro/kernels/rwkv_scan.py has no backward:
// the JAX package differentiates the plain recurrence with jax.grad.  This
// is the port's own kernel, behind kernels/rwkv_scan.py::RWKVScan.  It
// takes the forward's chunk form (csrc/rwkv_scan.cu): chunks of kC = 64
// steps, cs the inclusive cumsum of logw within a chunk, exponents relative
// to the chunk start (|cs| <= 64 * 0.105, so e^6.7 at most), and
//   q_in = r e^{cs - logw},  k_in = k e^{-cs},  A = strict_lower(q_in k_in^T)
//   o    = A v + (r.u.k) v + q_in S_c,
//   S_c+1 = e^{cs_last} S_c + (k e^{cs_last - cs})^T v.
// The chunk-start states S_c are the ones the forward's state_scan wrote
// into its scratch; the autograd Function keeps that scratch (B*H*chunks
// 64 x 64 float32: 84 MB at rwkv6-3b's training shape, B=8, T=1024), so
// nothing of the forward is recomputed.  Four launches:
//   1. rwkv_bwd_dstate, one block per (chunk, b*H + h): each chunk's
//      q_in^T do (64 x 64) and decay e^{cs_last} into scratch.
//   2. rwkv_bwd_scan, one thread per (b*H + h, state element): from dS_T
//      back over the chunks, dS_c = e^{cs_last,c} dS_c+1 + q_in^T do_c,
//      leaving in the scratch the gradient of each chunk's END state and
//      writing dS0 (the gradient of the first chunk's start).
//   3. rwkv_bwd_chunk, one block per (chunk, b*H + h), with
//      dS' = e^{cs_last} dS_c+1 (rows scaled) and P = strict_lower(do v^T):
//        dq_in = do S_c^T + P k_in          dr = e^{cs - logw} dq_in + u k (v.do)
//        dk_in = P^T q_in                    dk = e^{-cs} (dk_in + v dS'^T)
//        dv    = k_in dS' + A^T do + (r.u.k) do                  + r u (v.do)
//      and, from the cumsum identity (cs_t = sum_{i<=t} logw_i, so a term
//      in cs_i reaches every logw_t with t <= i), per channel m:
//        dlogw_t = sum_{i>t} X_i - sum_{i>=t} Y_i + sum_{s<t} Z_s + Dm
//      with X = q_in dq_in (the r side), Y = k_in dk_in (the k side),
//      Z = k_in (v dS'^T) (the state's k_tail side) and Dm = sum_j dS'
//      S_c (the state's decay), each sum a running sum down or up the
//      column in four 16-step segments; and each chunk's part of du.
//   4. rwkv_bwd_du, one thread per (h, m): du = the chunks' parts summed
//      over b and the chunks in a fixed order (deterministic, no atomics).
// tests/test_torch_grad_kernels.py holds this schedule, step by step in
// float64, against autograd and jax.grad of the plain recurrence.  In
// float32 the r- and k-side sums cancel where s >= t, against factors up to
// e^6.7, so dlogw carries the most rounding of the outputs.
//
// What bounds it on the H100: bytes.  At B=8, H=40, T=1024, M=64 it reads
// bf16 r, k, v, float32 logw and do and the saved states, and writes bf16
// dr, dk, dv and float32 dlogw: about 0.59 GB, 0.18 ms at 3.35 TB/s.  Its
// products are 8.67e9 multiply-adds a call, 0.259 ms on float32 CUDA
// cores at their 67 TFLOP/s: on them it cannot come near the byte bound.
//
// Two routes, picked in kernels/rwkv_scan.py::_bwd_route before the launch:
//   bf16 ("tc": rwkv_bwd_dstate_tc, rwkv_bwd_chunk_tc): every product on
//     the tensor cores, mma.sync.m16n8k16 in split bf16 (each float32
//     operand as hi + lo bf16, three products; lo lo dropped: about 2^-16
//     of a product, float32-class for dlogw, whose r- and k-side sums
//     cancel, where one bf16 product leaves it at about 4e-3 of its scale;
//     a TF32 m16n8k8 form was tried on the card and ran slower).
//     Operands are split once, as they are staged into shared memory as
//     swizzled bf16 tiles, and read as fragments with ldmatrix.  Launch 3
//     is two blocks a chunk (the channels: dr, dk, dlogw, du; the values:
//     dv), so that every sum stays in one block at about 100 KB of shared
//     memory and 128 registers a thread, two blocks of 8 warps a SM; a
//     block's score tile (P or A) is computed once and read from shared
//     memory straight or transposed.
//   float32 ("cc": rwkv_bwd_dstate, rwkv_bwd_chunk): float32 products on
//     CUDA cores, as in the forward; its callers are parity checks.  (These
//     kernels ran bf16 too until the tensor-core route replaced them.)
// Launches 2 and 4 are shared.
//
// T == 1 (a decode step) runs the same launches with one chunk; the
// forward keeps no scratch there and rwkv_bwd_chunk reads S_c from S0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "rwkv_common.cuh"

namespace {

// Element strides, in the order of the C interface below.
enum { R_SB, R_SH, R_ST, K_SB, K_SH, K_ST, V_SB, V_SH, V_ST, W_SB, W_SH, W_ST,
       DO_SB, DO_SH, DO_ST, DR_SB, DR_SH, DR_ST, DK_SB, DK_SH, DK_ST, DV_SB,
       DV_SH, DV_ST, DW_SB, DW_SH, DW_ST, DST_SB, DST_SH, S0_SB, S0_SH,
       DS0_SB, DS0_SH, kNStrides };
struct Strides {
  long long s[kNStrides];
};

// The first n of 4 floats into 4 elements of T at p.
__device__ __forceinline__ void store4t(float* p, float4 v, int n) {
  store4(p, v, n);
}
__device__ __forceinline__ void store4t(__nv_bfloat16* p, float4 v, int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
    q[0] = __floats2bfloat162_rn(v.x, v.y);
    q[1] = __floats2bfloat162_rn(v.z, v.w);
  } else {
    if (n > 0) p[0] = __float2bfloat16(v.x);
    if (n > 1) p[1] = __float2bfloat16(v.y);
    if (n > 2) p[2] = __float2bfloat16(v.z);
    if (n > 3) p[3] = __float2bfloat16(v.w);
  }
}

// out[t][s] = X[t] . Y[s] for s < t, else 0 (X, Y: [kC][kP] tiles): thread
// rows 4 tg .. 4 tg + 3, columns sg + 16 bb, the columns past its last row
// skipped, as the forward's scores.
__device__ __forceinline__ void strict_lower(const float* X, const float* Y,
                                             float* out) {
  const int tg = threadIdx.x / 16, sg = threadIdx.x % 16;
  const int nb = (4 * tg + 3) / 16 + 1;
  float sc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) sc[a][bb] = 0.f;
  for (int mm = 0; mm < kM; mm += 4) {
    float4 xa[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      xa[a] = *reinterpret_cast<const float4*>(X + (4 * tg + a) * kP + mm);
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      if (bb < nb) {
        const float4 yb =
            *reinterpret_cast<const float4*>(Y + (sg + 16 * bb) * kP + mm);
#pragma unroll
        for (int a = 0; a < 4; ++a) sc[a][bb] = dot4(xa[a], yb, sc[a][bb]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int t = 4 * tg + a, s = sg + 16 * bb;
      out[t * kP + s] = s < t ? sc[a][bb] : 0.f;
    }
}

// ---------------------------------------------------------------------------
//  1: each chunk's q_in^T do and decay
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv_bwd_dstate(const T* __restrict__ r, const float* __restrict__ logw,
                 const float* __restrict__ dout, float* __restrict__ qd,
                 float* __restrict__ dec, int H, int Tn, int M, Strides st) {
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int b = bh / H, h = bh - b * H;
  const int t0 = c * kC, n = min(kC, Tn - t0);

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kC][kP] r, then q_in
  float* d_s = q_s + kC * kP;                      // [kC][kM] do
  float* tot = d_s + kC * kM;                      // [kSeg][kM]

  const int m = threadIdx.x % kM, seg = threadIdx.x / kM;
  float lw[kSegLen];
  seg_logw(lw, logw + b * st.s[W_SB] + h * st.s[W_SH] + t0 * st.s[W_ST],
           st.s[W_ST], n, M, m, seg);
  {
    Staged<T, kM> sr;
    Staged<float, kM> sd;
    sr.load(r + b * st.s[R_SB] + h * st.s[R_SH] + t0 * st.s[R_ST], st.s[R_ST],
            n, M, 0);
    sd.load(dout + b * st.s[DO_SB] + h * st.s[DO_SH] + t0 * st.s[DO_ST],
            st.s[DO_ST], n, M, 0);
    sr.store(q_s, kP);
    sd.store(d_s, kM);
  }
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) part += lw[t];
  tot[seg * kM + m] = part;
  __syncthreads();
  float run = 0.f, last = 0.f;
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    const float x = tot[q * kM + m];
    if (q < seg) run += x;
    last += x;
  }
  float* qc = q_s + seg * kSegLen * kP + m;
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) {
    qc[t * kP] *= expf(run);               // r * exp(cs - logw)
    run += lw[t];
  }
  if (seg == 0) dec[((long long)bh * nc + c) * kM + m] = expf(last);
  __syncthreads();

  // qd[m][j] = sum_t q_in[t][m] do[t][j]
  const Tile<kM> tl;
  float4 acc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < n; ++t) {
    const float4 dd = *reinterpret_cast<const float4*>(d_s + t * kM + 4 * tl.cg);
    float qt[4];
    ld_rows<4>(q_s + t * kP + tl.row(0), qt);
#pragma unroll
    for (int a = 0; a < 4; ++a) fma4(acc[a], qt[a], dd);
  }
  float* out = qd + ((long long)bh * nc + c) * kState + 4 * tl.cg;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(out + tl.row(a) * kM) = acc[a];
}

// ---------------------------------------------------------------------------
//  2: the gradients of the chunk states, from the last chunk back
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
rwkv_bwd_scan(float* __restrict__ qd, const float* __restrict__ dec,
               const float* __restrict__ dst, float* __restrict__ ds0,
               int BH, int H, int nc, int M, Strides st) {
  constexpr int kAhead = 16;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int bh = (int)(idx / kState), e = (int)(idx % kState);
  if (bh >= BH) return;
  const int b = bh / H, h = bh - b * H;
  const int m = e / kM, j = e % kM;
  const bool in = m < M && j < M;
  float G = dst && in ? dst[b * st.s[DST_SB] + h * st.s[DST_SH] + m * M + j]
                      : 0.f;
  float* p = qd + (long long)bh * nc * kState + e;
  const float* a = dec + (long long)bh * nc * kM + m;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kAhead) {
    float d[kAhead], w[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 - i >= 0) {
        d[i] = p[(long long)(c0 - i) * kState];
        w[i] = a[(c0 - i) * kM];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 - i >= 0) {
        p[(long long)(c0 - i) * kState] = G;   // the gradient at chunk end
        G = fmaf(w[i], G, d[i]);
      }
  }
  if (ds0 && in) ds0[b * st.s[DS0_SB] + h * st.s[DS0_SH] + m * M + j] = G;
}

// ---------------------------------------------------------------------------
//  3: each chunk's gradients
// ---------------------------------------------------------------------------
template <typename T>
struct ChunkArgs {
  const T* r;
  const T* k;
  const T* v;
  const float* logw;
  const float* u;
  const float* dout;
  const float* states;   // (B*H, chunks, 64, 64) chunk starts, or null
  const float* s0;       // read when states is null (one chunk); null: 0
  const float* dsend;    // (B*H, chunks, 64, 64) gradients at chunk ends
  T* dr;
  T* dk;
  T* dv;
  float* dlogw;
  float* du_part;        // (B*H, chunks, 64)
  int H, Tn, M;
};

constexpr int kTiles = 9;            // [kC][kP] tiles of rwkv_bwd_chunk
constexpr size_t kChunkSmem =
    sizeof(float) * (kTiles * kC * kP + 3 * kM + 2 * kC + 3 * kSeg * kM);

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv_bwd_chunk(ChunkArgs<T> g, Strides st) {
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int M = g.M;
  const int b = bh / g.H, h = bh - b * g.H;
  const int t0 = c * kC, n = min(kC, g.Tn - t0);

  extern __shared__ float4 smem4[];
  float* QI = reinterpret_cast<float*>(smem4);   // r, then q_in; later Z
  float* KI = QI + kC * kP;                       // k, then k_in
  float* Vs = KI + kC * kP;                       // v [t][j]
  float* DO = Vs + kC * kP;                       // do [t][j]
  float* CS = DO + kC * kP;                       // cs [t][m]
  float* SC = CS + kC * kP;                       // S_c [m][j]
  float* DS = SC + kC * kP;                       // dS' [m][j]
  float* A = DS + kC * kP;                        // scores; later X
  float* P = A + kC * kP;                         // do . v; later Y
  float* u_s = P + kC * kP;                       // [kM]
  float* lastv = u_s + kM;                        // [kM] cs_last
  float* Dm = lastv + kM;                         // [kM] sum_j dS' S_c
  float* bu = Dm + kM;                            // [kC] r . u . k
  float* dd = bu + kC;                            // [kC] v . do
  float* tot = dd + kC;                           // [3][kSeg][kM]

  const T* rb = g.r + b * st.s[R_SB] + h * st.s[R_SH] + t0 * st.s[R_ST];
  const T* kb = g.k + b * st.s[K_SB] + h * st.s[K_SH] + t0 * st.s[K_ST];
  const int m = threadIdx.x % kM, seg = threadIdx.x / kM;
  float lw[kSegLen];
  seg_logw(lw, g.logw + b * st.s[W_SB] + h * st.s[W_SH] + t0 * st.s[W_ST],
           st.s[W_ST], n, M, m, seg);
  {
    Staged<T, kM> sr, sk, sv;
    Staged<float, kM> sd;
    sr.load(rb, st.s[R_ST], n, M, 0);
    sk.load(kb, st.s[K_ST], n, M, 0);
    sv.load(g.v + b * st.s[V_SB] + h * st.s[V_SH] + t0 * st.s[V_ST],
            st.s[V_ST], n, M, 0);
    sd.load(g.dout + b * st.s[DO_SB] + h * st.s[DO_SH] + t0 * st.s[DO_ST],
            st.s[DO_ST], n, M, 0);
    const float uu = threadIdx.x < M ? g.u[h * M + threadIdx.x] : 0.f;
    sr.store(QI, kP);
    sk.store(KI, kP);
    sv.store(Vs, kP);
    sd.store(DO, kP);
    if (threadIdx.x < kM) u_s[threadIdx.x] = uu;
  }
  __syncthreads();

  // the bonus r . u . k and v . do of each row, one warp per row; the
  // segment totals of logw
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < kC; t += kThreads / 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int mm = lane; mm < kM; mm += 32) {
      s1 += QI[t * kP + mm] * u_s[mm] * KI[t * kP + mm];
      s2 += Vs[t * kP + mm] * DO[t * kP + mm];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      bu[t] = s1;
      dd[t] = s2;
    }
  }
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) part += lw[t];
  tot[seg * kM + m] = part;
  __syncthreads();

  // column m over this segment: its part of du from the raw r and k, then
  // q_in, k_in and cs in place
  {
    float run = 0.f, last = 0.f;
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      const float x = tot[q * kM + m];
      if (q < seg) run += x;
      last += x;
    }
    float* qc = QI + seg * kSegLen * kP + m;
    float* kc = KI + seg * kSegLen * kP + m;
    float* cc = CS + seg * kSegLen * kP + m;
    float du = 0.f;
#pragma unroll
    for (int t = 0; t < kSegLen; ++t) {
      const float rq = qc[t * kP], kq = kc[t * kP];
      du = fmaf(rq * kq, dd[seg * kSegLen + t], du);
      qc[t * kP] = rq * expf(run);         // r * exp(cs - logw)
      run += lw[t];
      kc[t * kP] = kq * expf(-run);        // k * exp(-cs)
      cc[t * kP] = run;
    }
    tot[(kSeg + seg) * kM + m] = du;
    if (seg == 0) lastv[m] = last;
  }
  {
    // S_c and the gradient at the chunk's end
    Staged<float, kM> sg;
    sg.load(g.dsend + ((long long)bh * nc + c) * kState, kM, kM, kM, 0);
    if (g.states) {
      Staged<float, kM> ss;
      ss.load(g.states + ((long long)bh * nc + c) * kState, kM, kM, kM, 0);
      ss.store(SC, kP);
    } else {
      for (int i = threadIdx.x; i < kState; i += kThreads) {
        const int mm = i / kM, j = i % kM;
        SC[mm * kP + j] = g.s0 && mm < M && j < M
            ? g.s0[b * st.s[S0_SB] + h * st.s[S0_SH] + mm * M + j] : 0.f;
      }
    }
    sg.store(DS, kP);
  }
  __syncthreads();
  if (threadIdx.x < kM) {
    float s = 0.f;
    for (int q = 0; q < kSeg; ++q) s += tot[(kSeg + q) * kM + threadIdx.x];
    g.du_part[((long long)bh * nc + c) * kM + threadIdx.x] = s;
  }
  for (int i = threadIdx.x; i < kState; i += kThreads) {
    const int mm = i / kM, j = i % kM;
    DS[mm * kP + j] *= expf(lastv[mm]);    // dS' = e^{cs_last} dS
  }
  strict_lower(QI, KI, A);
  strict_lower(DO, Vs, P);
  __syncthreads();
  if (threadIdx.x < kM) {
    float s = 0.f;
    const float* ds = DS + threadIdx.x * kP;
    const float* sc = SC + threadIdx.x * kP;
    for (int j = 0; j < kM; ++j) s = fmaf(ds[j], sc[j], s);
    Dm[threadIdx.x] = s;
  }

  // this thread's rows t0r .. t0r + 3 and columns c0 .. c0 + 3 of
  // dq_in, dk_in, v dS'^T (over m) and dv (over j)
  const Tile<kM> tl;
  const int t0r = tl.row(0), c0 = 4 * tl.cg;
  float4 dq[4], dki[4], dkt[4], dv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    dq[a] = dki[a] = dkt[a] = dv[a] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j = 0; j < kM; j += 4) {        // do S_c^T and v dS'^T
    float4 s4[4], d4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s4[i] = *reinterpret_cast<const float4*>(SC + (c0 + i) * kP + j);
      d4[i] = *reinterpret_cast<const float4*>(DS + (c0 + i) * kP + j);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 x = *reinterpret_cast<const float4*>(DO + (t0r + a) * kP + j);
      const float4 y = *reinterpret_cast<const float4*>(Vs + (t0r + a) * kP + j);
      dq[a].x = dot4(x, s4[0], dq[a].x);
      dq[a].y = dot4(x, s4[1], dq[a].y);
      dq[a].z = dot4(x, s4[2], dq[a].z);
      dq[a].w = dot4(x, s4[3], dq[a].w);
      dkt[a].x = dot4(y, d4[0], dkt[a].x);
      dkt[a].y = dot4(y, d4[1], dkt[a].y);
      dkt[a].z = dot4(y, d4[2], dkt[a].z);
      dkt[a].w = dot4(y, d4[3], dkt[a].w);
    }
  }
  const int s_end = min(n, t0r + 3);       // s < t <= t0r + 3
  for (int s = 0; s < s_end; ++s) {        // P k_in (P is 0 for s >= t)
    const float4 kv = *reinterpret_cast<const float4*>(KI + s * kP + c0);
#pragma unroll
    for (int a = 0; a < 4; ++a) fma4(dq[a], P[(t0r + a) * kP + s], kv);
  }
  for (int i = t0r + 1; i < n; ++i) {      // P^T q_in and A^T do, i > t
    const float4 pv = *reinterpret_cast<const float4*>(P + i * kP + t0r);
    const float4 av = *reinterpret_cast<const float4*>(A + i * kP + t0r);
    const float4 qv = *reinterpret_cast<const float4*>(QI + i * kP + c0);
    const float4 ov = *reinterpret_cast<const float4*>(DO + i * kP + c0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      fma4(dki[a], f4(pv, a), qv);
      fma4(dv[a], f4(av, a), ov);
    }
  }
  for (int mm = 0; mm < kM; ++mm) {        // k_in dS'
    const float4 d4 = *reinterpret_cast<const float4*>(DS + mm * kP + c0);
#pragma unroll
    for (int a = 0; a < 4; ++a) fma4(dv[a], KI[(t0r + a) * kP + mm], d4);
  }

  // dr, dk, dv; then X, Y, Z of the same elements for dlogw
  const float4 uu = *reinterpret_cast<const float4*>(u_s + c0);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0r + a;
    const float4 qi = *reinterpret_cast<const float4*>(QI + t * kP + c0);
    const float4 ki = *reinterpret_cast<const float4*>(KI + t * kP + c0);
    if (t < n) {
      const float4 rr = load4(rb + t * st.s[R_ST] + c0, M - c0);
      const float4 kk = load4(kb + t * st.s[K_ST] + c0, M - c0);
      const float4 cs = *reinterpret_cast<const float4*>(CS + t * kP + c0);
      const float4 cp = t > 0
          ? *reinterpret_cast<const float4*>(CS + (t - 1) * kP + c0)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 ov = *reinterpret_cast<const float4*>(DO + t * kP + c0);
      const float ddt = dd[t], but = bu[t];
      float rv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ui = f4(uu, i);
        rv[i] = fmaf(expf(f4(cp, i)), f4(dq[a], i), ui * f4(kk, i) * ddt);
        kv[i] = fmaf(expf(-f4(cs, i)), f4(dki[a], i) + f4(dkt[a], i),
                     f4(rr, i) * ui * ddt);
        vv[i] = fmaf(but, f4(ov, i), f4(dv[a], i));
      }
      store4t(g.dr + b * st.s[DR_SB] + h * st.s[DR_SH] +
                  (t0 + t) * st.s[DR_ST] + c0,
              make_float4(rv[0], rv[1], rv[2], rv[3]), M - c0);
      store4t(g.dk + b * st.s[DK_SB] + h * st.s[DK_SH] +
                  (t0 + t) * st.s[DK_ST] + c0,
              make_float4(kv[0], kv[1], kv[2], kv[3]), M - c0);
      store4t(g.dv + b * st.s[DV_SB] + h * st.s[DV_SH] +
                  (t0 + t) * st.s[DV_ST] + c0,
              make_float4(vv[0], vv[1], vv[2], vv[3]), M - c0);
    }
    dq[a] = make_float4(qi.x * dq[a].x, qi.y * dq[a].y, qi.z * dq[a].z,
                        qi.w * dq[a].w);                          // X
    dki[a] = make_float4(ki.x * dki[a].x, ki.y * dki[a].y, ki.z * dki[a].z,
                         ki.w * dki[a].w);                        // Y
    dkt[a] = make_float4(ki.x * dkt[a].x, ki.y * dkt[a].y, ki.z * dkt[a].z,
                         ki.w * dkt[a].w);                        // Z
  }
  __syncthreads();                         // A, P and QI are read
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0r + a;
    *reinterpret_cast<float4*>(A + t * kP + c0) = dq[a];
    *reinterpret_cast<float4*>(P + t * kP + c0) = dki[a];
    *reinterpret_cast<float4*>(QI + t * kP + c0) = dkt[a];
  }
  __syncthreads();

  // dlogw down column m, this thread's segment: segment totals first
  float* X = A;
  float* Y = P;
  float* Z = QI;
  {
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int t = 0; t < kSegLen; ++t) {
      const int row = seg * kSegLen + t;
      sx += X[row * kP + m];
      sy += Y[row * kP + m];
      sz += Z[row * kP + m];
    }
    tot[seg * kM + m] = sx;
    tot[(kSeg + seg) * kM + m] = sy;
    tot[(2 * kSeg + seg) * kM + m] = sz;
  }
  __syncthreads();
  float xa = 0.f, ya = 0.f, zb = 0.f;      // X, Y after and Z before
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    if (q > seg) {
      xa += tot[q * kM + m];
      ya += tot[(kSeg + q) * kM + m];
    }
    if (q < seg) zb += tot[(2 * kSeg + q) * kM + m];
  }
  float zpre[kSegLen];
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) {
    zpre[t] = zb;
    zb += Z[(seg * kSegLen + t) * kP + m];
  }
  const float dm = Dm[m];
  float* dw = g.dlogw + b * st.s[DW_SB] + h * st.s[DW_SH] + m;
#pragma unroll
  for (int t = kSegLen - 1; t >= 0; --t) {
    const int row = seg * kSegLen + t;
    ya += Y[row * kP + m];                 // sum_{i >= t} Y_i
    if (row < n && m < M)
      dw[(t0 + row) * st.s[DW_ST]] = xa - ya + zpre[t] + dm;
    xa += X[row * kP + m];                 // sum_{i > t - 1} X_i
  }
}

// ---------------------------------------------------------------------------
//  bf16: 1 and 3 on the tensor cores, mma.sync.m16n8k16 in split bf16
// ---------------------------------------------------------------------------
// An operand x is taken as hi + lo, both bf16 (hi = x rounded, lo = the
// rest rounded: 16 of float32's 24 significant bits), and a product as
// lo_a hi_b + hi_a lo_b + hi_a hi_b with float32 accumulators; the lo lo
// term and lo's own rounding leave about 2^-16 of each product
// (tests/test_torch_grad_kernels.py emulates it).  An operand staged from
// bf16 (v) is exact in hi, and its lo term is skipped.  Each operand is
// split once, as it is staged into shared memory as a pair of bf16 tiles
// (hi, lo) in the XOR-swizzled layout of mma_sync.cuh, and its fragments
// come from ldmatrix (.trans where the tile's rows run along k).
using bf16 = __nv_bfloat16;

struct Bf {
  unsigned h, l;
};
__device__ __forceinline__ Bf bf(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  return {*reinterpret_cast<const unsigned*>(&h),
          *reinterpret_cast<const unsigned*>(&l)};
}
// c (16 x 8) += a (16 x 16) b (16 x 8) in split bf16; LA / LB: a / b has a
// lo part (al / bl, else unused).  a: mma.sync's A fragment (4 registers),
// b: its B fragment (2).
template <bool LA, bool LB>
__device__ __forceinline__ void mma3(float* c, const unsigned* ah,
                                     const unsigned* al, const unsigned* bh,
                                     const unsigned* bl) {
  if (LA) mma16816(c, al, bh[0], bh[1]);
  if (LB) mma16816(c, ah, bl[0], bl[1]);
  mma16816(c, ah, bh[0], bh[1]);
}
// The A fragment of rows r0 .., k k0 .. (16 each) of a swizzled tile of
// CPR chunks a row, stored [row][k] (ld_a) or [k][row] (ld_a_t).
template <int CPR>
__device__ __forceinline__ void ld_a(unsigned* a, const bf16* t, int r0,
                                     int k0, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
  ldsm_x4(a, t + swz<CPR>(r0 + (mi & 1) * 8 + mr, k0 / 8 + (mi >> 1)));
}
template <int CPR>
__device__ __forceinline__ void ld_a_t(unsigned* a, const bf16* t, int r0,
                                       int k0, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
  ldsm_x4_t(a, t + swz<CPR>(k0 + (mi >> 1) * 8 + mr, r0 / 8 + (mi & 1)));
}
// The B fragments of columns n0 .. n0 + 15 (b[0..1] the n-tile n0, b[2..3]
// n0 + 8), k k0 .., of a tile stored [n][k] (ld_b) or [k][n] (ld_b_t).
template <int CPR>
__device__ __forceinline__ void ld_b(unsigned* b, const bf16* t, int n0,
                                     int k0, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
  ldsm_x4(b, t + swz<CPR>(n0 + (mi >> 1) * 8 + mr, k0 / 8 + (mi & 1)));
}
template <int CPR>
__device__ __forceinline__ void ld_b_t(unsigned* b, const bf16* t, int n0,
                                       int k0, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
  ldsm_x4_t(b, t + swz<CPR>(k0 + (mi & 1) * 8 + mr, n0 / 8 + (mi >> 1)));
}
// Four floats at (row, col) (col a multiple of 4) of a pair of swizzled
// tiles, split into hi and lo; one float (put1).
template <int CPR>
__device__ __forceinline__ void put4(bf16* hi, bf16* lo, int row, int col,
                                     float4 v) {
  const int o = swz<CPR>(row, col >> 3) + (col & 7);
  const Bf x = bf(v.x, v.y), y = bf(v.z, v.w);
  *reinterpret_cast<uint2*>(hi + o) = make_uint2(x.h, y.h);
  *reinterpret_cast<uint2*>(lo + o) = make_uint2(x.l, y.l);
}
template <int CPR>
__device__ __forceinline__ void put1(bf16* hi, bf16* lo, int row, int col,
                                     float x) {
  const int o = swz<CPR>(row, col >> 3) + (col & 7);
  const bf16 h = __float2bfloat16_rn(x);
  hi[o] = h;
  lo[o] = __float2bfloat16_rn(x - __bfloat162float(h));
}
__device__ __forceinline__ float4 scale4(float4 v, float a) {
  return make_float4(v.x * a, v.y * a, v.z * a, v.w * a);
}
// The sum over the 16 lanes (of a half warp) that hold one row
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 1 on the tensor cores: one block per (chunk, b*H + h); q_in (formed in
// float32 as in rwkv_bwd_dstate) and do staged as split bf16 tiles; warp w
// owns rows 16 (w % 4) .. and columns 32 (w / 4) .. of the 64 x 64
// product q_in^T do.
constexpr size_t kDstateTcSmem =
    sizeof(float) * (kC * kP + kSeg * kM) + 4 * sizeof(bf16) * kC * kM;

__global__ void __launch_bounds__(kThreads)
rwkv_bwd_dstate_tc(const bf16* __restrict__ r, const float* __restrict__ logw,
                   const float* __restrict__ dout, float* __restrict__ qd,
                   float* __restrict__ dec, int H, int Tn, int M,
                   Strides st) {
  constexpr int Q64 = kM / 4;
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int b = bh / H, h = bh - b * H;
  const int t0 = c * kC, n = min(kC, Tn - t0);

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kC][kP] r, then q_in
  float* tot = q_s + kC * kP;                      // [kSeg][kM]
  bf16* QIh = reinterpret_cast<bf16*>(tot + kSeg * kM);   // q_in [t][m]
  bf16* QIl = QIh + kC * kM;
  bf16* DOh = QIl + kC * kM;                              // do [t][j]
  bf16* DOl = DOh + kC * kM;

  const int m = threadIdx.x % kM, seg = threadIdx.x / kM;
  float lw[kSegLen];
  seg_logw(lw, logw + b * st.s[W_SB] + h * st.s[W_SH] + t0 * st.s[W_ST],
           st.s[W_ST], n, M, m, seg);
  {
    Staged<bf16, kM> sr;
    Staged<float, kM> sd;
    sr.load(r + b * st.s[R_SB] + h * st.s[R_SH] + t0 * st.s[R_ST], st.s[R_ST],
            n, M, 0);
    sd.load(dout + b * st.s[DO_SB] + h * st.s[DO_SH] + t0 * st.s[DO_ST],
            st.s[DO_ST], n, M, 0);
    sr.store(q_s, kP);
#pragma unroll
    for (int j = 0; j < Staged<float, kM>::N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      put4<kM / 8>(DOh, DOl, i / Q64, (i % Q64) * 4, sd.v[j]);
    }
  }
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) part += lw[t];
  tot[seg * kM + m] = part;
  __syncthreads();
  float run = 0.f, last = 0.f;
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    const float x = tot[q * kM + m];
    if (q < seg) run += x;
    last += x;
  }
  float* qc = q_s + seg * kSegLen * kP + m;
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) {
    qc[t * kP] *= __expf(run);             // r * exp(cs - logw)
    run += lw[t];
  }
  if (seg == 0) dec[((long long)bh * nc + c) * kM + m] = expf(last);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kC * Q64 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int row = i / Q64, col = (i % Q64) * 4;
    put4<kM / 8>(QIh, QIl, row, col,
                 *reinterpret_cast<const float4*>(q_s + row * kP + col));
  }
  __syncthreads();

  // qd[m][j] = sum_t q_in[t][m] do[t][j]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float acc[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk) {
    unsigned ah[4], al[4];
    ld_a_t<kM / 8>(ah, QIh, r0, 16 * kk, lane);
    ld_a_t<kM / 8>(al, QIl, r0, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned bh_[4], bl_[4];
      ld_b_t<kM / 8>(bh_, DOh, n0 + 16 * np, 16 * kk, lane);
      ld_b_t<kM / 8>(bl_, DOl, n0 + 16 * np, 16 * kk, lane);
      mma3<true, true>(acc[2 * np], ah, al, bh_, bl_);
      mma3<true, true>(acc[2 * np + 1], ah, al, bh_ + 2, bl_ + 2);
    }
  }
  float* out = qd + ((long long)bh * nc + c) * kState;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(out + (r0 + gq + 8 * hh) * kM + n0 + 8 * nt +
                                 2 * t4) =
          make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
}

// 3 on the tensor cores: two blocks per (chunk, b*H + h), blockIdx.x =
// part: 0 owns the channels (dr, dk, dlogw and du), 1 the values (dv).
// Every sum stays in one block.  Warp w owns rows 16 (w % 4) .. of the
// chunk and half (w / 4) of its part's 64 output columns.  The block's 64
// x 64 score tile (P in the channel part, A in the value part) is
// computed once, each warp a 16 x 32 piece left of the diagonal, and kept
// as split bf16 tiles, from which ldmatrix reads it straight or
// transposed (P^T, A^T).  Shared memory is reused as the products move
// on: P goes over do, q_in and k_in over S_c and dS', dlogw's column sums
// over v and all of those.
constexpr int kPX = kM + 1;          // dlogw's column sums
constexpr size_t kChanF32 =          // cs; u, Dm, dd, column sums
    sizeof(float) * (kC * kP + 3 * kM + 3 * kSeg * kM);
constexpr size_t kChanSmem =         // r, k, v; do, S_c, dS' (2 each)
    kChanF32 + sizeof(bf16) * 9 * kC * kM;
constexpr size_t kValF32 = sizeof(float) * (kC * kP + kM + kC + kSeg * kM);
constexpr size_t kValSmem =          // q_in, k_in, A, dS', do (2 each)
    kValF32 + sizeof(bf16) * 10 * kC * kM;
constexpr size_t kChunkTcSmem = kChanSmem > kValSmem ? kChanSmem : kValSmem;
static_assert(kChanF32 % 16 == 0 && kValF32 % 16 == 0, "tile alignment");
static_assert(3 * kC * kPX * sizeof(float) <= sizeof(bf16) * 7 * kC * kM,
              "dlogw's sums fit over the product tiles");

// The first n of two floats into bf16 at p
__device__ __forceinline__ void st2(bf16* p, float x, float y, int n) {
  if (n > 1 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    if (n > 0) p[0] = __float2bfloat16(x);
    if (n > 1) p[1] = __float2bfloat16(y);
  }
}

// part 0: the channels
__device__ __forceinline__ void chunk_channels(const ChunkArgs<bf16>& g,
                                               const Strides& st,
                                               uint8_t* sm, int c, int bh,
                                               int nc) {
  constexpr int Q64 = kM / 4;                     // float4 chunks a row
  constexpr int CPR = kM / 8;
  const int M = g.M;
  const int b = bh / g.H, h = bh - b * g.H;
  const int t0 = c * kC, n = min(kC, g.Tn - t0);
  float* CF = reinterpret_cast<float*>(sm);       // cs [t][m]
  float* u_s = CF + kC * kP;                      // [kM]
  float* Dm = u_s + kM;                           // [kM] sum_j dS' S_c
  float* dd = Dm + kM;                            // [kC] v . do
  float* tot = dd + kC;                           // [3][kSeg][kM]
  bf16* Rh = reinterpret_cast<bf16*>(sm + kChanF32);      // r [t][m]
  bf16* Kh = Rh + kC * kM;                                // k [t][m]
  bf16* Vh = Kh + kC * kM;                   // v [t][j]; last X, Y, Z
  bf16* DOh = Vh + kC * kM;                  // do [t][j]; then P [t][s]
  bf16* DOl = DOh + kC * kM;
  bf16* SCh = DOl + kC * kM;                 // S_c [m][j]; then q_in [t][m]
  bf16* SCl = SCh + kM * kM;
  bf16* DSh = SCl + kM * kM;                 // dS' [m][j]; then k_in [s][m]
  bf16* DSl = DSh + kM * kM;
  float* X = reinterpret_cast<float*>(Vh);   // last: [t][m] column sums
  float* Y = X + kC * kPX;
  float* Z = Y + kC * kPX;

  const int tid = threadIdx.x;
  const int m = tid % kM, seg = tid / kM;
  float lw[kSegLen];
  float4 ds4[4];
  seg_logw(lw, g.logw + b * st.s[W_SB] + h * st.s[W_SH] + t0 * st.s[W_ST],
           st.s[W_ST], n, M, m, seg);
  {
    Staged<bf16, kM> sv, sr, sk;
    Staged<float, kM> sd;
    sd.load(g.dout + b * st.s[DO_SB] + h * st.s[DO_SH] + t0 * st.s[DO_ST],
            st.s[DO_ST], n, M, 0);
    sv.load(g.v + b * st.s[V_SB] + h * st.s[V_SH] + t0 * st.s[V_ST],
            st.s[V_ST], n, M, 0);
    sr.load(g.r + b * st.s[R_SB] + h * st.s[R_SH] + t0 * st.s[R_ST],
            st.s[R_ST], n, M, 0);
    sk.load(g.k + b * st.s[K_SB] + h * st.s[K_SH] + t0 * st.s[K_ST],
            st.s[K_ST], n, M, 0);
    const float uu = tid < M ? g.u[h * M + tid] : 0.f;
    // S_c and the gradient at the chunk's end
    const float* send = g.dsend + ((long long)bh * nc + c) * kState;
    float4 sc4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      ds4[i] = reinterpret_cast<const float4*>(send)[e];
      if (g.states) {
        sc4[i] = reinterpret_cast<const float4*>(
            g.states + ((long long)bh * nc + c) * kState)[e];
      } else {
        const int mm = e / Q64, j = (e % Q64) * 4;
        float v4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v4[q] = g.s0 && mm < M && j + q < M
                      ? g.s0[b * st.s[S0_SB] + h * st.s[S0_SH] + mm * M + j +
                             q]
                      : 0.f;
        sc4[i] = make_float4(v4[0], v4[1], v4[2], v4[3]);
      }
    }
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < kSegLen; ++t) part += lw[t];
    tot[seg * kM + m] = part;
    if (tid < kM) u_s[tid] = uu;
    // do (split), v, r and k (exact) tiles; v . do of each row from the
    // staged registers (a row's 16 chunks lie in 16 lanes of a half warp)
#pragma unroll
    for (int j = 0; j < Staged<float, kM>::N; ++j) {
      const int i = tid + j * kThreads;
      const int row = i / Q64, col = (i % Q64) * 4;
      const int o = swz<CPR>(row, col >> 3) + (col & 7);
      put4<CPR>(DOh, DOl, row, col, sd.v[j]);
      *reinterpret_cast<uint2*>(Vh + o) = sv.v[j];
      *reinterpret_cast<uint2*>(Rh + o) = sr.v[j];
      *reinterpret_cast<uint2*>(Kh + o) = sk.v[j];
      const float s2 = sum16(dot4(sd.v[j], unpack(sv.v[j]), 0.f));
      if ((tid & 15) == 0) dd[row] = s2;
    }
    // S_c (split); sum_j dS S_c of each row (16 lanes), scaled below
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      put4<CPR>(SCh, SCl, e / Q64, (e % Q64) * 4, sc4[i]);
      const float s2 = sum16(dot4(ds4[i], sc4[i], 0.f));
      if ((tid & 15) == 0) Dm[e / Q64] = s2;
    }
  }
  __syncthreads();

  // dS' = e^{cs_last} dS on the rows this thread holds (split); column m
  // over its segment: cs and its part of du
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = tid + i * kThreads;
    const int mm = e / Q64;
    float last = 0.f;
#pragma unroll
    for (int q = 0; q < kSeg; ++q) last += tot[q * kM + mm];
    put4<CPR>(DSh, DSl, mm, (e % Q64) * 4, scale4(ds4[i], __expf(last)));
  }
  {
    float run = 0.f;
#pragma unroll
    for (int q = 0; q < kSeg; ++q)
      if (q < seg) run += tot[q * kM + m];
    float du = 0.f;
#pragma unroll
    for (int t = 0; t < kSegLen; ++t) {
      const int row = seg * kSegLen + t;
      const int o = swz<CPR>(row, m >> 3) + (m & 7);
      du = fmaf(__bfloat162float(Rh[o]) * __bfloat162float(Kh[o]), dd[row],
                du);
      run += lw[t];
      CF[row * kP + m] = run;
    }
    tot[(kSeg + seg) * kM + m] = du;
  }
  __syncthreads();
  if (tid < kM) {
    float s = 0.f, last = 0.f;
    for (int q = 0; q < kSeg; ++q) {
      s += tot[(kSeg + q) * kM + tid];
      last += tot[q * kM + tid];
    }
    g.du_part[((long long)bh * nc + c) * kM + tid] = s;
    Dm[tid] *= __expf(last);
  }

  // warp: rows i = r0 + gq (+ 8), output columns mc0 + 8 nn + 2 t4 (+ 1)
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int rw = warp & 3, r0 = 16 * rw, mc0 = 32 * (warp >> 2);
  float dq[4][4] = {}, dki[4][4] = {}, dkt[4][4] = {};
  // P = strict_lower(do v^T), once: warp w its rows r0 .. and columns
  // mc0 .. (the n-tiles left of the diagonal); dq = do S_c^T and dkt = v
  // dS'^T on its output columns
  float p[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kM / 16; ++kk) {
    unsigned ah[4], al[4], av[4], bh_[4], bl_[4];
    ld_a<CPR>(ah, DOh, r0, 16 * kk, lane);
    ld_a<CPR>(al, DOl, r0, 16 * kk, lane);
    ld_a<CPR>(av, Vh, r0, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int n0 = mc0 + 16 * np;
      if (n0 < r0 + 16) {
        ld_b<CPR>(bh_, Vh, n0, 16 * kk, lane);
        mma3<true, false>(p[2 * np], ah, al, bh_, nullptr);
        mma3<true, false>(p[2 * np + 1], ah, al, bh_ + 2, nullptr);
      }
      ld_b<CPR>(bh_, SCh, n0, 16 * kk, lane);
      ld_b<CPR>(bl_, SCl, n0, 16 * kk, lane);
      mma3<true, true>(dq[2 * np], ah, al, bh_, bl_);
      mma3<true, true>(dq[2 * np + 1], ah, al, bh_ + 2, bl_ + 2);
      ld_b<CPR>(bh_, DSh, n0, 16 * kk, lane);
      ld_b<CPR>(bl_, DSl, n0, 16 * kk, lane);
      mma3<false, true>(dkt[2 * np], av, nullptr, bh_, bl_);
      mma3<false, true>(dkt[2 * np + 1], av, nullptr, bh_ + 2, bl_ + 2);
    }
  }
  __syncthreads();       // do, S_c, dS' are read: P, q_in, k_in go over them
  bf16* Ph = DOh;
  bf16* Pl = DOl;
  bf16* QIh = SCh;
  bf16* QIl = SCl;
  bf16* KIh = DSh;
  bf16* KIl = DSl;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = r0 + gq + 8 * hh, s = mc0 + 8 * nt + 2 * t4;
      const Bf x = bf(s < i ? p[nt][2 * hh] : 0.f,
                      s + 1 < i ? p[nt][2 * hh + 1] : 0.f);
      const int o = swz<CPR>(i, s >> 3) + (s & 7);
      *reinterpret_cast<unsigned*>(Ph + o) = x.h;
      *reinterpret_cast<unsigned*>(Pl + o) = x.l;
    }
  // q_in = r e^{cs_prev}, k_in = k e^{-cs}, split
#pragma unroll
  for (int j = 0; j < kC * Q64 / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int row = i / Q64, col = (i % Q64) * 4;
    const int o = swz<CPR>(row, col >> 3) + (col & 7);
    const float4 r4 = unpack(*reinterpret_cast<const uint2*>(Rh + o));
    const float4 k4 = unpack(*reinterpret_cast<const uint2*>(Kh + o));
    const float4 cs = *reinterpret_cast<const float4*>(CF + row * kP + col);
    const float4 cp = row > 0
        ? *reinterpret_cast<const float4*>(CF + (row - 1) * kP + col)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    put4<CPR>(QIh, QIl, row, col,
              make_float4(r4.x * __expf(cp.x), r4.y * __expf(cp.y),
                          r4.z * __expf(cp.z), r4.w * __expf(cp.w)));
    put4<CPR>(KIh, KIl, row, col,
              make_float4(k4.x * __expf(-cs.x), k4.y * __expf(-cs.y),
                          k4.z * __expf(-cs.z), k4.w * __expf(-cs.w)));
  }
  __syncthreads();
  // dq += P k_in (s < r0 + 16) and dk_in = P^T q_in (t >= r0), P's
  // fragments straight and transposed from its tiles
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned ah[4], al[4], bh_[4], bl_[4];
    if (kk <= rw) {
      ld_a<CPR>(ah, Ph, r0, 16 * kk, lane);
      ld_a<CPR>(al, Pl, r0, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ld_b_t<CPR>(bh_, KIh, mc0 + 16 * np, 16 * kk, lane);
        ld_b_t<CPR>(bl_, KIl, mc0 + 16 * np, 16 * kk, lane);
        mma3<true, true>(dq[2 * np], ah, al, bh_, bl_);
        mma3<true, true>(dq[2 * np + 1], ah, al, bh_ + 2, bl_ + 2);
      }
    }
    if (kk >= rw) {
      ld_a_t<CPR>(ah, Ph, r0, 16 * kk, lane);
      ld_a_t<CPR>(al, Pl, r0, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ld_b_t<CPR>(bh_, QIh, mc0 + 16 * np, 16 * kk, lane);
        ld_b_t<CPR>(bl_, QIl, mc0 + 16 * np, 16 * kk, lane);
        mma3<true, true>(dki[2 * np], ah, al, bh_, bl_);
        mma3<true, true>(dki[2 * np + 1], ah, al, bh_ + 2, bl_ + 2);
      }
    }
  }

  // dr, dk; then X = q_in dq_in, Y = k_in dk_in, Z = k_in (v dS'^T)
  float xs[4][4], ys[4][4], zs[4][4];
#pragma unroll
  for (int nn = 0; nn < 4; ++nn)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = r0 + gq + 8 * hh, cc = mc0 + 8 * nn + 2 * t4;
      const int o = swz<CPR>(i, cc >> 3) + (cc & 7);
      const float2 r2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Rh + o));
      const float2 k2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Kh + o));
      const float ddi = dd[i];
      float dr2[2], dk2[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = 2 * hh + q, col = cc + q;
        const float rv = q ? r2.y : r2.x, kv = q ? k2.y : k2.x;
        const float ep = __expf(i > 0 ? CF[(i - 1) * kP + col] : 0.f);
        const float em = __expf(-CF[i * kP + col]);
        const float uu = u_s[col];
        dr2[q] = fmaf(ep, dq[nn][e], uu * kv * ddi);
        dk2[q] = fmaf(em, dki[nn][e] + dkt[nn][e], rv * uu * ddi);
        xs[nn][e] = rv * ep * dq[nn][e];
        ys[nn][e] = kv * em * dki[nn][e];
        zs[nn][e] = kv * em * dkt[nn][e];
      }
      if (i < n) {
        st2(g.dr + b * st.s[DR_SB] + h * st.s[DR_SH] +
                (t0 + i) * st.s[DR_ST] + cc, dr2[0], dr2[1], M - cc);
        st2(g.dk + b * st.s[DK_SB] + h * st.s[DK_SH] +
                (t0 + i) * st.s[DK_ST] + cc, dk2[0], dk2[1], M - cc);
      }
    }
  __syncthreads();                          // the product tiles are read
#pragma unroll
  for (int nn = 0; nn < 4; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + gq + 8 * (e >> 1);
      const int col = mc0 + 8 * nn + 2 * t4 + (e & 1);
      X[i * kPX + col] = xs[nn][e];
      Y[i * kPX + col] = ys[nn][e];
      Z[i * kPX + col] = zs[nn][e];
    }
  __syncthreads();

  // dlogw down column m, this thread's segment: segment totals first
  {
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int t = 0; t < kSegLen; ++t) {
      const int row = seg * kSegLen + t;
      sx += X[row * kPX + m];
      sy += Y[row * kPX + m];
      sz += Z[row * kPX + m];
    }
    tot[seg * kM + m] = sx;
    tot[(kSeg + seg) * kM + m] = sy;
    tot[(2 * kSeg + seg) * kM + m] = sz;
  }
  __syncthreads();
  float xa = 0.f, ya = 0.f, zb = 0.f;       // X, Y after and Z before
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    if (q > seg) {
      xa += tot[q * kM + m];
      ya += tot[(kSeg + q) * kM + m];
    }
    if (q < seg) zb += tot[(2 * kSeg + q) * kM + m];
  }
  float zpre[kSegLen];
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) {
    zpre[t] = zb;
    zb += Z[(seg * kSegLen + t) * kPX + m];
  }
  const float dm = Dm[m];
  float* dw = g.dlogw + b * st.s[DW_SB] + h * st.s[DW_SH] + m;
#pragma unroll
  for (int t = kSegLen - 1; t >= 0; --t) {
    const int row = seg * kSegLen + t;
    ya += Y[row * kPX + m];                  // sum_{i >= t} Y_i
    if (row < n && m < M)
      dw[(t0 + row) * st.s[DW_ST]] = xa - ya + zpre[t] + dm;
    xa += X[row * kPX + m];                  // sum_{i > t - 1} X_i
  }
}

// part 1: dv, all its columns
__device__ __forceinline__ void chunk_values(const ChunkArgs<bf16>& g,
                                             const Strides& st, uint8_t* sm,
                                             int c, int bh, int nc) {
  constexpr int Q64 = kM / 4;
  const int M = g.M;
  const int b = bh / g.H, h = bh - b * g.H;
  const int t0 = c * kC, n = min(kC, g.Tn - t0);
  float* DOF = reinterpret_cast<float*>(sm);      // do [t][j], float32
  float* u_s = DOF + kC * kP;                     // [kM]
  float* bu = u_s + kM;                           // [kC] r . u . k
  float* tot = bu + kC;                           // [kSeg][kM]
  bf16* QIh = reinterpret_cast<bf16*>(sm + kValF32);      // q_in [t][m]
  bf16* QIl = QIh + kC * kM;
  bf16* KIh = QIl + kC * kM;                              // k_in [s][m]
  bf16* KIl = KIh + kC * kM;
  bf16* DSh = KIl + kC * kM;                              // dS' [m][j]
  bf16* DSl = DSh + kM * kM;
  bf16* DOh = DSl + kM * kM;                              // do [t][j]
  bf16* DOl = DOh + kC * kM;
  bf16* Ah = DOl + kC * kM;                               // A [t][s]
  bf16* Al = Ah + kC * kC;

  const int tid = threadIdx.x;
  const int m = tid % kM, seg = tid / kM;
  float lw[kSegLen];
  float4 ds4[4];
  seg_logw(lw, g.logw + b * st.s[W_SB] + h * st.s[W_SH] + t0 * st.s[W_ST],
           st.s[W_ST], n, M, m, seg);
  {
    Staged<bf16, kM> sr, sk;
    Staged<float, kM> sd;
    sr.load(g.r + b * st.s[R_SB] + h * st.s[R_SH] + t0 * st.s[R_ST],
            st.s[R_ST], n, M, 0);
    sk.load(g.k + b * st.s[K_SB] + h * st.s[K_SH] + t0 * st.s[K_ST],
            st.s[K_ST], n, M, 0);
    sd.load(g.dout + b * st.s[DO_SB] + h * st.s[DO_SH] + t0 * st.s[DO_ST],
            st.s[DO_ST], n, M, 0);
    const float uu = tid < M ? g.u[h * M + tid] : 0.f;
    // the gradient at the chunk's end
    const float* send = g.dsend + ((long long)bh * nc + c) * kState;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ds4[i] = reinterpret_cast<const float4*>(send)[tid + i * kThreads];
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < kSegLen; ++t) part += lw[t];
    tot[seg * kM + m] = part;
    if (tid < kM) u_s[tid] = uu;
    // r . u . k of each row from the staged registers (16 lanes a row)
#pragma unroll
    for (int j = 0; j < Staged<bf16, kM>::N; ++j) {
      const int i = tid + j * kThreads;
      const int row = i / Q64, col = (i % Q64) * 4;
      const float4 r4 = unpack(sr.v[j]), k4 = unpack(sk.v[j]);
      float uk = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < M)
          uk = fmaf(f4(r4, q) * g.u[h * M + col + q], f4(k4, q), uk);
      const float s1 = sum16(uk);
      if ((tid & 15) == 0) bu[row] = s1;
    }
    // raw r and k (exact in bf16) into the hi tiles, for the column pass
#pragma unroll
    for (int j = 0; j < Staged<bf16, kM>::N; ++j) {
      const int i = tid + j * kThreads;
      const int row = i / Q64, col = (i % Q64) * 4;
      const int o = swz<kM / 8>(row, col >> 3) + (col & 7);
      *reinterpret_cast<uint2*>(QIh + o) = sr.v[j];
      *reinterpret_cast<uint2*>(KIh + o) = sk.v[j];
    }
    sd.store(DOF, kP);
#pragma unroll
    for (int j = 0; j < Staged<float, kM>::N; ++j) {
      const int i = tid + j * kThreads;
      put4<kM / 8>(DOh, DOl, i / Q64, (i % Q64) * 4, sd.v[j]);
    }
  }
  __syncthreads();

  // dS' = e^{cs_last} dS on the rows this thread holds (split); column m
  // over its segment: q_in and k_in (split)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = tid + i * kThreads;
    const int mm = e / Q64;
    float last = 0.f;
#pragma unroll
    for (int q = 0; q < kSeg; ++q) last += tot[q * kM + mm];
    put4<kM / 8>(DSh, DSl, mm, (e % Q64) * 4, scale4(ds4[i], __expf(last)));
  }
  {
    float run = 0.f;
#pragma unroll
    for (int q = 0; q < kSeg; ++q)
      if (q < seg) run += tot[q * kM + m];
#pragma unroll
    for (int t = 0; t < kSegLen; ++t) {
      const int row = seg * kSegLen + t;
      const int o = swz<kM / 8>(row, m >> 3) + (m & 7);
      const float rv = __bfloat162float(QIh[o]);
      const float kv = __bfloat162float(KIh[o]);
      put1<kM / 8>(QIh, QIl, row, m, rv * __expf(run));   // r exp(cs - logw)
      run += lw[t];
      put1<kM / 8>(KIh, KIl, row, m, kv * __expf(-run));  // k exp(-cs)
    }
  }
  __syncthreads();

  // warp: rows s = r0 + gq (+ 8), columns jc0 + 8 nn + 2 t4 (+ 1), nn < 4
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int rw = warp & 3, r0 = 16 * rw, jc0 = 32 * (warp >> 2);
  // A = strict_lower(q_in k_in^T), once: warp w its rows r0 .. and
  // columns 32 (w / 4) .. (the n-tiles left of the diagonal), into its
  // tiles, split
  const int pc0 = 32 * (warp >> 2);
  {
    float a4[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk) {
      unsigned ah[4], al[4], bh_[4], bl_[4];
      ld_a<kM / 8>(ah, QIh, r0, 16 * kk, lane);
      ld_a<kM / 8>(al, QIl, r0, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        if (pc0 + 16 * np < r0 + 16) {
          ld_b<kM / 8>(bh_, KIh, pc0 + 16 * np, 16 * kk, lane);
          ld_b<kM / 8>(bl_, KIl, pc0 + 16 * np, 16 * kk, lane);
          mma3<true, true>(a4[2 * np], ah, al, bh_, bl_);
          mma3<true, true>(a4[2 * np + 1], ah, al, bh_ + 2, bl_ + 2);
        }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = r0 + gq + 8 * hh, s2 = pc0 + 8 * nt + 2 * t4;
        const Bf x = bf(s2 < t ? a4[nt][2 * hh] : 0.f,
                        s2 + 1 < t ? a4[nt][2 * hh + 1] : 0.f);
        const int o = swz<kM / 8>(t, s2 >> 3) + (s2 & 7);
        *reinterpret_cast<unsigned*>(Ah + o) = x.h;
        *reinterpret_cast<unsigned*>(Al + o) = x.l;
      }
  }
  __syncthreads();
  // dv = k_in dS' + A^T do (t > s: t >= r0), A^T's fragments transposed
  // from A's tiles
  float dv[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kM / 16; ++kk) {
    unsigned ah[4], al[4], bh_[4], bl_[4];
    ld_a<kM / 8>(ah, KIh, r0, 16 * kk, lane);
    ld_a<kM / 8>(al, KIl, r0, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      ld_b_t<kM / 8>(bh_, DSh, jc0 + 16 * np, 16 * kk, lane);
      ld_b_t<kM / 8>(bl_, DSl, jc0 + 16 * np, 16 * kk, lane);
      mma3<true, true>(dv[2 * np], ah, al, bh_, bl_);
      mma3<true, true>(dv[2 * np + 1], ah, al, bh_ + 2, bl_ + 2);
    }
    if (kk >= rw) {
      ld_a_t<kM / 8>(ah, Ah, r0, 16 * kk, lane);
      ld_a_t<kM / 8>(al, Al, r0, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ld_b_t<kM / 8>(bh_, DOh, jc0 + 16 * np, 16 * kk, lane);
        ld_b_t<kM / 8>(bl_, DOl, jc0 + 16 * np, 16 * kk, lane);
        mma3<true, true>(dv[2 * np], ah, al, bh_, bl_);
        mma3<true, true>(dv[2 * np + 1], ah, al, bh_ + 2, bl_ + 2);
      }
    }
  }
#pragma unroll
  for (int nn = 0; nn < 4; ++nn)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = r0 + gq + 8 * hh, cc = jc0 + 8 * nn + 2 * t4;
      if (s < n) {
        const float bs = bu[s];
        st2(g.dv + b * st.s[DV_SB] + h * st.s[DV_SH] + (t0 + s) * st.s[DV_ST] +
                cc,
            fmaf(bs, DOF[s * kP + cc], dv[nn][2 * hh]),
            fmaf(bs, DOF[s * kP + cc + 1], dv[nn][2 * hh + 1]), M - cc);
      }
    }
}

__global__ void __launch_bounds__(kThreads, 2)
rwkv_bwd_chunk_tc(ChunkArgs<bf16> g, Strides st) {
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  const int c = blockIdx.y, bh = blockIdx.z;
  if (blockIdx.x == 0)
    chunk_channels(g, st, sm, c, bh, gridDim.y);
  else
    chunk_values(g, st, sm, c, bh, gridDim.y);
}

// ---------------------------------------------------------------------------
//  4: du, summed over b and the chunks
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
rwkv_bwd_du(const float* __restrict__ part, float* __restrict__ du, int B,
            int H, int nc, int M) {
  const int i = blockIdx.x * kThreads + threadIdx.x;   // h * M + m
  if (i >= H * M) return;
  const int h = i / M, m = i - h * M;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c)
      s += part[((long long)(b * H + h) * nc + c) * kM + m];
  du[i] = s;
}

template <typename T>
int launch(const ChunkArgs<T>& g, const float* dst, float* ds0, float* dec,
           float* dsend, int B, const Strides& st, cudaStream_t stream) {
  static unsigned done_ds = 0, done_ch = 0;
  const size_t smem_ds = sizeof(float) *
      ((size_t)kC * kP + (size_t)kC * kM + (size_t)kSeg * kM);
  cudaError_t err = smem_once((const void*)rwkv_bwd_dstate<T>, smem_ds,
                              &done_ds);
  if (err == cudaSuccess)
    err = smem_once((const void*)rwkv_bwd_chunk<T>, kChunkSmem, &done_ch);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * g.H, nc = (g.Tn + kC - 1) / kC;
  const dim3 grid(nc, BH);
  rwkv_bwd_dstate<T><<<grid, kThreads, smem_ds, stream>>>(
      g.r, g.logw, g.dout, dsend, dec, g.H, g.Tn, g.M, st);
  const long long threads = (long long)BH * kState;
  rwkv_bwd_scan<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads,
                   0, stream>>>(dsend, dec, dst, ds0, BH, g.H, nc, g.M, st);
  rwkv_bwd_chunk<T><<<grid, kThreads, kChunkSmem, stream>>>(g, st);
  return (int)cudaGetLastError();
}

// 1, 2 and 3 for bf16 on the tensor cores
int launch_tc(const ChunkArgs<__nv_bfloat16>& g, const float* dst,
              float* ds0, float* dec, float* dsend, int B, const Strides& st,
              cudaStream_t stream) {
  static unsigned done_ds = 0, done_ch = 0;
  const size_t smem_ds = kDstateTcSmem;
  cudaError_t err = smem_once((const void*)rwkv_bwd_dstate_tc, smem_ds,
                              &done_ds);
  if (err == cudaSuccess)
    err = smem_once((const void*)rwkv_bwd_chunk_tc, kChunkTcSmem, &done_ch);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * g.H, nc = (g.Tn + kC - 1) / kC;
  rwkv_bwd_dstate_tc<<<dim3(nc, BH), kThreads, smem_ds, stream>>>(
      g.r, g.logw, g.dout, dsend, dec, g.H, g.Tn, g.M, st);
  const long long threads = (long long)BH * kState;
  rwkv_bwd_scan<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads,
                   0, stream>>>(dsend, dec, dst, ds0, BH, g.H, nc, g.M, st);
  rwkv_bwd_chunk_tc<<<dim3(2, nc, BH), kThreads, kChunkTcSmem, stream>>>(g,
                                                                         st);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* r, const void* k, const void* v,
        const float* logw, const float* u, const float* s0,
        const float* states, const float* dout, const float* dst, void* dr,
        void* dk, void* dv, float* dlogw, float* du, float* ds0, float* dsend,
        float* dec, float* du_part, int B, int H, int Tn, int M,
        const Strides& st, cudaStream_t stream) {
  const ChunkArgs<T> g{static_cast<const T*>(r), static_cast<const T*>(k),
                       static_cast<const T*>(v), logw, u, dout, states, s0,
                       dsend, static_cast<T*>(dr), static_cast<T*>(dk),
                       static_cast<T*>(dv), dlogw, du_part, H, Tn, M};
  int err;
  if constexpr (sizeof(T) == 2)
    err = launch_tc(g, dst, ds0, dec, dsend, B, st, stream);
  else
    err = launch<T>(g, dst, ds0, dec, dsend, B, st, stream);
  if (err) return err;
  rwkv_bwd_du<<<(H * M + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      du_part, du, B, H, (Tn + kC - 1) / kC, M);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of r/k/v and dr/dk/dv: 0 = float32, 1 = bfloat16; everything else
// is float32.  states: the forward's (B*H, chunks, 64, 64) chunk-start
// states, or null for T == 1 (then S_c is s0, or zeros when s0 is null).
// dst (the gradient of the final state) and ds0 (the gradient of S0, to
// write) may be null.  dsend (B*H, chunks, 64, 64), dec (B*H, chunks, 64)
// and du_part (B*H, chunks, 64) are float32 scratch.  strides (elements):
// (b, h, t) of r, k, v, logw, do, dr, dk, dv, dlogw, then (b, h) of dst,
// s0 and ds0; the last dim of every tensor has unit stride, u and du are
// (H, M) contiguous and each (M, M) state is contiguous.  tc: the route
// the wrapper picked, 1 (tensor cores) for bf16 and only for it, 0 (CUDA
// cores) for float32.  Four launches.
// Returns a cudaError_t (0 on success).
extern "C" int repro_rwkv_scan_bwd(
    int dtype, int tc, const void* r, const void* k, const void* v,
    const void* logw,
    const void* u, const void* s0, const void* states, const void* dout,
    const void* dst, void* dr, void* dk, void* dv, void* dlogw, void* du,
    void* ds0, void* dsend, void* dec, void* du_part, int B, int H, int Tn,
    int M, const long long* strides, void* stream) {
  if (M < 1 || M > kM || Tn < 1 || B * H < 1 || B * H > 65535 ||
      (Tn > 1 && !states) || !dsend || !dec || !du_part ||
      tc != (dtype == 1))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < kNStrides; ++i) st.s[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(logw),
                      static_cast<const float*>(u),
                      static_cast<const float*>(s0),
                      static_cast<const float*>(states),
                      static_cast<const float*>(dout),
                      static_cast<const float*>(dst)};
  float* o[] = {static_cast<float*>(dlogw), static_cast<float*>(du),
                static_cast<float*>(ds0), static_cast<float*>(dsend),
                static_cast<float*>(dec), static_cast<float*>(du_part)};
  if (dtype == 0)
    return run<float>(r, k, v, f[0], f[1], f[2], f[3], f[4], f[5], dr, dk,
                      dv, o[0], o[1], o[2], o[3], o[4], o[5], B, H, Tn, M, st,
                      s);
  if (dtype == 1)
    return run<__nv_bfloat16>(r, k, v, f[0], f[1], f[2], f[3], f[4], f[5],
                              dr, dk, dv, o[0], o[1], o[2], o[3], o[4], o[5],
                              B, H, Tn, M, st, s);
  return (int)cudaErrorInvalidValue;
}
