// K4 rwkv_scan: the WKV6 recurrence of RWKV6's time-mix, chunked.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv_scan.py, function
// rwkv_scan (its _kernel body).  Same math, the chunk form of the model's
// _wkv_chunk (src/repro/models/rwkv.py): per chunk of C steps, with cs the
// inclusive cumsum of logw along time,
//   q_in = r * exp(cs - logw)      k_in = k * exp(-cs)
//   o    = tril(q_in k_in^T, -1) v + (r . u . k) v + q_in S
//   S    = exp(cs_last) S + (k * exp(cs_last - cs))^T v
// Every exponent is relative to the chunk start and bounded by
// C * 0.105 (the model's DECAY_SCALE), so e^6.7 ~ 800 at most in float32.
// Three differences from the Pallas kernel, all toward the model: the scan
// starts from S0 (zeros when none is given), so a decode step (T == 1, the
// model's plain recurrence exactly) and a continued prefill run here too;
// a ragged T is masked (the Pallas grid floor-divides it away); the chunk
// is the model's CHUNK = 64.
//
// What bounds it on the H100: bytes.  A prefill of B=1, H=40, T=1024, M=64
// reads bf16 r/k/v and float32 logw and writes float32 o (~38 MB) for
// ~1 GFLOP, and a decode step reads and writes S (float32, 64 x 64 per
// head), both far below the card's float32 ridge of ~20 flop/byte.  The
// work is small (~0.015 ms at the float32 CUDA-core rate); what a
// sequential walk over the chunks lacks is parallelism, so the products
// stay float32 on CUDA cores and the design spreads the work.
//
// Prefill (T > 1): the standard chunk-parallel decomposition of linear
// attention, three launches per call, all float32 on CUDA cores:
//   1. chunk_state, one 256-thread block per (tile of JT value columns,
//      chunk, b * H + h), all in parallel: the chunk's state delta
//      k_tail^T v (64 x JT) and decay exp(cs_last) into float32 scratch.
//   2. state_scan, one thread per (b * H + h, state element): walks the
//      chunks in order, S_{c+1} = exp(cs_last,c) * S_c + delta_c from S0,
//      overwriting each delta with the state at its chunk's start, and
//      writes the final S.  The deltas are read 16 chunks ahead.
//   3. chunk_out, one block per (column tile, chunk, b * H + h): the
//      chunk-local output tril(q_in k_in^T, -1) v + (r . u . k) v plus the
//      cross term q_in S_c from the scratch, written once into o.
// Output column j and state column S[:, j] depend only on v[:, j], so a
// block takes JT of the 64 value columns; q_in, k_in, the scores and the
// cumsum are recomputed in each column tile.  JT is 64 when the chunks
// alone give two blocks per SM (B * H * chunks >= 264, the rwkv6-3b
// prefill: 640 blocks), else 32 or 16.  A block issues all its loads
// before it stores any to shared memory, so it waits for device memory
// once.  A chunk's r and k are staged as float32 rows of 68 words
// (16-byte aligned, so the score and output products read float4s); the
// scores then take k_in's place.  The cumsum splits each column into four
// 16-step segments, one thread each, whose totals pass through shared
// memory, so all 256 threads take part; logw goes straight from device
// memory to the registers of its column's threads, and the decays are
// applied in the same pass.  The score and output products keep 4 x 4
// (or TR x 4) register tiles; each warp owns 8 consecutive rows, so the
// score columns and the sum over s past a warp's last row are skipped:
// the warps of lower rows finish early and leave the SM to the others.  Rows past a ragged T are zeros (logw 0, so cs_last is the last
// valid row's) and never stored; heads smaller than 64 are zero-padded to
// 64.  What holds the prefill back on the H100 (PERF.md): chunk_out's
// blocks load, then compute, in lockstep waves, so device memory and the
// CUDA cores take turns; a persistent chunk_out that loads the next tile
// while it computes this one is the next step.
//
// Decode (T == 1): one pass, no chunk staging, o_j = sum_m r_m (S[m,j] +
// u_m k_m v_j) and S'[m,j] = exp(logw_m) S[m,j] + k_m v_j.  One block of
// 256 threads per (16 value columns, b * H + h), 640 blocks at B = 4,
// H = 40; each thread reads and writes 4 columns of one row of S with
// 16-byte accesses, and the sum over m is a shuffle within the warp and
// eight partials through shared memory.
//
// Every input is read through its strides (unit stride on the last dim),
// so the model's (B, T, H, M) projections are passed as permuted views and
// o is written into a (B, T, H, M) buffer, never copied.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "rwkv_common.cuh"

namespace {

constexpr int kDecJT = 16;             // decode: value columns per block

// Element strides, in the order of the C interface below.
enum { R_SB, R_SH, R_ST, K_SB, K_SH, K_ST, V_SB, V_SH, V_ST, W_SB, W_SH, W_ST,
       O_SB, O_SH, O_ST, S0_SB, S0_SH, S_SB, S_SH, kNStrides };
struct Strides {
  long long s[kNStrides];
};

// ---------------------------------------------------------------------------
//  prefill 1: each chunk's state delta and decay
// ---------------------------------------------------------------------------
template <typename T, int JT>
__global__ void __launch_bounds__(kThreads)
chunk_state(const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ logw, float* __restrict__ buf,
            float* __restrict__ dec, int H, int Tn, int M, Strides st) {
  const int j0 = blockIdx.x * JT, c = blockIdx.y, bh = blockIdx.z;
  const int nc = gridDim.y;
  const int b = bh / H, h = bh - b * H;
  const int t0 = c * kC, n = min(kC, Tn - t0);

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [kC][kP] k, then k_tail
  float* v_s = k_s + kC * kP;                      // [kC][JT]
  float* tot = v_s + kC * JT;                      // [kSeg][kM]

  // cumsum of logw down each column in four segments (this thread: column
  // m, segment seg), the segments' totals through shared memory
  const int m = threadIdx.x % kM, seg = threadIdx.x / kM;
  float lw[kSegLen];
  seg_logw(lw, logw + b * st.s[W_SB] + h * st.s[W_SH] + t0 * st.s[W_ST],
           st.s[W_ST], n, M, m, seg);
  {
    Staged<T, kM> sk;
    Staged<T, JT> sv;
    sk.load(k + b * st.s[K_SB] + h * st.s[K_SH] + t0 * st.s[K_ST], st.s[K_ST],
            n, M, 0);
    sv.load(v + b * st.s[V_SB] + h * st.s[V_SH] + t0 * st.s[V_ST], st.s[V_ST],
            n, M, j0);
    sk.store(k_s, kP);
    sv.store(v_s, JT);
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
  float* kc = k_s + seg * kSegLen * kP + m;
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) {
    run += lw[t];
    kc[t * kP] *= expf(last - run);        // k * exp(cs_last - cs)
  }
  if (blockIdx.x == 0 && seg == 0) dec[(long long)bh * nc * kM + c * kM + m] =
      expf(last);
  __syncthreads();

  // delta[m][j] = sum_t k_tail[t][m] v[t][j]
  const Tile<JT> tl;
  float4 acc[Tile<JT>::TR];
#pragma unroll
  for (int a = 0; a < Tile<JT>::TR; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < n; ++t) {
    const float4 vv = *reinterpret_cast<const float4*>(v_s + t * JT + 4 * tl.cg);
    float kt[Tile<JT>::TR];
    ld_rows<Tile<JT>::TR>(k_s + t * kP + tl.row(0), kt);
#pragma unroll
    for (int a = 0; a < Tile<JT>::TR; ++a) fma4(acc[a], kt[a], vv);
  }
  float* out = buf + ((long long)bh * nc + c) * kState + j0 + 4 * tl.cg;
#pragma unroll
  for (int a = 0; a < Tile<JT>::TR; ++a)
    *reinterpret_cast<float4*>(out + tl.row(a) * kM) = acc[a];
}

// ---------------------------------------------------------------------------
//  prefill 2: the states at the chunk starts, in order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
state_scan(float* __restrict__ buf, const float* __restrict__ dec,
           const float* __restrict__ s0, float* __restrict__ s_out, int BH,
           int H, int nc, int M, Strides st) {
  constexpr int kAhead = 16;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int bh = (int)(idx / kState), e = (int)(idx % kState);
  if (bh >= BH) return;
  const int b = bh / H, h = bh - b * H;
  const int m = e / kM, j = e % kM;
  const bool in = m < M && j < M;
  float S = s0 && in ? s0[b * st.s[S0_SB] + h * st.s[S0_SH] + m * M + j] : 0.f;
  float* p = buf + (long long)bh * nc * kState + e;
  const float* a = dec + (long long)bh * nc * kM + m;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float d[kAhead], w[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 + i < nc) {
        d[i] = p[(long long)(c0 + i) * kState];
        w[i] = a[(c0 + i) * kM];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 + i < nc) {
        p[(long long)(c0 + i) * kState] = S;    // the state at chunk start
        S = fmaf(w[i], S, d[i]);
      }
  }
  if (in) s_out[b * st.s[S_SB] + h * st.s[S_SH] + m * M + j] = S;
}

// ---------------------------------------------------------------------------
//  prefill 3: each chunk's output
// ---------------------------------------------------------------------------
template <typename T, int JT>
__global__ void __launch_bounds__(kThreads)
chunk_out(const T* __restrict__ r, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ logw,
          const float* __restrict__ u, const float* __restrict__ buf,
          float* __restrict__ o, int H, int Tn, int M, Strides st) {
  const int j0 = blockIdx.x * JT, c = blockIdx.y, bh = blockIdx.z;
  const int nc = gridDim.y;
  const int b = bh / H, h = bh - b * H;
  const int t0 = c * kC, n = min(kC, Tn - t0);

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kC][kP] r, then q_in
  float* k_s = q_s + kC * kP;                      // [kC][kP] k, k_in, scores
  float* v_s = k_s + kC * kP;                      // [kC][JT]
  float* S_s = v_s + kC * JT;                      // [kM][JT] S at the start
  float* u_s = S_s + kM * JT;                      // [kM]
  float* dg = u_s + kM;                            // [kC] bonus r . u . k
  float* tot = dg + kC;                            // [kSeg][kM]

  // the cumsum of logw as in chunk_state
  const int m = threadIdx.x % kM, seg = threadIdx.x / kM;
  float lw[kSegLen];
  seg_logw(lw, logw + b * st.s[W_SB] + h * st.s[W_SH] + t0 * st.s[W_ST],
           st.s[W_ST], n, M, m, seg);
  {
    Staged<T, kM> sr, sk;
    Staged<T, JT> sv;
    Staged<float, JT> ss;
    sr.load(r + b * st.s[R_SB] + h * st.s[R_SH] + t0 * st.s[R_ST], st.s[R_ST],
            n, M, 0);
    sk.load(k + b * st.s[K_SB] + h * st.s[K_SH] + t0 * st.s[K_ST], st.s[K_ST],
            n, M, 0);
    sv.load(v + b * st.s[V_SB] + h * st.s[V_SH] + t0 * st.s[V_ST], st.s[V_ST],
            n, M, j0);
    ss.load(buf + ((long long)bh * nc + c) * kState, kM, kM, kM, j0);
    const float uu = threadIdx.x < M ? u[h * M + threadIdx.x] : 0.f;
    sr.store(q_s, kP);
    sk.store(k_s, kP);
    sv.store(v_s, JT);
    ss.store(S_s, JT);
    if (threadIdx.x < kM) u_s[threadIdx.x] = uu;
  }
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) part += lw[t];
  tot[seg * kM + m] = part;
  __syncthreads();

  // the bonus on the diagonal, one warp per row, before q and k decay
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < kC; t += kThreads / 32) {
    float s = 0.f;
    for (int mm = lane; mm < kM; mm += 32)
      s += q_s[t * kP + mm] * u_s[mm] * k_s[t * kP + mm];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) dg[t] = s;
  }
  __syncthreads();
  float run = 0.f;
  for (int q = 0; q < seg; ++q) run += tot[q * kM + m];
  float* qc = q_s + seg * kSegLen * kP + m;
  float* kc = k_s + seg * kSegLen * kP + m;
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) {
    qc[t * kP] *= expf(run);               // r * exp(cs - logw)
    run += lw[t];
    kc[t * kP] *= expf(-run);              // k * exp(-cs)
  }
  __syncthreads();

  // scores[t][s] = q_in[t] . k_in[s] for s < t, the bonus for s == t,
  // over k_in once every thread has read it
  // (thread: rows 4 tg .. 4 tg + 3, columns sg + 16 bb; the columns past
  // its last row are skipped, so a warp's work grows with its rows)
  {
    const int tg = threadIdx.x / 16, sg = threadIdx.x % 16;
    const int nb = (4 * tg + 3) / 16 + 1;       // column blocks it needs
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) sc[a][bb] = 0.f;
    for (int mm = 0; mm < kM; mm += 4) {
      float4 qa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(q_s + (4 * tg + a) * kP + mm);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        if (bb < nb) {
          const float4 kb =
              *reinterpret_cast<const float4*>(k_s + (sg + 16 * bb) * kP + mm);
#pragma unroll
          for (int a = 0; a < 4; ++a) sc[a][bb] = dot4(qa[a], kb, sc[a][bb]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int t = 4 * tg + a, s = sg + 16 * bb;
        k_s[t * kP + s] = s < t ? sc[a][bb] : s == t ? dg[t] : 0.f;
      }
  }
  __syncthreads();

  // o = scores @ v + q_in @ S
  const Tile<JT> tl;
  constexpr int TR = Tile<JT>::TR;
  float4 acc[TR];
#pragma unroll
  for (int a = 0; a < TR; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
  // scores of row t are zero past s = t: stop at the thread's last row
  const int s_end = min((n + 3) & ~3, (tl.row(TR - 1) + 4) & ~3);
  for (int s = 0; s < s_end; s += 4) {
    float4 vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      vv[i] = *reinterpret_cast<const float4*>(v_s + (s + i) * JT + 4 * tl.cg);
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const float4 p = *reinterpret_cast<const float4*>(k_s + tl.row(a) * kP + s);
#pragma unroll
      for (int i = 0; i < 4; ++i) fma4(acc[a], f4(p, i), vv[i]);
    }
  }
  for (int mm = 0; mm < kM; mm += 4) {
    float4 sv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sv[i] = *reinterpret_cast<const float4*>(S_s + (mm + i) * JT + 4 * tl.cg);
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const float4 q = *reinterpret_cast<const float4*>(q_s + tl.row(a) * kP + mm);
#pragma unroll
      for (int i = 0; i < 4; ++i) fma4(acc[a], f4(q, i), sv[i]);
    }
  }
  float* ob = o + b * st.s[O_SB] + h * st.s[O_SH];
  const int j = j0 + 4 * tl.cg;
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int t = tl.row(a);
    if (t < n) store4(ob + (long long)(t0 + t) * st.s[O_ST] + j, acc[a], M - j);
  }
}

// ---------------------------------------------------------------------------
//  decode (T == 1): one pass over S
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv_decode(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_out, int H, int M,
            Strides st) {
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int m = threadIdx.x / 4, j = blockIdx.x * kDecJT + (threadIdx.x % 4) * 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float red[kThreads / 32][kDecJT];

  float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
  if (m < M) {
    const float rm = to_float(r[b * st.s[R_SB] + h * st.s[R_SH] + m]);
    const float km = to_float(k[b * st.s[K_SB] + h * st.s[K_SH] + m]);
    const float wm = expf(logw[b * st.s[W_SB] + h * st.s[W_SH] + m]);
    const float um = u[h * M + m];
    const float4 vv = load4(v + b * st.s[V_SB] + h * st.s[V_SH] + j, M - j);
    const float4 S = s0 ? load4(s0 + b * st.s[S0_SB] + h * st.s[S0_SH] +
                                m * M + j, M - j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float ukm = um * km;
    part = make_float4(rm * fmaf(ukm, vv.x, S.x), rm * fmaf(ukm, vv.y, S.y),
                       rm * fmaf(ukm, vv.z, S.z), rm * fmaf(ukm, vv.w, S.w));
    store4(s_out + b * st.s[S_SB] + h * st.s[S_SH] + m * M + j,
           make_float4(fmaf(wm, S.x, km * vv.x), fmaf(wm, S.y, km * vv.y),
                       fmaf(wm, S.z, km * vv.z), fmaf(wm, S.w, km * vv.w)),
           M - j);
  }
  // sum over m: the warp's 8 rows by shuffle, then the 8 warps
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    part.x += __shfl_xor_sync(0xffffffffu, part.x, off);
    part.y += __shfl_xor_sync(0xffffffffu, part.y, off);
    part.z += __shfl_xor_sync(0xffffffffu, part.z, off);
    part.w += __shfl_xor_sync(0xffffffffu, part.w, off);
  }
  if (lane < 4) {
    red[warp][4 * lane] = part.x;
    red[warp][4 * lane + 1] = part.y;
    red[warp][4 * lane + 2] = part.z;
    red[warp][4 * lane + 3] = part.w;
  }
  __syncthreads();
  const int jj = blockIdx.x * kDecJT + threadIdx.x;
  if (threadIdx.x < kDecJT && jj < M) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
    o[b * st.s[O_SB] + h * st.s[O_SH] + jj] = s;
  }
}

template <typename T, int JT>
int launch_prefill(const T* r, const T* k, const T* v, const float* logw,
                   const float* u, const float* s0, float* o, float* s_out,
                   float* buf, float* dec, int B, int H, int Tn, int M,
                   const Strides& st, cudaStream_t stream) {
  static unsigned done_state = 0, done_out = 0;
  const size_t smem_state = sizeof(float) *
      ((size_t)kC * kP + (size_t)kC * JT + (size_t)kSeg * kM);
  const size_t smem_out = sizeof(float) *
      (2 * (size_t)kC * kP + (size_t)kC * JT + (size_t)kM * JT + kM + kC +
       (size_t)kSeg * kM);
  cudaError_t err = smem_once((const void*)chunk_state<T, JT>, smem_state,
                              &done_state);
  if (err == cudaSuccess)
    err = smem_once((const void*)chunk_out<T, JT>, smem_out, &done_out);
  if (err != cudaSuccess) return (int)err;
  const int nc = (Tn + kC - 1) / kC;
  const dim3 grid((M + JT - 1) / JT, nc, B * H);
  chunk_state<T, JT><<<grid, kThreads, smem_state, stream>>>(
      k, v, logw, buf, dec, H, Tn, M, st);
  const long long threads = (long long)B * H * kState;
  state_scan<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
               stream>>>(buf, dec, s0, s_out, B * H, H, nc, M, st);
  chunk_out<T, JT><<<grid, kThreads, smem_out, stream>>>(
      r, k, v, logw, u, buf, o, H, Tn, M, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, float* o, float* s_out,
           float* buf, float* dec, int B, int H, int Tn, int M,
           const Strides& st, cudaStream_t stream) {
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  if (Tn == 1) {
    const dim3 grid((M + kDecJT - 1) / kDecJT, B * H);
    rwkv_decode<T><<<grid, kThreads, 0, stream>>>(rr, kk, vv, logw, u, s0, o,
                                                 s_out, H, M, st);
    return (int)cudaGetLastError();
  }
  // value columns per block: the chunks alone should give two blocks an SM
  const long long chunks = (long long)B * H * ((Tn + kC - 1) / kC);
  if (chunks >= 264)
    return launch_prefill<T, 64>(rr, kk, vv, logw, u, s0, o, s_out, buf, dec,
                                 B, H, Tn, M, st, stream);
  if (chunks >= 132)
    return launch_prefill<T, 32>(rr, kk, vv, logw, u, s0, o, s_out, buf, dec,
                                 B, H, Tn, M, st, stream);
  return launch_prefill<T, 16>(rr, kk, vv, logw, u, s0, o, s_out, buf, dec, B,
                               H, Tn, M, st, stream);
}

}  // namespace

// dtype of r/k/v: 0 = float32, 1 = bfloat16; logw, u, S0, o and S are
// float32.  s0 may be null (start from zeros).  buf (B*H, chunks, 64, 64)
// and dec (B*H, chunks, 64) are float32 scratch for T > 1 (null for
// T == 1).  strides (elements): r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb,
// v_sh, v_st, logw_sb, logw_sh, logw_st, o_sb, o_sh, o_st, s0_sb, s0_sh,
// s_sb, s_sh; the last dim of every tensor has unit stride, u is (H, M)
// contiguous and each (M, M) state is contiguous.  Returns a cudaError_t
// (0 on success).
extern "C" int repro_rwkv_scan(int dtype, const void* r, const void* k,
                               const void* v, const void* logw,
                               const void* u, const void* s0, void* o,
                               void* s_out, void* buf, void* dec, int B,
                               int H, int Tn, int M,
                               const long long* strides, void* stream) {
  if (M < 1 || M > kM || Tn < 1 || B * H < 1 || B * H > 65535 ||
      (Tn > 1 && (!buf || !dec)))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < kNStrides; ++i) st.s[i] = strides[i];
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* of = static_cast<float*>(o);
  float* sf = static_cast<float*>(s_out);
  float* bf = static_cast<float*>(buf);
  float* df = static_cast<float*>(dec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, lw, uu, s0f, of, sf, bf, df, B, H, Tn, M,
                         st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, lw, uu, s0f, of, sf, bf, df, B, H,
                                 Tn, M, st, s);
  return (int)cudaErrorInvalidValue;
}
