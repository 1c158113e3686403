// K1 decode_attention: one query token per sequence against its KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py,
// function decode_attention (its _kernel body).  Same math: GQA, where the
// query heads of a group share one read of the cache; online softmax with
// float32 m / l / acc; positions >= lengths[b] are masked and never read.
//
// What bounds it on the H100: bytes, at the bf16 tensor cores' rate.  It
// reads k and v once (2 * len * hd elements per (b, kv-head)) and does
// 4 * G flops per element read, far below the ~295 flop/byte ridge of the
// bf16 tensor cores, so the bound is the cache bytes over the 3.35 TB/s of
// HBM3.  On CUDA cores it is not: at G = 16 each bf16 element costs 2 * G
// float32 FMAs plus its conversion and the lanes' reductions, above the
// float32 ridge of ~20 flop/byte, and a CUDA-core version measured
// instruction-bound (its time grew with heads x keys per lane group; the
// float32 kernel's times in chip_smoke.py show it).  So the bf16 path
// multiplies on the tensor cores.
//
// Design: a split over the cache (flash-decoding).  One 128-thread block
// per (split of keys_per_split keys, b, kv-head, group of up to 16 of the
// kv-head's query heads): the wrapper's plan() picks the split from S
// (never from the lengths, which live on the device) for about two blocks
// per SM, and every served shape has G <= 16, so each group's cache is
// read once.  A block whose split starts at or past min(lengths[b], S)
// exits at once.  A live block walks its keys in tiles through a
// two-stage ring in shared memory filled by cp.async 16-byte copies, the
// next tile in flight while the current one is multiplied; where a row's
// address is not 16-byte aligned (or hd is not a multiple of 8) it copies
// element by element instead.  k and v are read through their strides, so
// the model's (B, S, Hkv, hd) cache is passed as a permuted view.
//
//  - bf16, hd in {32, 64, 128, 256} (decode_attention_tc): the block's
//    heads are the 16 rows of mma.sync.m16n8k16 tiles (rows past G are
//    zeros); each of the 4 warps takes 16 keys of a 64-key tile: S = Q K^T
//    from ldmatrix fragments of the XOR-swizzled tiles, the online softmax
//    on the accumulators (row max and sum over the 4 lanes of a row), P
//    packed into bf16 A fragments and O += P V with ldmatrix.trans.
//  - float32, or another hd (decode_attention_kernel): CUDA cores in full
//    float32.  Lane groups of L lanes own GH heads and a stride of the
//    tile's keys; each lane takes the partial dot of its 8 * NC dims, the
//    group sums it with __shfl_xor_sync, and keeps (m, l, acc) in float32
//    registers, rescaled once per batch of kU keys.
//
// Both end in finish(): the block's partial states (warps, or key strides)
// are merged through shared memory.  With one live split the block writes
// the output; otherwise it writes its m, l and unnormalised acc to float32
// scratch, and the last live block of its (b, kv-head, head group), found
// by an atomicInc ticket that wraps back to 0 by itself, rescales the
// splits by exp(m_i - max m) and writes the output in q's dtype.  One
// launch, no second kernel.  The finite -1e30 sentinel stands for -inf.
// The tensor-core kernel's shared-memory attribute is set once per
// instantiation and device, not per launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kU = 4;             // keys per batch of one lane group
constexpr int kTileBytes = 8192;  // bytes of one k (or v) tile in the ring
constexpr int kMaxSplits = 256;   // the wrapper's plan never exceeds it
constexpr int kGS = 8;            // splits per group of the combine
constexpr int kMaxGroups = kMaxSplits / kGS;
// shared memory of fold(): m, l and weights of up to kMaxGroups slots
inline size_t fold_bytes(int hpb) {
  return 2 * sizeof(float) * (size_t)hpb * (kMaxGroups + 1);
}
// Dynamic shared memory needs no cudaFuncSetAttribute below 48 KB; the
// CUDA-core kernel's ring is 32 KB, its merge at most 33 KB (hd = 2048)
// and the combine's at most 4.2 KB, so it never makes that host call.
constexpr size_t kSmemDefault = 48 * 1024;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 8 elements of a shared-memory row (16-byte aligned) as float32.
__device__ __forceinline__ void chunk8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void chunk8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {            // bf16 -> float: the top half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Copy 8 elements (one chunk) of a cache row into shared memory: 16-byte
// asynchronous copies where the row is aligned and the chunk lies inside
// hd, else element loads with zero fill past hd.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* src, int n) {
  constexpr int kPer = 16 / sizeof(T);     // elements per 16-byte copy
  if (n >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 8; i += kPer) cp_async16(dst + i, src + i);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = i < n ? src[i] : from_f32<T>(0.f);
  }
}

// What one block does: its split, (b, kv-head, head group), heads and the
// live splits of its sequence.
template <typename T>
struct Work {
  int b, kvh, head0, gc;       // sequence, kv head, first head, heads
  int split, base, nlive;      // split, (b, kv head, head group), live
  int start, end;              // keys [start, end)
  T* ob;                       // output of the first head
};

// Fill w; false for a block with no keys, which exits (after writing
// zeros where the sequence has no key at all: lengths[b] <= 0).
template <typename T>
__device__ __forceinline__ bool block_work(const int* lengths, T* out, int H,
                                           int Hkv, int S, int hd, int hpb,
                                           int kps, long long o_sb,
                                           long long o_sh, Work<T>* w) {
  const int G = H / Hkv;
  const int ngroups = (G + hpb - 1) / hpb;
  w->split = blockIdx.x;
  w->base = blockIdx.y;
  w->b = w->base / (Hkv * ngroups);
  w->kvh = (w->base / ngroups) % Hkv;
  const int hg = w->base % ngroups;
  w->head0 = w->kvh * G + hg * hpb;
  w->gc = min(hpb, G - hg * hpb);
  int len = lengths[w->b];
  if (len > S) len = S;
  w->nlive = len > 0 ? (len + kps - 1) / kps : 0;
  if (w->split >= (w->nlive > 0 ? w->nlive : 1)) return false;  // empty
  w->ob = out + w->b * o_sb + (long long)w->head0 * o_sh;
  if (w->nlive == 0) {                     // nothing to attend to: zeros
    for (int i = threadIdx.x; i < w->gc * hd; i += kThreads)
      w->ob[(i / hd) * o_sh + i % hd] = from_f32<T>(0.f);
    return false;
  }
  w->start = w->split * kps;
  w->end = min(w->start + kps, len);
  return true;
}

// Fold count partial states of the scratch (the slots first, first +
// step, ...; each gc heads of hd unnormalised acc, and m, l) by
// exp(m_i - max m).  With ob, divide by the folded l and write the output
// in T; without, write the folded state back into the slot first.  wts is
// shared memory for 2 * gc * (count + 1) floats.
template <typename T>
__device__ void fold(float* pacc, float* pml, int first, int count,
                     int step, int gc, int hd, int hpb, float* wts, T* ob,
                     long long o_sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = gc * count;
  float* lsm = wts + nw;                     // [gc][count] l
  float* head_m = lsm + nw;                  // [gc] folded m, l
  float* head_l = head_m + gc;
  for (int idx = tid; idx < nw; idx += kThreads) {
    const int hs = idx / count, i = idx - hs * count;
    const float* ml = pml + 2 * ((size_t)(first + i * step) * hpb + hs);
    wts[idx] = __ldcg(ml);
    lsm[idx] = __ldcg(ml + 1);
  }
  __syncthreads();
  for (int hs = warp; hs < gc; hs += kThreads / 32) {
    float M = kNegInf;
    for (int i = lane; i < count; i += 32) M = fmaxf(M, wts[hs * count + i]);
    M = warp_max(M);
    float den = 0.f;
    for (int i = lane; i < count; i += 32)
      den = fmaf(__expf(wts[hs * count + i] - M), lsm[hs * count + i], den);
    den = warp_sum(den);
    const float inv = ob ? 1.f / fmaxf(den, 1e-30f) : 1.f;
    for (int i = lane; i < count; i += 32)
      wts[hs * count + i] = __expf(wts[hs * count + i] - M) * inv;
    if (lane == 0) {
      head_m[hs] = M;
      head_l[hs] = den;
    }
  }
  __syncthreads();
  // the weighted sum, kE elements per thread at a time: 16-byte loads
  // (4-byte where hd % 4 != 0), several slots in flight
  constexpr int kE = 8;
  const bool vec = (hd & 3) == 0;
  const int per = vec ? 4 : 1;               // elements per load
  const int ne = gc * hd / per;
  const size_t sstride = (size_t)step * hpb * hd / per;   // loads per slot
  const size_t off = (size_t)first * hpb * hd / per;
  for (int e0 = 0; e0 < ne; e0 += kE * kThreads) {
    float4 y[kE];
    int hsj[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      y[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      hsj[j] = min(e0 + j * kThreads + tid, ne - 1) * per / hd;
    }
#pragma unroll 4
    for (int i = 0; i < count; ++i) {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int e = e0 + j * kThreads + tid;
        if (e < ne) {
          const float wi = wts[hsj[j] * count + i];
          if (vec) {
            const float4 x = __ldcg(reinterpret_cast<const float4*>(pacc) +
                                    off + i * sstride + e);
            y[j].x = fmaf(wi, x.x, y[j].x);
            y[j].y = fmaf(wi, x.y, y[j].y);
            y[j].z = fmaf(wi, x.z, y[j].z);
            y[j].w = fmaf(wi, x.w, y[j].w);
          } else {
            y[j].x = fmaf(wi, __ldcg(pacc + off + i * sstride + e), y[j].x);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = e0 + j * kThreads + tid;
      if (e < ne) {
        const int hs = hsj[j], d = e * per - hs * hd;
        if (ob) {
          T* o = ob + hs * o_sh + d;
          o[0] = from_f32<T>(y[j].x);
          if (vec) {
            o[1] = from_f32<T>(y[j].y);
            o[2] = from_f32<T>(y[j].z);
            o[3] = from_f32<T>(y[j].w);
          }
        } else {
          float* a = pacc + (size_t)first * hpb * hd + (size_t)hs * hd + d;
          a[0] = y[j].x;
          if (vec) {
            a[1] = y[j].y;
            a[2] = y[j].z;
            a[3] = y[j].w;
          }
        }
      }
    }
  }
  if (!ob) {
    for (int hs = tid; hs < gc; hs += kThreads) {
      float* ml = pml + 2 * ((size_t)first * hpb + hs);
      ml[0] = head_m[hs];
      ml[1] = head_l[hs];
    }
  }
}

// The block's end, common to both kernels.  acc_s [R][PG][hdp] and ml_s
// [R][PG][2] hold R partial states (m, l, unnormalised acc) of PG head
// rows; they are merged by exp(m_r - max m), whose weights take the
// (R + 2) * PG floats after ml_s.  With one live split the
// block writes the output; otherwise it writes its partials to the
// scratch, and the last live block of its base (an atomicInc ticket that
// wraps back to 0) combines all splits, in two levels (groups of kGS
// splits, then the groups).  wts is free shared memory for
// 2 * hpb * (kMaxGroups + 1) floats.
template <typename T>
__device__ void finish(const float* acc_s, const float* ml_s, int R, int PG,
                       int hdp, int gc, int hd, int hpb, const Work<T>& w,
                       int nsplit, float* part, unsigned* tickets, float* wts,
                       long long o_sh) {
  // scratch: every (base, split, head)'s unnormalised acc [hd], then
  // every (base, split, head)'s m and l
  const int tid = threadIdx.x, lane = tid & 31;
  const int nlive = w.nlive, split = w.split, base = w.base;
  T* ob = w.ob;
  const size_t rows = (size_t)gridDim.y * nsplit * hpb;
  float* pacc = part + (size_t)base * nsplit * hpb * hd;   // [nsplit][hpb][hd]
  float* pml = part + rows * hd + (size_t)base * nsplit * hpb * 2;
  // the R rows' weights exp(m_r - max m) per head, once (divided by the
  // folded l when this block writes the output)
  float* rw = const_cast<float*>(ml_s) + 2 * R * PG;   // [R][PG]
  float* hm = rw + R * PG;                             // [PG] m, then l
  float* hl = hm + PG;
  for (int hs = tid; hs < gc; hs += kThreads) {
    float M = kNegInf;
    for (int rr = 0; rr < R; ++rr) M = fmaxf(M, ml_s[2 * (rr * PG + hs)]);
    float ls = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      const float wr = __expf(ml_s[2 * (rr * PG + hs)] - M);
      rw[rr * PG + hs] = wr;
      ls = fmaf(wr, ml_s[2 * (rr * PG + hs) + 1], ls);
    }
    if (nlive == 1) {
      const float inv = 1.f / fmaxf(ls, 1e-30f);
      for (int rr = 0; rr < R; ++rr) rw[rr * PG + hs] *= inv;
    }
    hm[hs] = M;
    hl[hs] = ls;
  }
  __syncthreads();
  for (int i = tid; i < gc * hd; i += kThreads) {
    const int hs = i / hd, d = i - hs * hd;
    float a = 0.f;
    for (int rr = 0; rr < R; ++rr)
      a = fmaf(rw[rr * PG + hs], acc_s[(size_t)(rr * PG + hs) * hdp + d], a);
    if (nlive == 1) {
      ob[hs * o_sh + d] = from_f32<T>(a);
    } else {
      const size_t row = (size_t)split * hpb + hs;
      pacc[row * hd + d] = a;
      if (d == 0) {
        pml[2 * row] = hm[hs];
        pml[2 * row + 1] = hl[hs];
      }
    }
  }
  if (nlive == 1) return;

  // the combine, in two levels: the last live block of each group of kGS
  // splits folds its group into the group's first slot, and the last of
  // those folds the groups into the output (one level when nlive <= kGS)
  __shared__ unsigned s_ticket;
  const int ngr = (nlive + kGS - 1) / kGS;
  const int grp = split / kGS;
  const int gn = min(kGS, nlive - grp * kGS);
  unsigned* tk = tickets + (size_t)base * (1 + kMaxGroups);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_ticket = atomicInc(tk + 1 + grp, (unsigned)gn - 1);
  __syncthreads();
  if (s_ticket != (unsigned)gn - 1) return;
  __threadfence();
  if (ngr == 1) {
    fold<T>(pacc, pml, 0, nlive, 1, gc, hd, hpb, wts, ob, o_sh);
    return;
  }
  if (gn > 1)
    fold<T>(pacc, pml, grp * kGS, gn, 1, gc, hd, hpb, wts, nullptr, o_sh);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_ticket = atomicInc(tk, (unsigned)ngr - 1);
  __syncthreads();
  if (s_ticket != (unsigned)ngr - 1) return;
  __threadfence();
  fold<T>(pacc, pml, 0, ngr, kGS, gc, hd, hpb, wts, ob, o_sh);
}

// GH: query heads per lane group; NC: 8-element chunks per lane.
template <typename T, int GH, int NC>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ part, unsigned* __restrict__ tickets,
                        int H, int Hkv, int S, int hd, int hpb, int kps,
                        int nsplit, int L, int TK, float scale,
                        long long q_sb, long long q_sh,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh) {
  constexpr int D = 8 * NC;                // dims per lane
  const int tid = threadIdx.x;
  Work<T> w;
  if (!block_work(lengths, out, H, Hkv, S, hd, hpb, kps, o_sb, o_sh, &w))
    return;
  const int b = w.b, kvh = w.kvh, head0 = w.head0, gc = w.gc;
  const int start = w.start, end = w.end;

  // thread layout: lane groups of L lanes; P groups own heads (GH each),
  // R groups (the key stride) per head set
  const int c = tid % L;
  const int grp = tid / L;
  const int P = (gc + GH - 1) / GH;
  const int R = (kThreads / L) / P;
  const int p = grp % P;
  const int r = grp / P;
  const bool active = r < R;
  const int lane = tid & 31;
  const unsigned gmask =
      L == 32 ? 0xffffffffu : (((1u << L) - 1u) << (lane & ~(L - 1)));
  const int hdp = 8 * NC * L;              // padded row length in smem

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw); // [2 stages][k, v][TK][hdp]

  // the group's query chunks, scaled, in registers
  float qr[GH][D];
#pragma unroll
  for (int gi = 0; gi < GH; ++gi) {
    const int hs = p * GH + gi;
    const T* qrow = q + b * q_sb + (long long)(head0 + hs) * q_sh;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = (n * L + c) * 8 + e;
        qr[gi][n * 8 + e] =
            active && hs < gc && d < hd ? to_f32(qrow[d]) * scale : 0.f;
      }
  }
  float m[GH], l[GH], acc[GH][D];
#pragma unroll
  for (int gi = 0; gi < GH; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) acc[gi][e] = 0.f;
  }

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int cpr = hdp / 8;                 // chunks per smem row
  const int ntiles = (end - start + TK - 1) / TK;

  auto stage = [&](int t) {
    T* ks = ring + (t & 1) * 2 * TK * hdp;
    T* vs = ks + TK * hdp;
    const int t0 = start + t * TK;
    const int nk = min(TK, end - t0);
    for (int i = tid; i < nk * cpr; i += kThreads) {
      const int j = i / cpr, ch = i - j * cpr;
      const int d0 = ch * 8;
      const int n = hd - d0;
      stage_chunk(ks + j * hdp + d0, kb + (t0 + j) * k_ss + d0, n);
      stage_chunk(vs + j * hdp + d0, vb + (t0 + j) * v_ss + d0, n);
    }
  };

  stage(0);
  cp_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) stage(t + 1);
    cp_commit();                           // possibly empty: uniform count
    cp_wait_one();                         // tile t has landed
    __syncthreads();
    const T* ks = ring + (t & 1) * 2 * TK * hdp;
    const T* vs = ks + TK * hdp;
    const int nk = min(TK, end - (start + t * TK));
    if (active) {
      for (int j0 = r; j0 < nk; j0 += R * kU) {
        // every key of the batch is loaded and multiplied without a branch
        // (a key past the tile reads the tile's last row and weighs 0), so
        // the kU keys' and GH heads' chains interleave
        float s[GH][kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = min(j0 + u * R, nk - 1);
#pragma unroll
          for (int gi = 0; gi < GH; ++gi) s[gi][u] = 0.f;
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            float kf[8];
            chunk8(ks + j * hdp + (n * L + c) * 8, kf);
#pragma unroll
            for (int gi = 0; gi < GH; ++gi)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                s[gi][u] = fmaf(qr[gi][n * 8 + e], kf[e], s[gi][u]);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          if (o < L)
#pragma unroll
            for (int gi = 0; gi < GH; ++gi)
#pragma unroll
              for (int u = 0; u < kU; ++u)
                s[gi][u] += __shfl_xor_sync(gmask, s[gi][u], o);
        float pw[GH][kU];
#pragma unroll
        for (int gi = 0; gi < GH; ++gi) {
          float mx = kNegInf;
#pragma unroll
          for (int u = 0; u < kU; ++u)
            mx = fmaxf(mx, j0 + u * R < nk ? s[gi][u] : kNegInf);
          const float m_new = fmaxf(m[gi], mx);
          const float corr = __expf(m[gi] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const float e = __expf(s[gi][u] - m_new);
            pw[gi][u] = j0 + u * R < nk ? e : 0.f;
            sum += pw[gi][u];
          }
          l[gi] = l[gi] * corr + sum;
          m[gi] = m_new;
#pragma unroll
          for (int e = 0; e < D; ++e) acc[gi][e] *= corr;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = min(j0 + u * R, nk - 1);
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            float vf[8];
            chunk8(vs + j * hdp + (n * L + c) * 8, vf);
#pragma unroll
            for (int gi = 0; gi < GH; ++gi)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                acc[gi][n * 8 + e] = fmaf(pw[gi][u], vf[e], acc[gi][n * 8 + e]);
          }
        }
      }
    }
    __syncthreads();                       // stage t & 1 may be refilled
  }

  // merge the R key strides of each head through shared memory
  const int PG = P * GH;
  float* acc_s = reinterpret_cast<float*>(smem_raw);   // [R][PG][hdp]
  float* ml_s = acc_s + (size_t)R * PG * hdp;          // [R][PG][2]
  if (active) {
#pragma unroll
    for (int gi = 0; gi < GH; ++gi) {
      const int row = r * PG + p * GH + gi;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc_s[(size_t)row * hdp + (n * L + c) * 8 + e] = acc[gi][n * 8 + e];
      if (c == 0) {
        ml_s[2 * row] = m[gi];
        ml_s[2 * row + 1] = l[gi];
      }
    }
  }
  __syncthreads();
  finish(acc_s, ml_s, R, PG, hdp, gc, hd, hpb, w, nsplit, part, tickets,
         reinterpret_cast<float*>(smem_raw), o_sh);
}

// ---------------------------------------------------------------------------
//  bf16: the group's heads as the 16 rows of mma.sync tiles
// ---------------------------------------------------------------------------
constexpr int kTcRows = 16;   // heads per block (rows of the m16n8k16 tile)
constexpr int kTcTK = 64;     // keys per tile: 16 per warp

template <int HD>
struct TcShape {
  static constexpr bool kQRegs = HD <= 128;   // Q fragments in registers
  static constexpr size_t tiles =             // q tile, then the ring
      sizeof(__nv_bfloat16) * ((size_t)kTcRows * HD + 4 * (size_t)kTcTK * HD);
  static constexpr size_t merge =             // 4 warps x 16 rows
      sizeof(float) * 4 * kTcRows * ((size_t)HD + 5);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_tc(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                    unsigned* __restrict__ tickets, int H, int Hkv, int S,
                    int hpb, int kps, int nsplit, float scale,
                    long long q_sb, long long q_sh,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long o_sb, long long o_sh) {
  constexpr int CPR = HD / 8;
  constexpr int DT = HD / 8;          // output n-tiles of 8 dims
  constexpr int KS = HD / 16;         // k-steps of S = Q K^T
  constexpr bool kQRegs = TcShape<HD>::kQRegs;
  Work<__nv_bfloat16> w;
  if (!block_work(lengths, out, H, Hkv, S, HD, hpb, kps, o_sb, o_sh, &w))
    return;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, its row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = q_s + kTcRows * HD;  // [stage][k, v][kTcTK][HD]

  const __nv_bfloat16* kb = k + w.b * k_sb + w.kvh * k_sh;
  const __nv_bfloat16* vb = v + w.b * v_sb + w.kvh * v_sh;
  const int ntiles = (w.end - w.start + kTcTK - 1) / kTcTK;

  // the block's heads as rows of the q tile; rows past gc are zeros
  load_tile<HD, kTcRows, kThreads>(
      q_s, q + w.b * q_sb + (long long)w.head0 * q_sh, q_sh, 0, w.gc);
  load_tile<HD, kTcTK, kThreads>(ring, kb, k_ss, w.start, w.end);
  load_tile<HD, kTcTK, kThreads>(ring + kTcTK * HD, vb, v_ss, w.start, w.end);
  cp_commit();

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  unsigned qf[kQRegs ? KS : 1][4];
  const int qrow = (mi & 1) * 8 + mr;   // this lane's ldmatrix row of q
  const int kw0 = warp * 16;            // this warp's keys in a tile

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = w.start + t * kTcTK;
    if (t + 1 < ntiles) {
      __nv_bfloat16* nk = ring + ((t + 1) & 1) * 2 * kTcTK * HD;
      load_tile<HD, kTcTK, kThreads>(nk, kb, k_ss, t0 + kTcTK, w.end);
      load_tile<HD, kTcTK, kThreads>(nk + kTcTK * HD, vb, v_ss, t0 + kTcTK,
                                     w.end);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const __nv_bfloat16* ks = ring + (t & 1) * 2 * kTcTK * HD;
    const __nv_bfloat16* vs = ks + kTcTK * HD;
    if constexpr (kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qf[kk], q_s + swz<CPR>(qrow, kk * 2 + (mi >> 1)));
      }
    }
    const int nk = min(kTcTK, w.end - t0);
    if (kw0 < nk) {
      // S = Q K^T: 16 heads x this warp's 16 keys
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned a[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldsm_x4(a, q_s + swz<CPR>(qrow, kk * 2 + (mi >> 1)));
        }
        unsigned bf[4];
        ldsm_x4(bf, ks + swz<CPR>(kw0 + (mi >> 1) * 8 + mr,
                                  kk * 2 + (mi & 1)));
        mma16816(s[0], a, bf[0], bf[1]);
        mma16816(s[1], a, bf[2], bf[3]);
      }
      // scale; keys past the tile's end are masked (their v rows are 0)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kw0 + n * 8 + 2 * t4 + (e & 1);
          s[n][e] = kj < nk ? s[n][e] * scale : kNegInf;
        }
      // online softmax for the lane's two rows (heads g and g + 8)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = fmaxf(fmaxf(s[0][2 * rr], s[0][2 * rr + 1]),
                         fmaxf(s[1][2 * rr], s[1][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mrow[rr], mx);
        const float corr = __expf(mrow[rr] - m_new);
        mrow[rr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
            const float p =
                s[n][e] == kNegInf ? 0.f : __expf(s[n][e] - m_new);
            s[n][e] = p;
            sum += p;
          }
        lrow[rr] = lrow[rr] * corr + sum;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[d][2 * rr] *= corr;
          o[d][2 * rr + 1] *= corr;
        }
      }
      // O += P V, P packed from the score accumulators
      const unsigned a[4] = {pack_bf16(s[0][0], s[0][1]),
                             pack_bf16(s[0][2], s[0][3]),
                             pack_bf16(s[1][0], s[1][1]),
                             pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        unsigned bf[4];
        ldsm_x4_t(bf, vs + swz<CPR>(kw0 + (mi & 1) * 8 + mr,
                                    dp * 2 + (mi >> 1)));
        mma16816(o[2 * dp], a, bf[0], bf[1]);
        mma16816(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();                  // this stage may be refilled
  }
  cp_wait_all();

  // each warp's state (16 rows) into shared memory, merged by finish()
  float* acc_s = reinterpret_cast<float*>(smem_raw);   // [4][16][HD]
  float* ml_s = acc_s + 4 * kTcRows * HD;              // [4][16][2]
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = lrow[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = warp * kTcRows + g + rr * 8;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc_s[row * HD + d * 8 + 2 * t4] = o[d][2 * rr];
      acc_s[row * HD + d * 8 + 2 * t4 + 1] = o[d][2 * rr + 1];
    }
    if (t4 == 0) {
      ml_s[2 * row] = mrow[rr];
      ml_s[2 * row + 1] = l;
    }
  }
  __syncthreads();
  finish(acc_s, ml_s, 4, kTcRows, HD, w.gc, HD, hpb, w, nsplit, part,
         tickets, reinterpret_cast<float*>(smem_raw), o_sh);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const int* lengths,
              void* out, void* part, void* tickets, int B, int H, int Hkv,
              int S, int hpb, int kps, int nsplit, const long long* st,
              cudaStream_t stream) {
  static unsigned done = 0;
  size_t smem = TcShape<HD>::tiles;
  if (TcShape<HD>::merge > smem) smem = TcShape<HD>::merge;
  if (fold_bytes(hpb) > smem) smem = fold_bytes(hpb);
  cudaError_t err =
      smem_once((const void*)decode_attention_tc<HD>, smem, &done);
  if (err != cudaSuccess) return (int)err;
  const int G = H / Hkv;
  dim3 grid(nsplit, B * Hkv * ((G + hpb - 1) / hpb));
  using bf16 = __nv_bfloat16;
  decode_attention_tc<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lengths, static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<unsigned*>(tickets), H, Hkv, S,
      hpb, kps, nsplit, (float)pow((double)HD, -0.5), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

// Lanes per key: a power of two covering hd in 8-element chunks, at most
// 32; NC chunks per lane cover the rest (hd <= 2048).
inline void lane_shape(int hd, int* L, int* NC) {
  int l = 1;
  while (l < 32 && l * 8 < hd) l <<= 1;
  int nc = 1;
  while (nc * 8 * l < hd) nc <<= 1;
  *L = l;
  *NC = nc;
}

template <typename T, int GH, int NC>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, void* part, void* tickets, int B, int H, int Hkv,
           int S, int hd, int hpb, int kps, int nsplit, int L,
           const long long* st, cudaStream_t stream) {
  const int hdp = 8 * NC * L;
  int TK = kTileBytes / (hdp * (int)sizeof(T));
  if (TK > 64) TK = 64;
  if (TK < 1) TK = 1;
  // the merge holds R * P <= kThreads / L lane groups of GH heads (a
  // block of the last head group may have fewer heads and more strides)
  if ((hpb + GH - 1) / GH > kThreads / L) return (int)cudaErrorInvalidValue;
  const size_t ring = 4 * (size_t)TK * hdp * sizeof(T);
  const size_t merge =
      sizeof(float) * (size_t)(kThreads / L) * GH * (hdp + 5);
  const size_t weights = fold_bytes(hpb);
  size_t smem = ring > merge ? ring : merge;
  if (weights > smem) smem = weights;
  if (smem > kSmemDefault) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  dim3 grid(nsplit, B * Hkv * ((G + hpb - 1) / hpb));
  decode_attention_kernel<T, GH, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out),
      static_cast<float*>(part), static_cast<unsigned*>(tickets), H, Hkv, S,
      hd, hpb, kps, nsplit, L, TK, (float)pow((double)hd, -0.5), st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lengths,
             void* out, void* part, void* tickets, int B, int H, int Hkv,
             int S, int hd, int hpb, int kps, int nsplit,
             const long long* st, cudaStream_t s) {
  int L, NC;
  lane_shape(hd, &L, &NC);
  const int groups = kThreads / L;         // lane groups in a block
  // heads per lane group: the fewest that give every head of the block a
  // group; more than one chunk per lane takes one head per group
  int GH = (hpb + groups - 1) / groups;
  if (GH > 4 || (NC > 1 && GH > 1)) return (int)cudaErrorInvalidValue;
  if (GH == 3) GH = 4;
#define REPRO_K1(gh, nc)                                                      \
  return launch<T, gh, nc>(q, k, v, lengths, out, part, tickets, B, H, Hkv,  \
                           S, hd, hpb, kps, nsplit, L, st, s)
  if (NC == 1) {
    if (GH == 1) REPRO_K1(1, 1);
    if (GH == 2) REPRO_K1(2, 1);
    REPRO_K1(4, 1);
  }
  if (NC == 2) REPRO_K1(1, 2);
  if (NC == 4) REPRO_K1(1, 4);
  REPRO_K1(1, 8);
#undef REPRO_K1
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hpb query heads per block, kps keys
// per split, nsplit splits (the wrapper's plan()); part: float32 scratch
// of B * Hkv * ceil(G / hpb) * nsplit * hpb * (hd + 2) elements; tickets:
// B * Hkv * ceil(G / hpb) * 33 unsigned ints, zero before the first launch and
// left zero by every launch.  strides (elements): q_sb, q_sh, k_sb, k_sh,
// k_ss, v_sb, v_sh, v_ss, out_sb, out_sh; the head-dim stride of every
// tensor is 1.  Returns a cudaError_t (0 on success).
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, void* part, void* tickets,
                                      int B, int H, int Hkv, int S, int hd,
                                      int hpb, int kps, int nsplit,
                                      const long long* strides,
                                      void* stream) {
  if (H % Hkv != 0 || hd < 1 || hd > 2048 || hpb < 1 || kps < 1 ||
      nsplit < 1 || nsplit > kMaxSplits || (long long)kps * nsplit < S)
    return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hpb <= kTcRows) {
#define REPRO_K1_TC(hd_)                                                     \
  return launch_tc<hd_>(q, k, v, len, out, part, tickets, B, H, Hkv, S, hpb, \
                        kps, nsplit, strides, s)
    if (hd == 32) REPRO_K1_TC(32);
    if (hd == 64) REPRO_K1_TC(64);
    if (hd == 128) REPRO_K1_TC(128);
    if (hd == 256) REPRO_K1_TC(256);
#undef REPRO_K1_TC
  }
  if (dtype == 0)
    return dispatch<float>(q, k, v, len, out, part, tickets, B, H, Hkv, S, hd,
                           hpb, kps, nsplit, strides, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, len, out, part, tickets, B, H,
                                   Hkv, S, hd, hpb, kps, nsplit, strides, s);
  return (int)cudaErrorInvalidValue;
}
