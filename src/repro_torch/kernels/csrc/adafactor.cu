// Adafactor's update of one parameter leaf: the factored second moment
// (the row and column means of g^2), relative step clipping and weight
// decay, written into the parameter in place.
//
// Replaces no Pallas kernel: the JAX package leaves its optimizer
// (src/repro/train/optimizer.py, apply_updates' Adafactor branch) to XLA,
// which fuses it.  In eager PyTorch the same formula was about twenty
// float32 elementwise and reduction kernels a leaf, each a full pass over
// it, beside float32 copies of the leaf.  Same math, float32 throughout,
// the reference's 1e-30 and eps terms and clamps; three differences: sums
// are taken in another order; scale^2 is taken out of the row and column
// means (mean((scale g)^2 + 1e-30) = scale^2 mean(g^2) + 1e-30), so that
// the first pass can run before the global norm is known; and the
// divisions by a matrix's denominator and by the clip go through its
// reciprocal with one correction (div_by), which rounds as a division
// but in rare cases.
//
// What bounds it on the H100: bytes.  One step needs three passes over a
// leaf, because the clip scale needs every leaf's gradient norm and the
// relative step clipping needs the whole update's RMS:
//   1. adafactor_stats reads the gradient once: each row's sum of g^2 over
//      a column tile (rowpart), each column's over a unit of rows
//      (colpart), and the leaf's sum of squares (parts, one a block);
//      adafactor_reduce adds those partials in a fixed order into the
//      row sums (Bt, R), the column sums (Bt, C) and the leaf's total;
//   2. (after the global norm) adafactor_finish updates vr and vc from the
//      sums and forms each matrix's denominator max(mean_R vr, 1e-30);
//      adafactor_rms reads the gradient again for the sum of the
//      preconditioned update's squares (one partial a block);
//   3. adafactor_apply adds those partials (each block alike), reads the
//      gradient and the parameter and writes the parameter.
// That is 3 x 2 + 2 + 2 = 10 bytes a bf16 parameter, 8.7 G parameters in
// 26 ms at 3.35 TB/s, against about 174 bytes a parameter before.  A leaf
// is seen as a batch of matrices (Bt, R, C): R and C its two trailing dims,
// which Adafactor factors, Bt the product of the rest.  A unit of work is
// one tile of cp * VEC columns by rs rows of one matrix: cp threads across
// the tile, 256 / cp row groups down it, VEC = 8 consecutive elements a
// thread (one 16-byte load of bf16, two of float32) where the columns and
// the pointers allow, else 1.  The grids are persistent (the blocks the
// card holds at once, each walking units), so a pass's block partials are
// few and the third pass can add the second's in every block.  Every
// reduction has a fixed order: no float atomics, the same bits every run.
// No host synchronisation: the scale, decay and learning rate are read
// from 0-d device tensors.  Flat and element offsets are 64-bit: a stacked
// expert leaf holds 3 x 128 x 4096 x 1536 elements, above 2^31.
//
// A leaf of fewer than two dims is not factored: vr is elementwise, and
// the _flat kernels do passes 1 to 3 on it one element a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTiny = 1e-30f;

using bf16 = __nv_bfloat16;

struct Geo {
  long long Bt;      // matrices
  int R, C;          // rows and columns of each
  int cp;            // threads across a column tile (a power of two <= 32)
  int rs;            // rows a unit
  int nct, nrs;      // column tiles, row units
  long long units;   // Bt * nrs * nct
};

struct Unit {
  long long b;       // matrix
  int s, ct;         // row unit, column tile
};

__device__ __forceinline__ Unit unit_of(const Geo& geo, long long u) {
  const long long t = u / geo.nct;
  return {t / geo.nrs, (int)(t % geo.nrs), (int)(u % geo.nct)};
}

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// VEC consecutive elements as float32: VEC = 8 reads 16 bytes of bf16 or 32
// of float32 (the caller guarantees 16-byte alignment), VEC = 1 one element
template <int VEC>
__device__ __forceinline__ void load(const bf16* p, float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    x[0] = to_f(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    x[0] = *p;
  }
}

// store rounds to nearest even, as a float32 -> bf16 copy_ does
template <int VEC>
__device__ __forceinline__ void store(bf16* p, const float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    put(p, x[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    *p = x[0];
  }
}

// x / d from r = 1 / d rounded to nearest: q = x r and one correction by
// the residual x - q d, exact in a fused multiply-add (Markstein): the
// correctly rounded quotient but in rare cases, which are one ulp off.  A
// division takes about ten instructions an element, this three; d is one
// matrix's denominator or the clip, so r is taken once a unit.
__device__ __forceinline__ float div_by(float x, float d, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, d, x), r, q);
}

// The sum of v over the block in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  __syncthreads();                          // warp_sums is free again
  return total;
}

// The sum of a pass's block partials, in the same order in every block.
__device__ __forceinline__ float parts_sum(const float* parts, int nparts,
                                           float* warp_sums) {
  float v = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kThreads) v += parts[i];
  return block_sum(v, warp_sums);
}

// Pass 1: rowpart (Bt, R, nct), colpart (Bt, nrs, C), parts (gridDim.x).
template <typename G, int VEC>
__global__ void __launch_bounds__(kThreads)
adafactor_stats(const G* __restrict__ g, Geo geo, float* __restrict__ rowpart,
                float* __restrict__ colpart, float* __restrict__ parts) {
  __shared__ float cols[kThreads * VEC];    // (row group, tile column)
  __shared__ float warp_sums[kWarps];
  const int cp = geo.cp, rp = kThreads / cp, tile = cp * VEC;
  const int lane_c = threadIdx.x % cp, rl = threadIdx.x / cp;
  float sq = 0.f;
  for (long long u = blockIdx.x; u < geo.units; u += gridDim.x) {
    const Unit un = unit_of(geo, u);
    const int c0 = un.ct * tile + lane_c * VEC;
    const bool live = c0 < geo.C;           // VEC 8: C % 8 == 0, whole
    const int r_begin = un.s * geo.rs;
    const int r_end = min(geo.R, r_begin + geo.rs);
    const G* base = g + un.b * geo.R * geo.C + c0;
    float col[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) col[k] = 0.f;
    // the same trip count in every thread: the row sum's shuffles need
    // the whole warp
#pragma unroll 4
    for (int r0 = r_begin; r0 < r_end; r0 += rp) {
      const int r = r0 + rl;
      float x[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) x[k] = 0.f;
      if (live && r < r_end) load<VEC>(base + (long long)r * geo.C, x);
      float rsum = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float x2 = x[k] * x[k];
        col[k] += x2;
        rsum += x2;
      }
      for (int off = cp >> 1; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      if (lane_c == 0 && r < r_end) {
        rowpart[(un.b * geo.R + r) * geo.nct + un.ct] = rsum;
        sq += rsum;
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) cols[rl * tile + lane_c * VEC + k] = col[k];
    __syncthreads();
    for (int c = threadIdx.x; c < tile; c += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < rp; ++i) acc += cols[i * tile + c];
      const int cc = un.ct * tile + c;
      if (cc < geo.C)
        colpart[(un.b * geo.nrs + un.s) * geo.C + cc] = acc;
    }
    __syncthreads();
  }
  sq = block_sum(sq, warp_sums);
  if (threadIdx.x == 0) parts[blockIdx.x] = sq;
}

// Pass 1 of a leaf vr does not factor: its sum of squares only.
template <typename G>
__global__ void __launch_bounds__(kThreads)
adafactor_stats_flat(const G* __restrict__ g, long long n,
                     float* __restrict__ parts) {
  __shared__ float warp_sums[kWarps];
  float acc = 0.f;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float x = to_f(g[i]);
    acc += x * x;
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) parts[blockIdx.x] = acc;
}

// rowsum[i] = sum_t rowpart[i, t] (nrow rows of nct), colsum[b, c] =
// sum_s colpart[b, s, c] (ncol columns, nrs row units, C a matrix), and
// block 0 adds the block partials into *sq.
__global__ void __launch_bounds__(kThreads)
adafactor_reduce(const float* __restrict__ rowpart, int nct, long long nrow,
                 const float* __restrict__ colpart, int nrs, int C,
                 long long ncol, const float* __restrict__ parts, int nparts,
                 float* __restrict__ rowsum, float* __restrict__ colsum,
                 float* __restrict__ sq) {
  __shared__ float warp_sums[kWarps];
  if (blockIdx.x == 0) {
    const float total = parts_sum(parts, nparts, warp_sums);
    if (threadIdx.x == 0) *sq = total;
  }
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < nrow + ncol; i += (long long)gridDim.x * kThreads) {
    float acc = 0.f;
    if (i < nrow) {
      const float* p = rowpart + i * nct;
      for (int t = 0; t < nct; ++t) acc += p[t];
      rowsum[i] = acc;
    } else {
      const long long j = i - nrow, b = j / C;
      const float* p = colpart + b * nrs * C + (j - b * C);
      for (int s = 0; s < nrs; ++s) acc += p[(long long)s * C];
      colsum[j] = acc;
    }
  }
}

// vr <- decay vr + (1 - decay)(scale^2 rowsum / C + 1e-30), vc likewise
// over R, den = max(mean_R vr, 1e-30): one block a matrix.
__global__ void __launch_bounds__(kThreads)
adafactor_finish(const float* __restrict__ rowsum,
                 const float* __restrict__ colsum, float* __restrict__ vr,
                 float* __restrict__ vc, float* __restrict__ den, int R, int C,
                 const float* __restrict__ scale_p,
                 const float* __restrict__ decay_p) {
  __shared__ float warp_sums[kWarps];
  const long long b = blockIdx.x;
  const float scale = *scale_p, decay = *decay_p;
  const float s2 = scale * scale, keep = 1.f - decay;
  float acc = 0.f;
#pragma unroll 4
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const long long i = b * R + r;
    const float v = decay * vr[i] + keep * (s2 * (rowsum[i] / (float)C) + kTiny);
    vr[i] = v;
    acc += v;
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) den[b] = fmaxf(acc / (float)R, kTiny);
#pragma unroll 4
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const long long i = b * C + c;
    vc[i] = decay * vc[i] + keep * (s2 * (colsum[i] / (float)R) + kTiny);
  }
}

// Pass 2: parts[block] = the block's sum of (rsqrt(vr vc / den + eps)
// scale g)^2.
template <typename G, int VEC>
__global__ void __launch_bounds__(kThreads)
adafactor_rms(const G* __restrict__ g, Geo geo, const float* __restrict__ vr,
              const float* __restrict__ vc, const float* __restrict__ den,
              const float* __restrict__ scale_p, float eps,
              float* __restrict__ parts) {
  __shared__ float warp_sums[kWarps];
  const int cp = geo.cp, rp = kThreads / cp, tile = cp * VEC;
  const int lane_c = threadIdx.x % cp, rl = threadIdx.x / cp;
  const float scale = *scale_p;
  float acc = 0.f;
  for (long long u = blockIdx.x; u < geo.units; u += gridDim.x) {
    const Unit un = unit_of(geo, u);
    const int c0 = un.ct * tile + lane_c * VEC;
    if (c0 >= geo.C) continue;
    const int r_end = min(geo.R, un.s * geo.rs + geo.rs);
    const float d = den[un.b], rd = __frcp_rn(d);
    float cv[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) cv[k] = vc[un.b * geo.C + c0 + k];
    const G* base = g + un.b * geo.R * geo.C + c0;
    const float* vrb = vr + un.b * geo.R;
#pragma unroll 4
    for (int r = un.s * geo.rs + rl; r < r_end; r += rp) {
      float x[VEC];
      load<VEC>(base + (long long)r * geo.C, x);
      const float rv = vrb[r];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v =
            rsqrtf(div_by(rv * cv[k], d, rd) + eps) * (x[k] * scale);
        acc += v * v;
      }
    }
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) parts[blockIdx.x] = acc;
}

// Pass 2 unfactored: vr <- decay vr + (1 - decay)((scale g)^2 + 1e-30)
// elementwise, and the block's sum of (rsqrt(vr + eps) scale g)^2.
template <typename G>
__global__ void __launch_bounds__(kThreads)
adafactor_rms_flat(const G* __restrict__ g, long long n, float* __restrict__ vr,
                   const float* __restrict__ scale_p,
                   const float* __restrict__ decay_p, float eps,
                   float* __restrict__ parts) {
  __shared__ float warp_sums[kWarps];
  const float scale = *scale_p, decay = *decay_p, keep = 1.f - decay;
  float acc = 0.f;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float gs = to_f(g[i]) * scale;
    const float v = decay * vr[i] + keep * (gs * gs + kTiny);
    vr[i] = v;
    const float w = rsqrtf(v + eps) * gs;
    acc += w * w;
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) parts[blockIdx.x] = acc;
}

// Pass 3: p <- p - lr (u / max(rms, 1) + wd p), u as in pass 2, rms =
// sqrt(sum of pass 2's parts / n + 1e-30).
template <typename G, typename P, int VEC>
__global__ void __launch_bounds__(kThreads)
adafactor_apply(const G* __restrict__ g, P* __restrict__ p, Geo geo,
                const float* __restrict__ vr, const float* __restrict__ vc,
                const float* __restrict__ den,
                const float* __restrict__ scale_p,
                const float* __restrict__ lr_p,
                const float* __restrict__ parts, int nparts, float eps,
                float wd) {
  __shared__ float warp_sums[kWarps];
  const float n = (float)(geo.Bt * geo.R * geo.C);
  const float rms = sqrtf(parts_sum(parts, nparts, warp_sums) / n + kTiny);
  const float clip = fmaxf(rms, 1.f), rclip = __frcp_rn(clip);
  const float scale = *scale_p, lr = *lr_p;
  const int cp = geo.cp, rp = kThreads / cp, tile = cp * VEC;
  const int lane_c = threadIdx.x % cp, rl = threadIdx.x / cp;
  for (long long u = blockIdx.x; u < geo.units; u += gridDim.x) {
    const Unit un = unit_of(geo, u);
    const int c0 = un.ct * tile + lane_c * VEC;
    if (c0 >= geo.C) continue;
    const int r_end = min(geo.R, un.s * geo.rs + geo.rs);
    const float d = den[un.b], rd = __frcp_rn(d);
    float cv[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) cv[k] = vc[un.b * geo.C + c0 + k];
    const long long off = un.b * geo.R * geo.C + c0;
    const float* vrb = vr + un.b * geo.R;
#pragma unroll 4
    for (int r = un.s * geo.rs + rl; r < r_end; r += rp) {
      const long long at = off + (long long)r * geo.C;
      float x[VEC], w[VEC];
      load<VEC>(g + at, x);
      load<VEC>(p + at, w);
      const float rv = vrb[r];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = div_by(
            rsqrtf(div_by(rv * cv[k], d, rd) + eps) * (x[k] * scale), clip,
            rclip);
        w[k] = w[k] - (v + w[k] * wd) * lr;
      }
      store<VEC>(p + at, w);
    }
  }
}

template <typename G, typename P>
__global__ void __launch_bounds__(kThreads)
adafactor_apply_flat(const G* __restrict__ g, P* __restrict__ p, long long n,
                     const float* __restrict__ vr,
                     const float* __restrict__ scale_p,
                     const float* __restrict__ lr_p,
                     const float* __restrict__ parts, int nparts, float eps,
                     float wd) {
  __shared__ float warp_sums[kWarps];
  const float rms =
      sqrtf(parts_sum(parts, nparts, warp_sums) / (float)n + kTiny);
  const float clip = fmaxf(rms, 1.f);
  const float scale = *scale_p, lr = *lr_p;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float v = rsqrtf(vr[i] + eps) * (to_f(g[i]) * scale) / clip;
    const float w = to_f(p[i]);
    put(p + i, w - (v + w * wd) * lr);
  }
}

// ---------------------------------------------------------------------------
//  host side
// ---------------------------------------------------------------------------

// The blocks of kernel K the current card holds at once (at least one an
// SM), the occupancy asked once per kernel.
template <auto K>
int resident() {
  static const int per_sm = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, K, kThreads, 0) !=
        cudaSuccess)
      n = 1;
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per_sm * sms;
}

// A persistent grid for `work` units of kernel K, at most `cap` blocks.
template <auto K>
int grid_of(long long work, int cap) {
  long long n = resident<K>();
  if (work < n) n = work;
  if (cap < n) n = cap;
  return (int)(n > 0 ? n : 1);
}

bool geo_ok(Geo& geo, int vec) {
  if (geo.Bt < 1 || geo.R < 1 || geo.C < 1 || geo.cp < 1 || geo.cp > 32 ||
      (geo.cp & (geo.cp - 1)) || geo.rs < 1 || (vec != 1 && vec != 8) ||
      geo.C % vec)
    return false;
  geo.nct = (geo.C + geo.cp * vec - 1) / (geo.cp * vec);
  geo.nrs = (geo.R + geo.rs - 1) / geo.rs;
  geo.units = geo.Bt * geo.nrs * geo.nct;
  return true;
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename G, int VEC>
int stats_tiled(const void* g, Geo geo, float* rowpart, float* colpart,
                float* parts, int cap, cudaStream_t s) {
  const int grid = grid_of<&adafactor_stats<G, VEC>>(geo.units, cap);
  adafactor_stats<G, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const G*>(g), geo, rowpart, colpart, parts);
  return grid;
}

template <typename G>
int stats_flat(const void* g, long long n, float* parts, int cap,
               cudaStream_t s) {
  const int grid = grid_of<&adafactor_stats_flat<G>>(
      (n + kThreads - 1) / kThreads, cap);
  adafactor_stats_flat<G><<<grid, kThreads, 0, s>>>(
      static_cast<const G*>(g), n, parts);
  return grid;
}

struct Update {
  const void* g;
  void* p;
  Geo geo;
  const float *rowsum, *colsum;
  float *vr, *vc, *den, *parts;
  int cap;
  const float *scale, *decay, *lr;
  float eps, wd;
  cudaStream_t s;
};

template <typename G, typename P, int VEC>
void apply_tiled(const Update& a) {
  const Geo& geo = a.geo;
  adafactor_finish<<<(unsigned)geo.Bt, kThreads, 0, a.s>>>(
      a.rowsum, a.colsum, a.vr, a.vc, a.den, geo.R, geo.C, a.scale, a.decay);
  const int grid = grid_of<&adafactor_rms<G, VEC>>(geo.units, a.cap);
  adafactor_rms<G, VEC><<<grid, kThreads, 0, a.s>>>(
      static_cast<const G*>(a.g), geo, a.vr, a.vc, a.den, a.scale, a.eps,
      a.parts);
  const int grid3 = grid_of<&adafactor_apply<G, P, VEC>>(geo.units, 1 << 30);
  adafactor_apply<G, P, VEC><<<grid3, kThreads, 0, a.s>>>(
      static_cast<const G*>(a.g), static_cast<P*>(a.p), geo, a.vr, a.vc,
      a.den, a.scale, a.lr, a.parts, grid, a.eps, a.wd);
}

template <typename G, typename P>
void apply_flat(const Update& a) {
  const long long n = a.geo.C;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = grid_of<&adafactor_rms_flat<G>>(blocks, a.cap);
  adafactor_rms_flat<G><<<grid, kThreads, 0, a.s>>>(
      static_cast<const G*>(a.g), n, a.vr, a.scale, a.decay, a.eps, a.parts);
  const int grid3 = grid_of<&adafactor_apply_flat<G, P>>(blocks, 1 << 30);
  adafactor_apply_flat<G, P><<<grid3, kThreads, 0, a.s>>>(
      static_cast<const G*>(a.g), static_cast<P*>(a.p), n, a.vr, a.scale,
      a.lr, a.parts, grid, a.eps, a.wd);
}

template <typename G, typename P>
void apply_any(const Update& a, int factored, int vec) {
  if (!factored) return apply_flat<G, P>(a);
  if (vec == 8) return apply_tiled<G, P, 8>(a);
  apply_tiled<G, P, 1>(a);
}

}  // namespace

// Pass 1 of one leaf, g (Bt, R, C) contiguous, bf16 (g_f32 = 0) or float32:
// factored, rowsum (Bt, R) and colsum (Bt, C) float32 get the sums of g^2
// over each row and each column, through rowpart (Bt * R * nct floats) and
// colpart (Bt * nrs * C); *sq gets the sum of g^2 over the leaf.
// Unfactored (Bt = R = 1, C = the leaf's elements): *sq only.  parts holds
// cap floats.  The column tiles are cp * vec wide, the row units rs rows;
// vec 8 needs C % 8 == 0 and g 16-byte aligned.  Returns a cudaError_t (0
// on success).
extern "C" int repro_adafactor_stats(const void* g, int g_f32, int factored,
                                     long long Bt, int R, int C, int cp,
                                     int rs, int vec, void* rowpart,
                                     void* colpart, void* parts, int cap,
                                     void* rowsum, void* colsum, void* sq,
                                     void* stream) {
  Geo geo{Bt, R, C, cp, rs, 0, 0, 0};
  if (!geo_ok(geo, vec) || cap < 1 || (vec == 8 && !aligned(g)) ||
      (!factored && (Bt != 1 || R != 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(parts);
  float *rp = static_cast<float*>(rowpart), *cq = static_cast<float*>(colpart);
  int grid;
  if (!factored)
    grid = g_f32 ? stats_flat<float>(g, C, pp, cap, s)
                 : stats_flat<bf16>(g, C, pp, cap, s);
  else if (vec == 8)
    grid = g_f32 ? stats_tiled<float, 8>(g, geo, rp, cq, pp, cap, s)
                 : stats_tiled<bf16, 8>(g, geo, rp, cq, pp, cap, s);
  else
    grid = g_f32 ? stats_tiled<float, 1>(g, geo, rp, cq, pp, cap, s)
                 : stats_tiled<bf16, 1>(g, geo, rp, cq, pp, cap, s);
  const long long nrow = factored ? Bt * R : 0, ncol = factored ? Bt * C : 0;
  const int rgrid = grid_of<&adafactor_reduce>(
      (nrow + ncol + kThreads - 1) / kThreads, 1 << 30);
  adafactor_reduce<<<rgrid, kThreads, 0, s>>>(
      rp, geo.nct, nrow, cq, geo.nrs, C, ncol, pp, grid,
      static_cast<float*>(rowsum), static_cast<float*>(colsum),
      static_cast<float*>(sq));
  return (int)cudaGetLastError();
}

// Passes 2 and 3 of one leaf, after the global norm: factored, vr (Bt, R)
// and vc (Bt, C) float32 updated from rowsum and colsum, den (Bt) the
// matrices' denominators; unfactored (Bt = R = 1), vr (C) elementwise and
// vc, rowsum, colsum and den unused.  p (Bt, R, C) contiguous, bf16 (p_f32
// = 0) or float32, updated in place from g; scale, decay and lr 0-d float32
// on the device; parts holds cap floats.  vec 8 needs C % 8 == 0 and g and
// p 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int repro_adafactor_apply(
    const void* g, int g_f32, void* p, int p_f32, int factored, long long Bt,
    int R, int C, int cp, int rs, int vec, const void* rowsum,
    const void* colsum, void* vr, void* vc, void* den, void* parts, int cap,
    const void* scale, const void* decay, const void* lr, float eps,
    float wd, void* stream) {
  Geo geo{Bt, R, C, cp, rs, 0, 0, 0};
  if (!geo_ok(geo, vec) || cap < 1 ||
      (vec == 8 && !(aligned(g) && aligned(p))) ||
      (!factored && (Bt != 1 || R != 1)) ||
      (factored && Bt > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  const Update a{g, p, geo, static_cast<const float*>(rowsum),
                 static_cast<const float*>(colsum), static_cast<float*>(vr),
                 static_cast<float*>(vc), static_cast<float*>(den),
                 static_cast<float*>(parts), cap,
                 static_cast<const float*>(scale),
                 static_cast<const float*>(decay),
                 static_cast<const float*>(lr), eps, wd,
                 static_cast<cudaStream_t>(stream)};
  if (g_f32 && p_f32) apply_any<float, float>(a, factored, vec);
  else if (g_f32) apply_any<float, bf16>(a, factored, vec);
  else if (p_f32) apply_any<bf16, float>(a, factored, vec);
  else apply_any<bf16, bf16>(a, factored, vec);
  return (int)cudaGetLastError();
}
