// Tiles and loads shared by K4 rwkv_scan (csrc/rwkv_scan.cu) and its
// backward (csrc/rwkv_scan_bwd.cu): the chunk and head sizes, 256-thread
// blocks, float32 staging of a chunk's (T, M) rows from float32 or bf16
// inputs read through their strides (Staged), a column of logw straight
// into registers (seg_logw), and the 4 x 4 register tiles of a 64-row
// product (Tile).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kC = 64;                 // chunk: the model's CHUNK
constexpr int kM = 64;                 // head size, padded
constexpr int kP = kM + 4;             // row stride of a staged [t][m] tile
constexpr int kSeg = kThreads / kM;    // cumsum segments per column
constexpr int kSegLen = kC / kSeg;     // steps per segment
constexpr int kState = kM * kM;        // elements of one state

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store4(float* p, float4 v, int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    if (n > 0) p[0] = v.x;
    if (n > 1) p[1] = v.y;
    if (n > 2) p[2] = v.z;
    if (n > 3) p[3] = v.w;
  }
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}
__device__ __forceinline__ float f4(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The raw bits of 4 consecutive elements: a float4, or four bf16 in a
// uint2; unpack() makes the floats.
template <typename T> struct Raw4;
template <> struct Raw4<float> { using type = float4; };
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };
__device__ __forceinline__ float4 unpack(float4 v) { return v; }
__device__ __forceinline__ float4 unpack(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// The first n of the 4 elements at p (the rest zeros), element by element.
__device__ __forceinline__ float4 raw4_tail(const float* p, int n) {
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f,
                     n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}
__device__ __forceinline__ uint2 raw4_tail(const __nv_bfloat16* p, int n) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = i < n ? q[i] : 0u;
  return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

// Four elements at p, the first n of them inside the tensor, as floats:
// one vector load where aligned and whole, else element loads.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int n) {
  using R = typename Raw4<T>::type;
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & (sizeof(R) - 1)) == 0)
    return unpack(*reinterpret_cast<const R*>(p));
  return unpack(raw4_tail(p, n));
}

// Rows 0 .. kC - 1 (n of them valid) and columns col0 .. col0 + W of one
// (b, h, chunk) slice of a (T, M) input (row stride st).  load() puts the
// raw bits in registers and store() writes them to shared memory as
// float32, so all of a thread's loads are in flight before the first is
// used: a conversion between two loads would make the second wait for the
// first.  Where every chunk of 4 is aligned and whole (M a multiple of 4,
// the usual case, decided once per block) the loads are plain vector
// loads under a predicate; else element loads.  Rows past n and columns
// past M are zeros.
template <typename T, int W>
struct Staged {
  using R = typename Raw4<T>::type;
  static constexpr int Q = W / 4;                 // chunks of 4 per row
  static constexpr int N = kC * Q / kThreads;     // chunks per thread
  static_assert(N >= 1 && kC * Q % kThreads == 0, "tile shape");
  R v[N];
  __device__ __forceinline__ void load(const T* src, long long st, int n,
                                       int M, int col0) {
    const bool vec = M % 4 == 0 && st % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(src) & (sizeof(R) - 1)) == 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int t = i / Q, c = col0 + (i % Q) * 4;
      const T* p = src + t * st + c;
      if (vec)
        v[j] = t < n && c < M ? *reinterpret_cast<const R*>(p) : R{};
      else
        v[j] = t < n ? raw4_tail(p, M - c) : R{};
    }
  }
  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      *reinterpret_cast<float4*>(dst + (i / Q) * ld + (i % Q) * 4) =
          unpack(v[j]);
    }
  }
};

// Column m of logw over segment seg's kSegLen rows of the chunk, straight
// from device memory into registers (zeros past n or M): the 64 threads of
// a segment read each row's 64 floats together.
__device__ __forceinline__ void seg_logw(float (&lw)[kSegLen], const float* wb,
                                         long long st, int n, int M, int m,
                                         int seg) {
#pragma unroll
  for (int t = 0; t < kSegLen; ++t) {
    const int row = seg * kSegLen + t;
    lw[t] = row < n && m < M ? wb[row * st + m] : 0.f;
  }
}

// Register tile of an (kM rows) x JT product: thread tid owns the TR
// consecutive rows rg * TR .. + TR - 1 and the 4 columns 4 cg .. 4 cg + 3,
// so warp w owns rows 8 w .. 8 w + 7 whatever JT is.
template <int JT>
struct Tile {
  static constexpr int CG = JT / 4, RG = kThreads / CG, TR = kM / RG;
  int rg, cg;
  __device__ Tile() : rg(threadIdx.x / CG), cg(threadIdx.x % CG) {}
  __device__ int row(int a) const { return rg * TR + a; }
};

// TR consecutive floats at p (16-, 8- or 4-byte aligned by TR).
template <int TR>
__device__ __forceinline__ void ld_rows(const float* p, float* x) {
  if constexpr (TR == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (TR == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

}  // namespace
