// Helpers shared by the bf16 tensor-core kernels (K1, K2 and its
// backward, K3 and its backward): cp.async 16-byte copies into shared
// memory (stage8 for one chunk, load_tile for a swizzled tile of rows),
// ldmatrix fragment loads from XOR-swizzled tiles, mma.sync.m16n8k16 (bf16
// in, float32 accumulate), and the once-per-device dynamic shared-memory
// attribute.  Each source that
// includes this header is rebuilt when the header changes (_build.py
// hashes the headers a source includes).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_wait_one() { cp_wait<1>(); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Element offset of chunk c (8 bf16) of row r in a tile with CPR 16-byte
// chunks per row, XOR-swizzled so that ldmatrix's 8 rows (r0 .. r0 + 7,
// r0 a multiple of 8) hit 8 different groups of 4 banks, and no chunk
// leaves its row.  Each whole group of 8 chunks is XORed with r mod 8.  A
// trailing group of 4 (64-byte rows; hd 160's 20 chunks) is XORed within
// itself with (r / 2) mod 4.  When CPR is 4 mod 8, rows r and r + 1 start
// in opposite halves of the 8 bank groups, so both kinds of group stay
// conflict-free; CPR 4, 8, 16 and 32 keep the layouts they always had.
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CPR > 0 && CPR % 4 == 0,
                "rows of whole 64-byte groups: CPR a multiple of 4");
  constexpr int kMain = CPR & ~7;           // chunks in whole groups of 8
  if constexpr (kMain == CPR) {
    return (r * CPR + (c ^ (r & 7))) * 8;
  } else {
    const int cs = c < kMain ? c ^ (r & 7)
                             : kMain + ((c - kMain) ^ ((r >> 1) & 3));
    return (r * CPR + cs) * 8;
  }
}

// The 8 bf16 at src, of which the first n lie inside the tensor, into the
// 16-byte chunk dst: one cp.async when all 8 are inside and src is
// 16-byte aligned, else element loads with zero fill (src is dereferenced
// only inside the tensor).
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, int n) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
  } else {
    const __nv_bfloat16 z = __float2bfloat16(0.f);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = i < n ? src[i] : z;
  }
}

// Copy ROWS rows of HD bf16 (rows row0 + r of g, row stride rs) into the
// swizzled tile s, THREADS threads of the block taking part: cp.async
// where a chunk is 16-byte aligned, element loads where it is not, zeros
// for rows at or past nvalid.  The caller commits and waits.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g,
                                          long long rs, int row0,
                                          int nvalid) {
  constexpr int CPR = HD / 8;
  constexpr int N = ROWS * CPR;              // 16-byte chunks in the tile
  // a fixed trip count, unrolled: the row, chunk and swizzle of each of a
  // thread's chunks are affine in j, so their arithmetic is hoisted
#pragma unroll
  for (int j = 0; j < (N + THREADS - 1) / THREADS; ++j) {
    const int i = (int)threadIdx.x + j * THREADS;
    if (N % THREADS != 0 && i >= N) break;
    const int r = i / CPR, c = i - r * CPR;
    __nv_bfloat16* dst = s + swz<CPR>(r, c);
    if (row0 + r < nvalid) {
      const __nv_bfloat16* src = g + (long long)(row0 + r) * rs + c * 8;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = src[e];
      }
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Set a kernel's dynamic shared-memory limit once per device: done keeps
// one bit per device, in the caller's instantiation.
inline cudaError_t smem_once(const void* fn, size_t bytes, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (*done & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

}  // namespace
