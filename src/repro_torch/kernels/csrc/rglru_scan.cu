// K5 rglru_scan: the RG-LRU diagonal linear recurrence h_t = a_t h_{t-1} + b_t.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py, function
// rglru_scan (its _kernel body).  Same math: channels are independent, time
// is sequential, the carry is float32 and starts at zero (the model folds
// its h0 into b[:, 0]).  One difference: ragged T and D are masked here,
// where the Pallas grid floor-divides them away.
//
// What bounds it on the H100: bytes.  It reads a and b and writes h, all
// float32, once (12 bytes per element) for 2 flops per element.
//
// Design (simple and right first): one thread per channel, blocks of 64
// channels across D and one grid row per batch entry, so that the 32
// threads of a warp read 32 neighbouring floats of a time step (128 bytes,
// coalesced).  The loop over T runs in the thread with the carry in a
// register.  The loads do not depend on the carry, so each thread issues
// the a and b loads of kUnroll steps before it folds them in: that keeps
// 2 * kUnroll loads in flight per thread against the device memory's
// latency.  At B=1, D=4096 only 4,096 threads exist for the whole card;
// a chunked scan over T (a second pass to carry between chunks) is the
// next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int Tn, int D, long long a_sb,
                  long long a_st, long long b_sb, long long b_st,
                  long long h_sb, long long h_st) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const float* ap = a + bi * a_sb + d;
  const float* bp = b + bi * b_sb + d;
  float* hp = h + bi * h_sb + d;
  float carry = 0.f;
  int t = 0;
  for (; t + kUnroll <= Tn; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = ap[(long long)(t + i) * a_st];
      bv[i] = bp[(long long)(t + i) * b_st];
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      carry = av[i] * carry + bv[i];
      hp[(long long)(t + i) * h_st] = carry;
    }
  }
  for (; t < Tn; ++t) {
    carry = ap[(long long)t * a_st] * carry + bp[(long long)t * b_st];
    hp[(long long)t * h_st] = carry;
  }
}

}  // namespace

// a, b, h: (B, T, D) float32 with unit stride on D.  strides (elements):
// a_sb, a_st, b_sb, b_st, h_sb, h_st.  Returns a cudaError_t (0 on
// success).
extern "C" int repro_rglru_scan(const void* a, const void* b, void* h, int B,
                                int Tn, int D, const long long* strides,
                                void* stream) {
  if (B < 1 || Tn < 1 || D < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), Tn, D, strides[0], strides[1], strides[2],
      strides[3], strides[4], strides[5]);
  return (int)cudaGetLastError();
}
