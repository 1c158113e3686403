// K5 rglru_scan: the RG-LRU diagonal linear recurrence h_t = a_t h_{t-1} + b_t.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py, function
// rglru_scan (its _kernel body).  Same math: channels are independent, time
// is sequential, the carry is float32 and starts at zero (the model folds
// its h0 into b[:, 0]).  One difference: ragged T and D are masked here,
// where the Pallas grid floor-divides them away.
//
// What bounds it on the H100: bytes.  It reads a and b and writes h, all
// float32, once (12 bytes per element) for 2 flops per element, so the
// prefill of recurrentgemma-9b (B=1, T=4096, D=4096) needs 201 MB, 0.060 ms
// at 3.35 TB/s.  To reach that rate the card needs some MB of loads in
// flight; one thread per channel (the first design) gave 4,096 threads with
// 32 loads each, about 0.5 MB, and 5.5x the bound.
//
// Design: time is split across the warps of a block, and the steps each
// warp does not own are carried in by the associative form of one step,
// (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2) (combine in
// src/repro/models/rglru.py).  A block owns 32 channels of one batch row,
// one lane per channel, so each load of a warp is one 128-byte row of a
// time step; at B=1, D=4096 that is 128 blocks, about one per SM.  It walks
// T in windows of kWarps * kSteps steps; in each window warp w owns kSteps
// consecutive steps and
//   1. folds them, from the identity, into one pair (A_w, B_w) and
//      publishes it to shared memory;
//   2. after one barrier, reads the pairs of every warp: applied to the
//      block's carry, those before w give its carry-in, and all of them the
//      carry into the next window (every warp computes that for itself, so
//      one barrier a window suffices, with the pairs double-buffered);
//   3. replays its steps from the carry-in, from values still in
//      registers, and writes h.
// The loads of the next window are issued before the current one is
// computed (two register sets, used in turn), so each thread keeps up to
// 2 * 2 * kSteps loads in flight: up to 128 KB per SM.  a and b are read
// once and h written once: one pass over the bytes.  Steps past T fold as
// the identity (a = 1, b = 0) and are not stored; lanes past D neither
// load nor store.
//
// A decode step (T <= kSteps) keeps the light kernel of the first design,
// one thread per channel, with no window and no shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 16;                 // steps per warp in a window
constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kWindow = kSteps * kWarps;   // steps per window

struct Steps {
  float a[kSteps], b[kSteps];
};

// Issue the loads of steps t .. t + kSteps - 1 of this lane's channel (not
// waited for).  Steps past T, and lanes past D, get the identity.
__device__ __forceinline__ void load_steps(Steps& s, const float* ap,
                                           const float* bp, long long a_st,
                                           long long b_st, int t, int Tn,
                                           bool live) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    s.a[i] = 1.f;
    s.b[i] = 0.f;
    if (live && t + i < Tn) {
      s.a[i] = __ldg(ap + (long long)(t + i) * a_st);
      s.b[i] = __ldg(bp + (long long)(t + i) * b_st);
    }
  }
}

// One window for this warp's steps t .. t + kSteps - 1: fold, publish,
// carry in, replay.  carry enters as h before the window and leaves as h
// at its end.
__device__ __forceinline__ void window(const Steps& s, float2* pairs,
                                       float* hp, long long h_st, int t,
                                       int Tn, bool live, int warp,
                                       int lane, float& carry) {
  float A = 1.f, Bw = 0.f;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    A *= s.a[i];
    Bw = fmaf(s.a[i], Bw, s.b[i]);
  }
  pairs[warp * 32 + lane] = make_float2(A, Bw);
  __syncthreads();
  float c = carry, cin = carry;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) cin = c;
    const float2 p = pairs[w * 32 + lane];
    c = fmaf(p.x, c, p.y);
  }
  carry = c;
  float h = cin;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    h = fmaf(s.a[i], h, s.b[i]);
    if (live && t + i < Tn) hp[(long long)(t + i) * h_st] = h;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
rglru_scan_windows(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ h, int Tn, int D, long long a_sb,
                   long long a_st, long long b_sb, long long b_st,
                   long long h_sb, long long h_st) {
  __shared__ float2 pairs[2][kWarps * 32];  // by window parity
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = blockIdx.x * 32 + lane;
  const bool live = d < D;
  const int bi = blockIdx.y;
  const float* ap = a + bi * a_sb + d;
  const float* bp = b + bi * b_sb + d;
  float* hp = h + bi * h_sb + d;
  const int nwin = (Tn + kWindow - 1) / kWindow;
  int t = warp * kSteps;                    // this warp's first step
  float carry = 0.f;
  Steps x, y;
  load_steps(x, ap, bp, a_st, b_st, t, Tn, live);
  for (int wi = 0; wi < nwin; wi += 2, t += 2 * kWindow) {
    if (wi + 1 < nwin)
      load_steps(y, ap, bp, a_st, b_st, t + kWindow, Tn, live);
    window(x, pairs[0], hp, h_st, t, Tn, live, warp, lane, carry);
    if (wi + 1 < nwin) {
      if (wi + 2 < nwin)
        load_steps(x, ap, bp, a_st, b_st, t + 2 * kWindow, Tn, live);
      window(y, pairs[1], hp, h_st, t + kWindow, Tn, live, warp, lane,
             carry);
    }
  }
}

// Decode: one thread per channel, the few steps in the thread.
constexpr int kSeqThreads = 64;

__global__ void __launch_bounds__(kSeqThreads)
rglru_scan_steps(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ h, int Tn, int D, long long a_sb,
                 long long a_st, long long b_sb, long long b_st,
                 long long h_sb, long long h_st) {
  const int d = blockIdx.x * kSeqThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const float* ap = a + bi * a_sb + d;
  const float* bp = b + bi * b_sb + d;
  float* hp = h + bi * h_sb + d;
  float carry = 0.f;
  for (int t = 0; t < Tn; ++t) {
    carry = fmaf(ap[(long long)t * a_st], carry, bp[(long long)t * b_st]);
    hp[(long long)t * h_st] = carry;
  }
}

}  // namespace

// a, b, h: (B, T, D) float32 with unit stride on D, B <= 65535.  strides
// (elements): a_sb, a_st, b_sb, b_st, h_sb, h_st.  Returns a cudaError_t
// (0 on success).
extern "C" int repro_rglru_scan(const void* a, const void* b, void* h, int B,
                                int Tn, int D, const long long* strides,
                                void* stream) {
  if (B < 1 || B > 65535 || Tn < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* hf = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tn <= kSteps) {
    dim3 grid((D + kSeqThreads - 1) / kSeqThreads, B);
    rglru_scan_steps<<<grid, kSeqThreads, 0, s>>>(
        af, bf, hf, Tn, D, strides[0], strides[1], strides[2], strides[3],
        strides[4], strides[5]);
  } else {
    dim3 grid((D + 31) / 32, B);
    rglru_scan_windows<<<grid, kThreads, 0, s>>>(
        af, bf, hf, Tn, D, strides[0], strides[1], strides[2], strides[3],
        strides[4], strides[5]);
  }
  return (int)cudaGetLastError();
}
