// K5 rglru_scan, backward: the gradients of h_t = a_t h_{t-1} + b_t.
//
// The Pallas TPU kernel src/repro/kernels/rglru_scan.py has no backward:
// the JAX package differentiates the plain recurrence with jax.grad.  This
// is the port's own kernel, behind kernels/rglru_scan.py::RGLRUScan.  With
// dh the gradient of h and g_t the gradient of the loss through h_t,
//   g_t  = dh_t + a_{t+1} g_{t+1}      (g past the last step is zero)
//   da_t = g_t h_{t-1}                 (h_{-1} = 0)
//   db_t = g_t
// g is the forward's recurrence run backwards in time, with coefficient
// a_{t+1} and input dh_t, so the forward's design carries over with time
// reversed (csrc/rglru_scan.cu, rglru_scan_windows): a block owns 32
// channels of one batch row; it walks time from the end in windows of
// kWarps * kSteps steps, warp w owning kSteps consecutive steps of each
// window (warp 0 the latest); each warp folds its steps into one pair
// (A, B) with g_out = A g_in + B, publishes it, takes its carry-in from the
// pairs of the warps after it in time, replays its steps from registers
// and writes da and db.  One barrier a window, pairs double-buffered, the
// next window's loads in flight while one is computed.  Steps before time
// 0 fold as the identity and are not stored; lanes past D do nothing.
//
// What bounds it on the H100: bytes.  It reads a, h and dh and writes da
// and db, all float32 (20 bytes per element): at recurrentgemma-9b's
// training shape (B=8, T=1024, D=4096) 671 MB, 0.200 ms at 3.35 TB/s.
//
// A short T (T <= kSteps, decode-sized) runs one thread per channel, the
// steps in the thread, as the forward does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 16;                 // steps per warp in a window
constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kWindow = kSteps * kWarps;   // steps per window

// Strides (elements) of the (B, T, D) tensors, batch then time.
struct Strides {
  long long a_sb, a_st, h_sb, h_st, dh_sb, dh_st, da_sb, da_st, db_sb, db_st;
};

// One reversed step: g = c g + x, then da = g hp, db = g.
struct Steps {
  float c[kSteps], x[kSteps], hp[kSteps];
};

// Issue the loads of reversed steps s .. s + kSteps - 1 (time t = T-1-s)
// of this lane's channel (not waited for): c = a_{t+1} (0 at the last
// step, where the carry is zero anyway), x = dh_t, hp = h_{t-1}.  Steps
// before time 0, and lanes past D, get the identity.
__device__ __forceinline__ void load_steps(Steps& q, const float* ap,
                                           const float* hp, const float* dp,
                                           const Strides& st, int s, int Tn,
                                           bool live) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int t = Tn - 1 - (s + i);
    q.c[i] = 1.f;
    q.x[i] = 0.f;
    q.hp[i] = 0.f;
    if (live && t >= 0) {
      q.c[i] = t + 1 < Tn ? __ldg(ap + (long long)(t + 1) * st.a_st) : 0.f;
      q.x[i] = __ldg(dp + (long long)t * st.dh_st);
      q.hp[i] = t >= 1 ? __ldg(hp + (long long)(t - 1) * st.h_st) : 0.f;
    }
  }
}

// One window for this warp's reversed steps s .. s + kSteps - 1: fold,
// publish, carry in, replay.  carry enters as g after the window (in time)
// and leaves as g at its earliest step.
__device__ __forceinline__ void window(const Steps& q, float2* pairs,
                                       float* dap, float* dbp,
                                       const Strides& st, int s, int Tn,
                                       bool live, int warp, int lane,
                                       float& carry) {
  float A = 1.f, Bw = 0.f;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    A *= q.c[i];
    Bw = fmaf(q.c[i], Bw, q.x[i]);
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
  float g = cin;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    g = fmaf(q.c[i], g, q.x[i]);
    const int t = Tn - 1 - (s + i);
    if (live && t >= 0) {
      dbp[(long long)t * st.db_st] = g;
      dap[(long long)t * st.da_st] = g * q.hp[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
rglru_bwd_windows(const float* __restrict__ a, const float* __restrict__ h,
                  const float* __restrict__ dh, float* __restrict__ da,
                  float* __restrict__ db, int Tn, int D, Strides st) {
  __shared__ float2 pairs[2][kWarps * 32];  // by window parity
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = blockIdx.x * 32 + lane;
  const bool live = d < D;
  const int bi = blockIdx.y;
  const float* ap = a + bi * st.a_sb + d;
  const float* hp = h + bi * st.h_sb + d;
  const float* dp = dh + bi * st.dh_sb + d;
  float* dap = da + bi * st.da_sb + d;
  float* dbp = db + bi * st.db_sb + d;
  const int nwin = (Tn + kWindow - 1) / kWindow;
  int s = warp * kSteps;                    // this warp's first reversed step
  float carry = 0.f;
  Steps x, y;
  load_steps(x, ap, hp, dp, st, s, Tn, live);
  for (int wi = 0; wi < nwin; wi += 2, s += 2 * kWindow) {
    if (wi + 1 < nwin) load_steps(y, ap, hp, dp, st, s + kWindow, Tn, live);
    window(x, pairs[0], dap, dbp, st, s, Tn, live, warp, lane, carry);
    if (wi + 1 < nwin) {
      if (wi + 2 < nwin)
        load_steps(x, ap, hp, dp, st, s + 2 * kWindow, Tn, live);
      window(y, pairs[1], dap, dbp, st, s + kWindow, Tn, live, warp, lane,
             carry);
    }
  }
}

// Short T: one thread per channel, the steps in the thread.
constexpr int kSeqThreads = 64;

__global__ void __launch_bounds__(kSeqThreads)
rglru_bwd_steps(const float* __restrict__ a, const float* __restrict__ h,
                const float* __restrict__ dh, float* __restrict__ da,
                float* __restrict__ db, int Tn, int D, Strides st) {
  const int d = blockIdx.x * kSeqThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const float* ap = a + bi * st.a_sb + d;
  const float* hp = h + bi * st.h_sb + d;
  const float* dp = dh + bi * st.dh_sb + d;
  float* dap = da + bi * st.da_sb + d;
  float* dbp = db + bi * st.db_sb + d;
  float g = 0.f;
  for (int t = Tn - 1; t >= 0; --t) {
    const float c = t + 1 < Tn ? ap[(long long)(t + 1) * st.a_st] : 0.f;
    g = fmaf(c, g, dp[(long long)t * st.dh_st]);
    dbp[(long long)t * st.db_st] = g;
    dap[(long long)t * st.da_st] =
        t >= 1 ? g * hp[(long long)(t - 1) * st.h_st] : 0.f;
  }
}

}  // namespace

// a, h (the forward's output), dh, da, db: (B, T, D) float32 with unit
// stride on D, B <= 65535.  strides (elements): a_sb, a_st, h_sb, h_st,
// dh_sb, dh_st, da_sb, da_st, db_sb, db_st.  Returns a cudaError_t (0 on
// success).
extern "C" int repro_rglru_scan_bwd(const void* a, const void* h,
                                    const void* dh, void* da, void* db,
                                    int B, int Tn, int D,
                                    const long long* strides, void* stream) {
  if (B < 1 || B > 65535 || Tn < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9]};
  const float* af = static_cast<const float*>(a);
  const float* hf = static_cast<const float*>(h);
  const float* dhf = static_cast<const float*>(dh);
  float* daf = static_cast<float*>(da);
  float* dbf = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tn <= kSteps) {
    dim3 grid((D + kSeqThreads - 1) / kSeqThreads, B);
    rglru_bwd_steps<<<grid, kSeqThreads, 0, s>>>(af, hf, dhf, daf, dbf, Tn,
                                                 D, st);
  } else {
    dim3 grid((D + 31) / 32, B);
    rglru_bwd_windows<<<grid, kThreads, 0, s>>>(af, hf, dhf, daf, dbf, Tn, D,
                                                st);
  }
  return (int)cudaGetLastError();
}
