// Mamba-1 selective scan for Hopper (sm_90a).
//
// No TPU kernel replaces this one: the reference computes the scan of
// src/repro/models/ssm.py::mamba_forward with lax.associative_scan
// (ssm.py:107), which materialises decay, drive and h, each of shape
// (B, S, d_inner, d_state) in float32, in device memory.  For each batch
// row b and channel c, with the state h of d_state values (h0 or zeros):
//
//   for t in 0 .. S-1:
//     decay_n = exp(dt_t * A_cn)          (precise expf, no fast math)
//     drive_n = (dt_t * B_tn) * x_t
//     h_n     = decay_n * h_n + drive_n   (multiply and add rounded apart)
//     y_t     = sum_n h_n * C_tn  +  D_c * x_t     (n in order)
//
// and the last h goes out for the decode cache.  dt and x are
// (B, S, d_inner), B and C (B, S, d_state), all float32 and contiguous;
// A is (d_inner, d_state), D (d_inner,), h0 and h_last
// (B, d_inner, d_state).  The build passes -fmad=false, so each multiply
// and add rounds on its own, as the plain PyTorch version's separate
// operations do.
//
// What bounds it on the H100: bytes.  dt and x are read once and y
// written once, 12 bytes per (b, t, c), against 8 float32 operations
// per (b, t, c, n) on the CUDA cores (the exp counted as one): at
// falcon-mamba-7b's prefill (B 4, S 2048, d_inner 8192, d_state 16)
// 0.81 GB over 3.35 TB/s is 0.24 ms, and 8.6 GFLOP over 67 TFLOP/s
// 0.13 ms.  The reference's three (B, S, d_inner, d_state) tensors
// would move 4.3 GB each.
//
// The design is the simple one: one thread per (b, c) walks the
// sequence with its d_state values of h and A in registers (templated
// on d_state: 4 for the reduced configs, 16 for the published ones), so
// nothing of size d_state goes to device memory but h_last.  Every
// channel of a block reads the same B and C rows: a run of kSteps time
// steps of them is staged in shared memory by the whole block, and each
// thread first loads its kSteps values of dt and x into registers (loads
// issued back to back, so their latency is paid once a run), then walks
// the run.  Neighbouring threads hold neighbouring channels, so the dt,
// x and y accesses of a warp are coalesced.  What this leaves on the
// table: B * d_inner threads (32768 at falcon-mamba's prefill) fill an
// eighth of the card's thread slots, and a thread's steps are a serial
// chain; splitting d_state over lanes with a warp reduction, or the
// sequence into chunks with a second pass, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kSteps = 16;     // time steps per staged run

template <int N>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dv,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int s, int d) {
  __shared__ float sb[kSteps][N];
  __shared__ float sc[kSteps][N];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < d;

  float h[N], an[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    an[n] = live ? a[static_cast<long long>(c) * N + n] : 0.f;
    h[n] = (live && h0 != nullptr)
               ? h0[(static_cast<long long>(b) * d + c) * N + n]
               : 0.f;
  }
  const float dc = live ? dv[c] : 0.f;
  const long long row = static_cast<long long>(b) * s;  // first (b, t) row

  for (int t0 = 0; t0 < s; t0 += kSteps) {
    const int steps = min(kSteps, s - t0);
    __syncthreads();  // the previous run's B and C are consumed
    for (int i = threadIdx.x; i < kSteps * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const long long off = (row + t0 + t) * N + n;
      sb[t][n] = t < steps ? bm[off] : 0.f;
      sc[t][n] = t < steps ? cm[off] : 0.f;
    }
    float dts[kSteps], xs[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const long long off = (row + t0 + t) * d + c;
      dts[t] = (live && t < steps) ? dt[off] : 0.f;
      xs[t] = (live && t < steps) ? x[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (t < steps) {
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float decay = expf(dts[t] * an[n]);
          const float drive = (dts[t] * sb[t][n]) * xs[t];
          h[n] = decay * h[n] + drive;
          acc = acc + h[n] * sc[t][n];
        }
        if (live) y[(row + t0 + t) * d + c] = acc + dc * xs[t];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      h_last[(static_cast<long long>(b) * d + c) * N + n] = h[n];
  }
}

template <int N>
int launch_n(const float* dt, const float* x, const float* bm,
             const float* cm, const float* a, const float* dv,
             const float* h0, float* y, float* h_last, int batch, int s,
             int d, cudaStream_t stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, batch);
  scan_kernel<N><<<grid, kThreads, 0, stream>>>(dt, x, bm, cm, a, dv, h0, y,
                                                h_last, s, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 or the CUDA error of the launch; -1 for a d_state the
// library is not built for.
extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* bm, const void* cm,
                                     const void* a, const void* dv,
                                     const void* h0, void* y, void* h_last,
                                     int batch, int s, int d, int d_state,
                                     void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  switch (d_state) {
    case 4:
      return launch_n<4>(f(dt), f(x), f(bm), f(cm), f(a), f(dv), f(h0),
                         static_cast<float*>(y), static_cast<float*>(h_last),
                         batch, s, d, st);
    case 16:
      return launch_n<16>(f(dt), f(x), f(bm), f(cm), f(a), f(dv), f(h0),
                          static_cast<float*>(y),
                          static_cast<float*>(h_last), batch, s, d, st);
    default:
      return -1;
  }
}
