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
//     y_t     = sum_n h_n * C_tn  +  D_c * x_t
//
// and the last h goes out for the decode cache.  dt and x are
// (B, S, d_inner), B and C (B, S, d_state), all float32 and contiguous;
// A is (d_inner, d_state), D (d_inner,), h0 and h_last
// (B, d_inner, d_state).  The build passes -fmad=false, so each multiply
// and add of the state rounds on its own, as the plain PyTorch version's
// separate operations do: h and h_last are the plain version's bits.
//
// What bounds it on the H100.  The bound counted is bytes: dt and x
// read once and y written once, 12 bytes per (b, t, c), 0.81 GB a call
// at falcon-mamba-7b's prefill (B 4, S 2048, d_inner 8192, d_state 16),
// 0.24 ms at 3.35 TB/s.  What holds the kernel above it is instruction
// issue: a state step is 14 instructions (dt * A; the precise expf's
// eight: five on the FP32 pipe, a shift, MUFU.EX2 and the scaling
// multiply; dt * B, * x, decay * h, + drive; one fused h * C + acc),
// 1.07 G state steps a call, and each of an SM's 4 schedulers issues
// one warp instruction a clock: 0.45 ms at 1.98 GHz before any load,
// shuffle, store or stall.  Neither the precise expf nor the state's
// separate roundings can go without changing the function's bits, so the
// design issues nothing else it can avoid and keeps every scheduler fed.
//
// The first version gave one thread a whole channel (B * d_inner
// threads, two warps a scheduler at that prefill), staged B and C with
// two barriers a run and nothing in flight, tested every step of a run
// against S, and branched around each y store.  The design now:
//  1. d_state is split over G = 2 lanes of a warp at d_state 16 (8
//     states a lane, twice the warps; 1 lane at d_state 4): each lane
//     walks its states op for op as above, so the state rounds exactly
//     as before.  Only y's sum changes: each lane sums its products
//     h * C with fused multiply-adds (explicit fmaf, one rounding where
//     the plain version's separate product and sum round twice) on two
//     accumulators, and the two lanes' partial sums meet through a
//     shuffle, the same bits in both lanes; the lane of state group 0
//     stores y, under a predicate (st.global with @p) rather than a
//     branch, which would cost a reconvergence barrier every step.
//  2. The block stages runs of kSteps time steps of dt and x (its 64
//     channels) and of B and C in shared memory with cp.async, 16 bytes
//     a copy where rows are aligned, in a ring of three runs: while one
//     run is walked the next two are in flight, and one barrier a run
//     both publishes a landed run and frees the oldest buffer.  A whole
//     run is walked unrolled with no test against S; only the last,
//     short run tests.
//  3. Lanes hold neighbouring channels (G lanes each), so the staged dt
//     and x rows are read without bank conflicts and a warp's y stores
//     are one contiguous segment; a lane reads its states' B and C of a
//     step as float4s, broadcast to the warp.
// Fusing softplus(dt) or the silu(z) gate would be another function,
// with another bound; it stays outside the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;  // channels per block
constexpr int kSteps = 16;     // time steps per staged run
constexpr int kStages = 3;     // runs in the ring: one walked, two loading

// lanes a channel's states are split over
template <int N>
__host__ __device__ constexpr int groups() {
  return N == 16 ? 2 : 1;
}

template <int N>
struct Ring {
  float dt[kStages][kSteps][kChannels];
  float x[kStages][kSteps][kChannels];
  float bc[kStages][kSteps][2 * N];  // a step's B, then its C
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 or 4 bytes; bytes past `valid` are filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most `kPending` of this thread's newest groups are
// still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// st.global under a predicate, where a branch around the store would
// cost a reconvergence barrier a step
__device__ __forceinline__ void store_if(float* p, float v, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p st.global.f32 [%0], %1;\n}\n"
      ::"l"(p), "f"(v), "r"(static_cast<int>(on))
      : "memory");
}

// Issues the copies of run `r` (steps r * kSteps ...) into ring slot
// r % kStages: the block's dt and x columns [c0, c0 + kChannels) and the
// B and C rows.  Steps past S are not copied (the walk never reads them),
// channels past d read as zeros.  `vec`: every row starts on 16 bytes.
template <int N, int kThreads>
__device__ __forceinline__ void stage(Ring<N>& ring, int r,
                                      const float* dt, const float* x,
                                      const float* bm, const float* cm,
                                      long long row, int s, int d, int c0,
                                      bool vec) {
  const int t0 = r * kSteps;
  const int steps = min(kSteps, s - t0);
  if (steps <= 0) return;
  const int slot = r % kStages;
  if (vec) {
    constexpr int kRowChunks = kChannels / 4;
    for (int i = threadIdx.x; i < 2 * kSteps * kRowChunks; i += kThreads) {
      const int which = i / (kSteps * kRowChunks);  // 0: dt, 1: x
      const int t = (i / kRowChunks) % kSteps;
      const int ch = i % kRowChunks;
      if (t >= steps) continue;
      const int c = c0 + 4 * ch;
      const long long off = (row + t0 + t) * d + min(c, d - 4);
      float* dst =
          which ? &ring.x[slot][t][4 * ch] : &ring.dt[slot][t][4 * ch];
      cp_async16(dst, (which ? x : dt) + off, c < d ? 16 : 0);
    }
    constexpr int kBcChunks = N / 4;  // per step, of B and of C
    for (int i = threadIdx.x; i < 2 * kSteps * kBcChunks; i += kThreads) {
      const int t = i / (2 * kBcChunks);
      const int j = i % (2 * kBcChunks);
      if (t >= steps) continue;
      const float* src = j < kBcChunks ? bm : cm;
      cp_async16(&ring.bc[slot][t][4 * j],
                 src + (row + t0 + t) * N + 4 * (j % kBcChunks), 16);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * kSteps * kChannels; i += kThreads) {
      const int which = i / (kSteps * kChannels);
      const int t = (i / kChannels) % kSteps;
      const int cl = i % kChannels;
      if (t >= steps) continue;
      const int c = c0 + cl;
      const long long off = (row + t0 + t) * d + min(c, d - 1);
      float* dst = which ? &ring.x[slot][t][cl] : &ring.dt[slot][t][cl];
      cp_async4(dst, (which ? x : dt) + off, c < d ? 4 : 0);
    }
    for (int i = threadIdx.x; i < kSteps * 2 * N; i += kThreads) {
      const int t = i / (2 * N);
      const int j = i % (2 * N);
      if (t >= steps) continue;
      const float* src = j < N ? bm : cm;
      cp_async4(&ring.bc[slot][t][j], src + (row + t0 + t) * N + j % N, 4);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kChannels * groups<N>())
    scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dv,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int s, int d, bool vec) {
  constexpr int G = groups<N>();
  constexpr int P = N / G;  // states a lane walks
  constexpr int kThreads = kChannels * G;
  static_assert(P % 4 == 0, "a lane's states are read as float4s");
  __shared__ __align__(16) Ring<N> ring;

  const int g = threadIdx.x % G;   // state group: states g * P ...
  const int cl = threadIdx.x / G;  // channel in the block
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const bool live = c < d;
  const long long row = static_cast<long long>(b) * s;  // first (b, t) row

  const int runs = (s + kSteps - 1) / kSteps;
  stage<N, kThreads>(ring, 0, dt, x, bm, cm, row, s, d, c0, vec);
  cp_async_commit();
  stage<N, kThreads>(ring, 1, dt, x, bm, cm, row, s, d, c0, vec);
  cp_async_commit();

  float h[P], an[P];
  const long long state = (static_cast<long long>(b) * d + c) * N + g * P;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    an[p] = live ? a[static_cast<long long>(c) * N + g * P + p] : 0.f;
    h[p] = (live && h0 != nullptr) ? h0[state + p] : 0.f;
  }
  const float dc = live ? dv[c] : 0.f;

  for (int r = 0; r < runs; ++r) {
    cp_async_wait<1>();  // run r has landed (the newest group is r + 1)
    __syncthreads();     // ... for every thread; run r - 1 is walked
    stage<N, kThreads>(ring, r + 2, dt, x, bm, cm, row, s, d, c0, vec);
    cp_async_commit();   // (an empty group past the last run)

    const int slot = r % kStages;
    const int t0 = r * kSteps;
    // one time step: the lane's P states, then y of the channel
    const auto step = [&](int t) {
      const float dtv = ring.dt[slot][t][cl];
      const float xv = ring.x[slot][t][cl];
      const float4* b4 = reinterpret_cast<const float4*>(
          &ring.bc[slot][t][g * P]);
      const float4* c4 = reinterpret_cast<const float4*>(
          &ring.bc[slot][t][N + g * P]);
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 bq = b4[q], cq = c4[q];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 4 * q + e;
          const float decay = expf(dtv * an[p]);
          const float drive = (dtv * bv[e]) * xv;
          h[p] = decay * h[p] + drive;
          acc[e % 2] = fmaf(h[p], cv[e], acc[e % 2]);
        }
      }
      float part = acc[0] + acc[1];
#pragma unroll
      for (int off = 1; off < G; off <<= 1)
        part = part + __shfl_xor_sync(0xffffffffu, part, off);
      store_if(y + (row + t0 + t) * d + c, part + dc * xv, live && g == 0);
    };
    if (t0 + kSteps <= s) {  // a whole run (the same for the block)
#pragma unroll
      for (int t = 0; t < kSteps; ++t) step(t);
    } else {
      for (int t = 0; t < s - t0; ++t) step(t);
    }
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int p = 0; p < P; ++p) h_last[state + p] = h[p];
  }
}

template <int N>
int launch_n(const float* dt, const float* x, const float* bm,
             const float* cm, const float* a, const float* dv,
             const float* h0, float* y, float* h_last, int batch, int s,
             int d, cudaStream_t stream) {
  const auto addr = [](const float* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  const bool vec = d % 4 == 0 &&
                   ((addr(dt) | addr(x) | addr(bm) | addr(cm)) & 15) == 0;
  const dim3 grid((d + kChannels - 1) / kChannels, batch);
  scan_kernel<N><<<grid, kChannels * groups<N>(), 0, stream>>>(
      dt, x, bm, cm, a, dv, h0, y, h_last, s, d, vec);
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
