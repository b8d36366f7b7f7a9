// Backward of the Mamba-1 selective scan for Hopper (sm_90a).
//
// No TPU kernel replaces this one: the reference gets the scan's
// gradient by autodiff of lax.associative_scan (src/repro/models/
// ssm.py:107), and the port's forward is its own kernel
// (selective_scan.cu), so its gradient is a kernel of the port's own.
// With the forward's recurrence per batch row b and channel c
//
//   decay_t = exp(dt_t * A)   drive_t = (dt_t * B_t) * x_t
//   h_t = decay_t * h_{t-1} + drive_t     y_t = sum_n h_t * C_t + D * x_t
//
// and the state's adjoint g (dh_last, or zero, after the last step),
// walked from t = S - 1 down to 0:
//
//   g    = carry + C_t * dy_t           (carry = decay_{t+1} * g_{t+1})
//   ddt_t = sum_n g * (A * decay_t * h_{t-1} + B_t * x_t)
//   dx_t  = sum_n g * dt_t * B_t + D * dy_t
//   dB_t  = sum_c g * dt_t * x_t       dC_t = sum_c h_t * dy_t
//   dA   += g * dt_t * decay_t * h_{t-1}   (summed over b and t)
//   dD   += dy_t * x_t                      (summed over b and t)
//   carry = decay_t * g;   after the walk dh0 = carry.
//
// dt, x, dy (B, S, d_inner), B, C (B, S, d_state), A (d_inner, d_state),
// D (d_inner,), h0 and dh_last (B, d_inner, d_state) or null, all
// float32 and contiguous.
//
// Design.  One block per (batch row, 64 channels), d_state split over
// G = 2 lanes at 16 states (8 states a lane) and 1 lane at 4, as the
// forward.  The walk back needs h_{t-1} and h_t at every step, and the
// block cannot keep (S, 64, d_state) states; so
//  1. pass 1 walks the forward recurrence once and stores the state
//     before every run of kRun = 8 steps into a scratch buffer
//     (B, S / 8, d_inner, d_state) the wrapper allocates (537 MB at
//     falcon-mamba-7b's training call, B 4, S 2048, d_inner 8192): a
//     global write and read are cheaper here than a second walk, which
//     would cost issue slots, the kernel's bound;
//  2. pass 2 takes the runs from last to first: it recomputes the run's
//     8 states from the stored one into registers (unrolled, 9 x 8
//     floats a lane at d_state 16) and walks them back with the formulas
//     above.  The build passes -fmad=false, as the forward's, so the
//     recomputed states are the forward's bits; the adjoint's sums use
//     explicit fmaf.
// dt, x, dy of the block's channels and B, C of a run are staged in
// shared memory by cp.async, two runs in a ring (the next one in flight
// while one is walked); a step past S reads zeros there (dt = 0 makes
// decay 1 and every term 0), so every run is walked whole and only the
// stores test against S.
//
// No atomics.  ddt and dx of a channel sum its lanes' shares by one
// shuffle.  dB and dC sum over every channel: each warp reduces the 2 *
// (states a lane) values of its lanes by a reduce-scatter of shuffles
// (each level halves the values a lane holds: 15 shuffles a step at
// d_state 16, where a butterfly would take 64), the warps' sums meet in
// shared memory in warp order, and each block writes its partial sums
// (B, S, blocks, 2 * d_state); dA and dD are per (b, channel) partials.
// A second kernel of the same launch sums the partials in index order.
// Two calls on the same inputs give the same bits.
//
// What bounds it on the H100.  Bytes: dt, x, dy read and ddt, dx
// written, 20 bytes per (b, t, c) (B, C, the small outputs and the
// scratch aside), 1.34 GB at falcon-mamba's call, 0.40 ms at 3.35 TB/s.
// Instruction issue: the state step's precise expf runs three times
// (pass 1, the recompute, the walk back, where decay is formed again
// rather than kept in registers) beside about 12 more instructions of
// the adjoint and 2 of the reduce-scatter: about 55 instructions per
// (b, t, c, n), 59 G at that call, some 1.8 ms at one warp instruction a
// clock on each of 528 schedulers at 1.98 GHz.  It is a first version:
// right, not fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;  // channels per block
constexpr int kRun = 8;        // steps between stored states
constexpr unsigned kFull = 0xffffffffu;

// lanes a channel's states are split over
template <int N>
__host__ __device__ constexpr int groups() {
  return N == 16 ? 2 : 1;
}

template <int N>
struct Ring {
  float dt[2][kRun][kChannels];
  float x[2][kRun][kChannels];
  float dy[2][kRun][kChannels];
  float bc[2][kRun][2 * N];  // a step's B, then its C
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
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issues the copies of run r (steps r * kRun ...) into ring slot r % 2:
// the block's dt, x (and dy when `grad`) columns [c0, c0 + kChannels) and
// the B and C rows.  Steps past S and channels past d read as zeros.
// `vec`: every row starts on 16 bytes.
template <int N, int kThreads>
__device__ __forceinline__ void stage(Ring<N>& ring, int r, bool grad,
                                      const float* dt, const float* x,
                                      const float* dy, const float* bm,
                                      const float* cm, long long row, int s,
                                      int d, int c0, bool vec) {
  const int t0 = r * kRun;
  const int slot = r % 2;
  const int arrays = grad ? 3 : 2;
  if (vec) {
    constexpr int kRowChunks = kChannels / 4;
    for (int i = threadIdx.x; i < arrays * kRun * kRowChunks;
         i += kThreads) {
      const int which = i / (kRun * kRowChunks);  // 0: dt, 1: x, 2: dy
      const int t = (i / kRowChunks) % kRun;
      const int ch = i % kRowChunks;
      const int c = c0 + 4 * ch;
      const bool in = c < d && t0 + t < s;
      const long long off =
          (row + min(t0 + t, s - 1)) * d + min(c, d - 4);
      float* dst = which == 0   ? &ring.dt[slot][t][4 * ch]
                   : which == 1 ? &ring.x[slot][t][4 * ch]
                                : &ring.dy[slot][t][4 * ch];
      const float* src = which == 0 ? dt : which == 1 ? x : dy;
      cp_async16(dst, src + off, in ? 16 : 0);
    }
    constexpr int kBcChunks = N / 4;  // per step, of B and of C
    for (int i = threadIdx.x; i < kRun * 2 * kBcChunks; i += kThreads) {
      const int t = i / (2 * kBcChunks);
      const int j = i % (2 * kBcChunks);
      const float* src = j < kBcChunks ? bm : cm;
      cp_async16(&ring.bc[slot][t][4 * j],
                 src + (row + min(t0 + t, s - 1)) * N + 4 * (j % kBcChunks),
                 t0 + t < s ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < arrays * kRun * kChannels; i += kThreads) {
      const int which = i / (kRun * kChannels);
      const int t = (i / kChannels) % kRun;
      const int cl = i % kChannels;
      const int c = c0 + cl;
      const bool in = c < d && t0 + t < s;
      const long long off = (row + min(t0 + t, s - 1)) * d + min(c, d - 1);
      float* dst = which == 0   ? &ring.dt[slot][t][cl]
                   : which == 1 ? &ring.x[slot][t][cl]
                                : &ring.dy[slot][t][cl];
      const float* src = which == 0 ? dt : which == 1 ? x : dy;
      cp_async4(dst, src + off, in ? 4 : 0);
    }
    for (int i = threadIdx.x; i < kRun * 2 * N; i += kThreads) {
      const int t = i / (2 * N);
      const int j = i % (2 * N);
      const float* src = j < N ? bm : cm;
      cp_async4(&ring.bc[slot][t][j],
                src + (row + min(t0 + t, s - 1)) * N + j % N,
                t0 + t < s ? 4 : 0);
    }
  }
}

// st.global under a predicate (no branch, no reconvergence barrier)
__device__ __forceinline__ void store_if(float* p, float v, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p st.global.f32 [%0], %1;\n}\n"
      ::"l"(p), "f"(v), "r"(static_cast<int>(on))
      : "memory");
}

// Sums v[0 .. V) over the warp's lanes of the same state group (lane
// bits log2(G) .. 4) by a reduce-scatter: at each level a lane keeps
// half of its values and adds its partner's share of them, until it
// holds one; the remaining levels add whole.  Returns which value's sum
// the lane holds (the index into v), in v[0].  A pair of lanes adds
// keep + received in the same order on every call.
template <int V, int G>
__device__ __forceinline__ int reduce_scatter(float (&v)[V], int lane) {
  constexpr int kLevels = G == 2 ? 4 : 5;
  int idx = 0;
#pragma unroll
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const int off = 16 >> lvl;
    const int h = V >> (lvl + 1);
    if (h >= 1) {
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const float send = upper ? v[j] : v[j + h];
        const float keep = upper ? v[j + h] : v[j];
        v[j] = keep + __shfl_xor_sync(kFull, send, off);
      }
      if (upper) idx += h;
    } else {
      v[0] = v[0] + __shfl_xor_sync(kFull, v[0], off);
    }
  }
  return idx;
}

template <int N>
__global__ void __launch_bounds__(kChannels * groups<N>())
    scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                    const float* __restrict__ bm,
                    const float* __restrict__ cm,
                    const float* __restrict__ a,
                    const float* __restrict__ dv,
                    const float* __restrict__ h0,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_last,
                    float* __restrict__ ckpt, float* __restrict__ part_bc,
                    float* __restrict__ part_a, float* __restrict__ part_d,
                    float* __restrict__ ddt, float* __restrict__ dx,
                    float* __restrict__ dh0, int s, int d, bool vec) {
  constexpr int G = groups<N>();
  constexpr int P = N / G;           // states a lane walks
  constexpr int kThreads = kChannels * G;
  constexpr int kWarps = kThreads / 32;
  constexpr int V = 2 * P;           // a lane's dB and dC shares a step
  // lanes of a warp holding the same sum after the reduce-scatter: the
  // levels that add whole (G = 1: 4 lanes; G = 2: 1)
  constexpr int kSame = (32 / G) / V;
  static_assert(P % 4 == 0, "a lane's states move as float4s");
  __shared__ __align__(16) Ring<N> ring;
  __shared__ float wsum[kRun][kWarps][2 * N];

  const int g = threadIdx.x % G;   // state group: states g * P ...
  const int cl = threadIdx.x / G;  // channel in the block
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int blocks = gridDim.x;
  const int c0 = blk * kChannels;
  const int c = c0 + cl;
  const bool live = c < d;
  const long long row = static_cast<long long>(b) * s;
  const int runs = (s + kRun - 1) / kRun;
  const long long state = (static_cast<long long>(b) * d + c) * N + g * P;

  float an[P], h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    an[p] = live ? a[static_cast<long long>(c) * N + g * P + p] : 0.f;
    h[p] = (live && h0 != nullptr) ? h0[state + p] : 0.f;
  }
  const float dc = live ? dv[c] : 0.f;
  // the stored state before run r
  const auto ckpt_at = [&](int r) {
    return reinterpret_cast<float4*>(
        ckpt + ((static_cast<long long>(b) * runs + r) * d + c) * N + g * P);
  };
  // one forward step of the lane's states from the staged run
  const auto forward = [&](float (&hs)[P], int slot, int t) {
    const float dtv = ring.dt[slot][t][cl];
    const float xv = ring.x[slot][t][cl];
    const float* bv = &ring.bc[slot][t][g * P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float decay = expf(dtv * an[p]);
      const float drive = (dtv * bv[p]) * xv;
      hs[p] = decay * hs[p] + drive;
    }
  };

  // pass 1: the state before every run
  stage<N, kThreads>(ring, 0, false, dt, x, dy, bm, cm, row, s, d, c0, vec);
  cp_async_commit();
  for (int r = 0; r < runs; ++r) {
    if (live) {
      float4* out = ckpt_at(r);
#pragma unroll
      for (int q = 0; q < P / 4; ++q)
        out[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                             h[4 * q + 3]);
    }
    if (r + 1 == runs) break;  // the last run is walked in pass 2 only
    stage<N, kThreads>(ring, r + 1, false, dt, x, dy, bm, cm, row, s, d, c0,
                       vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kRun; ++t) forward(h, r % 2, t);
    __syncthreads();  // slot r % 2 is staged again at r + 2
  }
  cp_async_wait<0>();
  __syncthreads();

  // pass 2: the runs from last to first
  float carry[P], da[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    carry[p] = (live && dh_last != nullptr) ? dh_last[state + p] : 0.f;
    da[p] = 0.f;
  }
  float dd = 0.f;
  stage<N, kThreads>(ring, runs - 1, true, dt, x, dy, bm, cm, row, s, d, c0,
                     vec);
  cp_async_commit();
  for (int r = runs - 1; r >= 0; --r) {
    if (r > 0)
      stage<N, kThreads>(ring, r - 1, true, dt, x, dy, bm, cm, row, s, d, c0,
                         vec);
    cp_async_commit();  // (an empty group before the first run)
    cp_async_wait<1>();
    __syncthreads();
    const int slot = r % 2;
    const int t0 = r * kRun;

    // the run's states: hs[0] the stored one, hs[t + 1] after step t
    float hs[kRun + 1][P];
    if (live) {
      const float4* in = ckpt_at(r);
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 v = in[q];
        hs[0][4 * q] = v.x;
        hs[0][4 * q + 1] = v.y;
        hs[0][4 * q + 2] = v.z;
        hs[0][4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) hs[0][p] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < kRun; ++t) {
#pragma unroll
      for (int p = 0; p < P; ++p) hs[t + 1][p] = hs[t][p];
      forward(hs[t + 1], slot, t);
    }

    // the walk back
#pragma unroll
    for (int t = kRun - 1; t >= 0; --t) {
      const float dtv = ring.dt[slot][t][cl];
      const float xv = ring.x[slot][t][cl];
      const float dyv = ring.dy[slot][t][cl];
      const float* bv = &ring.bc[slot][t][g * P];
      const float* cv = &ring.bc[slot][t][N + g * P];
      float ddt_part = 0.f, dx_part = 0.f;
      float v[V];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float gp = fmaf(cv[p], dyv, carry[p]);
        const float decay = expf(dtv * an[p]);
        const float ah = decay * hs[t][p];
        const float gdt = gp * dtv;
        ddt_part = fmaf(gp, fmaf(an[p], ah, bv[p] * xv), ddt_part);
        da[p] = fmaf(gdt, ah, da[p]);
        dx_part = fmaf(gdt, bv[p], dx_part);
        v[p] = gdt * xv;
        v[P + p] = hs[t + 1][p] * dyv;
        carry[p] = decay * gp;
      }
      dd = fmaf(dyv, xv, dd);
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
        ddt_part = ddt_part + __shfl_xor_sync(kFull, ddt_part, off);
        dx_part = dx_part + __shfl_xor_sync(kFull, dx_part, off);
      }
      const long long at = (row + t0 + t) * d + c;
      const bool out = live && g == 0 && t0 + t < s;
      store_if(ddt + at, ddt_part, out);
      store_if(dx + at, fmaf(dc, dyv, dx_part), out);
      const int idx = reduce_scatter<V, G>(v, lane);
      if ((lane / G) % kSame == 0)
        wsum[t][warp][(idx / P) * N + g * P + idx % P] = v[0];
    }
    __syncthreads();
    // the block's sums over its channels, warp after warp
    for (int i = threadIdx.x; i < kRun * 2 * N; i += kThreads) {
      const int t = i / (2 * N);
      const int j = i % (2 * N);
      if (t0 + t >= s) continue;
      float sum = wsum[t][0][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum = sum + wsum[t][w][j];
      part_bc[((row + t0 + t) * blocks + blk) * (2 * N) + j] = sum;
    }
    __syncthreads();  // slot r % 2 and wsum are written again at r - 1
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      dh0[state + p] = carry[p];
      part_a[state + p] = da[p];
    }
    if (g == 0) part_d[static_cast<long long>(b) * d + c] = dd;
  }
}

// dB, dC: the blocks' partials summed in block order; dA, dD: the batch
// rows' partials summed in row order.  One thread an output.
__global__ void scan_bwd_sums(const float* __restrict__ part_bc,
                              const float* __restrict__ part_a,
                              const float* __restrict__ part_d,
                              float* __restrict__ db, float* __restrict__ dc,
                              float* __restrict__ da, float* __restrict__ dd,
                              int batch, int s, int d, int n, int blocks) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n_bc = static_cast<long long>(batch) * s * 2 * n;
  if (i < n_bc) {
    const long long r = i / (2 * n);
    const int j = static_cast<int>(i % (2 * n));
    const float* src = part_bc + r * blocks * 2 * n + j;
    float sum = src[0];
    for (int k = 1; k < blocks; ++k) sum = sum + src[k * 2 * n];
    (j < n ? db : dc)[r * n + j % n] = sum;
    return;
  }
  i -= n_bc;
  const long long n_a = static_cast<long long>(d) * n;
  if (i < n_a) {
    float sum = part_a[i];
    for (int k = 1; k < batch; ++k) sum = sum + part_a[k * n_a + i];
    da[i] = sum;
    return;
  }
  i -= n_a;
  if (i < d) {
    float sum = part_d[i];
    for (int k = 1; k < batch; ++k) sum = sum + part_d[k * d + i];
    dd[i] = sum;
  }
}

template <int N>
int launch_n(const float* dt, const float* x, const float* bm,
             const float* cm, const float* a, const float* dv,
             const float* h0, const float* dy, const float* dh_last,
             float* ckpt, float* part_bc, float* part_a, float* part_d,
             float* ddt, float* dx, float* db, float* dc, float* da,
             float* dd, float* dh0, int batch, int s, int d,
             cudaStream_t stream) {
  const auto addr = [](const float* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  const bool vec =
      d % 4 == 0 &&
      ((addr(dt) | addr(x) | addr(dy) | addr(bm) | addr(cm)) & 15) == 0;
  const int blocks = (d + kChannels - 1) / kChannels;
  scan_bwd_kernel<N><<<dim3(blocks, batch), kChannels * groups<N>(), 0,
                       stream>>>(dt, x, bm, cm, a, dv, h0, dy, dh_last, ckpt,
                                 part_bc, part_a, part_d, ddt, dx, dh0, s, d,
                                 vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * s * 2 * N +
                          static_cast<long long>(d) * N + d;
  const int threads = 256;
  scan_bwd_sums<<<static_cast<unsigned>((total + threads - 1) / threads),
                  threads, 0, stream>>>(part_bc, part_a, part_d, db, dc, da,
                                        dd, batch, s, d, N, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 or the CUDA error of a launch; -1 for a d_state the library
// is not built for.  h0, dh_last may be null (zeros).
extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* x, const void* bm, const void* cm,
    const void* a, const void* dv, const void* h0, const void* dy,
    const void* dh_last, void* ckpt, void* part_bc, void* part_a,
    void* part_d, void* ddt, void* dx, void* db, void* dc, void* da,
    void* dd, void* dh0, int batch, int s, int d, int d_state,
    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  switch (d_state) {
    case 4:
      return launch_n<4>(f(dt), f(x), f(bm), f(cm), f(a), f(dv), f(h0),
                         f(dy), f(dh_last), o(ckpt), o(part_bc), o(part_a),
                         o(part_d), o(ddt), o(dx), o(db), o(dc), o(da),
                         o(dd), o(dh0), batch, s, d, st);
    case 16:
      return launch_n<16>(f(dt), f(x), f(bm), f(cm), f(a), f(dv), f(h0),
                          f(dy), f(dh_last), o(ckpt), o(part_bc), o(part_a),
                          o(part_d), o(ddt), o(dx), o(db), o(dc), o(da),
                          o(dd), o(dh0), batch, s, d, st);
    default:
      return -1;
  }
}
