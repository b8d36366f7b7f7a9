// Backward of the Mamba-1 selective scan for Hopper (sm_90a).
//
// No TPU kernel replaces this one: the reference gets the scan's
// gradient by autodiff of lax.associative_scan (src/repro/models/
// ssm.py:107), and the port's forward is its own kernel
// (selective_scan.cu), so its gradient is a kernel of the port's own.
// With the forward's recurrence per batch row b and channel c
//
//   decay_t = exp(dt_t * A)   drive_t = (dt_t * B_t) * x_t
//   ah_t = decay_t * h_{t-1}  h_t = ah_t + drive_t
//   y_t = sum_n h_t * C_t + D * x_t
//
// and the state's adjoint g (dh_last, or zero, after the last step),
// walked from t = S - 1 down to 0:
//
//   g    = carry + C_t * dy_t           (carry = decay_{t+1} * g_{t+1})
//   ddt_t = sum_n g * A * ah_t + x_t * sum_n g * B_t
//   dx_t  = dt_t * sum_n g * B_t + D * dy_t
//   dB_t  = sum_c g * (dt_t * x_t)      dC_t = sum_c h_t * dy_t
//   dA   += (g * ah_t) * dt_t           (summed over b and t)
//   dD   += dy_t * x_t                  (summed over b and t)
//   carry = decay_t * g;   after the walk dh0 = carry.
//
// dt, x, dy (B, S, d_inner), B, C (B, S, d_state), A (d_inner, d_state),
// D (d_inner,), h0 and dh_last (B, d_inner, d_state) or null, all
// float32 and contiguous.
//
// What bounds it on the H100.  Bytes: dt, x, dy read and ddt, dx
// written, 20 bytes per (b, t, c) (B, C, the small outputs and the
// scratch aside), 1.35 GB at falcon-mamba-7b's training call (B 4, S
// 2048, d_inner 8192, d_state 16): 0.40 ms at 3.35 TB/s.  What holds the
// kernel above it is instruction issue: 1.07 G (b, t, c, n) state steps,
// each walked forward twice (a pass that stores the state, then the
// recompute of the walk back; 13 instructions each, eight of them the
// precise expf, which -fmad=false and the forward's bits rule out
// replacing) and back once (7 instructions), beside the sums' shuffles,
// the shared-memory traffic and the copies: about 46 instructions per
// state step, 1.5 G warp instructions, 1.5 ms at one warp instruction a
// clock on each of 528 schedulers at 1.98 GHz.
//
// The design:
//  1. The whole grid in one wave.  Every block is a serial walk of S
//     steps, so a second, partial wave costs close to a whole block's
//     time.  A lane walks 2 channels x 4 states (8 pairs, a float4 of
//     states per channel), so a channel's 16 states span 4 lanes of a
//     warp (kLanesN; 1 lane at d_state 4) and a warp covers 16 channels;
//     a block is 64 channels, 128 threads.  What a run needs lives in
//     shared memory, not in registers, and __launch_bounds__(128, 4)
//     holds a thread to 128 registers: 4 blocks an SM (16 warps, 51 KB
//     of shared memory each), so falcon-mamba's 512 blocks fit the 528
//     slots of 132 SMs.
//  2. Two expf a state step, not three.  The state is stored every kRun
//     = 4 steps (1.07 GB of scratch at that call: a run's products and
//     decays, 2 x 4 x 8 floats a lane, must fit shared memory at 4
//     blocks an SM).  The walk back takes the runs from last to first:
//     the recompute forms each step's decay and decay * h_{t-1} once, op
//     for op as the forward (the build passes -fmad=false), keeps both
//     in shared memory and forms dC there; the walk reads them back.
//     The factored sums (ddt and dx through sum_n g * B) save 4
//     instructions a pair.
//  3. No load in the way of a run.  dt, x, dy, B, C and the next run's
//     stored state are staged by cp.async into a ring of two runs, one
//     run ahead (each lane copies its own stored state); one barrier a
//     run both publishes a landed run and frees the older one.  Each
//     thread's share of the copies is a fixed, unrolled list: a loop
//     whose trip count differs by thread cost branches, and hoisted
//     addresses spilled at the 128-register cap.
//  4. No atomics, every sum in a fixed order.  ddt and dx: each lane sums
//     its 4 states, the 4 lanes of a channel pair meet by a reduce-
//     scatter of shuffles (each lane ends with one of ddt / dx of its two
//     channels and stores it).  dB and dC: each lane sums its 2 channels,
//     a reduce-scatter over the warp's 8 channel pairs, the warps' sums
//     meet in shared memory in warp order, each block writes its partial
//     sums (B, S, blocks, 2 * d_state) (summed one run late, so the run's
//     barrier is the only one); dA and dD are per (b, channel) partials.
//     A second kernel of the same launch sums the partials in index
//     order.  Two calls on the same inputs give the same bits.
// A step past S reads zeros from the ring (dt = 0 makes decay 1 and
// every term 0), so every run is walked whole and only stores test S.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;  // channels per block
constexpr int kRun = 4;        // steps between stored states
constexpr int kLaneC = 2;      // channels a lane walks
constexpr int kLaneP = 4;      // states a lane walks per channel
constexpr int kPairs = kLaneC * kLaneP;
constexpr int kMinBlocks = 4;  // blocks an SM the walk is built for
constexpr unsigned kFull = 0xffffffffu;

// the lane geometry at d_state N
template <int N>
struct Geo {
  static constexpr int kLanesN = N / kLaneP;    // lanes of a channel pair
  static constexpr int kLanesC = 32 / kLanesN;  // channel pairs a warp
  static constexpr int kWarps = kChannels / (kLaneC * kLanesC);
  static constexpr int kThreads = 32 * kWarps;
  static_assert(kLaneC == 2 && kLaneP == 4,
                "a lane reads its channels as a float2, its states as float4s");
  static_assert(kLanesC % kLaneP == 0,
                "the dB / dC reduce-scatter leaves one sum a lane");
};

template <int N>
struct Smem {
  // the ring: two runs of the block's dt, x, dy, a step's B then its C,
  // and the state stored before the run
  float cols[3][2][kRun][kChannels];  // dt, x, dy
  float bc[2][kRun][2 * N];
  float ck[2][kChannels * N];
  // each thread's recompute of the run walked: decay_t * h_{t-1} and
  // decay_t of its pairs, a float4 a channel
  float4 ah[kRun][kLaneC][Geo<N>::kThreads];
  float4 dec[kRun][kLaneC][Geo<N>::kThreads];
  // each warp's dB (first N) and dC (last N) sums, two runs
  float wsum[2][kRun][Geo<N>::kWarps][2 * N];
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issues the copies of run r (steps r * kRun ...) into ring slot r % 2:
// the block's dt, x (and dy when kGrad) columns [c0, c0 + kChannels) and
// the B and C rows.  Steps past S and channels past d read as zeros.
// `vec`: every row starts on 16 bytes.  Each thread's share is a fixed
// list of chunks, unrolled (no loop whose trip count differs by thread).
template <int N, bool kGrad>
__device__ __forceinline__ void stage(Smem<N>& sm, int r,
                                      const float* dt, const float* x,
                                      const float* dy, const float* bm,
                                      const float* cm, long long row, int s,
                                      int d, int c0, bool vec) {
  constexpr int kThreads = Geo<N>::kThreads;
  constexpr int kArrays = kGrad ? 3 : 2;  // dt, x, dy
  const int t0 = r * kRun;
  const int slot = r % 2;
  // the (B, S, .) row of step t of the run, clamped into the tensor
  const auto step_row = [&](int t) {
    return row + min(t0 + t, s - 1);
  };
  const auto array = [&](int which) {
    return which == 0 ? dt : which == 1 ? x : dy;
  };
  if (vec) {
    constexpr int kRowChunks = kChannels / 4;
    constexpr int kChunks = kArrays * kRun * kRowChunks;
#pragma unroll
    for (int q = 0; q < (kChunks + kThreads - 1) / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (kChunks % kThreads != 0 && i >= kChunks) break;
      const int which = i / (kRun * kRowChunks);  // 0: dt, 1: x, 2: dy
      const int t = (i / kRowChunks) % kRun;
      const int ch = i % kRowChunks;
      const int c = c0 + 4 * ch;
      cp_async16(&sm.cols[which][slot][t][4 * ch],
                 array(which) + step_row(t) * d + min(c, d - 4),
                 c < d && t0 + t < s ? 16 : 0);
    }
    constexpr int kBcChunks = N / 4;  // per step, of B and of C
    constexpr int kBc = kRun * 2 * kBcChunks;
#pragma unroll
    for (int q = 0; q < (kBc + kThreads - 1) / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (kBc % kThreads != 0 && i >= kBc) break;
      const int t = i / (2 * kBcChunks);
      const int j = i % (2 * kBcChunks);
      cp_async16(&sm.bc[slot][t][4 * j],
                 (j < kBcChunks ? bm : cm) + step_row(t) * N +
                     4 * (j % kBcChunks),
                 t0 + t < s ? 16 : 0);
    }
  } else {
    constexpr int kChunks = kArrays * kRun * kChannels;
#pragma unroll
    for (int q = 0; q < (kChunks + kThreads - 1) / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (kChunks % kThreads != 0 && i >= kChunks) break;
      const int which = i / (kRun * kChannels);
      const int t = (i / kChannels) % kRun;
      const int cl = i % kChannels;
      const int c = c0 + cl;
      cp_async4(&sm.cols[which][slot][t][cl],
                array(which) + step_row(t) * d + min(c, d - 1),
                c < d && t0 + t < s ? 4 : 0);
    }
    constexpr int kBc = kRun * 2 * N;
#pragma unroll
    for (int q = 0; q < (kBc + kThreads - 1) / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (kBc % kThreads != 0 && i >= kBc) break;
      const int t = i / (2 * N);
      const int j = i % (2 * N);
      cp_async4(&sm.bc[slot][t][j],
                (j < N ? bm : cm) + step_row(t) * N + j % N,
                t0 + t < s ? 4 : 0);
    }
  }
}

// st.global under a predicate (no branch, no reconvergence barrier); no
// memory clobber: nothing in the kernel reads what it stores
__device__ __forceinline__ void store_if(float* p, float v, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p st.global.f32 [%0], %1;\n}\n"
      ::"l"(p), "f"(v), "r"(static_cast<int>(on)));
}

// Sums v[0 .. V) over the warp's lanes that differ in the lane bits
// kOffHi, kOffHi / 2, .. kOffLo by a reduce-scatter: at each level a lane
// keeps half of its values and adds its partner's share of them, until
// it holds one; the remaining levels add whole.  Returns the index into v
// of the first sum the lane holds (it holds V >> levels of them, or one).
// A pair of lanes adds keep + received in the same order on every call.
__host__ __device__ constexpr int levels(int hi, int lo) {
  return hi < lo || hi == 0 ? 0 : 1 + levels(hi / 2, lo);
}
template <int V, int kOffHi, int kOffLo>
__device__ __forceinline__ int reduce_scatter(float (&v)[V], int lane) {
  constexpr int kLevels = levels(kOffHi, kOffLo);
  int idx = 0;
#pragma unroll
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const int off = kOffHi >> lvl;
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
__global__ void __launch_bounds__(Geo<N>::kThreads, kMinBlocks)
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
  using G = Geo<N>;
  constexpr int kLanesN = G::kLanesN;
  constexpr int kWarps = G::kWarps;
  // lanes of a warp holding the same dB / dC sum after the reduce-
  // scatter over the channel pairs: the levels that add whole
  constexpr int kSame = G::kLanesC / kLaneP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nl = lane % kLanesN;  // states 4 nl .. 4 nl + 3
  const int cl = 2 * (warp * G::kLanesC + lane / kLanesN);  // in the block
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int blocks = gridDim.x;
  const int cb = blk * kChannels;  // the block's first channel
  const int c = cb + cl;           // the lane's channels c, c + 1
  const bool live[kLaneC] = {c < d, c + 1 < d};
  const long long row = static_cast<long long>(b) * s;
  const int runs = (s + kRun - 1) / kRun;
  // a lane's float4 of channel c + k in a (B, d, N) tensor
  const auto state_at = [&](int k) {
    return (static_cast<long long>(b) * d + c + k) * N + kLaneP * nl;
  };
  // the lane's stored state of channel c + k before run r (a live
  // channel's address for a channel past d)
  float* const ckpt_lane =
      ckpt + (static_cast<long long>(b) * runs * d + min(c, d - 1)) * N +
      kLaneP * nl;
  const auto ckpt_at = [&](int r, int k) {
    return ckpt_lane + static_cast<long long>(r) * d * N +
           (live[k] ? k * N : 0);
  };
  // a lane's two channels of staged column `which` (0 dt, 1 x, 2 dy)
  const auto pair_of = [&](int which, int slot, int t) {
    return *reinterpret_cast<const float2*>(&sm.cols[which][slot][t][cl]);
  };

  float an[kPairs], h[kPairs], dc[kLaneC];
#pragma unroll
  for (int k = 0; k < kLaneC; ++k) {
    dc[k] = live[k] ? dv[c + k] : 0.f;
#pragma unroll
    for (int p = 0; p < kLaneP; ++p) {
      an[kLaneP * k + p] =
          live[k] ? a[static_cast<long long>(c + k) * N + kLaneP * nl + p]
                  : 0.f;
      h[kLaneP * k + p] =
          (live[k] && h0 != nullptr) ? h0[state_at(k) + p] : 0.f;
    }
  }
  // one forward step of the lane's pairs from the staged step t: the
  // forward's operations, each rounded on its own; `on_pair(j, ah, decay)`
  // sees each pair's decay * h_{t-1} and decay
  const auto forward = [&](int slot, int t, auto&& on_pair) {
    const float2 dt2 = pair_of(0, slot, t);
    const float2 x2 = pair_of(1, slot, t);
    const float4 b4 =
        *reinterpret_cast<const float4*>(&sm.bc[slot][t][kLaneP * nl]);
    const float dtv[kLaneC] = {dt2.x, dt2.y};
    const float xv[kLaneC] = {x2.x, x2.y};
    const float bv[kLaneP] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int k = 0; k < kLaneC; ++k) {
#pragma unroll
      for (int p = 0; p < kLaneP; ++p) {
        const int j = kLaneP * k + p;
        const float decay = expf(dtv[k] * an[j]);
        const float drive = (dtv[k] * bv[p]) * xv[k];
        const float ah = decay * h[j];
        h[j] = ah + drive;
        on_pair(j, ah, decay);
      }
    }
  };

  // pass 1: the state before every run
  stage<N, false>(sm, 0, dt, x, dy, bm, cm, row, s, d, cb, vec);
  cp_async_commit();
  for (int r = 0; r < runs; ++r) {
#pragma unroll
    for (int k = 0; k < kLaneC; ++k)
      if (live[k])
        *reinterpret_cast<float4*>(ckpt_at(r, k)) =
            make_float4(h[kLaneP * k], h[kLaneP * k + 1],
                        h[kLaneP * k + 2], h[kLaneP * k + 3]);
    if (r + 1 == runs) break;  // the last run is walked in pass 2 only
    cp_async_wait_all();
    __syncthreads();  // run r landed; every thread is past run r - 1
    if (r + 2 < runs)
      stage<N, false>(sm, r + 1, dt, x, dy, bm, cm, row, s, d, cb, vec);
    cp_async_commit();
#pragma unroll
    for (int t = 0; t < kRun; ++t)
      forward(r % 2, t, [](int, float, float) {});
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free for pass 2

  // pass 2: the runs from last to first
  const auto stage_bwd = [&](int r) {
    stage<N, true>(sm, r, dt, x, dy, bm, cm, row, s, d, cb, vec);
#pragma unroll
    for (int k = 0; k < kLaneC; ++k)  // the lane's own stored state
      cp_async16(&sm.ck[r % 2][(cl + k) * N + kLaneP * nl], ckpt_at(r, k),
                 live[k] ? 16 : 0);
    cp_async_commit();
  };
  // the block's dB, dC of run r: its warps' sums in warp order
  const auto block_sums = [&](int r) {
    constexpr int kOut = kRun * 2 * N;
    const int t0 = r * kRun;
#pragma unroll
    for (int q = 0; q < (kOut + G::kThreads - 1) / G::kThreads; ++q) {
      const int i = tid + q * G::kThreads;
      if (kOut % G::kThreads != 0 && i >= kOut) break;
      const int t = i / (2 * N);
      const int j = i % (2 * N);
      float sum = sm.wsum[r % 2][t][0][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum = sum + sm.wsum[r % 2][t][w][j];
      store_if(part_bc + ((row + t0 + t) * blocks + blk) * (2 * N) + j, sum,
               t0 + t < s);
    }
  };
  float carry[kPairs], da[kPairs], dd[kLaneC] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kLaneC; ++k)
#pragma unroll
    for (int p = 0; p < kLaneP; ++p) {
      carry[kLaneP * k + p] = (live[k] && dh_last != nullptr)
                                  ? dh_last[state_at(k) + p]
                                  : 0.f;
      da[kLaneP * k + p] = 0.f;
    }
  const bool writes_bc = (lane / kLanesN) % kSame == 0;
  stage_bwd(runs - 1);
  for (int r = runs - 1; r >= 0; --r) {
    cp_async_wait_all();
    __syncthreads();  // run r landed; every thread is past run r + 1
    if (r > 0)
      stage_bwd(r - 1);
    if (r + 1 < runs) block_sums(r + 1);
    const int slot = r % 2;
    const int t0 = r * kRun;

    // the recompute: from the stored state, each step's decay * h_{t-1}
    // and decay into shared memory, and dC of the step
#pragma unroll
    for (int k = 0; k < kLaneC; ++k) {
      const float4 v =
          *reinterpret_cast<const float4*>(&sm.ck[slot][(cl + k) * N +
                                                        kLaneP * nl]);
      h[kLaneP * k] = v.x;
      h[kLaneP * k + 1] = v.y;
      h[kLaneP * k + 2] = v.z;
      h[kLaneP * k + 3] = v.w;
    }
#pragma unroll
    for (int t = 0; t < kRun; ++t) {
      float ahs[kPairs], decs[kPairs];
      forward(slot, t, [&](int j, float ah, float decay) {
        ahs[j] = ah;
        decs[j] = decay;
      });
      const float2 dy2 = pair_of(2, slot, t);
      const float dyv[kLaneC] = {dy2.x, dy2.y};
      float vc[kLaneP];
#pragma unroll
      for (int p = 0; p < kLaneP; ++p)
        vc[p] = fmaf(h[kLaneP + p], dyv[1], h[p] * dyv[0]);
#pragma unroll
      for (int k = 0; k < kLaneC; ++k) {
        sm.ah[t][k][tid] =
            make_float4(ahs[kLaneP * k], ahs[kLaneP * k + 1],
                        ahs[kLaneP * k + 2], ahs[kLaneP * k + 3]);
        sm.dec[t][k][tid] =
            make_float4(decs[kLaneP * k], decs[kLaneP * k + 1],
                        decs[kLaneP * k + 2], decs[kLaneP * k + 3]);
      }
      const int idx = reduce_scatter<kLaneP, 16, kLanesN>(vc, lane);
      if (writes_bc) sm.wsum[slot][t][warp][N + kLaneP * nl + idx] = vc[0];
    }

    // the walk back, on the recompute's decays
#pragma unroll
    for (int t = kRun - 1; t >= 0; --t) {
      const float2 dt2 = pair_of(0, slot, t);
      const float2 x2 = pair_of(1, slot, t);
      const float2 dy2 = pair_of(2, slot, t);
      const float4 b4 =
          *reinterpret_cast<const float4*>(&sm.bc[slot][t][kLaneP * nl]);
      const float4 c4 =
          *reinterpret_cast<const float4*>(&sm.bc[slot][t][N + kLaneP * nl]);
      const float dtv[kLaneC] = {dt2.x, dt2.y};
      const float xv[kLaneC] = {x2.x, x2.y};
      const float dyv[kLaneC] = {dy2.x, dy2.y};
      const float bv[kLaneP] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[kLaneP] = {c4.x, c4.y, c4.z, c4.w};
      float sgaa[kLaneC], sgb[kLaneC], vb[kLaneP];
#pragma unroll
      for (int k = 0; k < kLaneC; ++k) {
        const float4 ah4 = sm.ah[t][k][tid];
        const float4 de4 = sm.dec[t][k][tid];
        const float ah[kLaneP] = {ah4.x, ah4.y, ah4.z, ah4.w};
        const float de[kLaneP] = {de4.x, de4.y, de4.z, de4.w};
        const float dtx = dtv[k] * xv[k];
#pragma unroll
        for (int p = 0; p < kLaneP; ++p) {
          const int j = kLaneP * k + p;
          const float gp = fmaf(cv[p], dyv[k], carry[j]);
          const float t1 = gp * ah[p];
          sgaa[k] = p == 0 ? t1 * an[j] : fmaf(t1, an[j], sgaa[k]);
          da[j] = fmaf(t1, dtv[k], da[j]);
          sgb[k] = p == 0 ? gp * bv[p] : fmaf(gp, bv[p], sgb[k]);
          vb[p] = k == 0 ? gp * dtx : fmaf(gp, dtx, vb[p]);
          carry[j] = de[p] * gp;
        }
        dd[k] = fmaf(dyv[k], xv[k], dd[k]);
      }
      // ddt of the two channels, then dx before D * dy
      float o[2 * kLaneC] = {fmaf(xv[0], sgb[0], sgaa[0]),
                             fmaf(xv[1], sgb[1], sgaa[1]), dtv[0] * sgb[0],
                             dtv[1] * sgb[1]};
      const int oi = reduce_scatter<2 * kLaneC, kLanesN / 2, 1>(o, lane);
      const bool in = t0 + t < s;
      const long long at = (row + t0 + t) * d + c;
#pragma unroll
      for (int q = 0; q < 2 * kLaneC / kLanesN; ++q) {
        // value oi + q: ddt of channel c + k, or (from kLaneC on) dx
        const int i = oi + q;
        const bool second = i % kLaneC != 0;
        const bool is_dx = i >= kLaneC;
        const float dx_v = fmaf(second ? dc[1] : dc[0],
                                second ? dyv[1] : dyv[0], o[q]);
        store_if((is_dx ? dx : ddt) + at + (second ? 1 : 0),
                 is_dx ? dx_v : o[q], (second ? live[1] : live[0]) && in);
      }
      const int idx = reduce_scatter<kLaneP, 16, kLanesN>(vb, lane);
      if (writes_bc) sm.wsum[slot][t][warp][kLaneP * nl + idx] = vb[0];
    }
  }
  __syncthreads();
  block_sums(0);
  cp_async_wait_all();
#pragma unroll
  for (int k = 0; k < kLaneC; ++k) {
    if (!live[k]) continue;
#pragma unroll
    for (int p = 0; p < kLaneP; ++p) {
      dh0[state_at(k) + p] = carry[kLaneP * k + p];
      part_a[state_at(k) + p] = da[kLaneP * k + p];
    }
    if (nl == 0) part_d[static_cast<long long>(b) * d + c + k] = dd[k];
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

constexpr int kSumThreads = 256;

// the walk's shared memory above 48 KB, and the carveout that lets
// kMinBlocks blocks an SM hold it: set at the first call for each N, whose
// error every later call returns
template <int N>
cudaError_t configure() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem<N>)));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        scan_bwd_kernel<N>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }();
  return err;
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
  cudaError_t err = configure<N>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (d + kChannels - 1) / kChannels;
  scan_bwd_kernel<N><<<dim3(blocks, batch), Geo<N>::kThreads,
                       sizeof(Smem<N>), stream>>>(
      dt, x, bm, cm, a, dv, h0, dy, dh_last, ckpt, part_bc, part_a, part_d,
      ddt, dx, dh0, s, d, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * s * 2 * N +
                          static_cast<long long>(d) * N + d;
  scan_bwd_sums<<<static_cast<unsigned>((total + kSumThreads - 1) /
                                        kSumThreads),
                  kSumThreads, 0, stream>>>(part_bc, part_a, part_d, db, dc,
                                            da, dd, batch, s, d, N, blocks);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int occupancy_n(int* out) {
  cudaError_t err = configure<N>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes walk, sums;
  err = cudaFuncGetAttributes(&walk, scan_bwd_kernel<N>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncGetAttributes(&sums, scan_bwd_sums);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scan_bwd_kernel<N>, Geo<N>::kThreads, sizeof(Smem<N>));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = walk.numRegs;
  out[1] = static_cast<int>(walk.localSizeBytes);
  out[2] = per_sm;
  out[3] = Geo<N>::kThreads;
  out[4] = static_cast<int>(sizeof(Smem<N>));
  out[5] = sums.numRegs;
  out[6] = kSumThreads;
  return 0;
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

// The launch geometry as the card reports it, into out[0 .. 7): the
// walk's registers a thread, its local (spill) bytes a thread, its
// resident blocks an SM, threads a block and shared memory bytes a
// block; the sums kernel's registers a thread and threads a block.
// Returns 0, a CUDA error, or -1 for a d_state not built.
extern "C" int selective_scan_bwd_occupancy(int d_state, int* out) {
  switch (d_state) {
    case 4:
      return occupancy_n<4>(out);
    case 16:
      return occupancy_n<16>(out);
    default:
      return -1;
  }
}
