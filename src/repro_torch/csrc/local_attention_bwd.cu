// Gradient of the sliding-window causal attention for Hopper (sm_90a).
//
// No TPU kernel corresponds to this one: the reference trains through
// jax's autodiff of the plain attention of
// src/repro/models/common.py:232-285 (flash_attention), whose forward
// src/repro/kernels/local_attention.py::_attn_kernel computes.  The
// forward here is csrc/local_attention.cu, unchanged; this source gives
// dq, dk and dv from q, k, v, the forward's output o and its gradient dO.
// For each (batch, head h, query row i) and each key j of its window,
// j <= i and j > i - window, with kv head h / group:
//
//   s_ij  = (q_i . k_j) * D^-0.5       [t = tanh(s / cap), s = t * cap]
//   p_ij  = exp(s_ij - lse_i)          lse_i = log sum_j exp(s_ij)
//   dp_ij = dO_i . v_j                 D_i = dO_i . o_i
//   ds_ij = p_ij (dp_ij - D_i)         [* (1 - t^2)], * D^-0.5
//   dv_j += round(p_ij) dO_i           (p rounded to v's type, as the
//                                       forward rounds it before p . v)
//   dk_j += ds_ij q_i                  dq_i += ds_ij k_j
//
// with f32 sums; dq, dk, dv are written in the input type.  A masked
// pair (outside the window, or past S) has p = 0 and ds = 0, as the
// reference's -1e30 score gives.
//
// What bounds it on the H100: operations.  The function needs 10 D per
// unmasked pair for the five products (Q K^T, dO V^T, P^T dO, dS^T Q,
// dS K) and 2 D for the statistics' Q K^T, against 989 TFLOP/s of bf16
// tensor cores or 67 TFLOP/s of f32 FMAs; q, k, v, o, dO read once and
// dq, dk, dv written once take far less (gemma3-1b's local layer, D =
// 256, window 512: 9x less at bf16's rate).
//
// Two routes, one dispatch (local_attention_bwd_launch, at the end):
// bfloat16 at D = 64, 128 and 256 runs the tensor-core kernels
// (namespace tcb); float32, and bfloat16 at D = 16 (reduced configs
// only), run the CUDA-core kernels.
// Each route is three kernels on one stream, launched by one call, with
// no atomics: every gradient is summed in one block in a fixed order,
// so a backward is bitwise repeatable.
//
// Tensor cores (tcb), the design against what held the CUDA-core route
// back (no tensor cores, operands staged through f32 shared memory, a
// small and unbalanced grid):
//  1. Every product on wgmma, bf16 operands, f32 accumulators: the
//     64 x 64 score-like products (S = Q K^T, dP = dO V^T and their
//     transposes) read both operands from shared memory (m64n64k16);
//     the gradient products (dV += P^T dO, dK += dS^T Q, dQ += dS K)
//     take P or dS from registers, as the forward takes P for P V (the
//     accumulator of a 64 x 64 product is, 16 columns at a time, the A
//     fragment of the next), and the other operand MN-major from shared
//     memory, m64nNk16 with N up to 256.  P is rounded to bf16 as the
//     forward rounds it; dS is rounded to bf16 too.
//  2. Tiles stay bf16 in shared memory in the forward's layout (64-
//     column atoms, 128-byte swizzle; csrc/sm90.cuh), loaded by TMA with
//     zeros past S, each completing an mbarrier; the streamed tiles
//     pass through a 2-stage ring whose next load the second warpgroup
//     to be done with a stage issues, while both compute the other.
//  3. 64-row tiles and three kernels, each a fixed walk:
//     tc_stats: one warpgroup per (batch, head, 64 query rows): S over
//       the rows' key tiles, an online max and sum in the log2 domain
//       -> lse (log2), and delta = dO . o per row.
//     tc_dkdv: one block of two warpgroups per (batch, kv head, 64
//       keys) (or a cluster of two, item 5), K and V loaded once; it
//       walks each query head of the group and each 64-row query tile
//       whose rows reach the keys (Q, dO, lse and delta through the
//       ring: the statistics by bulk copies of 64 floats).  Warpgroup
//       0 computes S^T = K Q^T, P^T = 2^(S^T - lse) and dV += P^T dO
//       (D / 2 accumulator registers a thread); warpgroup 1 computes
//       dP^T = V dO^T, takes P^T D^-0.5 (1 - t^2) from warpgroup 0
//       through shared memory, forms dS^T and runs dK += dS^T Q.  At
//       D = 256: K, V 64 KB, the ring 2 x 65 KB, the hand-over 16 KB.
//     tc_dq: one block of two warpgroups per (batch, head, 64 query
//       rows), K and V through the ring: warpgroup 0 computes S and P,
//       warpgroup 1 dP and dS, handed back as bf16 fragments; dQ += dS
//       K is split by columns (D / 2 each; all of it in warpgroup 1 at
//       D = 64).  Query tiles in reverse, the longest first.
//     So Q K^T runs three times and dO V^T twice: 16 D per pair on the
//     tensor cores against the 12 D the bound counts.
//  4. Every visited tile holds an unmasked pair (the walks visit only
//     the tiles that meet a window; kernels/local_attention.py::
//     bwd_tile_schedule mirrors them), and the mask is applied only on
//     a tile that holds a masked pair.
//  5. The global layers' triangle: a tc_dkdv block walks every query
//     tile below its keys, so on a full causal layer the first key
//     tile walks the whole group's column and the last one tile a head;
//     while the grid fits the card in one wave (gemma3-1b: 128 blocks
//     on 132 SMs) the longest block sets the time, at twice the mean.
//     There (dkdv_parts: one wave, window over half of S) each key tile
//     takes a cluster of two blocks that walk consecutive halves of its
//     steps; block 1 leaves its partial dK, dV in its shared memory and
//     block 0 adds them to its own through distributed shared memory
//     (mapa / ld.shared::cluster) and stores: a fixed order, no
//     atomics, no buffer in device memory.  Pairing key tiles j and
//     n - 1 - j in one block would halve the grid instead, no gain while
//     it fits one wave.
//
// CUDA cores (float32; bfloat16 at D = 16), the first version, kept for
// the float32 checks:
//  1. stats: one block per (batch, head, 32 query rows) recomputes each
//     row's scores over its window and keeps a running max and sum
//     (masked scores skipped) -> lse (B, H, S); and D = dO . o per row.
//  2. dkdv: one block per (batch, kv head, 32 keys).  It walks every
//     query head of the kv head's group and every 32-row query tile
//     whose rows reach the key tile (i in [j, j + window)), and sums the
//     group's contributions to dk and dv in registers.
//  3. dq: one block per (batch, head, 32 query rows) walks the key tiles
//     of its rows' windows.
// All in f32 FMAs: the three kernels recompute Q K^T three times and dO
// V^T twice (16 D per pair), tiles are converted to f32 in shared
// memory with rows padded by one float (so that the rows a warp reads at
// one column sit in separate banks), S and dP run as 2 x 2 register
// tiles (one shared load per FMA), and the accumulations keep a (4 keys
// x D / 32 columns) tile a thread (12 loads per 32 FMAs at D = 256).
// dkdv launches the key tiles in order and dq its query tiles in
// reverse, so the longest blocks of a causal layer go first.

#include "sm90.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;      // query rows and keys per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int LDS = TILE + 1;  // row stride of the (32, 32) score tiles

struct Geometry {
  int s, h, group, window;
  float scale, softcap;  // softcap <= 0: none
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// p as the forward multiplies it with v: rounded to the input type
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Rows [lo, lo + 32) of one head of a (B, S, heads, D) tensor, as f32,
// into a (32, D + 1) shared tile; rows at or past s are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int lo,
                                          int s, long long row_stride) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int row = lo + r;
    dst[r * (D + 1) + d] =
        row < s ? to_f32(src[static_cast<long long>(row) * row_stride + d])
                : 0.f;
  }
}

__device__ __forceinline__ bool in_window(int i, int j, int s, int window) {
  return i < s && j < s && j <= i && j > i - window;
}

// The 2 x 2 register tiles of a 32 x 32 product A B^T over D: thread
// (ty, tx) = (tid / 16, tid % 16) sums rows ty, ty + 16 of A against
// rows tx, tx + 16 of B.
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         float acc[2][2]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  acc[0][0] = acc[0][1] = acc[1][0] = acc[1][1] = 0.f;
  const float* a0 = a + ty * (D + 1);
  const float* a1 = a + (ty + 16) * (D + 1);
  const float* b0 = b + tx * (D + 1);
  const float* b1 = b + (tx + 16) * (D + 1);
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float x0 = a0[d], x1 = a1[d], y0 = b0[d], y1 = b1[d];
    acc[0][0] = fmaf(x0, y0, acc[0][0]);
    acc[0][1] = fmaf(x0, y1, acc[0][1]);
    acc[1][0] = fmaf(x1, y0, acc[1][0]);
    acc[1][1] = fmaf(x1, y1, acc[1][1]);
  }
}

// The score of a pair after the scale and the soft cap; *t is tanh's
// value (for the cap's derivative)
__device__ __forceinline__ float score(float dot, const Geometry& g,
                                       float* t) {
  float s = dot * g.scale;
  if (g.softcap > 0.f) {
    *t = tanhf(s / g.softcap);
    s = *t * g.softcap;
  }
  return s;
}

// The accumulators' layout: a thread owns rows (of dq) or keys (of dk,
// dv) tid / TD + NJ rr and head-dim columns tid % TD + TD cc.
template <int D>
struct Acc {
  static constexpr int TD = D < 32 ? D : 32;
  static constexpr int NJ = THREADS / TD;   // row groups: 8, or 16 at D 16
  static constexpr int JR = TILE / NJ;      // rows a thread: 4, or 2
  static constexpr int DC = D / TD;         // columns a thread
};

// The per-tile work of dkdv and dq: scores and dO V^T of q rows [q0, +32)
// against keys [k0, +32) into p (rounded) and ds tiles.
template <typename T, int D>
__device__ __forceinline__ void p_ds_tile(const float* qs, const float* ks,
                                          const float* dos, const float* vs,
                                          const float* lse, const float* del,
                                          float* ps, float* dss, int q0,
                                          int k0, const Geometry& g) {
  float sa[2][2], pa[2][2];
  dot_tile<D>(qs, ks, sa);
  dot_tile<D>(dos, vs, pa);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int r = ty + 16 * a, c = tx + 16 * b;
      float p = 0.f, ds = 0.f;
      if (in_window(q0 + r, k0 + c, g.s, g.window)) {
        float t = 0.f;
        const float s = score(sa[a][b], g, &t);
        p = expf(s - lse[r]);
        ds = p * (pa[a][b] - del[r]);
        if (g.softcap > 0.f) ds *= 1.f - t * t;
        ds *= g.scale;
      }
      if (ps != nullptr) ps[r * LDS + c] = round_to<T>(p);
      dss[r * LDS + c] = ds;
    }
  }
}

// 1. lse and D per query row
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ lse, float* __restrict__ delta,
                 Geometry g) {
  extern __shared__ float smem[];
  float* qs = smem;                      // (32, D + 1)
  float* ks = qs + TILE * (D + 1);       // (32, D + 1)
  float* ss = ks + TILE * (D + 1);       // (32, 33)
  const int nq = gridDim.x;
  const int q0 = (nq - 1 - blockIdx.x) * TILE;
  const int bh = blockIdx.y, b = bh / g.h, h = bh % g.h;
  const int kvh = h / g.group, kv_heads = g.h / g.group;
  const long long q_row = static_cast<long long>(g.h) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const long long q_off = static_cast<long long>(b) * g.s * q_row + h * D;
  const T* kb = k + static_cast<long long>(b) * g.s * k_row + kvh * D;
  load_rows<T, D>(qs, q + q_off, q0, g.s, q_row);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float m = -INFINITY, l = 0.f;  // warp 0: row `lane`'s running max, sum
  const int q_hi = min(g.s - 1, q0 + TILE - 1);
  const int k_lo = max(0, q0 - g.window + 1);
  for (int k0 = (k_lo / TILE) * TILE; k0 <= q_hi; k0 += TILE) {
    __syncthreads();
    load_rows<T, D>(ks, kb, k0, g.s, k_row);
    __syncthreads();
    float sa[2][2];
    dot_tile<D>(qs, ks, sa);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int r = ty + 16 * a, c = tx + 16 * c2;
        float t;
        ss[r * LDS + c] = in_window(q0 + r, k0 + c, g.s, g.window)
                              ? score(sa[a][c2], g, &t)
                              : -INFINITY;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float tm = m;
      for (int c = 0; c < TILE; ++c) tm = fmaxf(tm, ss[lane * LDS + c]);
      if (tm > -INFINITY) {
        l *= expf(m - tm);  // m = -inf before the first key: l is 0
        for (int c = 0; c < TILE; ++c) {
          const float s = ss[lane * LDS + c];
          if (s > -INFINITY) l += expf(s - tm);
        }
        m = tm;
      }
    }
  }
  const long long st = static_cast<long long>(bh) * g.s;
  if (warp == 0 && q0 + lane < g.s) lse[st + q0 + lane] = m + logf(l);
  // D_i = dO_i . o_i: warp w takes rows w, w + 8, ...; lanes split d
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const int i = q0 + r;
    if (i >= g.s) break;
    const T* orow = o + q_off + static_cast<long long>(i) * q_row;
    const T* drow = dout + q_off + static_cast<long long>(i) * q_row;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[st + i] = acc;
  }
}

// 2. dk and dv of 32 keys of one kv head, summed over the group's heads
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, Geometry g) {
  using A = Acc<D>;
  extern __shared__ float smem[];
  float* ks = smem;                      // (32, D + 1) each
  float* vs = ks + TILE * (D + 1);
  float* qs = vs + TILE * (D + 1);
  float* dos = qs + TILE * (D + 1);
  float* ps = dos + TILE * (D + 1);      // (32, 33) each
  float* dss = ps + TILE * LDS;
  float* lse_s = dss + TILE * LDS;       // (32,) each
  float* del_s = lse_s + TILE;
  const int k0 = blockIdx.x * TILE;
  const int bk = blockIdx.y, kv_heads = g.h / g.group;
  const int b = bk / kv_heads, kvh = bk % kv_heads;
  const long long q_row = static_cast<long long>(g.h) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const long long k_off = static_cast<long long>(b) * g.s * k_row + kvh * D;
  load_rows<T, D>(ks, k + k_off, k0, g.s, k_row);
  load_rows<T, D>(vs, v + k_off, k0, g.s, k_row);
  float dk_acc[A::JR][A::DC], dv_acc[A::JR][A::DC];
#pragma unroll
  for (int rr = 0; rr < A::JR; ++rr)
#pragma unroll
    for (int cc = 0; cc < A::DC; ++cc) dk_acc[rr][cc] = dv_acc[rr][cc] = 0.f;
  const int jt = threadIdx.x / A::TD, dt = threadIdx.x % A::TD;
  // rows i in [k0, k0 + 31 + window), below s
  const int i_end = min(g.s, k0 + TILE - 1 + g.window);
  for (int gi = 0; gi < g.group; ++gi) {
    const int h = kvh * g.group + gi;
    const long long q_off = static_cast<long long>(b) * g.s * q_row + h * D;
    const long long st = (static_cast<long long>(b) * g.h + h) * g.s;
    for (int q0 = k0; q0 < i_end; q0 += TILE) {
      __syncthreads();
      load_rows<T, D>(qs, q + q_off, q0, g.s, q_row);
      load_rows<T, D>(dos, dout + q_off, q0, g.s, q_row);
      if (threadIdx.x < TILE) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < g.s ? lse[st + i] : 0.f;
        del_s[threadIdx.x] = i < g.s ? delta[st + i] : 0.f;
      }
      __syncthreads();
      p_ds_tile<T, D>(qs, ks, dos, vs, lse_s, del_s, ps, dss, q0, k0, g);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < TILE; ++r) {
        float pj[A::JR], sj[A::JR], od[A::DC], qd[A::DC];
#pragma unroll
        for (int rr = 0; rr < A::JR; ++rr) {
          pj[rr] = ps[r * LDS + jt + A::NJ * rr];
          sj[rr] = dss[r * LDS + jt + A::NJ * rr];
        }
#pragma unroll
        for (int cc = 0; cc < A::DC; ++cc) {
          od[cc] = dos[r * (D + 1) + dt + A::TD * cc];
          qd[cc] = qs[r * (D + 1) + dt + A::TD * cc];
        }
#pragma unroll
        for (int rr = 0; rr < A::JR; ++rr)
#pragma unroll
          for (int cc = 0; cc < A::DC; ++cc) {
            dv_acc[rr][cc] = fmaf(pj[rr], od[cc], dv_acc[rr][cc]);
            dk_acc[rr][cc] = fmaf(sj[rr], qd[cc], dk_acc[rr][cc]);
          }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < A::JR; ++rr) {
    const int j = k0 + jt + A::NJ * rr;
    if (j >= g.s) continue;
    const long long row = k_off + static_cast<long long>(j) * k_row;
#pragma unroll
    for (int cc = 0; cc < A::DC; ++cc) {
      dk[row + dt + A::TD * cc] = from_f32<T>(dk_acc[rr][cc]);
      dv[row + dt + A::TD * cc] = from_f32<T>(dv_acc[rr][cc]);
    }
  }
}

// 3. dq of 32 query rows of one head
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Geometry g) {
  using A = Acc<D>;
  extern __shared__ float smem[];
  float* qs = smem;                      // (32, D + 1) each
  float* dos = qs + TILE * (D + 1);
  float* ks = dos + TILE * (D + 1);
  float* vs = ks + TILE * (D + 1);
  float* dss = vs + TILE * (D + 1);      // (32, 33)
  float* lse_s = dss + TILE * LDS;       // (32,) each
  float* del_s = lse_s + TILE;
  const int nq = gridDim.x;
  const int q0 = (nq - 1 - blockIdx.x) * TILE;
  const int bh = blockIdx.y, b = bh / g.h, h = bh % g.h;
  const int kv_heads = g.h / g.group, kvh = h / g.group;
  const long long q_row = static_cast<long long>(g.h) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const long long q_off = static_cast<long long>(b) * g.s * q_row + h * D;
  const long long k_off = static_cast<long long>(b) * g.s * k_row + kvh * D;
  const long long st = static_cast<long long>(bh) * g.s;
  load_rows<T, D>(qs, q + q_off, q0, g.s, q_row);
  load_rows<T, D>(dos, dout + q_off, q0, g.s, q_row);
  if (threadIdx.x < TILE) {
    const int i = q0 + threadIdx.x;
    lse_s[threadIdx.x] = i < g.s ? lse[st + i] : 0.f;
    del_s[threadIdx.x] = i < g.s ? delta[st + i] : 0.f;
  }
  float dq_acc[A::JR][A::DC];
#pragma unroll
  for (int rr = 0; rr < A::JR; ++rr)
#pragma unroll
    for (int cc = 0; cc < A::DC; ++cc) dq_acc[rr][cc] = 0.f;
  const int it = threadIdx.x / A::TD, dt = threadIdx.x % A::TD;
  const int q_hi = min(g.s - 1, q0 + TILE - 1);
  const int k_lo = max(0, q0 - g.window + 1);
  for (int k0 = (k_lo / TILE) * TILE; k0 <= q_hi; k0 += TILE) {
    __syncthreads();
    load_rows<T, D>(ks, k + k_off, k0, g.s, k_row);
    load_rows<T, D>(vs, v + k_off, k0, g.s, k_row);
    __syncthreads();
    p_ds_tile<T, D>(qs, ks, dos, vs, lse_s, del_s, nullptr, dss, q0, k0, g);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float si[A::JR], kd[A::DC];
#pragma unroll
      for (int rr = 0; rr < A::JR; ++rr)
        si[rr] = dss[(it + A::NJ * rr) * LDS + c];
#pragma unroll
      for (int cc = 0; cc < A::DC; ++cc)
        kd[cc] = ks[c * (D + 1) + dt + A::TD * cc];
#pragma unroll
      for (int rr = 0; rr < A::JR; ++rr)
#pragma unroll
        for (int cc = 0; cc < A::DC; ++cc)
          dq_acc[rr][cc] = fmaf(si[rr], kd[cc], dq_acc[rr][cc]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < A::JR; ++rr) {
    const int i = q0 + it + A::NJ * rr;
    if (i >= g.s) continue;
    const long long row = q_off + static_cast<long long>(i) * q_row;
#pragma unroll
    for (int cc = 0; cc < A::DC; ++cc)
      dq[row + dt + A::TD * cc] = from_f32<T>(dq_acc[rr][cc]);
  }
}

template <int D>
constexpr int stats_smem() { return (2 * TILE * (D + 1) + TILE * LDS) * 4; }
template <int D>
constexpr int dkdv_smem() {
  return (4 * TILE * (D + 1) + 2 * TILE * LDS + 2 * TILE) * 4;
}
template <int D>
constexpr int dq_smem() {
  return (4 * TILE * (D + 1) + TILE * LDS + 2 * TILE) * 4;
}

template <typename T, int D>
int launch_t(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* delta, int batch, const Geometry& g,
             cudaStream_t stream) {
  static const cudaError_t attr = [] {  // once per instantiation
    cudaError_t e = cudaFuncSetAttribute(
        stats_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        stats_smem<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkdv_smem<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem<D>());
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = (g.s + TILE - 1) / TILE;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot = static_cast<const T*>(dout);
  stats_kernel<T, D><<<dim3(tiles, batch * g.h), THREADS, stats_smem<D>(),
                       stream>>>(qt, kt, ot, dot, lse, delta, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv_kernel<T, D><<<dim3(tiles, batch * (g.h / g.group)), THREADS,
                      dkdv_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<T, D><<<dim3(tiles, batch * g.h), THREADS, dq_smem<D>(),
                    stream>>>(qt, kt, vt, dot, lse, delta,
                              static_cast<T*>(dq), g);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// bfloat16 at D = 64, 128, 256: tensor cores (namespace tcb)
// ---------------------------------------------------------------------
namespace tcb {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int BT = 64;     // rows of every tile: keys or query rows
constexpr int STAGES = 2;  // ring depth of the streamed tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

// the row stride of the lse and delta scratch: S rounded up to a tile,
// so that each tile's 64 values sit on 256 bytes for a bulk copy
__host__ __device__ constexpr int stat_stride(int s) {
  return (s + BT - 1) / BT * BT;
}

// bytes of a (64, D) bf16 tile
template <int D>
__host__ __device__ constexpr int tile_bytes() { return 2 * BT * D; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// query row i sees key j: j <= i, i - j < window, i below S (a key past S
// is past every row below S)
__device__ __forceinline__ bool sees(int i, int j, const Geometry& g) {
  return i < g.s && j <= i && i - j < g.window;
}

// a (64 rows, 64 keys) tile with no masked pair: every key at or before
// the first row, the last row inside the first key's window, every row
// below S
__device__ __forceinline__ bool tile_full(int q0, int k0, const Geometry& g) {
  return k0 + BT - 1 <= q0 && q0 + BT - 1 - k0 < g.window &&
         q0 + BT - 1 < g.s;
}

// The score of a dot product in the log2 domain, s D^-0.5 log2(e) (the
// soft cap on s D^-0.5 first), and in *f the factor dS takes from it:
// D^-0.5, times 1 - tanh^2 under the cap
__device__ __forceinline__ float score2(float dot, const Geometry& g,
                                        float* f) {
  if (g.softcap > 0.0f) {
    const float t = tanhf(dot * g.scale / g.softcap);
    *f = g.scale * (1.0f - t * t);
    return t * g.softcap * kLog2e;
  }
  *f = g.scale;
  return dot * (g.scale * kLog2e);
}

// Accumulator layout (wgmma m64nN): lane 4 r + c of warp w of a
// warpgroup holds rows 16 w + r and 16 w + r + 8 and, in each 8-wide
// block i of columns, 8 i + 2 c and 8 i + 2 c + 1 (registers 4 i ..
// 4 i + 3).  Register x's row and column offsets from those of lane
// 4 r + c's first:
__device__ __forceinline__ int acc_row(int x) { return 8 * (x % 4 / 2); }
__device__ __forceinline__ int acc_col(int x) { return 8 * (x / 4) + (x & 1); }

// A warpgroup's (64 x N) accumulator, rounded to bf16, into rows r0 ...
// and columns c0 ... of one head of a (B, S, heads, D) tensor (`base`
// at the head's first column of batch b's row 0); rows past S are not
// stored
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2],
                                           __nv_bfloat16* base,
                                           long long row_stride, int r0,
                                           int c0, int s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4;
  const int r = r0 + 16 * warp + lane / 4, c = c0 + 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < s)
        *reinterpret_cast<__nv_bfloat162*>(
            base + (r + 8 * h) * row_stride + c + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * h],
                                  acc[4 * n + 2 * h + 1]);
}

// the (64, D) tile of rows r0 ... of one head into shared memory, D / 64
// atoms of (64, 64), completing on `bar`; rows past S are zeros
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map, int head,
                                          int r0, int b, uint64_t* bar) {
#pragma unroll
  for (int a = 0; a < D / ATOM; ++a)
    tma_load_4d(dst + a * BT * 128, map, a * ATOM, head, r0, b, bar);
}

// one warpgroup's 64 x 64 product A B^T over D, both K-major (64, D)
// tiles in shared memory, into x
template <int D>
__device__ __forceinline__ void product_ss(float (&x)[32],
                                           const unsigned char* a,
                                           const unsigned char* b) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss(x, desc_k<BT>(a, ks), desc_k<BT>(b, ks), ks > 0);
  wgmma_commit();
  wgmma_wait();
  keep_all(x);
}

// acc (64 x N) += A (64 x 64, as four k16 register fragments) B (64 x N
// from atom `atom` on of an MN-major (64, D) tile in shared memory)
template <int N>
__device__ __forceinline__ void product_rs(float (&acc)[N / 2],
                                           const uint32_t (&a)[4][4],
                                           const unsigned char* b,
                                           int atom) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs<N>(acc, a[j], desc_mn<BT>(b, j, atom));
  wgmma_commit();
  wgmma_wait();
  keep_all(acc);
}

// A warpgroup is done with ring stage `st` (named barrier ID gathers
// it): the second of the two warpgroups to be done loads the stage's
// next use, if there is one (`more`, the same for both).
template <int ID, typename Load>
__device__ __forceinline__ void release(int* done, int st, bool more,
                                        const Load& load) {
  bar_sync<ID, 128>();
  if (threadIdx.x % 128 == 0 && more) {
    __threadfence_block();
    if (atomicAdd(&done[st], 1) & 1) {
      __threadfence_block();
      load();
    }
  }
}

// 1. lse (log2 domain) and delta = dO . o of 64 query rows of one
// (batch, head): one warpgroup; S = Q K^T over the rows' key tiles, K
// through a 2-stage TMA ring, an online max and sum
template <int D>
constexpr int stats_bytes() { return 3 * tile_bytes<D>() + 64 + 1024; }

template <int D>
__global__ void __launch_bounds__(128, 2)
    tc_stats(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const bf16* __restrict__ o, const bf16* __restrict__ dout,
             float* __restrict__ lse, float* __restrict__ delta,
             Geometry g) {
  constexpr int T = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align1024(smem_raw);
  unsigned char* sk = sq + T;  // STAGES tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sk + STAGES * T);
  uint64_t* q_full = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / g.h, head = bh % g.h;
  const int kvh = head / g.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;  // heaviest first
  const int t0 = max(0, q0 - g.window + 1) / BT;
  const int n = min(q0 + BT - 1, g.s - 1) / BT - t0 + 1;
  auto load_k = [&](int i) {
    mbar_expect(&full[i % STAGES], T);
    load_tile<D>(sk + (i % STAGES) * T, &tk, kvh, (t0 + i) * BT, b,
                 &full[i % STAGES]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    mbar_init(q_full, 1);
    mbar_fence_init();
    mbar_expect(q_full, T);
    load_tile<D>(sq, &tq, head, q0, b, q_full);
    for (int i = 0; i < min(n, STAGES); ++i) load_k(i);
  }
  __syncthreads();

  // delta while the tiles land: warp w takes rows w, w + 4, ...; a lane
  // reads 8 columns at a time.  The rows past S of the last tile get 0,
  // as their lse does: the other kernels read them, and mask them.
  const long long q_row = static_cast<long long>(g.h) * D;
  const long long st_row = static_cast<long long>(bh) * stat_stride(g.s);
  for (int r = warp; r < BT; r += 4) {
    const int i = q0 + r;
    if (i >= g.s) {
      if (lane == 0) delta[st_row + i] = 0.0f;
      continue;
    }
    const long long at =
        (static_cast<long long>(b) * g.s + i) * q_row + head * D;
    float acc = 0.0f;
    for (int c = 8 * lane; c < D; c += 256) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + at + c);
      const __nv_bfloat162* op =
          reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp =
          reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 x = __bfloat1622float2(op[u]);
        const float2 y = __bfloat1622float2(dp[u]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[st_row + i] = acc;
  }

  const int row0 = q0 + 16 * warp + lane / 4, col = 2 * (lane % 4);
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  float sc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) sc[x] = 0.0f;
  mbar_wait(q_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES, k0 = (t0 + i) * BT;
    mbar_wait(&full[st], (i / STAGES) & 1);
    product_ss<D>(sc, sq, sk + st * T);
    __syncthreads();  // the stage is read: its next tile may come
    if (threadIdx.x == 0 && i + STAGES < n) load_k(i + STAGES);
    // masked scores at -1e30: a row that has seen no key of its window
    // counts them with m = -1e30, and the first key of its window wipes
    // that with l *= 2^(-1e30 - m) = 0
    const bool partial = !tile_full(q0, k0, g);
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      float f;
      float y = score2(sc[x], g, &f);
      if (partial && !sees(row0 + acc_row(x), k0 + col + acc_col(x), g))
        y = kMasked;
      sc[x] = y;
      mx[x % 4 / 2] = fmaxf(mx[x % 4 / 2], y);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      l[r] *= ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) l[x % 4 / 2] += ex2(sc[x] - m[x % 4 / 2]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (lane % 4 == 0)
      lse[st_row + row0 + 8 * r] =
          row0 + 8 * r < g.s ? m[r] + log2f(l[r]) : 0.0f;
  }
}

// 2. dk and dv of 64 keys of one (batch, kv head), summed over the
// group's query heads.  Warpgroup 0: S^T = K Q^T, P^T, dV += P^T dO;
// warpgroup 1: dP^T = V dO^T, dS^T, dK += dS^T Q.  Warpgroup 0 hands
// P^T D^-0.5 (1 - t^2) to warpgroup 1 through shared memory (`pc`).
template <int D>
struct DkdvSmem {
  static constexpr int T = tile_bytes<D>();
  // a ring stage: Q, dO, then lse and delta of its 64 rows (padded so
  // that the next stage starts on 1024 bytes)
  static constexpr int STAGE = 2 * T + 1024;
  static constexpr int PC = 4 * BT * BT;
  static constexpr int BYTES = 2 * T + STAGES * STAGE + PC + 64 + 1024;
};

template <int D>
__global__ void __launch_bounds__(256, 1)
    tc_dkdv(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, Geometry g) {
  using L = DkdvSmem<D>;
  constexpr int T = L::T;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align1024(smem_raw);
  unsigned char* sv = sk + T;
  unsigned char* ring = sv + T;
  float* pc = reinterpret_cast<float*>(ring + STAGES * L::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(pc + BT * BT);
  uint64_t* kv_full = full + STAGES;
  int* done = reinterpret_cast<int*>(kv_full + 1);

  // the warpgroup index read from lane 0: the compiler then knows it,
  // and every branch around a wgmma, to be uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int kv_heads = g.h / g.group;
  const int b = blockIdx.x / kv_heads, kvh = blockIdx.x % kv_heads;
  const int k0 = blockIdx.y * BT;  // the first key tiles walk the most
  // query tiles whose rows reach the keys: i in [k0, k0 + 63 + window)
  const int qt0 = k0 / BT;
  const int nq = min(g.s - 1, k0 + BT - 2 + g.window) / BT - qt0 + 1;
  // steps: (head of the group, query tile); the blocks of a cluster
  // (gridDim.z of them) take consecutive shares, this one steps
  // [first, first + n)
  const int steps = g.group * nq;
  const int first = steps * blockIdx.z / gridDim.z;
  const int n = steps * (blockIdx.z + 1) / gridDim.z - first;
  auto load_step = [&](int i) {
    unsigned char* stage = ring + (i % STAGES) * L::STAGE;
    uint64_t* bar = &full[i % STAGES];
    const int head = kvh * g.group + (first + i) / nq;
    const int q0 = (qt0 + (first + i) % nq) * BT;
    const long long at =
        static_cast<long long>(b * g.h + head) * stat_stride(g.s) + q0;
    mbar_expect(bar, 2 * T + 2 * 4 * BT);
    load_tile<D>(stage, &tq, head, q0, b, bar);
    load_tile<D>(stage + T, &tdo, head, q0, b, bar);
    bulk_load(stage + 2 * T, lse + at, 4 * BT, bar);
    bulk_load(stage + 2 * T + 4 * BT, delta + at, 4 * BT, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      done[i] = 0;
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
    mbar_expect(kv_full, 2 * T);
    load_tile<D>(sk, &tk, kvh, k0, b, kv_full);
    load_tile<D>(sv, &tv, kvh, k0, b, kv_full);
    for (int i = 0; i < min(n, STAGES); ++i) load_step(i);
  }
  __syncthreads();
  mbar_wait(kv_full, 0);

  const int lane = tid % 32, warp = tid / 32;
  const int key0 = k0 + 16 * warp + lane / 4;  // this lane's first key
  const int col = 2 * (lane % 4);
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  bf16* const out_base = (wg == 0 ? dv : dk) +
                         static_cast<long long>(b) * g.s * kv_row + kvh * D;
  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.0f;
  float sc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) sc[x] = 0.0f;
  uint32_t frag[4][4];

  if (wg == 0) {
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const unsigned char* stage = ring + st * L::STAGE;
      const float* lse_s = reinterpret_cast<const float*>(stage + 2 * T);
      const int q0 = (qt0 + (first + i) % nq) * BT;
      mbar_wait(&full[st], (i / STAGES) & 1);
      product_ss<D>(sc, sk, stage);  // S^T = K Q^T: keys x query rows
      const bool partial = !tile_full(q0, k0, g);
      bar_sync<2, 256>();  // warpgroup 1 has read the last pc
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int c = col + acc_col(x);
        float f;
        float p = ex2(score2(sc[x], g, &f) - lse_s[c]);
        if (partial && !sees(q0 + c, key0 + acc_row(x), g)) p = 0.0f;
        sc[x] = p;
        pc[x * 128 + tid] = p * f;
      }
      bar_arrive<1, 256>();  // pc is ready
      pack_frags(sc, frag);  // p rounded to bf16, as the forward's
      product_rs<D>(acc, frag, stage + T, 0);  // dV += P^T dO
      release<3>(done, st, i + STAGES < n, [&] { load_step(i + STAGES); });
    }
  } else {
    if (n > 0) bar_arrive<2, 256>();  // pc starts free
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const unsigned char* stage = ring + st * L::STAGE;
      const float* delta_s =
          reinterpret_cast<const float*>(stage + 2 * T + 4 * BT);
      mbar_wait(&full[st], (i / STAGES) & 1);
      product_ss<D>(sc, sv, stage + T);  // dP^T = V dO^T
      bar_sync<1, 256>();                // pc is ready
#pragma unroll
      for (int x = 0; x < 32; ++x)
        sc[x] = pc[x * 128 + tid] * (sc[x] - delta_s[col + acc_col(x)]);
      if (i + 1 < n) bar_arrive<2, 256>();  // pc is free
      pack_frags(sc, frag);                 // dS^T rounded to bf16
      product_rs<D>(acc, frag, stage, 0);   // dK += dS^T Q
      release<4>(done, st, i + STAGES < n, [&] { load_step(i + STAGES); });
    }
  }
  if (gridDim.z > 1) {
    // the cluster's partial sums, in order: block 1 leaves its
    // accumulators in its ring (no load is in flight once both
    // warpgroups are done), block 0 adds them to its own and stores
    __syncthreads();
    float* part = reinterpret_cast<float*>(ring) + wg * (D / 2) * 128;
    if (blockIdx.z == 1) {
#pragma unroll
      for (int x = 0; x < D / 2; ++x) part[x * 128 + tid] = acc[x];
    }
    cluster_sync();
    if (blockIdx.z == 0) {
      const uint32_t other = cluster_addr(part, 1);
#pragma unroll
      for (int x = 0; x < D / 2; ++x)
        acc[x] += ld_cluster(other + 4 * (x * 128 + tid));
    }
    cluster_sync();  // block 1's shared memory stays until it is read
    if (blockIdx.z != 0) return;
  }
  store_rows<D>(acc, out_base, kv_row, k0, 0, g.s);
}

// 3. dq of 64 query rows of one (batch, head), over the key tiles of the
// rows' windows, K and V through a 2-stage TMA ring.  Warpgroup 0: S =
// Q K^T and P, handing P D^-0.5 (1 - t^2) to warpgroup 1 (`pc`);
// warpgroup 1: dP = dO V^T and dS, handing dS's bf16 fragments back
// (`dsf`).  dQ += dS K is split by columns, D / 2 each (at D = 64
// warpgroup 1 takes all of it: half an atom is no wgmma operand).
template <int D>
struct DqSmem {
  static constexpr int T = tile_bytes<D>();
  static constexpr int STAGE = 2 * T;  // K, then V
  static constexpr int PC = 4 * BT * BT;
  static constexpr int DSF = 4 * 16 * 128;
  static constexpr int BYTES = 2 * T + STAGES * STAGE + PC + DSF + 64 + 1024;
  static constexpr int D0 = D >= 128 ? D / 2 : 0;  // warpgroup 0's columns
  static constexpr int D1 = D - D0;                // warpgroup 1's
};

template <int D>
__global__ void __launch_bounds__(256, 1)
    tc_dq(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, Geometry g) {
  using L = DqSmem<D>;
  constexpr int T = L::T;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align1024(smem_raw);
  unsigned char* sdo = sq + T;
  unsigned char* ring = sdo + T;
  float* pc = reinterpret_cast<float*>(ring + STAGES * L::STAGE);
  uint32_t* dsf = reinterpret_cast<uint32_t*>(pc + BT * BT);
  uint64_t* full = reinterpret_cast<uint64_t*>(dsf + 16 * 128);
  uint64_t* qd_full = full + STAGES;
  int* done = reinterpret_cast<int*>(qd_full + 1);

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.x, b = bh / g.h, head = bh % g.h;
  const int kvh = head / g.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;  // heaviest first
  const int t0 = max(0, q0 - g.window + 1) / BT;
  const int n = min(q0 + BT - 1, g.s - 1) / BT - t0 + 1;
  auto load_step = [&](int i) {
    unsigned char* stage = ring + (i % STAGES) * L::STAGE;
    uint64_t* bar = &full[i % STAGES];
    mbar_expect(bar, 2 * T);
    load_tile<D>(stage, &tk, kvh, (t0 + i) * BT, b, bar);
    load_tile<D>(stage + T, &tv, kvh, (t0 + i) * BT, b, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      done[i] = 0;
    }
    mbar_init(qd_full, 1);
    mbar_fence_init();
    mbar_expect(qd_full, 2 * T);
    load_tile<D>(sq, &tq, head, q0, b, qd_full);
    load_tile<D>(sdo, &tdo, head, q0, b, qd_full);
    for (int i = 0; i < min(n, STAGES); ++i) load_step(i);
  }
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32;
  const int row0 = q0 + 16 * warp + lane / 4, col = 2 * (lane % 4);
  // this lane's two rows' lse (warpgroup 0) or delta (warpgroup 1)
  const float* stat =
      (wg == 0 ? lse : delta) + static_cast<long long>(bh) * stat_stride(g.s);
  const float st0 = row0 < g.s ? stat[row0] : 0.0f;
  const float st1 = row0 + 8 < g.s ? stat[row0 + 8] : 0.0f;
  const long long q_row = static_cast<long long>(g.h) * D;
  bf16* const out_base =
      dq + static_cast<long long>(b) * g.s * q_row + head * D;
  float sc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) sc[x] = 0.0f;
  uint32_t frag[4][4];
  mbar_wait(qd_full, 0);

  if (wg == 0) {
    constexpr int N0 = L::D0 > 0 ? L::D0 : 8;  // (unused at D = 64)
    float acc[N0 / 2];
#pragma unroll
    for (int x = 0; x < N0 / 2; ++x) acc[x] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES, k0 = (t0 + i) * BT;
      const unsigned char* stage = ring + st * L::STAGE;
      mbar_wait(&full[st], (i / STAGES) & 1);
      product_ss<D>(sc, sq, stage);  // S = Q K^T
      const bool partial = !tile_full(q0, k0, g);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        float f;
        float p = ex2(score2(sc[x], g, &f) - (acc_row(x) ? st1 : st0));
        if (partial && !sees(row0 + acc_row(x), k0 + col + acc_col(x), g))
          p = 0.0f;
        pc[x * 128 + tid] = p * f;
      }
      bar_arrive<1, 256>();  // pc is ready
      bar_sync<5, 256>();    // dS is ready (so pc is read)
      if constexpr (L::D0 > 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            frag[j][u] = dsf[(4 * j + u) * 128 + tid];
        product_rs<L::D0>(acc, frag, stage, 0);  // dQ[:, :D0] += dS K
      }
      release<3>(done, st, i + STAGES < n, [&] { load_step(i + STAGES); });
    }
    if constexpr (L::D0 > 0)
      store_rows<L::D0>(acc, out_base, q_row, q0, 0, g.s);
  } else {
    float acc[L::D1 / 2];
#pragma unroll
    for (int x = 0; x < L::D1 / 2; ++x) acc[x] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const unsigned char* stage = ring + st * L::STAGE;
      mbar_wait(&full[st], (i / STAGES) & 1);
      product_ss<D>(sc, sdo, stage + T);  // dP = dO V^T
      bar_sync<1, 256>();                 // pc is ready
#pragma unroll
      for (int x = 0; x < 32; ++x)
        sc[x] = pc[x * 128 + tid] * (sc[x] - (acc_row(x) ? st1 : st0));
      pack_frags(sc, frag);  // dS rounded to bf16
      if constexpr (L::D0 > 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            dsf[(4 * j + u) * 128 + tid] = frag[j][u];
      }
      bar_arrive<5, 256>();  // dS is ready, pc is read
      product_rs<L::D1>(acc, frag, stage, L::D0 / ATOM);  // dQ[:, D0:]
      release<4>(done, st, i + STAGES < n, [&] { load_step(i + STAGES); });
    }
    store_rows<L::D1>(acc, out_base, q_row, q0, L::D0, g.s);
  }
}

// blocks per key tile of tc_dkdv: 2 (a cluster) when its grid of
// `blocks` fits the card's `sms` in one wave and the window covers
// more than half of S, else 1
inline int dkdv_parts(int blocks, int sms, int s, int window) {
  return blocks <= sms && 2 * window > s ? 2 : 1;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int batch, const Geometry& g, cudaStream_t stream) {
  static const cudaError_t attr = [] {  // once per head dim
    cudaError_t e = cudaFuncSetAttribute(
        tc_stats<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        stats_bytes<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tc_dkdv<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkdvSmem<D>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tc_dq<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqSmem<D>::BYTES);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int kv = g.h / g.group;
  const long long qs = static_cast<long long>(g.h) * D;  // a q row
  const long long ks = static_cast<long long>(kv) * D;   // a k row
  CUtensorMap tq, tk, tv, tdo;
  int err = tensor_map_4d(&tq, q, qs * g.s, qs, D, batch, g.s, g.h, D, BT);
  if (!err)
    err = tensor_map_4d(&tdo, dout, qs * g.s, qs, D, batch, g.s, g.h, D, BT);
  if (!err)
    err = tensor_map_4d(&tk, k, ks * g.s, ks, D, batch, g.s, kv, D, BT);
  if (!err)
    err = tensor_map_4d(&tv, v, ks * g.s, ks, D, batch, g.s, kv, D, BT);
  if (err) return err;
  const int tiles = (g.s + BT - 1) / BT;
  tc_stats<D><<<dim3(batch * g.h, tiles), 128, stats_bytes<D>(), stream>>>(
      tq, tk, static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      lse, delta, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the key tiles' walks are balanced while the window is short; on a
  // (near) full causal layer whose grid fits one wave, the first key
  // tiles walk up to twice the mean: each key tile then takes a cluster
  // of two blocks
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int parts = dkdv_parts(batch * kv * tiles, sms, g.s, g.window);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * kv, tiles, parts);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = DkdvSmem<D>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = parts;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tc_dkdv<D>, tq, tk, tv, tdo,
                         static_cast<const float*>(lse),
                         static_cast<const float*>(delta),
                         static_cast<bf16*>(dk), static_cast<bf16*>(dv), g);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tc_dq<D><<<dim3(batch * g.h, tiles), 256, DqSmem<D>::BYTES, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tcb

// the CUDA-core route in float32, at every head dim
int launch_f32(int d, const void* q, const void* k, const void* v,
               const void* o, const void* dout, void* dq, void* dk, void* dv,
               float* lse, float* delta, int batch, const Geometry& g,
               cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_t<float, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                 batch, g, stream);
    case 64:
      return launch_t<float, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                 batch, g, stream);
    case 128:
      return launch_t<float, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                  batch, g, stream);
    case 256:
      return launch_t<float, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                  batch, g, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq: (batch, s, h, d) contiguous; k, v, dk, dv: (batch, s,
// h / group, d) contiguous; lse, delta: float scratch of batch * h * (s
// rounded up to 64) each, on 16 bytes.
// The route: bf16 at d = 64, 128, 256 takes the tensor-core kernels,
// float32 and bf16 at d = 16 the CUDA-core ones (another d is refused).
// Launches the route's three kernels on `stream`; returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int local_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int batch, int s, int h, int group, int d, int window, float scale,
    float softcap, int bf16, void* stream) {
  const Geometry g{s, h, group, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (d) {
      case 64:
        return tcb::launch<64>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                               batch, g, st);
      case 128:
        return tcb::launch<128>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                batch, g, st);
      case 256:
        return tcb::launch<256>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                batch, g, st);
      case 16:
        return launch_t<__nv_bfloat16, 16>(q, k, v, o, dout, dq, dk, dv,
                                           lse, delta, batch, g, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch_f32(d, q, k, v, o, dout, dq, dk, dv, lse, delta, batch, g,
                    st);
}
