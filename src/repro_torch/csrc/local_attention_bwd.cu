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
// all in f32 from operands of the input type (bf16 or f32); dq, dk, dv
// are written in the input type.  A masked pair (outside the window, or
// past S) has p = 0 and ds = 0, as the reference's -1e30 score gives.
//
// Three kernels, one stream, launched by one call:
//  1. stats: one block per (batch, head, 32 query rows) recomputes each
//     row's scores over its window and keeps a running max and sum
//     (masked scores skipped) -> lse (B, H, S); and D = dO . o per row.
//  2. dkdv: one block per (batch, kv head, 32 keys).  It walks every
//     query head of the kv head's group and every 32-row query tile
//     whose rows reach the key tile (i in [j, j + window)), and sums the
//     group's contributions to dk and dv in registers: no atomics, so a
//     backward is bitwise repeatable.
//  3. dq: one block per (batch, head, 32 query rows) walks the key tiles
//     of its rows' windows.
//
// What bounds it on the H100: operations.  The function needs 10 D per
// unmasked pair for the five products (Q K^T, dO V^T, P^T dO, dS^T Q,
// dS K) and 2 D for the statistics' Q K^T, against 989 TFLOP/s of bf16
// tensor cores or 67 TFLOP/s of f32 FMAs; q, k, v, o, dO read once and
// dq, dk, dv written once take far less (gemma3-1b's local layer, D =
// 256, window 512: 9x less at bf16's rate).  This first version is
// simple and CUDA-core only: the three kernels recompute Q K^T three
// times and dO V^T twice (16 D per pair), tiles are converted to f32 in
// shared memory with rows padded by one float (so that the rows a warp
// reads at one column sit in separate banks), S and dP run as 2 x 2
// register tiles (one shared load per FMA), and the accumulations keep a
// (4 keys x D / 32 columns) tile a thread (12 loads per 32 FMAs at D =
// 256).  wgmma, TMA and the log-sum-exp written by the forward kernel
// are later work.  dkdv launches the key tiles in order and dq its query
// tiles in reverse, so the longest blocks of a causal layer go first.

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

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             float* lse, float* delta, int batch, const Geometry& g,
             cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_t<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, batch,
                             g, stream);
    case 64:
      return launch_t<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, batch,
                             g, stream);
    case 128:
      return launch_t<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                              batch, g, stream);
    case 256:
      return launch_t<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                              batch, g, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq: (batch, s, h, d) contiguous; k, v, dk, dv: (batch, s,
// h / group, d) contiguous; lse, delta: (batch, h, s) float scratch.
// Launches the three kernels on `stream`; returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int local_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int batch, int s, int h, int group, int d, int window, float scale,
    float softcap, int bf16, void* stream) {
  const Geometry g{s, h, group, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(d, q, k, v, o, dout, dq, dk, dv, lse,
                                        delta, batch, g, st)
              : launch_d<float>(d, q, k, v, o, dout, dq, dk, dv, lse, delta,
                                batch, g, st);
}
