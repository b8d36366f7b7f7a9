// Sliding-window causal flash attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/local_attention.py::_attn_kernel (reached
// through local_attention).  For each query row i of each (batch, head):
//
//   s_ij = (q_i . k_j) * D^-0.5      [then tanh(s / cap) * cap, cap > 0]
//   mask: j <= i and j > i - window  (a masked score is -1e30, not -inf)
//   online softmax over the key tiles in order, all in f32: running max
//   m, denominator l and accumulator acc; p = exp(s - m_new), rounded to
//   the input type before the p . v product; corr = exp(m_prev - m_new)
//   o_i = acc / max(l, 1e-30), rounded to the input type
//
// Work division.  The TPU grid walks (bh, q block, kv block) in order,
// carries m / l / acc in VMEM scratch along the kv axis, and visits a
// fixed span of kv blocks per q block (clamped at block 0, the clamped
// repeats masked out).  Hopper blocks run in no order, so here one block
// owns one (batch, head, 64-row query tile), keeps m / l / acc in
// registers, and loops itself over only the 64-key tiles that meet
// [q_lo - window + 1, q_hi].  A row whose window misses a whole visited
// tile takes p = exp(-1e30 + 1e30) = 1 there with m = -1e30; the first
// tile holding a key of its window then wipes that with
// corr = exp(-1e30 - m) = 0, exactly as on the TPU.
//
// GQA.  q is read as (B, S, H, D) and k, v as (B, S, KV, D) through
// element strides (unit stride along D); head h reads kv head h / group,
// so no repeated or transposed copy is made.  The (BH, S, D) layout of
// the reference's wrapper is the case H = KV = 1.
//
// Bound on the H100: 4 * D operations per unmasked (query, key) pair
// against 989 TFLOP/s (bf16 tensor cores), and q, k, v read once and o
// written once against 3.35 TB/s.  At gemma3-1b's prefill shapes (D =
// 256, S = 2048, window 512 or S) operations bound it.  This first
// version is simple: tiles are staged in shared memory as f32 and both
// products run as f32 FMAs on the CUDA cores (67 TFLOP/s peak), with no
// tensor cores (wgmma), TMA or pipelining, so it sits well above that
// bound; making it fast is later work.  Shared memory at D = 256 is
// 209 KB per block (q, k and v tiles of 64 rows plus the p tile), one
// block per SM; a row stride of D + 1 floats keeps the column reads free
// of bank conflicts.  Rounding: expf and tanhf without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int TX = 16;                 // threads along keys / head dim
constexpr int TY = 16;                 // threads along query rows
constexpr int THREADS = TX * TY;       // 256
constexpr int RQ = BQ / TY;            // query rows per thread
constexpr int CK = BK / TX;            // keys per thread
constexpr int LDP = BK + 1;            // row stride of the p tile
constexpr float kMasked = -1e30f;

struct Geometry {
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
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
  return __float2bfloat16_rn(x);
}

// rows [lo, lo + n) of one head, D wide, into a (n, D + 1) f32 tile;
// rows at or past s read as zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int lo,
                                          int n, int s) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int pos = lo + r;
    dst[r * LD + c] = pos < s ? to_f32(src[pos * row_stride + c]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    local_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           Geometry g) {
  constexpr int LD = D + 1;
  constexpr int DC = D / TX;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* sq = smem;            // BQ x LD
  float* sk = sq + BQ * LD;    // BK x LD
  float* sv = sk + BK * LD;    // BK x LD
  float* sp = sv + BK * LD;    // BQ x LDP

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int b = blockIdx.y / g.h;
  const int head = blockIdx.y % g.h;
  const int kv_head = head / g.group;
  const int q_lo = blockIdx.x * BQ;
  const int q_hi = min(q_lo + BQ, g.s) - 1;

  const T* qb = q + b * g.q_sb + head * g.q_sh;
  const T* kb = k + b * g.k_sb + kv_head * g.k_sh;
  const T* vb = v + b * g.v_sb + kv_head * g.v_sh;
  load_tile<T, D>(sq, qb, g.q_ss, q_lo, BQ, g.s);

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  const int t_first = max(0, q_lo - g.window + 1) / BK;
  const int t_last = q_hi / BK;
  for (int t = t_first; t <= t_last; ++t) {
    const int k_lo = t * BK;
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_tile<T, D>(sk, kb, g.k_ss, k_lo, BK, g.s);
    load_tile<T, D>(sv, vb, g.v_ss, k_lo, BK, g.s);
    __syncthreads();

    // scores of rows ty + TY * i against keys tx + TX * j
    float sc[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RQ], ka[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qa[i] = sq[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) ka[j] = sk[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = ty + TY * i;
      const int qp = q_lo + row;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kp = k_lo + tx + TX * j;
        float x = sc[i][j] * g.scale;
        if (g.softcap > 0.0f) x = tanhf(x / g.softcap) * g.softcap;
        x = (kp <= qp && kp > qp - g.window) ? x : kMasked;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the TX threads of a row are one half-warp
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        sp[row * LDP + tx + TX * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();  // the p tile is complete

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pa[i] = sp[(ty + TY * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sv[j * LD + tx + TX * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = o + b * g.o_sb + head * g.o_sh;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q_lo + ty + TY * i;
    if (qp >= g.s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[qp * g.o_ss + tx + TX * c] = from_f32<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Geometry& g, int batch, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = sizeof(float) * ((BQ + 2 * BK) * LD + BQ * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      local_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.s + BQ - 1) / BQ, batch * g.h);
  local_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             const Geometry& g, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, g, batch, stream);
    case 64: return launch<T, 64>(q, k, v, o, g, batch, stream);
    case 128: return launch<T, 128>(q, k, v, o, g, batch, stream);
    case 256: return launch<T, 256>(q, k, v, o, g, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point for ctypes.  Strides are in elements; `bf16`
// selects __nv_bfloat16 over float for q, k, v and o alike.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int local_attention_launch(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* v, long long v_sb, long long v_ss, long long v_sh, void* o,
    long long o_sb, long long o_ss, long long o_sh, int batch, int s, int h,
    int group, int d, int window, float scale, float softcap, int bf16,
    void* stream) {
  const Geometry g{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                   o_sb, o_ss, o_sh, s, h, group, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, g, batch, d, st)
              : launch_d<float>(q, k, v, o, g, batch, d, st);
}
