// Sliding-window causal flash attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/local_attention.py::_attn_kernel (reached
// through local_attention, whose pallas_call is at :116).  For each
// query row i of each (batch, head):
//
//   s_ij = (q_i . k_j) * DQK^-0.5    [then tanh(s / cap) * cap, cap > 0]
//   mask: j <= i and j > i - window  (a masked score is -1e30, not -inf)
//   online softmax over the key tiles in order, all in f32: running max
//   m, denominator l and accumulator acc; p = exp(s - m_new), rounded to
//   the input type before the p . v product; corr = exp(m_prev - m_new)
//   o_i = acc / max(l, 1e-30), rounded to the input type
//
// A row whose window misses a whole visited tile takes p = exp(-1e30 +
// 1e30) = 1 there with m = -1e30; the first tile holding a key of its
// window wipes that with corr = exp(-1e30 - m) = 0, as on the TPU.  The
// TPU grid walks (bh, q block, kv block) in order and carries m / l /
// acc in VMEM along the kv axis; here one block owns one (batch, head,
// query tile), keeps m / l / acc in registers and loops itself over the
// key tiles that meet [q_lo - window + 1, q_hi].  GQA: q is read as
// (B, S, H, DQK), k as (B, S, KV, DQK) and v as (B, S, KV, DV) through
// element strides (unit stride along the head dim); head h reads kv head
// h / group, so no repeated or transposed copy is made.  The output is
// (B, S, H, DV).
//
// Head dims.  q and k share DQK, v has DV of its own, and the kernels
// are templates on the pair: (D, D) for D = 16, 64, 128, 256, and
// deepseek-v3's MLA, (192, 128): q and k carry 128 "nope" and 64 rope
// dims, v 128.  Nothing is padded to a common width: Q K^T runs at DQK
// and P V at DV, the work the bound below counts.
//
// What bounds it on the H100: operations, 2 * (DQK + DV) per unmasked
// (query, key) pair (Q K^T and P V) against 989 TFLOP/s of bf16 tensor
// cores.  At gemma3-1b's prefill (D = 256, S = 2048) q, k, v read once
// and o written once against 3.35 TB/s take 1.2x less time than that
// on a local layer (window 512) and 2.8x less on a global one; at
// deepseek-v3's (192, 128, S = 2048, causal) 1.7x less.
//
// Two kernels, chosen by dtype (a dispatch, not a fallback):
//
// bfloat16: tensor cores (tc::attn_kernel).  One block owns 128 query
// rows of one (batch, head) as two warpgroups of 64.  What the design
// does about what held the first version back:
//  1. Both products on the tensor cores with wgmma, f32 accumulators:
//     S = Q K^T as m64n64k16 with Q and K read from shared memory, and
//     O += P V as m64nDVk16 (DV = 256: 128 accumulator registers a
//     thread)
//     with P taken from the S accumulators as the register A operand
//     (rounded to bf16) and V as an MN-major operand in shared memory.
//  2. No shared-memory loads by the threads: wgmma reads its shared
//     operands itself, and each 64 x 64 x 16 product is 131072
//     operations.
//  3. Tiles stay bf16 in shared memory, in 64-column atoms with the
//     128-byte swizzle: q 64 KB and a 2-stage K/V ring of 2 x 64 KB at
//     D = 256; at (192, 128) q and k are 3 atoms wide, v 2: q 48 KB, the
//     ring 2 x (24 + 16) KB, and S takes 12 k16 steps.  TMA loads them (one thread issues a tile, the hardware
//     computes the addresses and zero-fills past S), each tile's bytes
//     complete an mbarrier, and a stage's next tile goes out as soon as
//     both warpgroups are done with it, while they compute the other
//     stage.  The warpgroups take turns on the tensor cores (named
//     barriers): one issues its S only after the other has issued its
//     own, so one's softmax overlaps the other's products, with no
//     barrier across the block inside the loop.
//  4. Each warpgroup classifies each visited key tile against its 64
//     rows: a tile that can hold no unmasked pair is skipped, P V runs
//     only on the 16-key chunks that can, and the mask is applied only
//     where the tile holds a masked pair.  Skipping is exact: a skipped
//     chunk's p is 0 for a row that has seen a key of its window, and
//     otherwise wiped by corr = 0 later, as above.
//  5. The grid is (batch * heads, query tiles) with the query tile
//     reversed, so the causal layers' longest tiles launch first.
// The softmax runs in the log2 domain: scores times DQK^-0.5 log2(e)
// (exp2 with log2(e) folded in, ex2.approx.ftz), the difference from
// the running max taken before the exponential so that -1e30 - (-1e30)
// is exactly 0; tanhf without fast math; o = acc * (1 / max(l, 1e-30))
// with the reciprocal taken once per row.
//
// float32: CUDA cores (simt::attn_kernel).  The float32 path must hold
// the plain version to 2e-5, which TF32 tensor cores would not, so both
// products are f32 FMAs and the bound is 67 TFLOP/s.  What bounds this
// kernel is then feeding those FMAs: an SM's schedulers issue one warp
// instruction a clock each, and its shared memory delivers 128 bytes a
// clock, one byte per FMA the SM can issue, so a thread's register tile
// must be 8 x 8 (16 bytes of operands per 16 FMAs) or the loads, and not
// the FMAs, set the pace; every barrier and every masked pair is an FMA
// not issued too.  The first version read two scalars from shared memory
// per FMA pair in Q K^T (4 x 4 tiles, row stride D + 1, no 16-byte
// loads), copied tiles synchronously between two barriers, and computed
// and masked every visited tile whole.  The design now, one block of
// 256 threads per (batch, head, 64 query rows), one block an SM (at
// (192, 128) Q K^T's quarters are 48 wide and P V runs at DV = 128):
//  1. 8 x 8 register tiles read as float4s.  Q K^T splits the head dim
//     in quarters over 4 lanes: warp w owns rows 8 w ... 8 w + 7, and
//     lane ko + 8 qd sums their products with keys ko + 8 j over the
//     quarter qd, 4 d at a time (16 loads per 256 FMAs); two rounds of
//     shuffles (lane ^ 16, then ^ 8) leave each lane 4 rows x 4 keys of
//     whole scores, a row's 64 keys on 16 lanes.  P V gives each thread
//     8 rows x 8 head-dim columns at D = 256 (8 x 4 at 128, 4 x 4 at 64)
//     and reads p and v 4 keys at a time (16 loads per 256 FMAs).  k is
//     XOR-swizzled by row, 16 bytes at a time, so the rows a quarter-
//     warp reads at one chunk sit in separate bank groups; q and p reads
//     are broadcasts, v reads contiguous.  The tiles are q, k, v (64 x D
//     each, 192 KB at D = 256) and p (64 x 68): nothing is padded by a
//     float.
//  2. cp.async copies, 16 bytes each, overlapped with the products: a
//     tile's v is loaded while its scores are computed, the next k
//     while P V runs, into the buffer the other product has just
//     released; two barriers a tile.  A tile with every row below S is
//     copied with no clamp and no test per row.
//  3. Each warp classifies each visited tile against its 8 rows: a tile
//     with no masked pair for them is not masked, and P V runs only on
//     the groups of 4 keys that hold a pair of their windows
//     (tile_schedule counts this with F32_TILES).  Skipping is exact for
//     the reason the bfloat16 kernel's is.
//  4. The grid runs (batch, head) fastest, so the query heads of one kv
//     head read its k and v from L2 side by side, and the query tiles in
//     reverse, longest first.
// The softmax is the first version's, op for op: expf and tanhf without
// fast math, -1e30 for a masked score, corr = exp(m_prev - m_new), o =
// acc / max(l, 1e-30); each score's d and each output's keys are summed
// in order, the quarters of d in a fixed order.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;

struct Geometry {
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int s, h, group, window;
  float scale, softcap;  // softcap <= 0: none
};

namespace simt {
constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int THREADS = 256;
// Q K^T: warp w owns rows 8 w ... 8 w + 7; lane ko + 8 qd (ko < 8, qd < 4)
// sums their products with keys ko + 8 j (j < 8) over the quarter qd of
// the head dim, an 8 x 8 register tile; two rounds of shuffles then leave
// each lane 4 rows x 4 keys of whole scores (SR x SK), and a row's 64
// keys on 16 lanes
constexpr int SR = 4;           // score rows per lane after the sum
constexpr int SK = 4;           // score keys per lane after the sum
constexpr int LDP = BK + 4;     // row stride of the p tile

// P V: thread (tr, tc) of a TR x TC grid holds rows RM tr ... RM tr +
// RM - 1 of the output and its columns 4 tc + 4 TC m ... + 3 (m < RN / 4)
template <int D>
struct PV {
  static constexpr int TC = D / 4 < 32 ? D / 4 : 32;
  static constexpr int RN = D / TC;  // output columns per thread, 4 or 8
  static constexpr int TR = THREADS / TC;
  static constexpr int RM = BQ / TR;  // output rows per thread
};

// floats of shared memory: q and k tiles (BQ or BK rows of DQK), the v
// tile (BK rows of DV), the p tile, and per row the correction of the
// running sum and the sum itself
template <int DQK, int DV>
constexpr int smem_floats() {
  return (BQ + BK) * DQK + BK * DV + BQ * LDP + 2 * BQ;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where 16-byte chunk `ch` of row `r` of the k tile sits in shared
// memory: XOR-swizzled by row, so that the 8 rows a quarter-warp reads
// at one chunk sit in 8 bank groups.  The q and v tiles are not
// swizzled (a quarter-warp reads one q row, a warp one v row's chunks
// side by side).
template <int D>
__device__ __forceinline__ int k_chunk(int r, int ch) {
  return ch ^ (r & (D / 4 < 8 ? D / 4 - 1 : 7));
}

// cp.async of rows [lo, lo + 64) of one head, D wide, into a (64, D)
// tile; rows at or past s are zero-filled
template <int D, bool kSwizzled>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int lo,
                                          int s) {
  constexpr int CH = D / 4;             // 16-byte chunks per row
  if constexpr (THREADS % CH != 0) {
    // a row's chunks do not divide the threads (D = 192: 48): the tile's
    // chunks are dealt out in order, BK * CH / THREADS to a thread
    static_assert(BK * CH % THREADS == 0, "a tile's chunks per thread");
#pragma unroll
    for (int u = 0; u < BK * CH / THREADS; ++u) {
      const int i = threadIdx.x + THREADS * u;
      const int r = i / CH, ch = i % CH;
      const int pos = lo + r;
      cp_async16(dst + r * D + 4 * (kSwizzled ? k_chunk<D>(r, ch) : ch),
                 src + 4 * ch +
                     static_cast<long long>(min(pos, s - 1)) * row_stride,
                 pos < s ? 16 : 0);
    }
    return;
  }
  constexpr int STEP = THREADS / CH;    // rows apart of a thread's copies
  const int ch = threadIdx.x % CH;      // the same chunk of every row
  const int r0 = threadIdx.x / CH;
  const float* from = src + 4 * ch;
  if (lo + BK <= s) {  // every row in range: no clamp, no test
    const float* at = from + static_cast<long long>(lo + r0) * row_stride;
    const long long step = STEP * row_stride;
#pragma unroll
    for (int u = 0; u < BK / STEP; ++u) {
      const int r = r0 + STEP * u;
      cp_async16(dst + r * D + 4 * (kSwizzled ? k_chunk<D>(r, ch) : ch),
                 at + u * step, 16);
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < BK / STEP; ++u) {
    const int r = r0 + STEP * u;
    const int pos = lo + r;
    cp_async16(dst + r * D + 4 * (kSwizzled ? k_chunk<D>(r, ch) : ch),
               from + static_cast<long long>(min(pos, s - 1)) * row_stride,
               pos < s ? 16 : 0);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                Geometry g) {
  using M = PV<DV>;
  constexpr int C4 = DQK / 4;   // float4s of a q or k row
  constexpr int CV4 = DV / 4;   // float4s of a v row
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // BQ x DQK
  float* sk = sq + BQ * DQK;                    // BK x DQK, swizzled
  float* sv = sk + BK * DQK;                    // BK x DV
  float* sp = sv + BK * DV;                     // BQ x LDP
  float* scorr = sp + BQ * LDP;                 // BQ
  float* sl = scorr + BQ;                       // BQ
  const float4* sq4 = reinterpret_cast<const float4*>(sq);
  const float4* sk4 = reinterpret_cast<const float4*>(sk);
  const float4* sv4 = reinterpret_cast<const float4*>(sv);
  const float4* sp4 = reinterpret_cast<const float4*>(sp);

  const int w = threadIdx.x / 32, ko = threadIdx.x % 8;
  const int qd = threadIdx.x / 8 % 4;  // quarter of the head dim
  const int b0 = qd & 1, b1 = qd >> 1;
  // a lane's 8 rows and 8 keys start at the half it keeps after the
  // sums: rows 4 b1 ... and keys 8 (4 b0) ... first
  const int row0 = 8 * w + 4 * b1;
  const int tc = threadIdx.x % M::TC, tr = threadIdx.x / M::TC;
  // (batch, head) fastest, so the heads of a kv head run side by side;
  // query tiles in reverse, the longest causal ones first
  const int b = blockIdx.x / g.h;
  const int head = blockIdx.x % g.h;
  const int kv_head = head / g.group;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_hi = min(q_lo + BQ, g.s) - 1;

  const float* qb = q + b * g.q_sb + head * g.q_sh;
  const float* kb = k + b * g.k_sb + kv_head * g.k_sh;
  const float* vb = v + b * g.v_sb + kv_head * g.v_sh;

  // the key tiles that hold a key of some row's window: every one of
  // them has an unmasked pair, so none is skipped inside the range
  const int t_first = max(0, q_lo - g.window + 1) / BK;
  const int t_last = q_hi / BK;
  load_tile<DQK, false>(sq, qb, g.q_ss, q_lo, g.s);
  load_tile<DQK, true>(sk, kb, g.k_ss, t_first * BK, g.s);
  cp_async_commit();

  float m[SR], l[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
  }
  float acc[M::RM][M::RN];
#pragma unroll
  for (int i = 0; i < M::RM; ++i)
#pragma unroll
    for (int c = 0; c < M::RN; ++c) acc[i][c] = 0.0f;

  for (int t = t_first; t <= t_last; ++t) {
    const int k_lo = t * BK;
    cp_async_wait_all();  // this tile's k (and q)
    __syncthreads();      // ... landed for all; the last P V is done
    load_tile<DV, false>(sv, vb, g.v_ss, k_lo, g.s);
    cp_async_commit();

    // this warp's rows against the tile: a tile with no masked pair for
    // them (rows past S included) is not masked, and one with no pair of
    // their windows is not multiplied (its scores are all masked)
    const int r_lo = q_lo + 8 * w, r_hi = min(r_lo + 7, g.s - 1);
    const bool partial =
        !(k_lo + BK - 1 <= r_lo && k_lo > r_lo + 7 - g.window);
    const bool live =
        r_lo < g.s && k_lo <= r_hi && k_lo + BK - 1 > r_lo - g.window;
    // partial scores over this lane's quarter of d, 4 d at a time; part
    // [i][j]: row 8 w + (4 b1 + i) % 8, key ko + 8 j
    constexpr int SQ = C4 / 4;  // float4s of d in a quarter
    float part[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;
#pragma unroll 2
    for (int u = 0; u < (live ? SQ : 0); ++u) {
      const int c4 = qd * SQ + u;
      float4 qa[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qa[i] = sq4[(8 * w + (4 * b1 + i) % 8) * C4 + c4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 ka = sk4[(ko + 8 * j) * C4 + k_chunk<DQK>(ko, c4)];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          part[i][j] = fmaf(qa[i].x, ka.x, part[i][j]);
          part[i][j] = fmaf(qa[i].y, ka.y, part[i][j]);
          part[i][j] = fmaf(qa[i].z, ka.z, part[i][j]);
          part[i][j] = fmaf(qa[i].w, ka.w, part[i][j]);
        }
      }
    }
    // whole scores: rows with the lane of the other half of d (lane ^
    // 16: each keeps its first 4 rows and sends its last 4, the other
    // lane's first 4), then keys 8 (4 b0) ... with the lane ^ 8
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part[i][j] = part[i][j] +
                     __shfl_xor_sync(0xffffffffu, part[4 + i][j], 16);
    float sc[SR][SK];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        const float keep = b0 ? part[i][4 + j] : part[i][j];
        const float send = b0 ? part[i][j] : part[i][4 + j];
        sc[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
    // (the rows' reductions side by side, so their shuffles overlap; a
    // row's keys are on the 16 lanes that differ in ko and b0)
    float mx[SR], rs[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int qp = q_lo + row0 + i;
      mx[i] = kMasked;
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        const int kp = k_lo + ko + 8 * (4 * b0 + j);
        float x = sc[i][j] * g.scale;
        if (g.softcap > 0.0f) x = tanhf(x / g.softcap) * g.softcap;
        if (partial) x = (kp <= qp && kp > qp - g.window) ? x : kMasked;
        sc[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < SR; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      mx[i] = fmaxf(m[i], mx[i]);  // the new running max
      rs[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        const float p = expf(sc[i][j] - mx[i]);
        rs[i] += p;
        sp[(row0 + i) * LDP + ko + 8 * (4 * b0 + j)] = p;
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < SR; ++i)
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const float corr = expf(m[i] - mx[i]);
      l[i] = l[i] * corr + rs[i];
      m[i] = mx[i];
      if (threadIdx.x % 16 == 0) scorr[row0 + i] = corr;
    }
    cp_async_wait_all();  // this tile's v
    __syncthreads();      // ... landed for all; p and corr written
    if (t < t_last) {     // the next k into the tile just read
      load_tile<DQK, true>(sk, kb, g.k_ss, k_lo + BK, g.s);
      cp_async_commit();
    }

    // o = o * corr + p v, the keys in order
    float cr[M::RM];
#pragma unroll
    for (int i = 0; i < M::RM; ++i) cr[i] = scorr[M::RM * tr + i];
#pragma unroll
    for (int i = 0; i < M::RM; ++i)
#pragma unroll
      for (int c = 0; c < M::RN; ++c) acc[i][c] *= cr[i];
    // only the groups of 4 keys that hold a pair of the windows of this
    // thread's group of 8 rows: p is 0 at any other key (or wiped later
    // by corr = 0, for a row that has seen no key of its window yet)
    const int g_lo = q_lo + (M::RM * tr & ~7);
    const int g_hi = min(g_lo + 7, g.s - 1);
    const int j4_lo = max(0, g_lo - g.window + 1 - k_lo) / 4;
    const int j4_hi = g_lo < g.s ? min(BK - 1, g_hi - k_lo) / 4 : -1;
#pragma unroll 4
    for (int j4 = j4_lo; j4 <= j4_hi; ++j4) {
      float4 pa[M::RM];
#pragma unroll
      for (int i = 0; i < M::RM; ++i)
        pa[i] = sp4[(M::RM * tr + i) * (LDP / 4) + j4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 va[M::RN / 4];
#pragma unroll
        for (int n = 0; n < M::RN / 4; ++n)
          va[n] = sv4[(4 * j4 + jj) * CV4 + tc + M::TC * n];
#pragma unroll
        for (int i = 0; i < M::RM; ++i) {
          const float p = jj == 0   ? pa[i].x
                          : jj == 1 ? pa[i].y
                          : jj == 2 ? pa[i].z
                                    : pa[i].w;
#pragma unroll
          for (int n = 0; n < M::RN / 4; ++n) {
            acc[i][4 * n] = fmaf(p, va[n].x, acc[i][4 * n]);
            acc[i][4 * n + 1] = fmaf(p, va[n].y, acc[i][4 * n + 1]);
            acc[i][4 * n + 2] = fmaf(p, va[n].z, acc[i][4 * n + 2]);
            acc[i][4 * n + 3] = fmaf(p, va[n].w, acc[i][4 * n + 3]);
          }
        }
      }
    }
  }

  if (threadIdx.x % 16 == 0) {
#pragma unroll
    for (int i = 0; i < SR; ++i) sl[row0 + i] = l[i];
  }
  __syncthreads();
  float* ob = o + b * g.o_sb + head * g.o_sh;
#pragma unroll
  for (int i = 0; i < M::RM; ++i) {
    const int row = M::RM * tr + i;
    const int qp = q_lo + row;
    if (qp >= g.s) continue;
    const float den = fmaxf(sl[row], 1e-30f);
#pragma unroll
    for (int n = 0; n < M::RN / 4; ++n) {
      float4 out;
      out.x = acc[i][4 * n] / den;
      out.y = acc[i][4 * n + 1] / den;
      out.z = acc[i][4 * n + 2] / den;
      out.w = acc[i][4 * n + 3] / den;
      *reinterpret_cast<float4*>(ob + qp * g.o_ss + 4 * (tc + M::TC * n)) =
          out;
    }
  }
}

// q, k, v and o need rows on 16 bytes (the wrapper copies a view whose
// rows are not)
template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o,
           const Geometry& g, int batch, cudaStream_t stream) {
  static_assert(sizeof(T) == 4, "the CUDA-core kernel is float32");
  const int smem =
      static_cast<int>(sizeof(float)) * smem_floats<DQK, DV>();
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per pair
      attn_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(batch * g.h, (g.s + BQ - 1) / BQ);
  attn_kernel<DQK, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WGS = 2;              // warpgroups per block
constexpr int THREADS = 128 * WGS;
constexpr int BQ = 64 * WGS;        // query rows per block, 64 per warpgroup
constexpr int BK = 64;              // keys per tile, 4 chunks of 16
constexpr int STAGES = 2;           // K/V ring depth
constexpr int ATOM = 64;            // columns of one 128-byte swizzle atom
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory width of a tile row: D, or one atom zero-padded past D
__host__ __device__ constexpr int width(int d) { return d < ATOM ? ATOM : d; }
__host__ __device__ constexpr int smem_bytes(int dqk, int dv) {
  // the q tile and the K/V ring, 1024 bytes of slack to put them on a
  // 1024-byte boundary, and the barriers and counters
  return 2 * (BQ * width(dqk) + STAGES * BK * (width(dqk) + width(dv))) +
         1024 + 64;
}

// Byte offset of 16-byte chunk `chunk` (columns 8 chunk ...) of row `row`
// in a (ROWS, width) bf16 tile kept as width / 64 atoms of (ROWS, 64):
// rows of 128 bytes whose chunks are XOR-swizzled by row % 8, atoms on
// 1024-byte boundaries.  That is the layout wgmma's 128-byte swizzle
// mode reads, for a K-major operand (Q, K: rows are M or N, columns K)
// and for an MN-major one (V: rows are K, columns N) alike.
template <int ROWS>
__device__ __forceinline__ int tile_off(int row, int chunk) {
  return (chunk >> 3) * ROWS * 128 + row * 128 +
         (((chunk & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// the arrival of the thread that issues the copies, and the bytes they
// will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// TMA: the box at coordinates (c0 .. c3) of a 4-d tensor map into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile."
      "mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// named barriers: 1 and 2 order the two warpgroups' tensor-core work, 3
// and 4 gather one warpgroup
template <int ID, int N = THREADS>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}
template <int ID>
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
}
// the turn on the tensor cores passes to the other warpgroup (warpgroup
// 1's last turn has no taker)
__device__ __forceinline__ void pass_turn(int wg, bool more) {
  if (wg == 0)
    bar_arrive<2>();
  else if (more)
    bar_arrive<1>();
}

// wgmma matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle
__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins an accumulator register after wgmma_wait: no read of it moves
// above the wait
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// the accumulator operands d[i] .. d[i + 31] of a wgmma asm statement
#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACC32(i) ACC16(i), ACC16(i + 16)

// d (64 x 64, f32) (+)= a (64 x 16, K-major, shared) b (16 x 64, K-major,
// shared); the first product of a sum passes accumulate = 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) += a (64 x 16, registers) b (16 x N, MN-major, shared)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC32(0), ACC32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      " %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      " %100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      " %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC32(0), ACC32(32), ACC32(64), ACC32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC32
#undef ACC16
#undef ACC4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x (MUFU.EX2; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile for this lane's rows row0 (S registers
// 4 n, 4 n + 1) and row0 + 8 (4 n + 2, 4 n + 3), in place: S to p, m and
// l updated, the accumulator's correction returned in corr.  Scores are
// taken to the log2 domain, x = s D^-0.5 log2(e) (the soft cap on
// s D^-0.5 first), and masked at -1e30 where the tile is partial, which
// masks the dead chunks too; p = 2^(x - m) for the live chunks.
__device__ __forceinline__ void softmax(float (&sc)[32], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        int k_lo, int live, bool partial,
                                        int row0, int col, const Geometry& g,
                                        float scale_log2) {
  float mx[2] = {kMasked, kMasked};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = g.softcap > 0.0f
                  ? tanhf(sc[i] * g.scale / g.softcap) * g.softcap * kLog2e
                  : sc[i] * scale_log2;
    if (partial) {
      const int kp = k_lo + 8 * (i / 4) + col + (i & 1);
      const int qp = row0 + 8 * (i % 4 / 2);
      x = (kp <= qp && kp > qp - g.window) ? x : kMasked;
    }
    sc[i] = x;
    mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (!(live >> (i / 8) & 1)) continue;
    sc[i] = ex2(sc[i] - m[i % 4 / 2]);
    l[i % 4 / 2] += sc[i];
  }
}

// K and V of tile t (counted from the first visited, t0) into ring
// stage (t - t0) % 2 with TMA: 64-column boxes in the 128-byte swizzle,
// completing the stage's `full` barrier; K (DQK wide) first in the
// stage, then V (DV wide, DV <= DQK)
template <int DQK, int DV>
__device__ __forceinline__ void load_kv(unsigned char* stage_kv,
                                        uint64_t* full, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int kv_head,
                                        int t, int b) {
  constexpr int K_BYTES = 2 * BK * width(DQK), V_BYTES = 2 * BK * width(DV);
  mbar_expect(full, K_BYTES + V_BYTES);
  for (int a = 0; a < width(DQK) / ATOM; ++a) {
    tma_load(stage_kv + a * BK * 128, tk, a * ATOM, kv_head, t * BK, b, full);
    if (a < width(DV) / ATOM)
      tma_load(stage_kv + K_BYTES + a * BK * 128, tv, a * ATOM, kv_head,
               t * BK, b, full);
  }
}

// One block: 128 query rows of one (batch, head), two warpgroups of 64.
// Each warpgroup's accumulators follow wgmma's m64nN layout: lane
// 4 g + t of warp w holds rows 16 w + g and 16 w + g + 8 and, in each
// 8-wide n block i, columns 8 i + 2 t and 8 i + 2 t + 1 (registers
// 4 i .. 4 i + 3) -- per 16 keys, the A fragment of P . V.
//
// Copies.  Thread 0 loads the q tile and the first two key tiles with
// TMA; after that, the warpgroup that is second to finish with a ring
// stage (a counter per stage tells which) loads the stage's next tile,
// two ahead.  Each tile's `full` barrier completes when its bytes land.
// Turns.  The warpgroups take turns on the tensor cores through named
// barriers 1 and 2: one issues S = Q K^T only after the other has issued
// its own, so one warpgroup's softmax runs while the other's products do.
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    attn_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                bf16* __restrict__ o, Geometry g) {
  // the output is staged through the q tile, which must hold DV columns
  static_assert(DV <= width(DQK), "v wider than q");
  constexpr int Q_BYTES = 2 * BQ * width(DQK);
  constexpr int K_BYTES = 2 * BK * width(DQK);
  constexpr int STAGE_BYTES = K_BYTES + 2 * BK * width(DV);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* skv = sq + Q_BYTES;  // stage i: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + STAGES * STAGE_BYTES);
  uint64_t* full = bars;  // [STAGES]: the stage's tile landed
  uint64_t* q_full = bars + STAGES;
  int* done = reinterpret_cast<int*>(bars + STAGES + 1);  // [STAGES]

  // the warpgroup index read from lane 0: the compiler then knows it,
  // and every branch around a wgmma, to be uniform (a branch it must
  // take as divergent makes ptxas serialize the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int b = blockIdx.x / g.h, head = blockIdx.x % g.h;
  const int kv_head = head / g.group;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int q_hi = min(q_lo + BQ, g.s) - 1;
  const int t0 = max(0, q_lo - g.window + 1) / BK;  // visited key tiles
  const int t1 = q_hi / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      done[i] = 0;
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(q_full, Q_BYTES);
    for (int a = 0; a < width(DQK) / ATOM; ++a)
      tma_load(sq + a * BQ * 128, &tq, a * ATOM, head, q_lo, b, q_full);
    for (int t = t0; t <= min(t1, t0 + STAGES - 1); ++t)
      load_kv<DQK, DV>(skv + (t - t0) * STAGE_BYTES, &full[t - t0], &tk,
                       &tv, kv_head, t, b);
  }
  __syncthreads();

  // this warpgroup's rows (those at or past s are computed, not stored)
  // and this lane's two
  const int r_lo = q_lo + 64 * wg;
  const int r_hi = min(r_lo + 63, g.s - 1);
  const unsigned char* sq_wg = sq + wg * 64 * 128;
  const int row0 = r_lo + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  const float scale_log2 = g.scale * kLog2e;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};  // l: this lane's
  float corr[2];                                         // columns only
  float acc[width(DV) / 2];
#pragma unroll
  for (int i = 0; i < width(DV) / 2; ++i) acc[i] = 0.0f;
  float sc[32];  // S, then p, of one tile (a sum's first wgmma ignores it)
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;

  if (wg == 1) bar_arrive<1>();  // warpgroup 0 goes first
  mbar_wait(q_full, 0);
  for (int t = t0; t <= t1; ++t) {
    const int i = t - t0, stage = i % STAGES;
    const int k_lo = t * BK;
    // chunk j (keys k_lo + 16 j ...) is live if it can hold a key of
    // some row's window, k <= r_hi and k > r_lo - window; the same for
    // the whole warpgroup
    int live = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k_lo + 16 * j;
      if (r_lo < g.s && c <= r_hi && c + 15 > r_lo - g.window)
        live |= 1 << j;
    }
    unsigned char* sk = skv + stage * STAGE_BYTES;
    const unsigned char* sv = sk + K_BYTES;
    mbar_wait(&full[stage], (i / STAGES) & 1);

    // S = Q K^T, both K-major: 8-row groups 1024 bytes apart, k16 steps
    // 32 bytes apart inside a 64-column atom; issued in turn with the
    // other warpgroup (which takes its turn even on a dead tile)
    if (wg == 0)
      bar_sync<1>();
    else
      bar_sync<2>();
    if (live) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DQK / 16; ++ks)
        wgmma_ss(sc,
                 desc(sq_wg + (ks / 4) * BQ * 128 + (ks % 4) * 32, 0, 1024),
                 desc(sk + (ks / 4) * BK * 128 + (ks % 4) * 32, 0, 1024),
                 ks > 0);
      wgmma_commit();
      pass_turn(wg, t < t1);
      // some pair masked: not every key at or before the first row and
      // inside the last row's window
      const bool partial =
          !(k_lo + BK - 1 <= r_lo && k_lo > r_lo + 63 - g.window);
      wgmma_wait();
#pragma unroll
      for (int i = 0; i < 32; ++i) keep(sc[i]);

      softmax(sc, m, l, corr, k_lo, live, partial, row0, col, g,
              scale_log2);
#pragma unroll
      for (int i = 0; i < width(DV) / 2; ++i) acc[i] *= corr[(i / 2) % 2];

      // O += P V, 16 keys at a time: the S accumulators of chunk j are
      // its A fragment; V MN-major: 8-key groups 1024 bytes apart,
      // 64-column atoms BK * 128 apart
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[j][i] = pack_bf16(sc[8 * j + 2 * i], sc[8 * j + 2 * i + 1]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (live >> j & 1)
          wgmma_rs<width(DV)>(acc, pa[j],
                              desc(sv + j * 16 * 128, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int i = 0; i < width(DV) / 2; ++i) keep(acc[i]);
    } else {
      pass_turn(wg, t < t1);
    }
    // the warpgroup is done with the stage; the second one to be done
    // loads the stage's next tile
    if (wg == 0)
      bar_sync<3, 128>();
    else
      bar_sync<4, 128>();
    if (threadIdx.x % 128 == 0 && t + STAGES <= t1) {
      __threadfence_block();
      if (atomicAdd(&done[stage], 1) & 1) {
        __threadfence_block();
        load_kv<DQK, DV>(sk, &full[stage], &tk, &tv, kv_head, t + STAGES,
                         b);
      }
    }
  }

  if (r_lo >= g.s) return;
  // o = acc / max(l, 1e-30) through this warp's own 16 rows of the q
  // tile, then 16-byte stores
  float inv[2];  // 1 / max(l, 1e-30), once per row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  const int r0 = 64 * wg + 16 * warp;  // first row of this warp in the tile
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(
        sq + tile_off<BQ>(r0 + lane / 4, n) + 2 * col) =
        __floats2bfloat162_rn(acc[4 * n] * inv[0], acc[4 * n + 1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(
        sq + tile_off<BQ>(r0 + lane / 4 + 8, n) + 2 * col) =
        __floats2bfloat162_rn(acc[4 * n + 2] * inv[1],
                              acc[4 * n + 3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = o + b * g.o_sb + head * g.o_sh;
  constexpr int C = DV / 8;
  const int p_lo = q_lo + r0;
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = i / C, c = i % C;
    if (p_lo + r < g.s)
      *reinterpret_cast<uint4*>(ob + (p_lo + r) * g.o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(sq + tile_off<BQ>(r0 + r, c));
  }
}

// A 4-d tensor map over a (B, S, heads, D) bf16 tensor with element
// strides (sb, ss, sh, 1), dimensions ordered (D, heads, S, B) from the
// fastest; boxes of 64 columns x `rows` rows of one head, 128-byte
// swizzle, zeros past the tensor's edges.  Strides of extent-1
// dimensions are not read, so they are made up to keep the order.
int tensor_map(CUtensorMap* map, const void* base, long long sb,
               long long ss, long long sh, int batch, int s, int heads,
               int d, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long esh = heads > 1 ? sh : d;
  const long long ess = s > 1 ? ss : esh * heads;
  const long long esb = batch > 1 ? sb : ess * s;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(s),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * esh),
                           static_cast<cuuint64_t>(2 * ess),
                           static_cast<cuuint64_t>(2 * esb)};
  cuuint32_t box[4] = {ATOM, 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o,
           const Geometry& g, int batch, cudaStream_t stream) {
  const int smem = smem_bytes(DQK, DV);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per pair
      attn_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int kv = g.h / g.group;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, g.q_sb, g.q_ss, g.q_sh, batch, g.s, g.h, DQK,
                       BQ);
  if (!err)
    err = tensor_map(&tk, k, g.k_sb, g.k_ss, g.k_sh, batch, g.s, kv, DQK,
                     BK);
  if (!err)
    err = tensor_map(&tv, v, g.v_sb, g.v_ss, g.v_sh, batch, g.s, kv, DV, BK);
  if (err) return err;
  const dim3 grid(batch * g.h, (g.s + BQ - 1) / BQ);
  attn_kernel<DQK, DV><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// the (q/k, v) head-dim pairs built; any other is refused
int launch_d(const void* q, const void* k, const void* v, void* o,
             const Geometry& g, int batch, int dqk, int dv, bool bf16,
             cudaStream_t stream) {
#define ATTN_CASE(DQK, DV)                                                  \
  if (dqk == DQK && dv == DV)                                               \
    return bf16 ? tc::launch<DQK, DV>(q, k, v, o, g, batch, stream)         \
                : simt::launch<float, DQK, DV>(q, k, v, o, g, batch, stream);
  ATTN_CASE(16, 16)
  ATTN_CASE(64, 64)
  ATTN_CASE(128, 128)
  ATTN_CASE(256, 256)
  ATTN_CASE(192, 128)
#undef ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point for ctypes.  Strides are in elements; q and k are
// dqk wide, v and o dv wide; `bf16` selects the bfloat16 tensor-core
// kernel, else the float32 one, for q, k, v and o alike.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int local_attention_launch(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* v, long long v_sb, long long v_ss, long long v_sh, void* o,
    long long o_sb, long long o_ss, long long o_sh, int batch, int s, int h,
    int group, int dqk, int dv, int window, float scale, float softcap,
    int bf16, void* stream) {
  const Geometry g{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                   o_sb, o_ss, o_sh, s, h, group, window, scale, softcap};
  return launch_d(q, k, v, o, g, batch, dqk, dv, bf16 != 0,
                  static_cast<cudaStream_t>(stream));
}

