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
//   (D = DQK, q and k's head dim; v, o and dO are DV wide)
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
// Two routes, one dispatch (local_attention_bwd_launch, at the end), over
// the (DQK, DV) head-dim pairs (D, D) for D = 16, 64, 128, 256 and MLA's
// (192, 128) (deepseek-v3: q and k 128 + 64 rope dims, v 128; the scale
// DQK^-0.5): bfloat16 at (64, 64), (128, 128), (256, 256) and (192, 128)
// runs the tensor-core kernels (namespace tcb); float32 at every pair,
// and bfloat16 at (16, 16) (reduced configs only), run the CUDA-core
// kernels (namespace simt).  Every kernel is a template on the pair;
// where DQK != DV the products over Q and K (S, dK += dS^T Q, dQ += dS
// K) run DQK deep or wide and those over V and dO (dP, dV += P^T dO,
// delta) DV.
// Each route is three kernels on one stream, launched by one call, with
// no atomics: every gradient is summed in one block or one cluster in a
// fixed order, so a backward is bitwise repeatable.
//
// Tensor cores (tcb), the design against what held the first CUDA-core
// kernels back (no tensor cores, operands staged through f32 shared
// memory, a small and unbalanced grid):
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
//       At (192, 128): dV += P^T dO is m64n128k16 (64 accumulators a
//       thread), dK += dS^T Q m64n192k16 (96); K 24 KB, V 16 KB, the
//       ring 2 x 41 KB (Q, dO, statistics), the hand-over 16 KB:
//       142,400 bytes with the alignment slack, one block an SM.
//     tc_dq: one block of two warpgroups per (batch, head, 64 query
//       rows), K and V through the ring: warpgroup 0 computes S and P,
//       warpgroup 1 dP and dS, handed back as bf16 fragments; dQ += dS
//       K is split by columns (DV / 2 to warpgroup 0, the rest to
//       warpgroup 1, so that both run as many products; all of it in
//       warpgroup 1 at D = 64).  At (192, 128): 64 and 128 columns, the
//       operand starting on a 64-column atom (an MN-major operand cannot
//       start inside one); Q 24 KB, dO 16 KB, the ring 2 x 40 KB (K, V),
//       the hand-over 16 + 8 KB: 148,544 bytes.  tc_stats at (192, 128):
//       Q and a 2-stage K ring, 74,816 bytes, two blocks an SM.
//       Query tiles in reverse, the longest first.
//     So Q K^T runs three times and dO V^T twice: 16 D per pair on the
//     tensor cores against the 12 D the bound counts (at DQK != DV:
//     10 DQK + 6 DV against 8 DQK + 4 DV, 2688 against 2048 operations
//     a pair at (192, 128)).
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
// CUDA cores (simt: float32 at every head dim, bfloat16 at D = 16).  The
// float32 gradient must hold the plain version to 1e-4 of its scale,
// which TF32 tensor cores would not, so every product is f32 FMAs and
// the bound is 67 TFLOP/s.  As in the float32 forward
// (csrc/local_attention.cu, simt::attn_kernel), what bounds such a
// kernel is feeding those FMAs: an SM's shared memory gives 128 bytes a
// clock and its schedulers issue 128 FMAs, so each 16-byte load has to
// feed 16 FMAs.  The first version read one scalar from shared memory
// per FMA in S and dP (2 x 2 register tiles, rows padded by a float),
// copied tiles synchronously between two barriers, and gave dk / dv one
// block per (kv head, 32 keys): 20 blocks on 132 SMs at batch 1, S 640
// and a group of 4 on one kv head.  The design now: tiles of 32 query
// rows and 32 keys, blocks of 256 threads in two teams of four warps,
// one block an SM at D = 256.  At (192, 128) the two teams' S and dP are
// 192 and 128 deep, so each runs its own copy of the score loop, and
// their sums differ in width (team 0's dV 32 accumulators a thread,
// team 1's dK 64 over 96 of its 128 threads; dQ 32 over 192 of 256):
// stats 125,184 bytes of shared memory, dk / dv 137,216, dq 132,352.
//  1. 8 x 8 register tiles read as float4s.  S and dP (score_tile): a
//     team's lane e + 8 (rg + 2 kg) of warp w sums 8 rows against 8
//     keys over the head dim's 16-byte chunks e, e + 8, ... (16 loads
//     per 256 FMAs; the 8 lanes of a quarter-warp read 8 bank groups of
//     any row, so no row is padded or swizzled), and three rounds of
//     shuffles (lane ^ 4, ^ 2, ^ 1) leave each lane one row's 8 scores,
//     its chunks summed in one fixed order.  The gradient products
//     (grad_tile: dV += P^T dO, dK += dS^T Q, dQ += dS K) give a thread
//     8 rows x 8 columns at D = 256 in dk / dv (8 x 4 in dq, and at D =
//     128) and read a row of P or dS 4 at a time and dO, Q or K 4
//     columns at a time: 4 loads per 64 FMAs, a warp's P reads one
//     broadcast and its dO reads one 128-byte row piece.
//  2. Teams.  In dkdv team 0 computes S and team 1 dP at the same time;
//     team 1 hands dP over through shared memory, team 0 forms P and
//     dS (the first version's arithmetic, op for op), and then team 0
//     runs dV += P^T dO while team 1 runs dK += dS^T Q: each team keeps
//     one (32, D) accumulator.  In dq the teams compute S and dP, team
//     0 forms dS (stored transposed) and all 256 threads run dQ += dS K.
//     In stats each team takes every other key tile of the block's share.
//     Each product is one call for both teams, on operands chosen by
//     team: a copy of the unrolled loop a team cost 7% of dk / dv in
//     instruction fetch.
//  3. cp.async copies, 16 bytes each, into a 2-stage ring of the
//     streamed tiles (Q, dO, lse and delta in dkdv; K and V in dq; two
//     K tiles at a time in stats), the next step's copies issued as a
//     step starts and awaited at the next; a tile whose rows all lie
//     below S is copied with no test per row.  bfloat16 (D = 16 only)
//     is loaded and widened to f32 by the threads instead.
//  4. The grid fills the card with a fixed-order sum.  Each kernel walks
//     tiles (a query tile of a head in stats and dq, a key tile of a kv
//     head in dkdv) in steps: key tiles, or (head of the group, query
//     tile) pairs.  While one block a tile would leave SMs idle, a
//     cluster of walk_parts blocks (the fewest that fill the card, a
//     power of two up to 8) takes each tile, its blocks walking
//     consecutive shares of the steps; they add up their partial sums
//     through distributed shared memory in block order, each block one
//     slice of them (stats: block 0 merges each row's running max and
//     sum), and store: no atomics, no buffer in device memory.  The grid
//     is as many clusters as the card holds at once; the tiles, heaviest
//     first, are dealt to them in a snake (dealt), and which block takes
//     which share turns from tile to tile, so that the blocks' walks stay
//     near the mean.  At batch 1, S 640, 4 heads on 1 kv head: stats and
//     dq in clusters of 2, dk / dv in clusters of 8.
//     kernels/local_attention.py::bwd_cc_parts, bwd_cc_deal and
//     bwd_cc_schedule mirror the rule, the deal and the walks.
//  5. Every visited tile holds an unmasked pair, and the mask is applied
//     only on a tile that holds a masked pair (tile_full).  Key tiles go
//     in order and query tiles in reverse, the longest walks first.
// p and dS are the first version's, op for op: expf and tanhf without
// fast math, p rounded to the input type before dV, lse = m + log(l).

#include "sm90.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

struct Geometry {
  int s, h, group, window;
  float scale, softcap;  // softcap <= 0: none
};

// the first N of an accumulator array of M >= N floats, as an array:
// at MLA's pair the two teams' or warpgroups' sums differ in width and
// share one array sized for the wider
template <int N, int M>
__device__ __forceinline__ float (&prefix(float (&a)[M]))[N] {
  static_assert(N <= M, "a prefix of the array");
  return *reinterpret_cast<float(*)[N]>(&a[0]);
}

namespace simt {

constexpr int TILE = 32;       // query rows and keys per tile
constexpr int THREADS = 256;   // two teams of 4 warps
constexpr int TEAM = 128;
constexpr int LDT = TILE + 4;  // row stride of the (32, 32) p, dP, dS tiles
constexpr int MAX_PARTS = 8;   // blocks of a cluster (the portable limit)

// the row stride of the lse and delta scratch: S rounded up to 64
__host__ __device__ constexpr int stat_stride(int s) {
  return (s + 63) / 64 * 64;
}

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
// four values, rounded to the output type, at p (on 16 or 8 bytes)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Rows [lo, lo + 32) of one head of a (B, S, heads, D) tensor (`src` at
// the head's first column of row 0, rows `stride` elements apart) into a
// (32, D) f32 tile, by the whole block; rows at or past s are zeros.
// float32 goes by cp.async, 16 bytes a copy (awaited by
// cp_async_wait_all); bfloat16 (D = 16 only) is loaded and widened here.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int lo, int s) {
  constexpr int PER = 16 / static_cast<int>(sizeof(T));  // a copy's values
  constexpr int CH = D / PER;                            // copies a row
  constexpr int N = TILE * CH;
  const bool whole = lo + TILE <= s;  // every row in range: no test
#pragma unroll
  for (int u = 0; u < (N + THREADS - 1) / THREADS; ++u) {
    const int i = threadIdx.x + THREADS * u;
    if (N % THREADS != 0 && i >= N) break;
    const int r = i / CH, c = i % CH;
    const bool in = whole || lo + r < s;
    const T* from =
        src + static_cast<long long>(in ? lo + r : s - 1) * stride + c * PER;
    float* to = dst + r * D + c * PER;
    if constexpr (sizeof(T) == 4) {
      cp_async16(to, from, in ? 16 : 0);
    } else {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (in) raw = *reinterpret_cast<const uint4*>(from);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 c2 = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
      reinterpret_cast<float4*>(to)[0] = make_float4(a.x, a.y, b.x, b.y);
      reinterpret_cast<float4*>(to)[1] = make_float4(c2.x, c2.y, d.x, d.y);
    }
  }
}

__device__ __forceinline__ bool in_window(int i, int j, int s, int window) {
  return i < s && j < s && j <= i && j > i - window;
}
// a (32 rows, 32 keys) tile with no masked pair: every key at or before
// the first row, the last row inside the first key's window, every row
// below S
__device__ __forceinline__ bool tile_full(int q0, int k0, const Geometry& g) {
  return k0 + TILE - 1 <= q0 && q0 + TILE - 1 - k0 < g.window &&
         q0 + TILE - 1 < g.s;
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

// The row of A and the first row of B of this lane's 8 scores after
// score_tile (rows and keys of a (32, 32) tile)
__device__ __forceinline__ int lane_row() {
  const int t = threadIdx.x % TEAM, lane = t % 32;
  return 16 * (t / 32 % 2) + 8 * (lane / 8 % 2) + lane % 8;
}
__device__ __forceinline__ int lane_key() {
  const int t = threadIdx.x % TEAM;
  return 16 * (t / 64) + 8 * (t % 32 / 16);
}

// A B^T of two (32, D) f32 tiles in shared memory, by one team of 128
// threads.  Warp w of the team covers rows 16 (w % 2) ... + 15 and keys
// 16 (w / 2) ... + 15: its lane e + 8 (rg + 2 kg) sums rows 8 rg + i of
// those against keys 8 kg + j (i, j < 8) over the head dim's 16-byte
// chunks e, e + 8, ..., an 8 x 8 register tile (at D = 16 lanes e >= 4
// have no chunk).  Slot i of the tile holds row i ^ e, so that shuffles
// with lane ^ 4, ^ 2 and ^ 1, each keeping the low half of the slots and
// sending the high half, leave slot 0 with row e: out[j] = A[lane_row()]
// . B[lane_key() + j].
template <int D>
__device__ __forceinline__ void score_tile(const float* a, const float* b,
                                           float (&out)[8]) {
  constexpr int C4 = D / 4;  // 16-byte chunks of a row
  const int t = threadIdx.x % TEAM, w = t / 32, lane = t % 32;
  const int e = lane % 8;
  const float4* a4 = reinterpret_cast<const float4*>(a) +
                     (16 * (w % 2) + 8 * (lane / 8 % 2)) * C4;
  const float4* b4 =
      reinterpret_cast<const float4*>(b) + (16 * (w / 2) + 8 * (lane / 16)) * C4;
  float part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll 2
  for (int u = 0; u < (C4 + 7) / 8; ++u) {
    const int c = e + 8 * u;
    if (C4 % 8 != 0 && c >= C4) break;
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = a4[(i ^ e) * C4 + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = b4[j * C4 + c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        part[i][j] = fmaf(av[i].x, bv.x, part[i][j]);
        part[i][j] = fmaf(av[i].y, bv.y, part[i][j]);
        part[i][j] = fmaf(av[i].z, bv.z, part[i][j]);
        part[i][j] = fmaf(av[i].w, bv.w, part[i][j]);
      }
    }
  }
  // slot i of lane e and slot i ^ m of lane e ^ m hold the same row
#pragma unroll
  for (int m = 4; m > 0; m /= 2)
#pragma unroll
    for (int i = 0; i < m; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part[i][j] += __shfl_xor_sync(0xffffffffu, part[i + m][j], m);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = part[0][j];
}

// The layout of a gradient product's accumulators over NT threads: a
// (32, D) result, thread t < ACTIVE holding rows KR (t % KG) ... + KR - 1
// and columns 4 (t / KG) + 4 TC m ... + 3 (m < RN / 4)
__host__ __device__ constexpr int pow2_floor(int x) {
  return x < 2 ? 1 : 2 * pow2_floor(x / 2);
}
template <int D, int NT>
struct Grad {
  static constexpr int RN = NT == TEAM && D >= 256 ? 8 : 4;
  static constexpr int TC = D / RN;  // column groups
  // row groups: a power of two, so that they divide the tile's rows (D =
  // 192 leaves NT / TC = 2.67 or 5.33 a column group)
  static constexpr int KG = pow2_floor(NT / TC < TILE ? NT / TC : TILE);
  static constexpr int KR = TILE / KG;  // rows a thread
  static constexpr int ACTIVE = TC * KG;
  static constexpr int N = KR * RN;  // accumulators a thread
};


// acc += A^T B over the 32 rows r of a (32, 32) tile A (row stride LDT,
// its columns the result's rows) and a (32, D) tile B, r in order
template <int D, int NT>
__device__ __forceinline__ void grad_tile(const float* a, const float* b,
                                          float (&acc)[Grad<D, NT>::N],
                                          int t) {
  using G = Grad<D, NT>;
  if (t >= G::ACTIVE) return;
  const int g0 = G::KR * (t % G::KG), c0 = 4 * (t / G::KG);
#pragma unroll 8
  for (int r = 0; r < TILE; ++r) {
    float av[G::KR];
    if constexpr (G::KR % 4 == 0) {
#pragma unroll
      for (int x = 0; x < G::KR / 4; ++x) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + r * LDT + g0 + 4 * x);
        av[4 * x] = v.x;
        av[4 * x + 1] = v.y;
        av[4 * x + 2] = v.z;
        av[4 * x + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int x = 0; x < G::KR; ++x) av[x] = a[r * LDT + g0 + x];
    }
    float4 bv[G::RN / 4];
#pragma unroll
    for (int m = 0; m < G::RN / 4; ++m)
      bv[m] = *reinterpret_cast<const float4*>(b + r * D + c0 + 4 * G::TC * m);
#pragma unroll
    for (int x = 0; x < G::KR; ++x)
#pragma unroll
      for (int m = 0; m < G::RN / 4; ++m) {
        float* o = acc + x * G::RN + 4 * m;
        o[0] = fmaf(av[x], bv[m].x, o[0]);
        o[1] = fmaf(av[x], bv[m].y, o[1]);
        o[2] = fmaf(av[x], bv[m].z, o[2]);
        o[3] = fmaf(av[x], bv[m].w, o[3]);
      }
  }
}

// A gradient product's (32, D) result, summed over the cluster's blocks
// in block order, into rows r0 ... of one head of a (B, S, heads, D)
// tensor (`base` at the head's first column of row 0; rows past S are
// not stored).  A block alone stores its accumulators.  In a cluster,
// each block leaves them in `part` (NT * N floats of its shared memory),
// and block z adds up, in block order, and stores the float4s x = z, z +
// parts, ... of every thread's: a reduce-scatter through distributed
// shared memory, each block reading one share of the partial sums.
// put_part leaves them, sum_part adds and stores, and every thread of the
// cluster syncs between the two (store_sum, or the caller where the
// block's threads hold sums of two widths).
template <int D, int NT>
__device__ __forceinline__ void put_part(const float (&acc)[Grad<D, NT>::N],
                                         float* part, int t) {
  using G = Grad<D, NT>;
  if (gridDim.z == 1 || t >= G::ACTIVE) return;
  float4* p4 = reinterpret_cast<float4*>(part);
#pragma unroll
  for (int x = 0; x < G::N / 4; ++x)
    p4[x * NT + t] = make_float4(acc[4 * x], acc[4 * x + 1], acc[4 * x + 2],
                                 acc[4 * x + 3]);
}

template <typename T, int D, int NT>
__device__ __forceinline__ void sum_part(const float (&acc)[Grad<D, NT>::N],
                                         const float* part, T* base,
                                         long long row_stride, int r0, int s,
                                         int t) {
  using G = Grad<D, NT>;
  constexpr int X = G::N / 4, XR = G::RN / 4;  // float4s: all, of a row
  const bool active = t < G::ACTIVE;
  const int g0 = G::KR * (t % G::KG), c0 = 4 * (t / G::KG);
  auto put = [&](int x, float4 v) {  // float4 x: row x / XR, columns x % XR
    const int row = r0 + g0 + x / XR;
    if (row < s)
      store4(base + row * row_stride + c0 + 4 * G::TC * (x % XR), v);
  };
  const int parts = static_cast<int>(gridDim.z);
  if (parts == 1) {
    if (active) {
#pragma unroll
      for (int x = 0; x < X; ++x)
        put(x, make_float4(acc[4 * x], acc[4 * x + 1], acc[4 * x + 2],
                           acc[4 * x + 3]));
    }
    return;
  }
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (int x = blockIdx.z; active && x < X; x += parts) {
    const void* at = p4 + x * NT + t;
    float4 sum = ld_cluster4(sm90::cluster_addr(at, 0));
    for (int r = 1; r < parts; ++r) {
      const float4 v = ld_cluster4(sm90::cluster_addr(at, r));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    put(x, sum);
  }
}

template <typename T, int D, int NT>
__device__ __forceinline__ void store_sum(const float (&acc)[Grad<D, NT>::N],
                                          float* part, T* base,
                                          long long row_stride, int r0, int s,
                                          int t) {
  put_part<D, NT>(acc, part, t);
  if (gridDim.z > 1) sm90::cluster_sync();  // every thread of the cluster
  sum_part<T, D, NT>(acc, part, base, row_stride, r0, s, t);
}

// The walk of tile `tile` split over the gridDim.z blocks of its
// cluster in consecutive shares, the blocks taking them in turn from
// tile to tile (block z takes share (z + tile) % gridDim.z, so that the
// shares one longer than the others spread over the blocks): this
// block's steps [*first, *first + *n)
__device__ __forceinline__ void share(int steps, int tile, int* first,
                                      int* n) {
  const int parts = static_cast<int>(gridDim.z);
  const int i = (static_cast<int>(blockIdx.z) + tile) % parts;
  *first = steps * i / parts;
  *n = steps * (i + 1) / parts - *first;
}

// The tiles a cluster walks: the grid is gridDim.x clusters, and tile
// r * gridDim.x + c of the heaviest-first order goes to cluster c on
// even rounds r and to cluster gridDim.x - 1 - c on odd ones (a snake),
// so that each cluster's sum of walks is near the mean.  -1 past the end.
__device__ __forceinline__ int dealt(int c, int r, int clusters, int tiles) {
  const int tile = r * clusters + (r % 2 == 0 ? c : clusters - 1 - c);
  return tile < tiles ? tile : -1;
}

// a running max and sum of exponentials merged with another (the same
// result either way round)
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty: l = l2 = 0
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

// 1. lse and D per query row.  A tile is (batch, head, 32 query rows),
// dealt heaviest first (query tiles in reverse); a cluster's blocks walk
// consecutive shares of its key tiles, each team every other key tile of
// the share, two K tiles a ring stage
template <int D>
struct StatsTiles {
  static constexpr int TD = TILE * D;
  static constexpr int STAGE = 2 * TD;
  // Q, the ring, each (team, key half, key group)'s max and sum per row,
  // the block's max and sum per row for the cluster
  static constexpr int FLOATS = TD + 2 * STAGE + 8 * 2 * TILE + 2 * TILE;
  static constexpr int BYTES = 4 * FLOATS;
};

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    cc_stats(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ lse, float* __restrict__ delta, Geometry g,
             int tiles) {
  constexpr int D = DQK;  // Q and K; o and dO are DV wide
  using L = StatsTiles<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ring = qs + L::TD;
  float* mrg = ring + 2 * L::STAGE;  // (8, 2, 32)
  float* blk = mrg + 8 * 2 * TILE;   // (2, 32)
  const int nq = (g.s + TILE - 1) / TILE, heads = tiles / nq;
  const int kv_heads = g.h / g.group;
  const long long q_row = static_cast<long long>(g.h) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const long long o_row = static_cast<long long>(g.h) * DV;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int team = threadIdx.x / TEAM;
  const int row = lane_row(), key = lane_key();
  for (int r = 0;; ++r) {
    const int tile = dealt(blockIdx.x, r, gridDim.x, tiles);
    if (tile < 0) break;
    const int bh = tile % heads, b = bh / g.h, h = bh % g.h;
    const int q0 = (nq - 1 - tile / heads) * TILE;
    const long long q_off = static_cast<long long>(b) * g.s * q_row + h * D;
    const long long o_off = static_cast<long long>(b) * g.s * o_row + h * DV;
    const T* kb =
        k + static_cast<long long>(b) * g.s * k_row + (h / g.group) * D;
    const int t0 = max(0, q0 - g.window + 1) / TILE;
    int first, n;
    share(min(q0 + TILE - 1, g.s - 1) / TILE - t0 + 1, tile, &first, &n);
    auto load_stage = [&](int i) {  // key tiles 2 i and 2 i + 1 of the share
      float* st = ring + (i % 2) * L::STAGE;
      load_rows<T, D>(st, kb, k_row, (t0 + first + 2 * i) * TILE, g.s);
      if (2 * i + 1 < n)
        load_rows<T, D>(st + L::TD, kb, k_row,
                        (t0 + first + 2 * i + 1) * TILE, g.s);
    };
    __syncthreads();  // the last tile is done with the shared memory
    load_rows<T, D>(qs, q + q_off, q_row, q0, g.s);
    if (n > 0) load_stage(0);
    cp_async_commit();

    // D_i = dO_i . o_i while the tiles land: the cluster's warps take
    // the rows in turn; lanes split d.  Rows past S (below the next 32)
    // get 0, as their lse does: the other kernels read them, and mask them.
    const long long st_row = static_cast<long long>(bh) * stat_stride(g.s);
    for (int rr = warp + 8 * blockIdx.z; rr < TILE; rr += 8 * gridDim.z) {
      const int i = q0 + rr;
      float acc = 0.f;
      if (i < g.s) {
        const T* orow = o + o_off + static_cast<long long>(i) * o_row;
        const T* drow = dout + o_off + static_cast<long long>(i) * o_row;
        for (int d = lane; d < DV; d += 32)
          acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) delta[st_row + i] = acc;
    }

    float m = -INFINITY, l = 0.f;  // over this lane's keys of `row`
    for (int i = 0; 2 * i < n; ++i) {
      cp_async_wait_all();
      __syncthreads();  // this stage landed; the other one is read
      if (2 * i + 2 < n) {
        load_stage(i + 1);
        cp_async_commit();
      }
      if (2 * i + team >= n) continue;  // team 1 past the share's end
      const int k0 = (t0 + first + 2 * i + team) * TILE;
      float sc[8];
      score_tile<D>(qs, ring + (i % 2) * L::STAGE + team * L::TD, sc);
      const bool full = tile_full(q0, k0, g);
      float tm = m;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float t = 0.f;
        float s = score(sc[j], g, &t);
        if (!full && !in_window(q0 + row, k0 + key + j, g.s, g.window))
          s = -INFINITY;
        sc[j] = s;
        tm = fmaxf(tm, s);
      }
      if (tm > -INFINITY) {
        l *= expf(m - tm);  // m = -inf before the first key: l is 0
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (sc[j] > -INFINITY) l += expf(sc[j] - tm);
        m = tm;
      }
    }
    cp_async_wait_all();
    // each row's 8 partial (max, sum): (team, key half, key group) in order
    const int pidx = 4 * team + 2 * (threadIdx.x % TEAM / 64) + lane / 16;
    mrg[pidx * 2 * TILE + row] = m;
    mrg[pidx * 2 * TILE + TILE + row] = l;
    __syncthreads();
    if (threadIdx.x < TILE) {
      m = mrg[threadIdx.x];
      l = mrg[TILE + threadIdx.x];
      for (int p = 1; p < 8; ++p)
        merge(m, l, mrg[p * 2 * TILE + threadIdx.x],
              mrg[p * 2 * TILE + TILE + threadIdx.x]);
    }
    if (gridDim.z > 1) {  // the cluster's blocks, in order
      if (blockIdx.z > 0 && threadIdx.x < TILE) {
        blk[threadIdx.x] = m;
        blk[TILE + threadIdx.x] = l;
      }
      sm90::cluster_sync();
      if (blockIdx.z == 0 && threadIdx.x < TILE) {
        for (int p = 1; p < static_cast<int>(gridDim.z); ++p) {
          const uint32_t other = sm90::cluster_addr(blk, p);
          merge(m, l, sm90::ld_cluster(other + 4 * threadIdx.x),
                sm90::ld_cluster(other + 4 * (TILE + threadIdx.x)));
        }
      }
      sm90::cluster_sync();
    }
    if (blockIdx.z == 0 && threadIdx.x < TILE)
      lse[st_row + q0 + threadIdx.x] =
          q0 + static_cast<int>(threadIdx.x) < g.s ? m + logf(l) : 0.f;
  }
}

// The per-step work shared by dkdv and dq, in team 0 after the teams'
// S (sc) and dP (in dps) of query rows q0 ... against keys k0 ...: this
// lane's p (masked, unrounded) and dS, the first version's arithmetic
__device__ __forceinline__ void p_ds(const float (&sc)[8], const float* dps,
                                     float lse_r, float del_r, int q0, int k0,
                                     bool full, const Geometry& g,
                                     float (&p)[8], float (&ds)[8]) {
  const int row = lane_row(), key = lane_key();
  const float4 d0 = *reinterpret_cast<const float4*>(dps + row * LDT + key);
  const float4 d1 = *reinterpret_cast<const float4*>(dps + row * LDT + key + 4);
  const float dp[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float t = 0.f;
    const float s = score(sc[j], g, &t);
    float pj = expf(s - lse_r);
    float dj = pj * (dp[j] - del_r);
    if (g.softcap > 0.f) dj *= 1.f - t * t;
    dj *= g.scale;
    if (!full && !in_window(q0 + row, k0 + key + j, g.s, g.window))
      pj = dj = 0.f;
    p[j] = pj;
    ds[j] = dj;
  }
}

// team 1's dP of its lane into the (32, 32) hand-over tile
__device__ __forceinline__ void put_row(float* tile, const float (&x)[8]) {
  float* at = tile + lane_row() * LDT + lane_key();
  *reinterpret_cast<float4*>(at) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(at + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// 2. dk and dv of 32 keys of one (batch, kv head), summed over the
// group's query heads.  A tile is (batch, kv head, 32 keys), dealt
// heaviest first (key tiles in order); a cluster's blocks walk
// consecutive shares of its (head, query tile) steps, the query tiles
// whose rows reach the keys; team 0 keeps dV, team 1 dK
template <int DQK, int DV>
struct DkdvTiles {
  static constexpr int TK = TILE * DQK;  // a Q or K tile
  static constexpr int TV = TILE * DV;   // a dO or V tile
  static constexpr int STAGE = TK + TV + 2 * TILE;  // Q, dO, lse, delta
  // K, V, the ring, and the (32, 32) tiles of p (rounded), dS and dP
  static constexpr int FLOATS = TK + TV + 2 * STAGE + 3 * TILE * LDT;
  static constexpr int BYTES = 4 * FLOATS;
};

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    cc_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, Geometry g, int tiles) {
  constexpr int D = DQK;  // Q and K; V and dO are DV wide
  using L = DkdvTiles<DQK, DV>;
  using G = Grad<D, TEAM>;       // team 1: dK
  using GV = Grad<DV, TEAM>;     // team 0: dV
  constexpr int NA = G::N > GV::N ? G::N : GV::N;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + L::TK;
  float* ring = vs + L::TV;
  float* ps = ring + 2 * L::STAGE;
  float* dss = ps + TILE * LDT;
  float* dps = dss + TILE * LDT;
  const int nk = (g.s + TILE - 1) / TILE, kvs = tiles / nk;
  const int kv_heads = g.h / g.group;
  const long long q_row = static_cast<long long>(g.h) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const long long o_row = static_cast<long long>(g.h) * DV;     // dO
  const long long v_row = static_cast<long long>(kv_heads) * DV;
  const int team = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
  const int row = lane_row(), key = lane_key();
  for (int r = 0;; ++r) {
    const int tile = dealt(blockIdx.x, r, gridDim.x, tiles);
    if (tile < 0) break;
    const int bk = tile % kvs, b = bk / kv_heads, kvh = bk % kv_heads;
    const int k0 = tile / kvs * TILE;
    // query tiles whose rows reach the keys: i in [k0, k0 + 31 + window)
    const int qt0 = k0 / TILE;
    const int nq = min(g.s - 1, k0 + TILE - 2 + g.window) / TILE - qt0 + 1;
    int first, n;
    share(g.group * nq, tile, &first, &n);
    const long long k_off = static_cast<long long>(b) * g.s * k_row + kvh * D;
    const long long v_off = static_cast<long long>(b) * g.s * v_row + kvh * DV;
    auto load_step = [&](int i) {
      float* st = ring + (i % 2) * L::STAGE;
      const int head = kvh * g.group + (first + i) / nq;
      const int q0 = (qt0 + (first + i) % nq) * TILE;
      const long long q_off =
          static_cast<long long>(b) * g.s * q_row + head * D;
      const long long o_off =
          static_cast<long long>(b) * g.s * o_row + head * DV;
      load_rows<T, D>(st, q + q_off, q_row, q0, g.s);
      load_rows<T, DV>(st + L::TK, dout + o_off, o_row, q0, g.s);
      // lse then delta of the 32 rows (the scratch holds rows up to S
      // rounded up to 64; stats zeroed those past S)
      if (threadIdx.x < 16) {
        const long long at =
            static_cast<long long>(b * g.h + head) * stat_stride(g.s) + q0;
        const float* from = threadIdx.x < 8 ? lse + at : delta + at - TILE;
        cp_async16(st + L::TK + L::TV + 4 * threadIdx.x,
                   from + 4 * threadIdx.x, 16);
      }
    };
    __syncthreads();  // the last tile is done with the shared memory
    load_rows<T, D>(ks, k + k_off, k_row, k0, g.s);
    load_rows<T, DV>(vs, v + v_off, v_row, k0, g.s);
    if (n > 0) load_step(0);
    cp_async_commit();

    float acc[NA];  // team 0: dV, team 1: dK
#pragma unroll
    for (int x = 0; x < NA; ++x) acc[x] = 0.f;
    for (int i = 0; i < n; ++i) {
      cp_async_wait_all();
      __syncthreads();  // this step's tiles landed; the last step is done
      if (i + 1 < n) {
        load_step(i + 1);
        cp_async_commit();
      }
      const float* qs = ring + (i % 2) * L::STAGE;
      const float* dos = qs + L::TK;
      const float* stat = dos + L::TV;  // lse, then delta
      const int q0 = (qt0 + (first + i) % nq) * TILE;
      // team 0: S = Q K^T, team 1: dP = dO V^T, through one call (two
      // copies of the unrolled loop side by side cost instruction fetch;
      // at MLA's pair the two products differ in depth and take two)
      float sc[8];
      if constexpr (DQK == DV)
        score_tile<D>(team == 0 ? qs : dos, team == 0 ? ks : vs, sc);
      else if (team == 0)
        score_tile<D>(qs, ks, sc);
      else
        score_tile<DV>(dos, vs, sc);
      if (team == 1) put_row(dps, sc);
      __syncthreads();  // dP is in dps
      if (team == 0) {
        float p[8], ds[8];
        p_ds(sc, dps, stat[row], stat[TILE + row], q0, k0,
             tile_full(q0, k0, g), g, p, ds);
#pragma unroll
        for (int j = 0; j < 8; ++j) p[j] = round_to<T>(p[j]);
        put_row(ps, p);
        put_row(dss, ds);
      }
      __syncthreads();  // p and dS are in ps, dss
      // team 0: dV += P^T dO, team 1: dK += dS^T Q
      if constexpr (DQK == DV)
        grad_tile<D, TEAM>(team == 0 ? ps : dss, team == 0 ? dos : qs, acc,
                           t);
      else if (team == 0)
        grad_tile<DV, TEAM>(ps, dos, prefix<GV::N>(acc), t);
      else
        grad_tile<D, TEAM>(dss, qs, prefix<G::N>(acc), t);
    }
    cp_async_wait_all();
    __syncthreads();  // the ring is free: the cluster's partials go there
    if constexpr (DQK == DV) {
      store_sum<T, D, TEAM>(acc, ring + team * TEAM * G::N,
                            (team == 0 ? dv : dk) + k_off, k_row, k0, g.s,
                            t);
    } else {  // team 0's dV partials, then team 1's dK
      float* part = ring + team * TEAM * GV::N;
      if (team == 0)
        put_part<DV, TEAM>(prefix<GV::N>(acc), part, t);
      else
        put_part<D, TEAM>(prefix<G::N>(acc), part, t);
      if (gridDim.z > 1) sm90::cluster_sync();
      if (team == 0)
        sum_part<T, DV, TEAM>(prefix<GV::N>(acc), part, dv + v_off, v_row,
                              k0, g.s, t);
      else
        sum_part<T, D, TEAM>(prefix<G::N>(acc), part, dk + k_off, k_row, k0,
                             g.s, t);
    }
    if (gridDim.z > 1) sm90::cluster_sync();  // the partials are read
  }
}

// 3. dq of 32 query rows of one (batch, head).  A tile is (batch, head,
// 32 query rows), dealt heaviest first; a cluster's blocks walk
// consecutive shares of the key tiles of its rows' windows, K and V
// through the ring
template <int DQK, int DV>
struct DqTiles {
  static constexpr int TK = TILE * DQK;  // a Q or K tile
  static constexpr int TV = TILE * DV;   // a dO or V tile
  static constexpr int STAGE = TK + TV;  // K, V
  // Q, dO, the ring, the dP and dS^T tiles, lse and delta
  static constexpr int FLOATS =
      TK + TV + 2 * STAGE + 2 * TILE * LDT + 2 * TILE;
  static constexpr int BYTES = 4 * FLOATS;
};

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    cc_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Geometry g, int tiles) {
  constexpr int D = DQK;  // Q, K and dQ; V and dO are DV wide
  using L = DqTiles<DQK, DV>;
  using G = Grad<D, THREADS>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + L::TK;
  float* ring = dos + L::TV;
  float* dps = ring + 2 * L::STAGE;
  float* dst = dps + TILE * LDT;   // dS^T: keys x rows
  float* stat = dst + TILE * LDT;  // lse, then delta
  const int nq = (g.s + TILE - 1) / TILE, heads = tiles / nq;
  const int kv_heads = g.h / g.group;
  const long long q_row = static_cast<long long>(g.h) * D;
  const long long k_row = static_cast<long long>(kv_heads) * D;
  const long long o_row = static_cast<long long>(g.h) * DV;     // dO
  const long long v_row = static_cast<long long>(kv_heads) * DV;
  const int team = threadIdx.x / TEAM;
  const int row = lane_row(), key = lane_key();
  for (int r = 0;; ++r) {
    const int tile = dealt(blockIdx.x, r, gridDim.x, tiles);
    if (tile < 0) break;
    const int bh = tile % heads, b = bh / g.h, h = bh % g.h;
    const int q0 = (nq - 1 - tile / heads) * TILE;
    const long long q_off = static_cast<long long>(b) * g.s * q_row + h * D;
    const long long o_off = static_cast<long long>(b) * g.s * o_row + h * DV;
    const long long k_off =
        static_cast<long long>(b) * g.s * k_row + (h / g.group) * D;
    const long long v_off =
        static_cast<long long>(b) * g.s * v_row + (h / g.group) * DV;
    const int t0 = max(0, q0 - g.window + 1) / TILE;
    int first, n;
    share(min(q0 + TILE - 1, g.s - 1) / TILE - t0 + 1, tile, &first, &n);
    auto load_step = [&](int i) {
      float* st = ring + (i % 2) * L::STAGE;
      const int k0 = (t0 + first + i) * TILE;
      load_rows<T, D>(st, k + k_off, k_row, k0, g.s);
      load_rows<T, DV>(st + L::TK, v + v_off, v_row, k0, g.s);
    };
    __syncthreads();  // the last tile is done with the shared memory
    load_rows<T, D>(qs, q + q_off, q_row, q0, g.s);
    load_rows<T, DV>(dos, dout + o_off, o_row, q0, g.s);
    if (threadIdx.x < 16) {
      const long long at = static_cast<long long>(bh) * stat_stride(g.s) + q0;
      const float* from = threadIdx.x < 8 ? lse + at : delta + at - TILE;
      cp_async16(stat + 4 * threadIdx.x, from + 4 * threadIdx.x, 16);
    }
    if (n > 0) load_step(0);
    cp_async_commit();

    float acc[G::N];
#pragma unroll
    for (int x = 0; x < G::N; ++x) acc[x] = 0.f;
    for (int i = 0; i < n; ++i) {
      cp_async_wait_all();
      __syncthreads();  // this step's tiles landed; the last step is done
      if (i + 1 < n) {
        load_step(i + 1);
        cp_async_commit();
      }
      const float* ks = ring + (i % 2) * L::STAGE;
      const float* vs = ks + L::TK;
      const int k0 = (t0 + first + i) * TILE;
      // team 0: S = Q K^T, team 1: dP = dO V^T, through one call (two
      // copies of the unrolled loop side by side cost instruction fetch;
      // at MLA's pair the two products differ in depth and take two)
      float sc[8];
      if constexpr (DQK == DV)
        score_tile<D>(team == 0 ? qs : dos, team == 0 ? ks : vs, sc);
      else if (team == 0)
        score_tile<D>(qs, ks, sc);
      else
        score_tile<DV>(dos, vs, sc);
      if (team == 1) put_row(dps, sc);
      __syncthreads();  // dP is in dps
      if (team == 0) {
        float p[8], ds[8];
        p_ds(sc, dps, stat[row], stat[TILE + row], q0, k0,
             tile_full(q0, k0, g), g, p, ds);
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[(key + j) * LDT + row] = ds[j];
      }
      __syncthreads();  // dS^T is in dst
      grad_tile<D, THREADS>(dst, ks, acc, threadIdx.x);  // dQ += dS K
    }
    cp_async_wait_all();
    __syncthreads();  // the ring is free: the cluster's partials go there
    store_sum<T, D, THREADS>(acc, ring, dq + q_off, q_row, q0, g.s,
                             threadIdx.x);
    if (gridDim.z > 1) sm90::cluster_sync();  // the partials are read
  }
}

// Blocks a tile's walk is split over (a cluster summed in block order):
// while `tiles`, one block each, leave SMs of the card idle, the fewest
// that fill them, rounded up to a power of two, up to 8; else 1.
inline int walk_parts(int tiles, int sms) {
  int parts = 1;
  while (parts < MAX_PARTS && parts * tiles < sms) parts *= 2;
  return parts;
}

// One launch of `kernel` over `tiles` tiles in clusters of `parts`
// blocks, as many clusters as the card holds at once (at most one a
// tile); each cluster walks the tiles `dealt` to it.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int tiles, int parts,
                            int smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = parts;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(tiles, 1, parts);
  // the clusters the card holds at once, asked once per (device, kernel,
  // parts)
  static std::mutex lock;
  static struct {
    int dev, parts, clusters;
    const void* kernel;
  } seen[64];
  static int n_seen = 0;
  int dev = 0, clusters = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  {
    std::lock_guard<std::mutex> hold(lock);
    for (int i = 0; i < n_seen && !clusters; ++i)
      if (seen[i].dev == dev && seen[i].kernel == fn && seen[i].parts == parts)
        clusters = seen[i].clusters;
    if (!clusters) {
      e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
      if (e != cudaSuccess) return e;
      if (clusters < 1) return cudaErrorInvalidConfiguration;
      if (n_seen < 64) seen[n_seen++] = {dev, parts, clusters, fn};
    }
  }
  cfg.gridDim.x = clusters < tiles ? clusters : tiles;
  e = cudaLaunchKernelEx(&cfg, kernel, args..., tiles);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

}  // namespace simt

// the CUDA-core route's three kernels at (T, DQK, DV)
template <typename T, int DQK, int DV>
int launch_t(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* delta, int batch, const Geometry& g,
             cudaStream_t stream) {
  using namespace simt;
  static const cudaError_t attr = [] {  // once per instantiation
    cudaError_t e = cudaFuncSetAttribute(
        cc_stats<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        StatsTiles<DQK>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(cc_dkdv<T, DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkdvTiles<DQK, DV>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(cc_dq<T, DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqTiles<DQK, DV>::BYTES);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = (g.s + TILE - 1) / TILE, kv = g.h / g.group;
  const int rows = walk_parts(batch * g.h * nt, sms);
  const int keys = walk_parts(batch * kv * nt, sms);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  e = launch_clusters(cc_stats<T, DQK, DV>, batch * g.h * nt, rows,
                      StatsTiles<DQK>::BYTES, stream, qt, kt,
                      static_cast<const T*>(o), dot, lse, delta, g);
  if (e == cudaSuccess)
    e = launch_clusters(cc_dkdv<T, DQK, DV>, batch * kv * nt, keys,
                        DkdvTiles<DQK, DV>::BYTES, stream, qt, kt, vt, dot,
                        static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<T*>(dk),
                        static_cast<T*>(dv), g);
  if (e == cudaSuccess)
    e = launch_clusters(cc_dq<T, DQK, DV>, batch * g.h * nt, rows,
                        DqTiles<DQK, DV>::BYTES, stream, qt, kt, vt, dot,
                        static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<T*>(dq),
                        g);
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------
// bfloat16 at D = 64, 128, 256 and MLA's (192, 128): tensor cores
// (namespace tcb)
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

template <int DQK, int DV>
__global__ void __launch_bounds__(128, 2)
    tc_stats(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const bf16* __restrict__ o, const bf16* __restrict__ dout,
             float* __restrict__ lse, float* __restrict__ delta,
             Geometry g) {
  constexpr int D = DQK;  // Q and K; o and dO are DV wide
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
  const long long o_row = static_cast<long long>(g.h) * DV;
  const long long st_row = static_cast<long long>(bh) * stat_stride(g.s);
  for (int r = warp; r < BT; r += 4) {
    const int i = q0 + r;
    if (i >= g.s) {
      if (lane == 0) delta[st_row + i] = 0.0f;
      continue;
    }
    const long long at =
        (static_cast<long long>(b) * g.s + i) * o_row + head * DV;
    float acc = 0.0f;
    for (int c = 8 * lane; c < DV; c += 256) {
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
template <int DQK, int DV>
struct DkdvSmem {
  static constexpr int T = tile_bytes<DQK>();  // a K or Q tile
  static constexpr int TV = tile_bytes<DV>();  // a V or dO tile
  // a ring stage: Q, dO, then lse and delta of its 64 rows (padded so
  // that the next stage starts on 1024 bytes)
  static constexpr int STAGE = T + TV + 1024;
  static constexpr int PC = 4 * BT * BT;
  static constexpr int BYTES = T + TV + STAGES * STAGE + PC + 64 + 1024;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(256, 1)
    tc_dkdv(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, Geometry g) {
  constexpr int D = DQK;  // K, Q and dK; V, dO and dV are DV wide
  using L = DkdvSmem<DQK, DV>;
  constexpr int T = L::T, TV = L::TV;
  // accumulators a thread: warpgroup 0's dV, warpgroup 1's dK
  constexpr int NV = DV / 2, NK = D / 2, NA = NV > NK ? NV : NK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align1024(smem_raw);
  unsigned char* sv = sk + T;
  unsigned char* ring = sv + TV;
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
    mbar_expect(bar, T + TV + 2 * 4 * BT);
    load_tile<D>(stage, &tq, head, q0, b, bar);
    load_tile<DV>(stage + T, &tdo, head, q0, b, bar);
    bulk_load(stage + T + TV, lse + at, 4 * BT, bar);
    bulk_load(stage + T + TV + 4 * BT, delta + at, 4 * BT, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      done[i] = 0;
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
    mbar_expect(kv_full, T + TV);
    load_tile<D>(sk, &tk, kvh, k0, b, kv_full);
    load_tile<DV>(sv, &tv, kvh, k0, b, kv_full);
    for (int i = 0; i < min(n, STAGES); ++i) load_step(i);
  }
  __syncthreads();
  mbar_wait(kv_full, 0);

  const int lane = tid % 32, warp = tid / 32;
  const int key0 = k0 + 16 * warp + lane / 4;  // this lane's first key
  const int col = 2 * (lane % 4);
  // dV's rows (warpgroup 0) are DV wide, dK's (warpgroup 1) D
  const int out_d = wg == 0 ? DV : D;
  const long long kv_row = static_cast<long long>(kv_heads) * out_d;
  bf16* const out_base = (wg == 0 ? dv : dk) +
                         static_cast<long long>(b) * g.s * kv_row +
                         kvh * out_d;
  float acc[NA];
#pragma unroll
  for (int x = 0; x < NA; ++x) acc[x] = 0.0f;
  float sc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) sc[x] = 0.0f;
  uint32_t frag[4][4];

  if (wg == 0) {
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const unsigned char* stage = ring + st * L::STAGE;
      const float* lse_s = reinterpret_cast<const float*>(stage + T + TV);
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
      product_rs<DV>(prefix<NV>(acc), frag, stage + T, 0);  // dV += P^T dO
      release<3>(done, st, i + STAGES < n, [&] { load_step(i + STAGES); });
    }
  } else {
    if (n > 0) bar_arrive<2, 256>();  // pc starts free
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const unsigned char* stage = ring + st * L::STAGE;
      const float* delta_s =
          reinterpret_cast<const float*>(stage + T + TV + 4 * BT);
      mbar_wait(&full[st], (i / STAGES) & 1);
      product_ss<DV>(sc, sv, stage + T);  // dP^T = V dO^T
      bar_sync<1, 256>();                // pc is ready
#pragma unroll
      for (int x = 0; x < 32; ++x)
        sc[x] = pc[x * 128 + tid] * (sc[x] - delta_s[col + acc_col(x)]);
      if (i + 1 < n) bar_arrive<2, 256>();  // pc is free
      pack_frags(sc, frag);                 // dS^T rounded to bf16
      product_rs<D>(prefix<NK>(acc), frag, stage, 0);  // dK += dS^T Q
      release<4>(done, st, i + STAGES < n, [&] { load_step(i + STAGES); });
    }
  }
  if (gridDim.z > 1) {
    // the cluster's partial sums, in order: block 1 leaves its
    // accumulators in its ring (no load is in flight once both
    // warpgroups are done), block 0 adds them to its own and stores
    // (warpgroup 1's after warpgroup 0's NV; x < NA past a warpgroup's
    // own accumulators is skipped at MLA's pair)
    __syncthreads();
    const int nw = wg == 0 ? NV : NK;
    float* part = reinterpret_cast<float*>(ring) + wg * NV * 128;
    if (blockIdx.z == 1) {
#pragma unroll
      for (int x = 0; x < NA; ++x)
        if (NV == NK || x < nw) part[x * 128 + tid] = acc[x];
    }
    cluster_sync();
    if (blockIdx.z == 0) {
      const uint32_t other = cluster_addr(part, 1);
#pragma unroll
      for (int x = 0; x < NA; ++x)
        if (NV == NK || x < nw) acc[x] += ld_cluster(other + 4 * (x * 128 + tid));
    }
    cluster_sync();  // block 1's shared memory stays until it is read
    if (blockIdx.z != 0) return;
  }
  if constexpr (DQK == DV)
    store_rows<D>(acc, out_base, kv_row, k0, 0, g.s);
  else if (wg == 0)
    store_rows<DV>(prefix<NV>(acc), out_base, kv_row, k0, 0, g.s);
  else
    store_rows<D>(prefix<NK>(acc), out_base, kv_row, k0, 0, g.s);
}

// 3. dq of 64 query rows of one (batch, head), over the key tiles of the
// rows' windows, K and V through a 2-stage TMA ring.  Warpgroup 0: S =
// Q K^T and P, handing P D^-0.5 (1 - t^2) to warpgroup 1 (`pc`);
// warpgroup 1: dP = dO V^T and dS, handing dS's bf16 fragments back
// (`dsf`).  dQ += dS K is split by columns, DV / 2 to warpgroup 0 and
// the rest to warpgroup 1, so that both run as many products (S is D
// deep, dP DV; at D = DV, D / 2 each; at MLA's (192, 128) 64 and 128,
// whole 64-column atoms: an MN-major operand cannot start inside a
// swizzle atom, so no n96 split at column 96).  At DV = 64 warpgroup 1
// takes all of it: half an atom is no wgmma operand.
template <int DQK, int DV>
struct DqSmem {
  static constexpr int T = tile_bytes<DQK>();  // a Q or K tile
  static constexpr int TV = tile_bytes<DV>();  // a dO or V tile
  static constexpr int STAGE = T + TV;  // K, then V
  static constexpr int PC = 4 * BT * BT;
  static constexpr int DSF = 4 * 16 * 128;
  static constexpr int BYTES = T + TV + STAGES * STAGE + PC + DSF + 64 + 1024;
  static constexpr int D0 = DV >= 128 ? DV / 2 : 0;  // warpgroup 0's columns
  static constexpr int D1 = DQK - D0;                // warpgroup 1's
  static_assert(D0 % ATOM == 0 && D1 % ATOM == 0, "whole atoms");
};

template <int DQK, int DV>
__global__ void __launch_bounds__(256, 1)
    tc_dq(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, Geometry g) {
  constexpr int D = DQK;  // Q, K and dQ; dO and V are DV wide
  using L = DqSmem<DQK, DV>;
  constexpr int T = L::T, TV = L::TV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align1024(smem_raw);
  unsigned char* sdo = sq + T;
  unsigned char* ring = sdo + TV;
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
    mbar_expect(bar, T + TV);
    load_tile<D>(stage, &tk, kvh, (t0 + i) * BT, b, bar);
    load_tile<DV>(stage + T, &tv, kvh, (t0 + i) * BT, b, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      done[i] = 0;
    }
    mbar_init(qd_full, 1);
    mbar_fence_init();
    mbar_expect(qd_full, T + TV);
    load_tile<D>(sq, &tq, head, q0, b, qd_full);
    load_tile<DV>(sdo, &tdo, head, q0, b, qd_full);
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
    constexpr int N0 = L::D0 > 0 ? L::D0 : 8;  // (unused at DV = 64)
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
      product_ss<DV>(sc, sdo, stage + T);  // dP = dO V^T
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

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int batch, const Geometry& g, cudaStream_t stream) {
  static const cudaError_t attr = [] {  // once per head-dim pair
    cudaError_t e = cudaFuncSetAttribute(
        tc_stats<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        stats_bytes<DQK>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tc_dkdv<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkdvSmem<DQK, DV>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tc_dq<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqSmem<DQK, DV>::BYTES);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int kv = g.h / g.group;
  const long long qs = static_cast<long long>(g.h) * DQK;  // a q row
  const long long os = static_cast<long long>(g.h) * DV;   // a dO row
  const long long ks = static_cast<long long>(kv) * DQK;   // a k row
  const long long vs = static_cast<long long>(kv) * DV;    // a v row
  CUtensorMap tq, tk, tv, tdo;
  int err = tensor_map_4d(&tq, q, qs * g.s, qs, DQK, batch, g.s, g.h, DQK, BT);
  if (!err)
    err = tensor_map_4d(&tdo, dout, os * g.s, os, DV, batch, g.s, g.h, DV, BT);
  if (!err)
    err = tensor_map_4d(&tk, k, ks * g.s, ks, DQK, batch, g.s, kv, DQK, BT);
  if (!err)
    err = tensor_map_4d(&tv, v, vs * g.s, vs, DV, batch, g.s, kv, DV, BT);
  if (err) return err;
  const int tiles = (g.s + BT - 1) / BT;
  tc_stats<DQK, DV>
      <<<dim3(batch * g.h, tiles), 128, stats_bytes<DQK>(), stream>>>(
          tq, tk, static_cast<const bf16*>(o),
          static_cast<const bf16*>(dout), lse, delta, g);
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
  cfg.dynamicSmemBytes = DkdvSmem<DQK, DV>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = parts;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tc_dkdv<DQK, DV>, tq, tk, tv, tdo,
                         static_cast<const float*>(lse),
                         static_cast<const float*>(delta),
                         static_cast<bf16*>(dk), static_cast<bf16*>(dv), g);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tc_dq<DQK, DV><<<dim3(batch * g.h, tiles), 256, DqSmem<DQK, DV>::BYTES,
                   stream>>>(tq, tk, tv, tdo, lse, delta,
                             static_cast<bf16*>(dq), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tcb

// the CUDA-core route in float32, at every head-dim pair
int launch_f32(int d, int dv, const void* q, const void* k, const void* v,
               const void* o, const void* dout, void* dq, void* dk,
               void* dvo, float* lse, float* delta, int batch,
               const Geometry& g, cudaStream_t stream) {
  if (d == 192 && dv == 128)
    return launch_t<float, 192, 128>(q, k, v, o, dout, dq, dk, dvo, lse,
                                     delta, batch, g, stream);
  if (d != dv) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16:
      return launch_t<float, 16, 16>(q, k, v, o, dout, dq, dk, dvo, lse,
                                     delta, batch, g, stream);
    case 64:
      return launch_t<float, 64, 64>(q, k, v, o, dout, dq, dk, dvo, lse,
                                     delta, batch, g, stream);
    case 128:
      return launch_t<float, 128, 128>(q, k, v, o, dout, dq, dk, dvo, lse,
                                       delta, batch, g, stream);
    case 256:
      return launch_t<float, 256, 256>(q, k, v, o, dout, dq, dk, dvo, lse,
                                       delta, batch, g, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq: (batch, s, h, d or dv) contiguous; k, v, dk, dv:
// (batch, s, h / group, d or dv) contiguous (q, k, dq, dk d wide; v, o,
// dout, dv dv wide); lse, delta: float scratch of batch * h * (s rounded
// up to 64) each, on 16 bytes.
// The route: bf16 at (d, dv) = (64, 64), (128, 128), (256, 256) and
// (192, 128) takes the tensor-core kernels, float32 at those pairs and
// (16, 16), and bf16 at (16, 16), the CUDA-core ones (another pair is
// refused).  Launches the route's three kernels on `stream`; returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int local_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int batch, int s, int h, int group, int d, int dvw, int window,
    float scale, float softcap, int bf16, void* stream) {
  const Geometry g{s, h, group, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (d == 192 && dvw == 128)
      return tcb::launch<192, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                   batch, g, st);
    if (d != dvw) return static_cast<int>(cudaErrorInvalidValue);
    switch (d) {
      case 64:
        return tcb::launch<64, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                   batch, g, st);
      case 128:
        return tcb::launch<128, 128>(q, k, v, o, dout, dq, dk, dv, lse,
                                     delta, batch, g, st);
      case 256:
        return tcb::launch<256, 256>(q, k, v, o, dout, dq, dk, dv, lse,
                                     delta, batch, g, st);
      case 16:
        return launch_t<__nv_bfloat16, 16, 16>(q, k, v, o, dout, dq, dk, dv,
                                               lse, delta, batch, g, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch_f32(d, dvw, q, k, v, o, dout, dq, dk, dv, lse, delta, batch,
                    g, st);
}
