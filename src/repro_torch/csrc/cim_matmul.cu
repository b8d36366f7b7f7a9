// Domino CIM crossbar matmul for Hopper (sm_90a): w8a8 subarray dots on
// the int8 tensor cores, the per-subarray SAR ADC, and the digital code
// sum.
//
// Replaces src/repro/kernels/cim_matmul.py::_cim_kernel (nominal ADC)
// and ::_cim_kernel_var (per-subarray ADC variation), both reached
// through the pallas_call at :154.
//
//   codes[r, n] = sum_t clip(rint(f32(sum_{k<kc_t} x[t, r, k] * w[t, k, n])
//                                 * inv_t [+ off_t]), lo, hi)
//   out = codes            (emit_codes)
//   out = f32(codes) * step (otherwise)
//
// Step t is one subarray.  The conversion is the reference's arithmetic
// op for op: __int2float_rn (numpy's astype(float32)), __fmul_rn, then
// __fadd_rn as a separately rounded add (never an FMA; the build also
// passes -fmad=false), rintf (round half to even), and a clamp.  Codes
// are integers summed exactly in int32, so the sum may be split across
// blocks and added in any order without changing a bit; the wrapper
// keeps T * (q_max + 1) <= 2^24 so the float32 output holds them.
//
// What bounds it on the H100.  Bytes: x and w read once, the float32
// output written once, against 3.35 TB/s; int8 operations 2*T*R*kc*N at
// 1,979 TOP/s are 10x to 1000x below that on the main path's calls
// (vgg11-cifar10: R <= 4096, N <= 512, kc <= 256, 1 to 18 steps, 4 KB
// to 2.8 MB a call, 0.001 to 0.83 us of bound).  So a call is bound by
// latency: how many blocks are in flight, and how long the chain of
// dependent loads, products, barriers and stores that each block walks
// is.
//
// The design:
//  1. The dot on int8 tensor cores: wgmma m64nBRk32 .s32.s8.s8, both
//     operands K-major (integer wgmma takes no MN-major operand) in the
//     128-byte swizzle.  The operands are swapped: a block's 64 weight
//     columns are wgmma's M and its BR x rows (8, 16 or 32) its N,
//     so the small row counts (4 on the FC tiles, 16 on the deepest
//     convs) waste no 64-row MMA tile; the epilogue writes the tile
//     transposed.  wgmma rather than mma.sync: the operands stay in
//     shared memory (no ldmatrix, no fragment registers), and one
//     instruction covers a block's whole 64 x BR x 32 product.  A step
//     never shares a K tile with another: each step's depth is padded
//     with zeros to whole 128-byte atoms (four k32 products, always
//     issued: a product skipped by a branch made ptxas serialize them),
//     and zero rows add nothing to an exact integer dot.  After a step's
//     last atom its accumulators are converted in registers and added
//     into int32 code registers; the next step's first product
//     overwrites them (scale-d = 0).
//  2. A grid that fills the card: (column tiles of 64, row tiles of BR,
//     step slices).  The wrapper picks BR and the number of slices S
//     (kernels/cim_matmul.py::launch_plan, mirrored and checked on the
//     CPU by tests/test_torch_cim_split.py): the main path's conv calls
//     launch 48 to 384 blocks (8 to 64 before the split).  The S blocks
//     of one output tile form a thread-block cluster along the step axis
//     (S <= 8, the portable size); block z walks steps [z T / S,
//     (z + 1) T / S), which may be empty.  Block z also owns 1/S of the
//     tile: every block pushes each 4-column group of its partial codes
//     into the owner's receive slot (remote stores into distributed
//     shared memory, which nobody waits on), one cluster barrier makes
//     them visible, and each owner sums its S slots, converts and
//     stores (16 bytes a thread).  One launch, no workspace; the sum is
//     exact, so no split changes the result.  (Pulling the partials
//     with remote loads instead, and a second barrier, cost about 2 us
//     more a call in development runs on the card.)
//  3. Asynchronous, wide copies: each block walks its (step, 128-byte
//     atom) chunks in rounds through a ring of two rounds; a slice that
//     fits the ring loads in one round.  Rows whose base and strides
//     are 16-byte aligned arrive by cp.async, 16 bytes a thread, with
//     src-size zero-filling past the step's depth and past R and N;
//     the next round's copies are in flight while this round's products
//     run, and one wait, proxy fence and barrier cover a whole round.
//     Each thread forms its row addresses once.  An operand that is not
//     aligned (kc = 9 on the first conv, odd depths, odd FC slices) is
//     staged byte by byte into the same swizzled layout (all of a
//     thread's loads first, then its stores) and feeds the same
//     products.
//  4. Weights arrive K-major: the engine stores each conv layer's tiles
//     as a (T, N, kc padded to 16) tensor and each FC layer's as (N, K),
//     so every weight row read is contiguous along depth.
//
// Layout: x[t, r, k] at x + t*sxt + r*sxr + k and w[t, k, n] at
// w + t*swt + n*swn + k (unit stride along k for both).  Step t holds
// min(kc, k_total - t*kc) valid depth rows; rows past it read as zero,
// which pads a ragged last subarray in the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;    // one warpgroup
constexpr int BN = 64;          // weight columns per block: wgmma's M
constexpr int ATOM = 128;       // depth bytes per chunk: four k32 products
constexpr int MAX_SLICES = 8;   // blocks per cluster (portable size)
constexpr int LDP = BN + 4;     // row stride of the partial codes (int32):
                                // the fragment stores hit 32 banks

__host__ __device__ constexpr int chunk_bytes(int br) {
  return (BN + br) * ATOM;
}
// chunks per round: about 40 KB of copies in flight
__host__ __device__ constexpr int round_chunks(int br) {
  return 40960 / chunk_bytes(br) > 1 ? 40960 / chunk_bytes(br) : 1;
}
__host__ __device__ constexpr int ring_bytes(int br) {
  return 2 * round_chunks(br) * chunk_bytes(br);
}
// what the cluster's other blocks push: S slots of at most
// ceil(G / S) 4-column groups, G = BR * 64 / 4
__host__ __device__ constexpr int recv_bytes(int br) {
  return (br * BN / 4 + MAX_SLICES) * 16;
}
// the ring, the receive slots, and 1024 bytes of slack to put the ring
// on a 1024-byte boundary (about 80 KB: two blocks an SM)
__host__ __device__ constexpr int smem_bytes(int br) {
  return ring_bytes(br) + recv_bytes(br) + 1024;
}

struct Args {
  const int8_t* x;
  long long sxt, sxr;
  const int8_t* w;
  long long swt, swn;
  const float* adc;  // (T, 2) [inverse step, offset], or null
  float inv, lo, hi, step;
  float* out;
  int t, r, n, kc;
  long long k_total;
  int emit_codes;
  int x_vec, w_vec;  // the operand's rows are 16-byte aligned: cp.async
  int slices;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, the first `bytes` from src and zeros after
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// this thread's shared-memory writes, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// This thread's share of copying 128-byte depth atoms of rows [row0,
// row0 + ROWS) of a K-major operand (row i at base + i * stride) into a
// (ROWS, 128) tile: rows of 128 bytes whose 16-byte chunks are
// XOR-swizzled by row % 8, the layout wgmma's 128-byte swizzle reads.
// The thread copies chunk c = threadIdx.x % 8 of rows (threadIdx.x +
// THREADS i) / 8; their addresses are formed once per block.  Rows at or
// past n_rows, and bytes at or past the step's depth, land as zeros.
template <int ROWS>
struct AtomCopy {
  static constexpr int N = (ROWS * 8 + THREADS - 1) / THREADS;
  const int8_t* base;
  const int8_t* src[N];  // the row's chunk c, or null past the edge
  int dst[N];            // the chunk's byte offset in the tile, or -1

  __device__ __forceinline__ AtomCopy(const int8_t* b, long long stride,
                                      int row0, int n_rows)
      : base(b) {
    const int c = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = threadIdx.x + THREADS * i, row = p >> 3;
      src[i] = p < ROWS * 8 && row0 + row < n_rows
                   ? b + (long long)(row0 + row) * stride + 16 * c
                   : nullptr;
      dst[i] = p < ROWS * 8 ? row * 128 + ((c ^ (row & 7)) << 4) : -1;
    }
  }

  // the atom at element offset `off` of each row (step and depth) into
  // `tile`; this thread's chunks hold `bytes` valid bytes (0 to 16).
  // vec: cp.async, 16 bytes, zero-filled past `bytes`; otherwise staged
  // byte by byte (rows or strides not 16-byte aligned)
  __device__ __forceinline__ void copy(unsigned char* tile, long long off,
                                       int bytes, bool vec) const {
    if (vec) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (dst[i] < 0) continue;
        const int n = src[i] != nullptr ? bytes : 0;
        cp_async16(tile + dst[i], n > 0 ? src[i] + off : base, n);
      }
      return;
    }
    // every byte load first, then the stores: the loads of all chunks
    // are in flight together
    uint32_t v[N][4];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int n = dst[i] >= 0 && src[i] != nullptr ? bytes : 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[i][q] = 0u;
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (b < n)
          v[i][b >> 2] |=
              static_cast<uint32_t>(static_cast<uint8_t>(src[i][off + b]))
              << (8 * (b & 3));
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (dst[i] >= 0)
        *reinterpret_cast<uint4*>(tile + dst[i]) =
            make_uint4(v[i][0], v[i][1], v[i][2], v[i][3]);
  }
};

// wgmma matrix descriptor of a K-major operand in the 128-byte swizzle:
// start address, 1024 bytes between 8-row groups (16-byte units)
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// v into the same shared-memory address in cluster block `rank`
__device__ __forceinline__ void st_cluster(void* p, int rank, int4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile(
      "st.shared::cluster.v4.s32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
      : "memory");
}
// the cluster barrier in two halves: release this thread's writes,
// acquire everyone's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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
__device__ __forceinline__ void keep(int& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// d (64 x BR, int32) (+)= a (64 x 32, K-major, shared) b (BR x 32,
// K-major, shared); accumulate = 0 overwrites d
#define R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define R8(i) R4(i), R4(i + 4)
#define R16(i) R8(i), R8(i + 8)

template <int BR>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(int (&d)[4], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p;\n}\n"
        : R4(0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(int (&d)[8], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        : R8(0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(int (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : R16(0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

#undef R16
#undef R8
#undef R4

// One block: weight columns [64 bx, 64 bx + 64) by x rows [BR by, BR by +
// BR) over the steps of slice bz, one warpgroup.  Its accumulators
// follow wgmma's m64nBR layout: lane 4 g + q of warp v holds weight
// columns 16 v + g and 16 v + g + 8 and, in each 8-row block i of x,
// rows 8 i + 2 q and 8 i + 2 q + 1 (registers 4 i .. 4 i + 3).
template <bool kVar, int BR>
__global__ void __launch_bounds__(THREADS)
    cim_codes_kernel(const __grid_constant__ Args g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * BR;
  const int t0 = static_cast<int>((long long)blockIdx.z * g.t / g.slices);
  const int t1 =
      static_cast<int>((long long)(blockIdx.z + 1) * g.t / g.slices);
  const int atoms = max(1, (g.kc + ATOM - 1) / ATOM);
  const int chunks = (t1 - t0) * atoms;

  // chunk c = (step t0 + c / atoms, atom c % atoms) lands in slot c % (2 H)
  // of the ring.  Rounds of H chunks; a slice of at most 2 H chunks
  // loads in one round
  constexpr int H = round_chunks(BR);
  const int per_round = chunks <= 2 * H ? 2 * H : H;
  auto depth_of = [&](int t) {
    const long long rem = g.k_total - (long long)t * g.kc;
    return rem < g.kc ? static_cast<int>(rem) : g.kc;
  };
  const AtomCopy<BN> w_copy(g.w, g.swn, n0, g.n);
  const AtomCopy<BR> x_copy(g.x, g.sxr, r0, g.r);
  auto load_round = [&](int k) {
    for (int c = k * per_round; c < chunks && c < (k + 1) * per_round;
         ++c) {
      const int t = t0 + c / atoms, k0 = (c % atoms) * ATOM;
      const int bytes =
          max(0, min(16, depth_of(t) - k0 - 16 * (int)(threadIdx.x & 7)));
      unsigned char* st = ring + (c % (2 * H)) * chunk_bytes(BR);
      w_copy.copy(st, t * g.swt + k0, bytes, g.w_vec);
      x_copy.copy(st + BN * ATOM, t * g.sxt + k0, bytes, g.x_vec);
    }
  };
  load_round(0);

  int acc[BR / 2], codes[BR / 2];
#pragma unroll
  for (int j = 0; j < BR / 2; ++j) acc[j] = codes[j] = 0;

  for (int k = 0; k * per_round < chunks; ++k) {
    // round k landed (the only copies in flight)
    cp_async_wait_all();
    fence_async_shared();
    // everyone's copies, and everyone done with round k - 1, whose slots
    // round k + 1 refills
    __syncthreads();
    load_round(k + 1);
    for (int c = k * per_round; c < chunks && c < (k + 1) * per_round;
         ++c) {
      const unsigned char* st = ring + (c % (2 * H)) * chunk_bytes(BR);
      const int a = c % atoms;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < ATOM / 32; ++ks)
        Mma<BR>::run(acc, desc(st + ks * 32), desc(st + BN * ATOM + ks * 32),
                     a > 0 || ks > 0);
      wgmma_commit();
      if (a == atoms - 1) {
        // the SAR ADC of subarray t (the table's row of the global
        // step), then the digital code sum
        wgmma_wait();
#pragma unroll
        for (int j = 0; j < BR / 2; ++j) keep(acc[j]);
        const int t = t0 + c / atoms;
        const float s_inv = kVar ? __ldg(g.adc + 2 * t) : g.inv;
        const float s_off = kVar ? __ldg(g.adc + 2 * t + 1) : 0.0f;
#pragma unroll
        for (int j = 0; j < BR / 2; ++j) {
          float f = __fmul_rn(__int2float_rn(acc[j]), s_inv);
          if (kVar) f = __fadd_rn(f, s_off);
          f = fminf(fmaxf(rintf(f), g.lo), g.hi);
          // f is an integer of magnitude below 2^22: adding 1.5 * 2^23
          // puts it in the low mantissa bits, exactly (an add, not a
          // float-to-int conversion)
          codes[j] += __float_as_int(__fadd_rn(f, 12582912.0f)) - 0x4B400000;
        }
      }
    }
    wgmma_wait();  // the round's slots are read
  }
  __syncthreads();

  // this block's partial codes, (BR, LDP) int32 over the idle ring
  int* part = reinterpret_cast<int*>(ring);
  const int v = threadIdx.x / 32, g8 = threadIdx.x % 32 / 4,
            q = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < BR / 2; ++j) {
    const int r = 8 * (j / 4) + 2 * q + (j & 1);
    const int n = 16 * v + g8 + 8 * ((j >> 1) & 1);
    part[r * LDP + n] = codes[j];
  }

  __syncthreads();
  constexpr int G = BR * BN / 4;  // 4-column groups of the tile
  auto group_off = [](int idx) {
    return (idx / (BN / 4)) * LDP + (idx % (BN / 4)) * 4;
  };
  auto store = [&](int idx, int4 c) {
    const int r = r0 + idx / (BN / 4), n = n0 + (idx % (BN / 4)) * 4;
    if (r >= g.r) return;
    float f[4] = {__int2float_rn(c.x), __int2float_rn(c.y),
                  __int2float_rn(c.z), __int2float_rn(c.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (!g.emit_codes) f[i] = __fmul_rn(f[i], g.step);
    float* o = g.out + (long long)r * g.n + n;
    if (g.n % 4 == 0 && n + 3 < g.n) {
      *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < g.n) o[i] = f[i];
    }
  };
  const int s = g.slices;
  if (s == 1) {
    for (int idx = threadIdx.x; idx < G; idx += THREADS)
      store(idx, *reinterpret_cast<const int4*>(part + group_off(idx)));
    return;
  }
  // The cluster's S partials summed.  Block rank z owns groups
  // [z G / S, (z + 1) G / S); every block pushes each of its partial
  // groups into its owner's receive slot for it (remote stores through
  // distributed shared memory, which nobody waits on), one cluster
  // barrier makes them visible, and each owner sums its S slots.  After
  // the barrier no block touches another's shared memory.
  const int rank = blockIdx.z;  // the cluster spans the step axis alone
  const int cap = (G + s - 1) / s;
  int4* recv = reinterpret_cast<int4*>(ring + ring_bytes(BR));
  for (int idx = threadIdx.x; idx < G; idx += THREADS) {
    const int owner = ((idx + 1) * s - 1) / G;
    st_cluster(recv + rank * cap + idx - owner * G / s, owner,
               *reinterpret_cast<const int4*>(part + group_off(idx)));
  }
  cluster_arrive();
  cluster_wait();
  const int g0 = rank * G / s, g1 = (rank + 1) * G / s;
  for (int idx = g0 + threadIdx.x; idx < g1; idx += THREADS) {
    int4 sum = make_int4(0, 0, 0, 0);
    for (int z = 0; z < s; ++z) {
      const int4 p = recv[z * cap + idx - g0];
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    store(idx, sum);
  }
}

template <bool kVar, int BR>
int launch(const Args& g, cudaStream_t stream) {
  auto kernel = cim_codes_kernel<kVar, BR>;
  static cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BR));
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.n + BN - 1) / BN, (g.r + BR - 1) / BR, g.slices);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(BR);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = g.slices;
  cfg.attrs = attr;
  cfg.numAttrs = g.slices > 1 ? 1 : 0;  // one slice: no cluster
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVar>
int launch_rows(const Args& g, int rows, cudaStream_t stream) {
  switch (rows) {
    case 8: return launch<kVar, 8>(g, stream);
    case 16: return launch<kVar, 16>(g, stream);
    case 32: return launch<kVar, 32>(g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point for ctypes.  `adc` is a (T, 2) float32 table of
// [inverse step, offset] per step, or null for the nominal variant.
// `rows` (8, 16 or 32) x rows and 64 weight columns per block,
// `slices` (1 to 8) blocks per cluster along the step axis; `x_vec` /
// `w_vec` say that the operand's base and strides are 16-byte aligned.
// Returns the launch's CUDA error (0 on success).
extern "C" int cim_codes_launch(const void* x, long long sxt, long long sxr,
                                int x_vec, const void* w, long long swt,
                                long long swn, int w_vec, const void* adc,
                                float inv, float lo, float hi, float step,
                                void* out, int T, int R, int N, int kc,
                                long long k_total, int emit_codes, int rows,
                                int slices, void* stream) {
  if (slices < 1 || slices > MAX_SLICES)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  g.x = static_cast<const int8_t*>(x);
  g.sxt = sxt;
  g.sxr = sxr;
  g.w = static_cast<const int8_t*>(w);
  g.swt = swt;
  g.swn = swn;
  g.adc = static_cast<const float*>(adc);
  g.inv = inv;
  g.lo = lo;
  g.hi = hi;
  g.step = step;
  g.out = static_cast<float*>(out);
  g.t = T;
  g.r = R;
  g.n = N;
  g.kc = kc;
  g.k_total = k_total;
  g.emit_codes = emit_codes;
  g.x_vec = x_vec;
  g.w_vec = w_vec;
  g.slices = slices;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return adc != nullptr ? launch_rows<true>(g, rows, s)
                        : launch_rows<false>(g, rows, s);
}
