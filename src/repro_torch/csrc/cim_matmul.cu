// Domino CIM crossbar matmul for Hopper (sm_90a): w8a8 subarray dots,
// the per-subarray SAR ADC, and the digital code sum.
//
// Replaces src/repro/kernels/cim_matmul.py::_cim_kernel (nominal ADC)
// and ::_cim_kernel_var (per-subarray ADC variation).
//
//   codes[r, n] = sum_t clip(rint(f32(sum_{k<kc} x[t, r, k] * w[t, k, n])
//                                 * inv_t [+ off_t]), lo, hi)
//   out = codes            (emit_codes)
//   out = f32(codes) * step (otherwise)
//
// Step t is one subarray.  On the TPU the K grid axis runs in order and
// the output block carries the code sum from one step to the next; on
// Hopper blocks run in no order, so each block owns a BM x BN output
// tile and walks every step t itself, keeping the code sum in
// registers.  The dot of a step is exact in int32 (__dp4a over packed
// bytes); the conversion is the reference's arithmetic op for op:
// __int2float_rn (numpy's astype(float32)), __fmul_rn, then __fadd_rn as
// a separately rounded add (never an FMA; the build also passes
// -fmad=false), rintf (round half to even, never roundf), and a clamp.
// Codes are integers, summed exactly in int32; the wrapper keeps
// T * (q_max + 1) <= 2^24 so the float32 output holds them exactly.
//
// Bound on the H100: int8 operations 2*T*R*kc*N against 1,979 TOP/s and
// bytes x + w + out against 3.35 TB/s.  The main path's shapes are small
// (R <= 4096, N <= 512, kc <= 256), so most calls are bound by bytes and
// launch latency, not operations.  This first version is simple: byte
// loads staged through shared memory and __dp4a on the CUDA cores, no
// tensor cores (wgmma), TMA or pipelining.  Those belong to a later
// change that makes it fast.
//
// Layout: x[t, r, k] at x + t*sxt + r*sxr + k and w[t, k, n] at
// w + t*swt + k*swk + n (unit stride along k for x and along n for w).
// Step t holds min(kc, k_total - t*kc) valid rows of depth; rows past
// it read as zero, which pads a ragged last subarray in the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // depth bytes staged per shared-memory pass
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int KW = BK / 4;    // packed 32-bit words per staged row

template <bool kVar>
__global__ void __launch_bounds__(THREADS) cim_codes_kernel(
    const int8_t* __restrict__ x, long long sxt, long long sxr,
    const int8_t* __restrict__ w, long long swt, long long swk,
    const float* __restrict__ adc, float inv, float lo, float hi,
    float step, float* __restrict__ out, int T, int R, int N, int kc,
    long long k_total, int emit_codes) {
  // +1 word of padding keeps the column reads of ws free of bank
  // conflicts
  __shared__ int xs[BM][KW + 1];
  __shared__ int ws[BN][KW + 1];
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const int r0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int codes[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) codes[i][j] = 0;

  for (int t = 0; t < T; ++t) {
    const long long rem = k_total - (long long)t * kc;
    const int depth = rem < kc ? (int)rem : kc;
    const int8_t* xt = x + t * sxt;
    const int8_t* wt = w + t * swt;
    int acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < depth; k0 += BK) {
      // x rows: 4 consecutive depth bytes packed per word
      for (int idx = threadIdx.x; idx < BM * KW; idx += THREADS) {
        const int row = idx / KW, q = idx % KW;
        const int r = r0 + row;
        unsigned packed = 0;
        if (r < R) {
          const int8_t* p = xt + (long long)r * sxr;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int k = k0 + 4 * q + b;
            if (k < depth) packed |= (unsigned)(uint8_t)p[k] << (8 * b);
          }
        }
        xs[row][q] = (int)packed;
      }
      // w columns, transposed so that 4 consecutive depth bytes of one
      // column pack into one word; neighbouring threads read
      // neighbouring columns
      for (int idx = threadIdx.x; idx < BN * KW; idx += THREADS) {
        const int col = idx % BN, q = idx / BN;
        const int n = n0 + col;
        unsigned packed = 0;
        if (n < N) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int k = k0 + 4 * q + b;
            if (k < depth)
              packed |= (unsigned)(uint8_t)wt[(long long)k * swk + n]
                        << (8 * b);
          }
        }
        ws[col][q] = (int)packed;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < KW; ++q) {
        int a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[ty + i * (BM / TM)][q];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[tx + j * (BN / TN)][q];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // the SAR ADC of subarray t, then the digital code sum
    const float s_inv = kVar ? adc[2 * t] : inv;
    const float s_off = kVar ? adc[2 * t + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float f = __fmul_rn(__int2float_rn(acc[i][j]), s_inv);
        if (kVar) f = __fadd_rn(f, s_off);
        f = fminf(fmaxf(rintf(f), lo), hi);
        codes[i][j] += __float2int_rn(f);
      }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + i * (BM / TM);
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * (BN / TN);
      if (n >= N) continue;
      const float c = __int2float_rn(codes[i][j]);
      out[(long long)r * N + n] = emit_codes ? c : __fmul_rn(c, step);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  `adc` is a (T, 2) float32 table of
// [inverse step, offset] per step, or null for the nominal variant.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cim_codes_launch(const void* x, long long sxt, long long sxr,
                                const void* w, long long swt, long long swk,
                                const void* adc, float inv, float lo,
                                float hi, float step, void* out, int T, int R,
                                int N, int kc, long long k_total,
                                int emit_codes, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (R + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  float* op = static_cast<float*>(out);
  if (adc != nullptr) {
    cim_codes_kernel<true><<<grid, THREADS, 0, s>>>(
        xp, sxt, sxr, wp, swt, swk, static_cast<const float*>(adc), inv, lo,
        hi, step, op, T, R, N, kc, k_total, emit_codes);
  } else {
    cim_codes_kernel<false><<<grid, THREADS, 0, s>>>(
        xp, sxt, sxr, wp, swt, swk, nullptr, inv, lo, hi, step, op, T, R, N,
        kc, k_total, emit_codes);
  }
  return static_cast<int>(cudaGetLastError());
}
