// fp32 body of the grouped GEMM gmm.cu for Hopper (sm_90a): a
// register-blocked SGEMM fed through a ring of cp.async copies in shared
// memory.
//
// y[e, m, n] = sum_k x[e, m, k] * w[e, k, n], fp32 in, fp32 sums, fp32 out.
//
// Replaces, for fp32 calls, the TPU kernel src/repro/kernels/gmm.py::gmm
// (body _gmm_kernel). Its callers are the dropless fragment's GMM tiles
// (core/executor.py: E = 1, an expert's routed rows, granite's widths):
// GMM1 and GMM2 (x·W), their activation gradients (dy·Wᵀ, w a transposed
// view) and their weight gradients (xᵀ·dy, x a transposed view).
//
// What bounds it: the fp32 operations. GMM1 at C = 683 rows is 2.15 GFLOP,
// 0.0321 ms at the H100 SXM's 67 TFLOP/s of fp32 FMA, against about 13 MB
// of operands (0.004 ms at 3.35 TB/s). wgmma has no fp32 type, and TF32
// would change the rounding the fragment is held to, so the body runs on
// the CUDA cores. The first design (gmm_common.cuh, decode-shaped) read
// each weight from device memory per k with no reuse across its row groups
// and kept 8 x 4 sums a thread: 8-37x the bound at these shapes.
//
// What the design does about it:
//   * one CTA (128 threads) owns a BM x BN output tile of one expert and
//     keeps K whole: no split-K, no atomics (the paper's GMM rule, §4.2);
//   * K goes through shared memory in slabs of BK = 16, STAGES = 4 slabs in
//     a ring in dynamic shared memory, so three slabs' copies are in flight
//     while one is multiplied;
//   * every operand is copied by 16-byte cp.async chunks in the order it
//     is stored, rows padded by 4 floats: one stored M- or N-fastest (x with
//     ta = 1, w with tb = 0) as [k][mn], one stored K-fastest (x with
//     ta = 0, w with tb = 1) as [mn][k]. Nothing is transposed in flight;
//   * each thread keeps a TM x TN register tile of sums and reads, for 4 k
//     at a time, its fragments as 16-byte shared loads: 4 adjacent m's (n's)
//     of one k from a [k][mn] slab, or 4 k's of one m (n) from a [mn][k]
//     slab, where its rows (columns) are every RT-th (CT-th) one so that a
//     quarter-warp reads 8 distinct rows of 20 floats on distinct banks;
//   * three tiles, all 128 threads: 64 x 128 (8 x 8 sums a thread),
//     64 x 64 (8 x 4) and 32 x 64 (4 x 4). The wrapper (kernels/gmm.py,
//     fp32_tile) takes the largest whose grid has at least two CTAs per SM,
//     else the smallest: granite's C = 683 tiles get 176-528 CTAs, where a
//     128 x 128 tile gave GMM1 48 on 132 SMs.
// Each output is one fmaf chain over k in ascending order in one thread:
// repeats are bit-equal and the result does not depend on the tile.
// Ragged C, N and K are masked (zero-filled copies, guarded stores).
//
// Measured (launch/bench_gmm_fma.py, NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md): at C = 683 the six tile calls take 0.031-0.076 ms,
// 1.05-1.84x torch.bmm on the same operands and 4.7-10.6x faster than
// the FMA body. 16-byte copies of the K-fastest operands took the
// activation gradients from 0.094 / 0.090 ms (4-byte copies transposing
// in flight) to 0.066 / 0.059 ms. The FMA body is faster up to C = 8
// (GMM1 0.027 against 0.035 ms); from C = 9, where it moves to two row
// groups, it takes 0.049 ms: the wrapper's threshold.
//
// The body takes a call only if every operand's contiguous dimension is a
// multiple of 4 floats, N is too, and x, w and y are 16-byte aligned
// (usable()); the C entry refuses a tiled call that fails it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gmmf {

constexpr int BK = 16;        // k per slab
constexpr int STAGES = 4;     // slabs in the shared-memory ring
constexpr int PAD = 4;        // floats added to each staged row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-byte copy; with ok = false it reads nothing and zero-fills.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One operand's slab in shared memory, MN_T of its rows (x's m or w's n)
// by BK of k, kept in the operand's own order. KMAJOR (stored [K][MN], MN
// contiguous): sm[k][mn], rows of MN_T + PAD; else (stored [MN][K]):
// sm[mn][k], rows of BK + PAD.
template <int MN_T, bool KMAJOR>
struct Slab {
  static constexpr int LD = KMAJOR ? MN_T + PAD : BK + PAD;
  static constexpr int FLOATS = KMAJOR ? BK * LD : MN_T * LD;

  // Copies k0 .. k0 + BK of rows mn0 .. mn0 + MN_T of operand g (MN rows
  // of K) in 16-byte chunks, zero past K and MN.
  template <int NT>
  static __device__ __forceinline__ void load(float* sm, const float* g,
                                              int k0, int mn0, int K, int MN,
                                              int tid) {
    constexpr int CH = KMAJOR ? MN_T / 4 : BK / 4;   // chunks per smem row
    constexpr int ROWS = KMAJOR ? BK : MN_T;
    static_assert(ROWS * CH % NT == 0, "slab does not split evenly");
#pragma unroll
    for (int i = 0; i < ROWS * CH / NT; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / CH, c = (idx % CH) * 4;
      const int k = KMAJOR ? r : c, mn = KMAJOR ? c : r;
      const bool ok = k0 + k < K && mn0 + mn < MN;
      const size_t off = KMAJOR ? static_cast<size_t>(k0 + k) * MN + mn0 + mn
                                : static_cast<size_t>(mn0 + mn) * K + k0 + k;
      copy16(sm + r * LD + c, ok ? g + off : g, ok);
    }
  }
};

// Thread t of T along a tile side holds its v-th value at this index: in a
// KMAJOR slab groups of 4 adjacent ones, 4T apart (one 16-byte shared load
// per group and k); else every T-th one (one 16-byte load along k each).
template <int T, bool KMAJOR>
__device__ __forceinline__ int index_of(int t, int v) {
  return KMAJOR ? (v / 4) * 4 * T + t * 4 + v % 4 : t + v * T;
}

template <int BM, int BN, int TA, int TB>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES *
         (Slab<BM, TA == 1>::FLOATS + Slab<BN, TB == 0>::FLOATS) *
         static_cast<int>(sizeof(float));
}

// Threads of a BM x BN tile of TM x TN sums each.
template <int BM, int BN, int TM, int TN>
__host__ __device__ constexpr int threads() {
  return (BM / TM) * (BN / TN);
}

// A thread's TV values of slab rows k0 .. k0 + 3 (v[i][kk]): from a KMAJOR
// slab TV / 4 loads of 4 adjacent values per k, else TV loads of 4 k's.
template <int T, int TV, bool KMAJOR, int LD>
__device__ __forceinline__ void fragments(float (&v)[TV][4], const float* s,
                                          int t, int k0) {
  if constexpr (KMAJOR) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < TV / 4; ++g) {
        const float4 q = *reinterpret_cast<const float4*>(
            s + (k0 + kk) * LD + g * 4 * T + t * 4);
        v[4 * g][kk] = q.x; v[4 * g + 1][kk] = q.y;
        v[4 * g + 2][kk] = q.z; v[4 * g + 3][kk] = q.w;
      }
  } else {
#pragma unroll
    for (int i = 0; i < TV; ++i) {
      const float4 q =
          *reinterpret_cast<const float4*>(s + (t + i * T) * LD + k0);
      v[i][0] = q.x; v[i][1] = q.y; v[i][2] = q.z; v[i][3] = q.w;
    }
  }
}

// x: [E, C, K] (TA = 0) or stored [E, K, C] (TA = 1); w: [E, K, N] (TB = 0)
// or stored [E, N, K] (TB = 1); y: [E, C, N]. Grid: (ceil(N / BN),
// ceil(C / BM), E). The CTA's threads form RT x CT (BM / TM x BN / TN);
// a warp is 4 x 8 of them.
template <int BM, int BN, int TM, int TN, int TA, int TB>
__global__ void __launch_bounds__(threads<BM, BN, TM, TN>(), 2)
tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
             float* __restrict__ y, int C, int K, int N) {
  constexpr int NT = threads<BM, BN, TM, TN>();
  constexpr int RT = BM / TM, CT = BN / TN;
  constexpr bool AK = TA == 1, BKM = TB == 0;   // slabs k-major
  using SA = Slab<BM, AK>;
  using SB = Slab<BN, BKM>;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && RT % 4 == 0 && CT % 8 == 0,
                "unsupported tile");
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = smem + STAGES * SA::FLOATS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tm = (warp / (CT / 8)) * 4 + lane / 8;
  const int tn = (warp % (CT / 8)) * 8 + lane % 8;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* xe = x + static_cast<size_t>(e) * C * K;
  const float* we = w + static_cast<size_t>(e) * K * N;
  const int nk = (K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      SA::template load<NT>(as + s * SA::FLOATS, xe, s * BK, m0, K, C, tid);
      SB::template load<NT>(bs + s * SB::FLOATS, we, s * BK, n0, K, N, tid);
    }
    commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < nk; ++s) {
    wait_pending<STAGES - 2>();   // this thread's copies of slab s landed
    __syncthreads();              // everyone's; slot (s - 1) % STAGES free
    const int next = s + STAGES - 1;
    if (next < nk) {
      const int slot = next % STAGES;
      SA::template load<NT>(as + slot * SA::FLOATS, xe, next * BK, m0, K, C,
                            tid);
      SB::template load<NT>(bs + slot * SB::FLOATS, we, next * BK, n0, K, N,
                            tid);
    }
    commit();
    const float* a_s = as + (s % STAGES) * SA::FLOATS;
    const float* b_s = bs + (s % STAGES) * SB::FLOATS;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float a[TM][4], b[TN][4];
      fragments<RT, TM, AK, SA::LD>(a, a_s, tm, k4);
      fragments<CT, TN, BKM, SB::LD>(b, b_s, tn, k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
    }
  }

  float* ye = y + static_cast<size_t>(e) * C * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + index_of<RT, AK>(tm, i);
    if (m >= C) continue;
    float* yr = ye + static_cast<size_t>(m) * N;
    if constexpr (BKM) {
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const int n = n0 + index_of<CT, true>(tn, j);
        if (n < N)
          *reinterpret_cast<float4*>(yr + n) = make_float4(
              acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + index_of<CT, false>(tn, j);
        if (n < N) yr[n] = acc[i][j];
      }
    }
  }
}

// Whether the body can take a call: each operand's contiguous dimension
// (x: K, or C if ta; w: N, or K if tb) and N multiples of 4, and x, w, y on
// 16-byte aligned bases, so that every 16-byte copy and store is aligned.
inline bool usable(const void* x, const void* w, const void* y, int C, int K,
                   int N, int ta, int tb) {
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return (ta == 0 || ta == 1) && (tb == 0 || tb == 1) && C > 0 && N > 0 &&
         (ta ? C : K) % 4 == 0 && (tb ? K : N) % 4 == 0 && N % 4 == 0 &&
         al(x) && al(w) && al(y);
}

// The dynamic shared memory opt-in, and the largest shared-memory carveout
// so that several CTAs' rings fit an SM, once per device and instance.
constexpr int MAX_DEV = 64;
template <int BM, int BN, int TM, int TN, int TA, int TB>
cudaError_t prepare() {
  static bool done[MAX_DEV];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEV) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    auto kern = tiled_kernel<BM, BN, TM, TN, TA, TB>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<BM, BN, TA, TB>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int BM, int BN, int TM, int TN, int TA, int TB>
int run(const float* x, const float* w, float* y, int E, int C, int K, int N,
        cudaStream_t stream) {
  if ((C + BM - 1) / BM > 65535 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare<BM, BN, TM, TN, TA, TB>();
  if (err != cudaSuccess) return static_cast<int>(err);
  tiled_kernel<BM, BN, TM, TN, TA, TB>
      <<<dim3((N + BN - 1) / BN, (C + BM - 1) / BM, E),
         threads<BM, BN, TM, TN>(), smem_bytes<BM, BN, TA, TB>(), stream>>>(
          x, w, y, C, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int TM, int TN>
int run_layout(const float* x, const float* w, float* y, int E, int C,
               int K, int N, int ta, int tb, cudaStream_t stream) {
  switch (2 * ta + tb) {
    case 0: return run<BM, BN, TM, TN, 0, 0>(x, w, y, E, C, K, N, stream);
    case 1: return run<BM, BN, TM, TN, 0, 1>(x, w, y, E, C, K, N, stream);
    case 2: return run<BM, BN, TM, TN, 1, 0>(x, w, y, E, C, K, N, stream);
    default: return run<BM, BN, TM, TN, 1, 1>(x, w, y, E, C, K, N, stream);
  }
}

// tile: the code of kernels/gmm.py's FP32_TILES. Returns
// cudaErrorInvalidValue, launching nothing, for a tile code or a call the
// body cannot take.
inline int launch(const void* x, const void* w, void* y, int E, int C, int K,
                  int N, int ta, int tb, int tile, cudaStream_t stream) {
  if (!usable(x, w, y, C, K, N, ta, tb))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* yp = static_cast<float*>(y);
#define GMMF_TILE(CODE, BM, BN, TM, TN) \
  case CODE:                            \
    return run_layout<BM, BN, TM, TN>(xp, wp, yp, E, C, K, N, ta, tb, stream);
  switch (tile) {
    GMMF_TILE(1, 64, 128, 8, 8)
    GMMF_TILE(2, 64, 64, 8, 4)
    GMMF_TILE(3, 32, 64, 4, 4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GMMF_TILE
}

}  // namespace gmmf
