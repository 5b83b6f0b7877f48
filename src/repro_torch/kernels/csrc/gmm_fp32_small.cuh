// fp32 small-row body of the grouped GEMM gmm.cu for Hopper (sm_90a): one
// thread per output, each output one fmaf chain over k in ascending order,
// the operands streamed through a ring of cp.async copies in shared memory.
//
// y[e, m, n] = sum_k x[e, m, k] * w[e, k, n], fp32 in, fp32 sums, fp32 out.
//
// Replaces, for fp32 calls that neither the tiled body (gmm_fp32.cuh) nor
// the narrow body (gmm_fp32_narrow.cuh) takes, the TPU kernel
// src/repro/kernels/gmm.py::gmm (body _gmm_kernel): calls whose widths or
// bases are not multiples of 16 bytes (a one-row tile's weight gradient
// reads x as K = 1 float wide), and x passed as a transposed view where
// the call is too small for the tiled body.
//
// Why its sums are one ascending-k chain: the tiled body sums each output
// in one fmaf chain over ascending k, so its result does not depend on the
// tile. This body takes the same chain, so a row's bits do not depend on
// how many rows the call has, or on which body ran it: a tile padded by a
// bucket ladder from 5 rows to 16 moves from this body to the tiled one and
// its real rows keep their bits. (The first design's FMA body,
// gmm_common.cuh, split K into strided slices summed in a tree, which gave
// other bits than the tiled body.)
//
// What bounds it: the bytes. At C <= 8 each call reads the whole weight
// (GMM1: 1536 x 1024 floats, 6.3 MB, 1.9 us at 3.35 TB/s) for 2 C
// operations a weight; the K-long chain of each output is latency, about
// 4 cycles a k.
//
// What the design does about it:
//   * a CTA of 256 threads owns BN = 32 output columns (one a lane) of
//     RB <= 8 rows (one warp each) of one expert; K stays whole in the CTA
//     (no split-K, no atomics, the paper's GMM rule, §4.2). All eight warps
//     issue the copies, the first RB also sum: at C = 1 one warp's chain
//     runs while seven keep the copies going;
//   * K goes through shared memory in slabs of BK = 32, STAGES = 8 slabs
//     in a ring, so seven slabs' copies (28 KB of weights) are in flight a
//     CTA while one is summed: GMM1 at C = 1 runs 32 CTAs;
//   * copies in the order the operand is stored: 16-byte cp.async chunks of
//     w where it is stored [K][N] with N and its base 16-byte aligned (one
//     chunk a thread a slab), else 4-byte copies, neighbouring lanes on
//     neighbouring addresses (any layout, any alignment); zero-filled past
//     the edges. The slabs are kept [k][n] and [row][k], rows padded to 36
//     floats (16-byte aligned);
//   * a warp loads a slab's 32 x values (a broadcast, 16-byte loads) and its
//     lane's 32 weights into registers before its chain, so the chain waits
//     only on the FMAs (about 4 cycles a k: 3.5 us of K = 1536 at 1.76 GHz).
// A row past K adds nothing: the chain runs k = 0 .. K-1 only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gmms {

constexpr int BN = 32;         // output columns per CTA, one a lane
constexpr int BK = 32;         // k per slab
constexpr int STAGES = 8;      // slabs in the shared-memory ring
constexpr int LD = 36;         // padded slab row (16-byte aligned)
constexpr int NT = 256;        // threads per CTA: eight warps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 4-byte copy; with ok = false it reads nothing and zero-fills.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
// A 16-byte copy of which the first `bytes` are read, the rest zero-filled.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// x: [E, C, K] (TA = 0) or stored [E, K, C] (TA = 1); w: [E, K, N]
// (TB = 0) or stored [E, N, K] (TB = 1); y: [E, C, N]. W16: w's slab by
// 16-byte chunks (TB = 0, N % 4 == 0, w 16-byte aligned). Grid:
// (ceil(N / BN), ceil(C / RB), E), NT threads.
template <int RB, int TA, int TB, bool W16>
__global__ void __launch_bounds__(NT)
small_kernel(const float* __restrict__ x, const float* __restrict__ w,
             float* __restrict__ y, int C, int K, int N) {
  static_assert(RB >= 1 && RB <= NT / 32, "one warp a row");
  static_assert(!W16 || TB == 0, "16-byte chunks need w stored [K][N]");
  __shared__ __align__(16) float ws[STAGES][BK][LD];
  __shared__ __align__(16) float xs[STAGES][RB][LD];

  const int tid = threadIdx.x, lane = tid % 32, row = tid / 32;
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * RB, e = blockIdx.z;
  const float* xe = x + static_cast<size_t>(e) * C * K;
  const float* we = w + static_cast<size_t>(e) * K * N;
  const int nk = (K + BK - 1) / BK;

  // Slab s into ring slot `slot`: the lanes walk the operand's stored
  // (contiguous) dimension.
  auto load = [&](int s, int slot) {
    const int k0 = s * BK;
    if constexpr (W16) {
      static_assert(BK * BN / 4 == NT, "one 16-byte chunk a thread");
      const int k = tid / (BN / 4), n = (tid % (BN / 4)) * 4;
      const int left = N - (n0 + n);           // columns from here on
      const bool ok = k0 + k < K && left > 0;
      copy16(&ws[slot][k][n],
             ok ? we + static_cast<size_t>(k0 + k) * N + n0 + n : we,
             ok ? 4 * min(left, 4) : 0);
    } else {
      for (int i = tid; i < BK * BN; i += NT) {
        const int k = TB ? i % BK : i / BN, n = TB ? i / BK : i % BN;
        const bool ok = k0 + k < K && n0 + n < N;
        const size_t off = TB ? static_cast<size_t>(n0 + n) * K + k0 + k
                              : static_cast<size_t>(k0 + k) * N + n0 + n;
        copy4(&ws[slot][k][n], ok ? we + off : we, ok);
      }
    }
    for (int i = tid; i < RB * BK; i += NT) {
      const int r = TA ? i % RB : i / BK, k = TA ? i / RB : i % BK;
      const bool ok = r0 + r < C && k0 + k < K;
      const size_t off = TA ? static_cast<size_t>(k0 + k) * C + r0 + r
                            : static_cast<size_t>(r0 + r) * K + k0 + k;
      copy4(&xs[slot][r][k], ok ? xe + off : xe, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    commit();
  }

  float acc = 0.f;
  for (int s = 0; s < nk; ++s) {
    wait_pending<STAGES - 2>();   // this thread's copies of slab s landed
    __syncthreads();              // everyone's; slot (s - 1) % STAGES free
    const int next = s + STAGES - 1;
    if (next < nk) load(next, next % STAGES);
    commit();
    if (row >= RB) continue;      // a warp that only copies
    const int slot = s % STAGES;
    const float* xr = &xs[slot][row][0];
    const float* wc = &ws[slot][0][lane];
    const int kc = min(BK, K - s * BK);
    if (kc == BK) {
      float xv[BK], wv[BK];
#pragma unroll
      for (int k = 0; k < BK; k += 4) {
        const float4 q = *reinterpret_cast<const float4*>(xr + k);
        xv[k] = q.x; xv[k + 1] = q.y; xv[k + 2] = q.z; xv[k + 3] = q.w;
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) wv[k] = wc[k * LD];
#pragma unroll
      for (int k = 0; k < BK; ++k) acc = fmaf(xv[k], wv[k], acc);
    } else {
      for (int k = 0; k < kc; ++k) acc = fmaf(xr[k], wc[k * LD], acc);
    }
  }

  const int m = r0 + row, n = n0 + lane;
  if (row < RB && m < C && n < N)
    y[static_cast<size_t>(e) * C * N + static_cast<size_t>(m) * N + n] = acc;
}

template <int RB, int TA, int TB, bool W16>
int run(const float* x, const float* w, float* y, int E, int C, int K, int N,
        cudaStream_t stream) {
  small_kernel<RB, TA, TB, W16>
      <<<dim3((N + BN - 1) / BN, (C + RB - 1) / RB, E), NT, 0, stream>>>(
          x, w, y, C, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int RB>
int run_layout(const float* x, const float* w, float* y, int E, int C, int K,
               int N, int ta, int tb, cudaStream_t stream) {
  const bool w16 = tb == 0 && N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  switch (2 * ta + tb) {
    case 0:
      return w16 ? run<RB, 0, 0, true>(x, w, y, E, C, K, N, stream)
                 : run<RB, 0, 0, false>(x, w, y, E, C, K, N, stream);
    case 1: return run<RB, 0, 1, false>(x, w, y, E, C, K, N, stream);
    case 2:
      return w16 ? run<RB, 1, 0, true>(x, w, y, E, C, K, N, stream)
                 : run<RB, 1, 0, false>(x, w, y, E, C, K, N, stream);
    default: return run<RB, 1, 1, false>(x, w, y, E, C, K, N, stream);
  }
}

// Rows per CTA: C itself up to 8 (rounded up to a power of two), else 8,
// in ceil(C / 8) CTAs down the grid. Returns cudaErrorInvalidValue,
// launching nothing, for a call the grid cannot hold.
inline int launch(const void* x, const void* w, void* y, int E, int C, int K,
                  int N, int ta, int tb, cudaStream_t stream) {
  if ((ta != 0 && ta != 1) || (tb != 0 && tb != 1) || C <= 0 || N <= 0 ||
      K < 0 || E > 65535 || (C + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* yp = static_cast<float*>(y);
  if (C <= 1) return run_layout<1>(xp, wp, yp, E, C, K, N, ta, tb, stream);
  if (C <= 2) return run_layout<2>(xp, wp, yp, E, C, K, N, ta, tb, stream);
  if (C <= 4) return run_layout<4>(xp, wp, yp, E, C, K, N, ta, tb, stream);
  return run_layout<8>(xp, wp, yp, E, C, K, N, ta, tb, stream);
}

}  // namespace gmms
