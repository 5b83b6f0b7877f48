// fp32 narrow body of the grouped GEMM gmm.cu for Hopper (sm_90a): calls of
// a few rows, one CTA to every 8 output columns, the operands streamed by
// TMA through a ring of mbarrier-guarded stages that a producer warp keeps
// full.
//
// y[e, m, n] = sum_k x[e, m, k] * w[e, k, n], fp32 in, fp32 sums, fp32 out.
//
// Replaces, for fp32 calls too small for the tiled body (gmm.tiled_takes:
// its 32 x 64 tile's grid under 72 CTAs and under 257 rows), the TPU kernel
// src/repro/kernels/gmm.py::gmm (body _gmm_kernel). Its callers are the
// dropless fragment's small GMM tiles (core/executor.py: E = 1; in the
// online server's decode step an expert gets one to a few rows, its
// prefill about 21) and their activation gradients (w a transposed view).
//
// Every output is one fmaf chain over k in ascending order from 0, as in
// the tiled body (gmm_fp32.cuh) and the small-row body (gmm_fp32_small.cuh):
// a row's bits do not depend on the call's row count or on the body that
// ran it. No split-K, no atomics, no TF32 (the paper's GMM rule, §4.2).
//
// What bounds it (granite, GMM1 K = 1536, N = 1024; GMM2 K = 512, N = 1536;
// H100 SXM rates):
//   * the bytes: each call reads the whole weight, 6.3 MB for GMM1 (1.88 us
//     at 3.35 TB/s), 3.1 MB for GMM2 (0.94 us);
//   * the chain: K dependent FMAs an output at about 4.5 cycles each, 3.5 us
//     for K = 1536 and 1.2 us for K = 512 at 1.98 GHz, whatever the rows;
//   * the operations from a few dozen rows on: 2·C·K·N at 67 TFLOP/s, 6.0 us
//     for GMM1 at C = 127.
//
// What the design does about each:
//   * narrow column blocks fill the card: BN = CL·TN = 8 columns a CTA,
//     RB = (32 / CL)·TM·W rows (W consumer warps of 32 / CL row lanes by
//     CL column lanes, TM rows by TN columns a thread), one expert, K
//     whole. GMM1 at C = 1 runs 128 CTAs of 48 KB of weights, GMM2 192.
//     The wrapper (kernels/gmm.py, narrow_code) picks the configuration by
//     C: 4, 8, 32 or 64 rows a CTA;
//   * one producer thread streams 32-k stages by TMA, an x box (RB x 32)
//     and a w box (32 x BN, or BN x 32 where w is stored [N][K]), into a
//     ring of up to 32 stages (80 KB a CTA), each stage's bytes credited to
//     its "full" mbarrier. A consumer warp waits on that barrier only and
//     hands the stage back through its "empty" one (one arrival a consumer
//     warp): no barrier of the whole CTA;
//   * boxes of 128-byte rows land in TMA's 128-byte swizzle (x, and w
//     stored [N][K]), so that a quarter-warp's 16-byte loads of one k-chunk
//     from distinct rows fall in distinct bank groups; w stored [K][N]
//     lands unswizzled, a row of k read as one 32-byte segment. Each thread
//     keeps its swizzled offsets for the 8 chunks of a stage in registers;
//   * a thread keeps TM x TN independent chains and loads each 4-k group's
//     x and w fragments into registers D = 4 groups (16 k) ahead of its
//     FMAs, across stage boundaries.
// A k past K adds nothing: the chains run k = 0 .. K-1 only.
//
// TMA takes x stored [C][K] (ta = 0) and w stored either way, with K (and
// N where w is [K][N]) a multiple of 4 floats and 16-byte aligned bases
// (usable()). The wrapper sends every other fp32 call of this size to the
// small-row body and names it so (gmm.fp32_body: "small").

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_tc.cuh"   // mbarrier, TMA and driver-context helpers

namespace gmmn {

constexpr int BK = 32;             // k a stage: one 128-byte row
constexpr int ROW_BYTES = BK * 4;
constexpr int MAX_STAGES = 32;
constexpr int RING_BYTES = 80 * 1024;
constexpr int D = 4;               // 4-k groups loaded ahead of the FMAs
constexpr int MAX_WARPS = 4;       // consumer warps a CTA
constexpr int SMEM_BYTES = 1024 + RING_BYTES + 2 * MAX_STAGES * 8;

// Shared-memory loads of 16 and 4 bytes at a shared-window address, kept
// in program order with the stage barriers' waits.
__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ float lds1(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

// One 4-k group of a thread's operands: x[i][kk] of its TM rows, w[j][kk]
// of its TN columns.
template <int TM, int TN>
struct Frag {
  float x[TM][4];
  float w[TN][4];
};

// A thread's byte offsets in a stage for each 4-k group q: xo[i][q] of its
// row i's 16 bytes (x: RB rows of 128 B in TMA's 128-byte swizzle, 16-byte
// chunk q of row r at chunk q ^ (r % 8)); wo[j][q] of its column j's where
// w is stored [N][K] (BN rows of 128 B after the x box, swizzled the same
// way), else wo[0][0] of its TN columns in row k = 0 of w's [k][n] box
// (rows of BN floats).
template <int TM, int TN, int TB>
struct Offsets {
  uint32_t xo[TM][BK / 4];
  uint32_t wo[TB ? TN : 1][BK / 4];
};

// Group q (k = 4q .. 4q + 3) of the stage at shared address `st`.
template <int TM, int TN, int TB, int CL>
__device__ __forceinline__ void load_group(Frag<TM, TN>& f, uint32_t st,
                                           const Offsets<TM, TN, TB>& o,
                                           int q) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float4 v = lds4(st + o.xo[i][q]);
    f.x[i][0] = v.x; f.x[i][1] = v.y; f.x[i][2] = v.z; f.x[i][3] = v.w;
  }
  if constexpr (TB) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 v = lds4(st + o.wo[j][q]);
      f.w[j][0] = v.x; f.w[j][1] = v.y; f.w[j][2] = v.z; f.w[j][3] = v.w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a = st + o.wo[0][0] + 4 * (4 * q + kk) * CL * TN;
      if constexpr (TN == 1) {
        f.w[0][kk] = lds1(a);
      } else {
        const float4 v = lds4(a);
        f.w[0][kk] = v.x; f.w[1][kk] = v.y; f.w[2][kk] = v.z;
        f.w[3][kk] = v.w;
      }
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void fma_group(float (&acc)[TM][TN],
                                          const Frag<TM, TN>& f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = fmaf(f.x[i][kk], f.w[j][kk], acc[i][j]);
}

// map_x: x [E, C, K] in boxes of 32 k x RB rows; map_w: w [E, K, N] in
// boxes of BN x 32 k (TB = 0) or stored [E, N, K] in boxes of 32 k x BN
// (TB = 1). BN = CL TN columns, RB = (32 / CL) TM W rows. Grid:
// (ceil(N / BN), ceil(C / RB), E); W consumer warps and a producer warp. A
// stage holds 32 k: an x box of RB rows of 128 B rounded up to x_bytes (a
// multiple of 1 KB: the swizzle repeats every 1 KB), then a w box.
template <int TM, int TN, int TB, int CL>
__global__ void __launch_bounds__(32 * (MAX_WARPS + 1))
narrow_kernel(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w,
              float* __restrict__ y, int C, int K, int N, int stages,
              int x_bytes) {
  static_assert((CL == 2 || CL == 8) && (TN == 1 || TN == 4),
                "2 or 8 column lanes, 1 or 4 columns a thread");
  constexpr int RL = 32 / CL;
  constexpr int BN = CL * TN;
  constexpr int W_BYTES = BN * ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (gmmtc::smem_u32(smem_raw) + 1023) & ~1023u;
  const int stage_bytes = x_bytes + W_BYTES;
  const uint32_t bars = base + stages * stage_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  const int warps = blockDim.x / 32 - 1;
  const int rb = RL * TM * warps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * rb, e = blockIdx.z;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      gmmtc::mbar_init(full(s), 1);
      gmmtc::mbar_init(empty(s), warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == warps) {
    // Producer: one thread issues every copy.
    if (lane != 0) return;
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&map_x))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&map_w))
                 : "memory");
    const uint32_t bytes = rb * ROW_BYTES + W_BYTES;
    int s = 0;
    uint32_t ph = 0;
    for (int kb = 0; kb < nk; ++kb) {
      gmmtc::mbar_wait(empty(s), ph ^ 1);
      gmmtc::mbar_expect_tx(full(s), bytes);
      const uint32_t st = base + s * stage_bytes;
      gmmtc::tma_load(st, &map_x, full(s), kb * BK, m0, e);
      if (TB)
        gmmtc::tma_load(st + x_bytes, &map_w, full(s), kb * BK, n0, e);
      else
        gmmtc::tma_load(st + x_bytes, &map_w, full(s), n0, kb * BK, e);
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // Consumers: lane = CL rg + cl; the thread's rows are r0 + RL i of the
  // stage's x box, its columns cl + CL j (TB) or TN cl + j.
  const int rg = lane / CL, cl = lane % CL;
  const int r0 = warp * RL * TM + rg;
  Offsets<TM, TN, TB> o;
#pragma unroll
  for (int q = 0; q < BK / 4; ++q) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + RL * i;
      o.xo[i][q] = r * ROW_BYTES + ((q ^ (r & 7)) << 4);
    }
#pragma unroll
    for (int jj = 0; jj < (TB ? TN : 1); ++jj) {
      const int n = cl + CL * jj;
      o.wo[jj][q] = TB ? x_bytes + n * ROW_BYTES + ((q ^ (n & 7)) << 4)
                       : x_bytes + 4 * TN * cl;
    }
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // Stage t (k from 32 t) lies in ring slot `slot` (phase ph), at shared
  // address cur.
  const int nfull = K / BK;
  uint32_t cur = base, ph = 0;
  int slot = 0;
  Frag<TM, TN> f[D];
  if (nfull > 0) {
    gmmtc::mbar_wait(full(0), 0);
#pragma unroll
    for (int q = 0; q < D; ++q) load_group<TM, TN, TB, CL>(f[q], cur, o, q);
  }
  for (int t = 0; t < nfull; ++t) {
    const int nslot = slot + 1 == stages ? 0 : slot + 1;
    const uint32_t nph = nslot == 0 ? ph ^ 1 : ph;
    const uint32_t nxt = base + nslot * stage_bytes;
    const bool more = t + 1 < nfull;
#pragma unroll
    for (int q = 0; q < BK / 4; ++q) {
      fma_group<TM, TN>(acc, f[q % D]);
      const int qn = q + D;
      if (qn < BK / 4) {
        load_group<TM, TN, TB, CL>(f[q % D], cur, o, qn);
      } else if (more) {
        if (qn == BK / 4) gmmtc::mbar_wait(full(nslot), nph);
        load_group<TM, TN, TB, CL>(f[q % D], nxt, o, qn - BK / 4);
      }
    }
    __syncwarp();        // the stage is read: hand it back to the producer
    if (lane == 0) gmmtc::mbar_arrive(empty(slot));
    cur = nxt;
    slot = nslot;
    ph = nph;
  }
  const int kc = K - nfull * BK;     // the last stage's k, if it is partial
  if (kc > 0) {
    gmmtc::mbar_wait(full(slot), ph);
    for (int k = 0; k < kc; ++k) {
      const int q = k / 4, c = 4 * (k % 4);
      float xv[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = r0 + RL * i;
        xv[i] = lds1(cur + r * ROW_BYTES + ((q ^ (r & 7)) << 4) + c);
      }
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const int n = cl + CL * jj;
        wv[jj] = TB ? lds1(cur + x_bytes + n * ROW_BYTES +
                           ((q ^ (n & 7)) << 4) + c)
                    : lds1(cur + x_bytes + 4 * (k * BN + TN * cl + jj));
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj)
          acc[i][jj] = fmaf(xv[i], wv[jj], acc[i][jj]);
    }
  }

  float* ye = y + static_cast<size_t>(e) * C * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + r0 + RL * i;
    if (m >= C) continue;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int n = n0 + (TB ? cl + CL * jj : TN * cl + jj);
      if (n < N) ye[static_cast<size_t>(m) * N + n] = acc[i][jj];
    }
  }
}

// Whether TMA can describe the call: x stored [C][K] (ta = 0) with K a
// multiple of 4 floats; w's contiguous dim (N, or K if tb) a multiple of 4;
// x and w on 16-byte aligned bases (y takes plain stores).
inline bool usable(const void* x, const void* w, int C, int K, int N, int ta,
                   int tb) {
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return ta == 0 && (tb == 0 || tb == 1) && C > 0 && K > 0 && N > 0 &&
         K % 4 == 0 && (tb || N % 4 == 0) && al(x) && al(w);
}

// A 3-d fp32 tensor map [d2][d1][d0] (d0 contiguous) read in b0 x b1
// boxes, with the 128-byte swizzle where swz; out-of-bounds elements read
// as zero.
inline bool encode(CUtensorMap* map, const void* p, int d0, int d1, int d2,
                   int b0, int b1, bool swz) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t row = static_cast<cuuint64_t>(d0) * 4;
  const cuuint64_t strides[2] = {row, row * dims[1]};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swz ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared memory opt-in, once per device and instance.
template <int TM, int TN, int TB, int CL>
cudaError_t prepare() {
  static bool done[gmmtc::MAX_DEV];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= gmmtc::MAX_DEV) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(narrow_kernel<TM, TN, TB, CL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int TM, int TN, int TB, int CL>
int run(const void* x, const void* w, float* y, int E, int C, int K, int N,
        int warps, cudaStream_t stream) {
  const int rb = 32 / CL * TM * warps, bn = CL * TN;
  if (warps < 1 || warps > MAX_WARPS || (C + rb - 1) / rb > 65535 ||
      E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = gmmtc::bind_context(x);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare<TM, TN, TB, CL>();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mx, mw;
  const bool ok = encode(&mx, x, K, C, E, BK, rb, true) &&
                  (TB ? encode(&mw, w, K, N, E, BK, bn, true)
                      : encode(&mw, w, N, K, E, bn, BK, false));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int x_bytes = (rb * ROW_BYTES + 1023) / 1024 * 1024;
  const int stage_bytes = x_bytes + bn * ROW_BYTES;
  const int nk = (K + BK - 1) / BK;
  // At least two slots where there are two stages: a consumer waits for
  // the next stage before it hands back the current one.
  int stages = RING_BYTES / stage_bytes;
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  stages = stages > nk ? nk : stages;
  if (stages < 2 && nk > 1) return static_cast<int>(cudaErrorInvalidValue);
  narrow_kernel<TM, TN, TB, CL>
      <<<dim3((N + bn - 1) / bn, (C + rb - 1) / rb, E), 32 * (warps + 1),
         1024 + stages * stage_bytes + 2 * MAX_STAGES * 8, stream>>>(
          mx, mw, y, C, K, N, stages, x_bytes);
  return static_cast<int>(cudaGetLastError());
}

// cfg: a code of kernels/gmm.py's FP32_NARROW, (TM, TN, W, CL). Returns
// cudaErrorInvalidValue, launching nothing, for a code or a call the body
// cannot take.
inline int launch(const void* x, const void* w, void* y, int E, int C, int K,
                  int N, int ta, int tb, int cfg, cudaStream_t stream) {
  if (!usable(x, w, C, K, N, ta, tb))
    return static_cast<int>(cudaErrorInvalidValue);
  float* yp = static_cast<float*>(y);
#define GMMN_CFG(CODE, TM, TN, W, CL)                                     \
  case CODE:                                                              \
    return tb ? run<TM, TN, 1, CL>(x, w, yp, E, C, K, N, W, stream)       \
              : run<TM, TN, 0, CL>(x, w, yp, E, C, K, N, W, stream);
  switch (cfg) {
    GMMN_CFG(4, 1, 1, 1, 8)
    GMMN_CFG(5, 1, 1, 2, 8)
    GMMN_CFG(6, 2, 1, 4, 8)
    GMMN_CFG(7, 1, 4, 4, 2)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GMMN_CFG
}

}  // namespace gmmn
