// Backward of the fused GMM1 + SwiGLU for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gmm_swiglu_bwd.py::
// gmm_swiglu_bwd (bodies _dx_kernel and _dw_kernel). With x [E, C, K],
// w_in [E, K, 2F] (gate columns [0, F), up columns [F, 2F)) and dout
// [E, C, F], it recomputes g = x·Wg and u = x·Wu, forms
//   dg = dout * u * silu'(g),   du = dout * silu(g),
// and returns, as fp32 sums,
//   dx  [E, C, K]  = dg·Wgᵀ + du·Wuᵀ          (summed over F)
//   dw  [E, K, 2F] = xᵀ·dg ‖ xᵀ·du            (summed over C)
// dw in w_in's layout is the JAX [E, K, 2, F] dw4.
//
// What bounds it: at the training shape (granite, E = 48, C = 854,
// K = 1536, F = 512) the recompute, dx and dW are three products of
// 2·E·C·K·2F operations each, 386.8 GFLOP against 873 MB of inputs and
// outputs: the work is bound by operations, 0.39 ms at the card's bf16
// Tensor-Core rate.
//
// What the design does about it: this first version sums with fp32 FMAs,
// far from that bound; an mma/wgmma version is later work. It runs the
// three products as three tiled GEMMs of one shape of CTA, small enough for
// several CTAs per SM to hide each other's load latency:
//   1. gu_kernel: [g ‖ u] = x·[Wg ‖ Wu] over K, then dg and du in the
//      epilogue, written to the fp32 scratch dgu [E, C, 2F] (the one
//      recompute; the Pallas bodies recompute in both kernels);
//   2. dx_kernel: dx = dgu·w_inᵀ over 2F;
//   3. dw_kernel: dw = xᵀ·dgu over C.
// A CTA owns a 64 x 64 output tile of one expert (4 x 4 per thread) and
// loops over the reduction itself, 16 at a time through shared memory, where
// Pallas revisits an output block across a sequential grid axis. So, as the
// paper's rule asks (gmm.py), no reduction is split across CTAs and there
// are no atomics: results are deterministic. Ragged C, K and F are masked;
// nothing needs to divide a tile size. (A first design fused 1 and 2 in one
// CTA per 16 rows with a [16, K] fp32 accumulator in shared memory, as the
// Pallas dx body keeps its [bm, K] block. At one CTA per SM its loads
// stalled: the whole backward took 79.1 ms at the training shape on an
// H100, against 18.3 ms for these three kernels, in chip_smoke.py.)

#include "gmm_common.cuh"

namespace gsb {

using gmmk::to_f;

constexpr int THREADS = 256;
constexpr int TM = 64;              // output tile rows
constexpr int TN = 64;              // output tile columns
constexpr int TR = 16;              // reduction step staged in shared memory
constexpr int LD = TN + 4;          // padded shared-memory row
static_assert(THREADS == (TM / 4) * (TN / 4), "4 x 4 outputs per thread");
static_assert(TM == TN, "one staging loop serves both operands");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s[r][c] = val(r0 + r, c) for the TR x TN stage. RED_FAST: the reduction
// index is the contiguous one in memory, so neighbouring threads take
// neighbouring r; otherwise neighbouring c.
template <bool RED_FAST, class Val>
__device__ __forceinline__ void stage(float (*s)[LD], int r0, Val val) {
  for (int i = threadIdx.x; i < TR * TN; i += THREADS) {
    const int r = RED_FAST ? i % TR : i / TN;
    const int c = RED_FAST ? i / TR : i % TN;
    s[r][c] = val(r0 + r, c);
  }
}

// acc[i][j] = sum over r < red of A(4·ty + i, r) · B(r, 4·tx + j), for the
// thread (tx, ty) = (tid % 16, tid / 16). A and B return 0 outside the
// operands, so the ragged edges add nothing.
template <bool A_RED_FAST, bool B_RED_FAST, class AVal, class BVal>
__device__ __forceinline__ void tile_gemm(float (&acc)[4][4], int red,
                                          AVal a_val, BVal b_val) {
  __shared__ __align__(16) float as[TR][LD];   // as[r][m]
  __shared__ __align__(16) float bs[TR][LD];   // bs[r][n]
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = 0; r0 < red; r0 += TR) {
    __syncthreads();
    stage<A_RED_FAST>(as, r0, a_val);
    stage<B_RED_FAST>(bs, r0, b_val);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float4 a = ld4(&as[r][ty * 4]);
      const float4 b = ld4(&bs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// 1. Grid (ceil(F / 32), ceil(C / 64), E). Tile column n = 4p + q holds
// gate (q < 2) or up (q >= 2) of f = f0 + 2p + q % 2, so each thread has the
// gate and up sums of the same two f.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gu_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const T* __restrict__ dout, float* __restrict__ dgu, int C, int K,
          int F) {
  const int e = blockIdx.z, m0 = blockIdx.y * TM, f0 = blockIdx.x * TN / 2;
  const int twoF = 2 * F;
  const T* xe = x + (size_t)e * C * K;
  const T* we = w + (size_t)e * K * twoF;
  float acc[4][4];
  tile_gemm<true, false>(
      acc, K,
      [&](int k, int m) {
        return m0 + m < C && k < K ? to_f(xe[(size_t)(m0 + m) * K + k]) : 0.f;
      },
      [&](int k, int n) {
        const int f = f0 + n / 4 * 2 + n % 2;
        return k < K && f < F
                   ? to_f(we[(size_t)k * twoF + (n % 4 < 2 ? f : F + f)])
                   : 0.f;
      });
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);
  const T* de = dout + (size_t)e * C * F;
  float* ge = dgu + (size_t)e * C * twoF;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = f0 + tx * 2 + q;
      if (row >= C || f >= F) continue;
      const float g = acc[i][q], u = acc[i][2 + q];
      const float sig = 1.f / (1.f + expf(-g));
      const float dsilu = sig * (1.f + g * (1.f - sig));
      const float d = to_f(de[(size_t)row * F + f]);
      ge[(size_t)row * twoF + f] = d * u * dsilu;
      ge[(size_t)row * twoF + F + f] = d * (g * sig);
    }
  }
}

// 2. Grid (ceil(K / 64), ceil(C / 64), E): dx[c, k] = sum_j dgu[c, j] w[k, j].
template <typename T>
__global__ void __launch_bounds__(THREADS)
dx_kernel(const float* __restrict__ dgu, const T* __restrict__ w,
          float* __restrict__ dx, int C, int K, int F) {
  const int e = blockIdx.z, m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int twoF = 2 * F;
  const float* ge = dgu + (size_t)e * C * twoF;
  const T* we = w + (size_t)e * K * twoF;
  float acc[4][4];
  tile_gemm<true, true>(
      acc, twoF,
      [&](int j, int m) {
        return m0 + m < C && j < twoF ? ge[(size_t)(m0 + m) * twoF + j] : 0.f;
      },
      [&](int j, int n) {
        return n0 + n < K && j < twoF ? to_f(we[(size_t)(n0 + n) * twoF + j])
                                      : 0.f;
      });
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);
  float* dxe = dx + (size_t)e * C * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = n0 + tx * 4 + j;
      if (row < C && k < K) dxe[(size_t)row * K + k] = acc[i][j];
    }
  }
}

// 3. Grid (ceil(2F / 64), ceil(K / 64), E): dw[k, j] = sum_c x[c, k] dgu[c, j].
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const T* __restrict__ x, const float* __restrict__ dgu,
          float* __restrict__ dw, int C, int K, int F) {
  const int e = blockIdx.z, m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int twoF = 2 * F;
  const T* xe = x + (size_t)e * C * K;
  const float* ge = dgu + (size_t)e * C * twoF;
  float acc[4][4];
  tile_gemm<false, false>(
      acc, C,
      [&](int c, int m) {
        return c < C && m0 + m < K ? to_f(xe[(size_t)c * K + m0 + m]) : 0.f;
      },
      [&](int c, int n) {
        return c < C && n0 + n < twoF ? ge[(size_t)c * twoF + n0 + n] : 0.f;
      });
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);
  float* dwe = dw + (size_t)e * K * twoF;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (k < K && n < twoF) dwe[(size_t)k * twoF + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* w_in, const void* dout, void* dx,
           void* dw, void* dgu, int E, int C, int K, int F,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w_in);
  float* gp = static_cast<float*>(dgu);
  const int cm = (C + TM - 1) / TM;
  gu_kernel<T><<<dim3((2 * F + TN - 1) / TN, cm, E), THREADS, 0, stream>>>(
      xp, wp, static_cast<const T*>(dout), gp, C, K, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dx_kernel<T><<<dim3((K + TN - 1) / TN, cm, E), THREADS, 0, stream>>>(
      gp, wp, static_cast<float*>(dx), C, K, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<T><<<dim3((2 * F + TN - 1) / TN, (K + TM - 1) / TM, E), THREADS,
                 0, stream>>>(xp, gp, static_cast<float*>(dw), C, K, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gsb

// dx [E, C, K] and dw [E, K, 2F] are fp32 outputs; dgu [E, C, 2F] is fp32
// scratch. dtype: 0 = float32, 1 = bfloat16 (x, w_in and dout). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int gmm_swiglu_bwd_launch(const void* x, const void* w_in,
                                     const void* dout, void* dx, void* dw,
                                     void* dgu, int E, int C, int K, int F,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gsb::launch<float>(x, w_in, dout, dx, dw, dgu, E, C, K, F, s);
  if (dtype == 1)
    return gsb::launch<__nv_bfloat16>(x, w_in, dout, dx, dw, dgu, E, C, K, F,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
