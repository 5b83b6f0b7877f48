// FMA body of the grouped-GEMM kernels gmm.cu and gmm_swiglu.cu: the first
// design (fp32 FMAs on CUDA cores, shaped for decode).
//
// y[e, c, n] = sum_k x[e, c, k] * w[e, k, n]              (gmm)
// y[e, c, n] = silu(g) * u, g = x·w[:, :, n], u = x·w[:, :, F + n]
//                                                          (gmm_swiglu)
//
// Products are summed in fp32 registers; the result is cast to T once, after
// the epilogue. T is float or __nv_bfloat16.
//
// Layout of one CTA (256 threads) — it owns BN = 64 output columns of one
// expert and ROWS = MT x RG rows of it (one pass; the grid's z dimension
// covers the rows, so an expert with many rows, such as one dropless tile
// with E = 1, still spreads over the SMs; which CTA owns a row does not
// change how its sums are taken):
//   * 16 column groups of VEC = 4 adjacent columns; a half-warp's 16 threads
//     read one weight row's 64 (or, for SwiGLU, 2 x 64) columns together, so
//     each weight byte is fetched once per call, in full 128-byte lines;
//   * the other 16 "lanes" are RG row groups x KL = 16 / RG slices of K.
//     Each thread keeps MT rows x VEC columns (x2 for gate and up) of fp32
//     sums, so a small C (decode: 1 or 2 rows) spreads K over 16 slices and
//     a larger C (prefill: 27 rows) spreads its rows over the row groups;
//   * x is staged into shared memory as fp32, one K-chunk at a time;
//   * the KL partial sums of each output are added in a fixed tree in shared
//     memory (deterministic), then SwiGLU is applied and the tile is stored.
// Ragged C, N and K are masked; nothing needs to divide a block size.
//
// It takes the same operand layouts as the tensor-core body (gmm_tc.cuh):
// x is [E, C, K] or, ta = 1, [E, K, C]; w is [E, K, ldw] or, tb = 1,
// [E, N, K]. The launchers run it for fp32, and for bf16 calls whose strides
// or bases a TMA tensor map cannot describe.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gmmk {

constexpr int BN = 64;                 // output columns per CTA
constexpr int VEC = 4;                 // adjacent columns per thread
constexpr int CG = BN / VEC;           // 16 column groups
constexpr int THREADS = 256;
constexpr int LANES = THREADS / CG;    // 16 = RG * KL
constexpr int XS_FLOATS = 4096;        // 16 KB of staged x per K-chunk
constexpr int SMEM_FLOATS = 8192;      // 32 KB: x stage, then the reduction

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Four adjacent values, one vector load (16 B fp32, 8 B bf16). A bf16 is the
// top half of the fp32 with the same value, so widening is a shift; the
// element at the lower address sits in the low 16 bits.
__device__ __forceinline__ void load_vec(const float* p, float v[VEC]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float v[VEC]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// Columns [0, ncols) of a group, `swn` elements apart; a whole, aligned
// group of adjacent columns is one vector load.
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, int ncols, size_t swn,
                                          bool vec_ok, float v[VEC]) {
  if (vec_ok && ncols == VEC) {
    load_vec(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = j < ncols ? to_f(p[j * swn]) : 0.f;
  }
}

// x: C x K per expert, element (r, k) at r * sxr + k * sxk; w: K x ldw per
// expert, ldw = N (gmm) or 2N (SwiGLU, N = F), element (k, n) at
// k * swk + n * swn; y: [E, C, N]. Grid: (ceil(N / BN), E, ceil(C / ROWS)).
template <typename T, int MT, int RG, bool SWIGLU>
__global__ void __launch_bounds__(THREADS, 2)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ y, int C, int K, int N, int ldw, size_t sxr,
           size_t sxk, size_t swk, size_t swn, bool vec_ok) {
  constexpr int KL = LANES / RG;        // K slices
  constexpr int ROWS = MT * RG;         // rows per pass
  constexpr int KC = XS_FLOATS / ROWS;  // K-chunk staged per pass
  constexpr int NW = SWIGLU ? 2 : 1;    // gate (and up) accumulators
  static_assert(LANES % RG == 0, "RG must divide 16");
  static_assert(KL == 1 || (KL / 2) * RG * NW * MT * BN <= SMEM_FLOATS,
                "reduction buffer exceeds shared memory");

  __shared__ __align__(16) float smem[SMEM_FLOATS];
  float* xs = smem;                     // [ROWS][KC] during the K loop
  float* red = smem;                    // partial sums after it

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int lane = tid / CG;
  const int rg = lane % RG;
  const int kl = lane / RG;
  const int e = blockIdx.y;
  const int n0 = blockIdx.x * BN + cg * VEC;
  const int ncols = min(VEC, N - n0);   // <= 0 past the ragged N edge

  const T* xe = x + (size_t)e * C * K;
  const T* we = w + (size_t)e * K * ldw + (ncols > 0 ? n0 * swn : 0);
  T* ye = y + (size_t)e * C * N;

  // One pass per CTA as launched (gridDim.z = ceil(C / ROWS)). Kept as a
  // loop: the same body as a straight block with r0 = blockIdx.z * ROWS ran
  // 14-26% slower on an H100 at one pass (C = 17, 127; bench_gmm_fma).
  for (int r0 = blockIdx.z * ROWS; r0 < C; r0 += gridDim.z * ROWS) {
    float acc[NW][MT][VEC];
#pragma unroll
    for (int q = 0; q < NW; ++q)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[q][m][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      __syncthreads();                  // xs / red free again
      for (int i = tid; i < ROWS * KC; i += THREADS) {
        const int r = i / KC, k = i % KC;
        float v = 0.f;
        if (r0 + r < C && k < kc)
          v = to_f(xe[(r0 + r) * sxr + (k0 + k) * sxk]);
        xs[i] = v;
      }
      __syncthreads();
      if (ncols > 0) {
        const float* xr = xs + rg * MT * KC;
#pragma unroll 4
        for (int k = kl; k < kc; k += KL) {
          const T* wrow = we + (k0 + k) * swk;
          float wv[NW][VEC];
          load_cols(wrow, ncols, swn, vec_ok, wv[0]);
          if (SWIGLU)
            load_cols(wrow + N * swn, ncols, swn, vec_ok, wv[NW - 1]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = xr[m * KC + k];
#pragma unroll
            for (int q = 0; q < NW; ++q)
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                acc[q][m][j] = fmaf(xv, wv[q][j], acc[q][m][j]);
          }
        }
      }
    }

    // Sum the KL slices: halve the live slices each round, fixed order.
#pragma unroll
    for (int half = KL / 2; half >= 1; half /= 2) {
      __syncthreads();
      if (kl >= half && kl < 2 * half) {
        float* dst = red + (size_t)((kl - half) * RG + rg) * NW * MT * BN;
#pragma unroll
        for (int q = 0; q < NW; ++q)
#pragma unroll
          for (int m = 0; m < MT; ++m)
            *reinterpret_cast<float4*>(dst + (q * MT + m) * BN + cg * VEC) =
                make_float4(acc[q][m][0], acc[q][m][1], acc[q][m][2],
                            acc[q][m][3]);
      }
      __syncthreads();
      if (kl < half) {
        const float* src = red + (size_t)(kl * RG + rg) * NW * MT * BN;
#pragma unroll
        for (int q = 0; q < NW; ++q)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float4 p = *reinterpret_cast<const float4*>(
                src + (q * MT + m) * BN + cg * VEC);
            acc[q][m][0] += p.x; acc[q][m][1] += p.y;
            acc[q][m][2] += p.z; acc[q][m][3] += p.w;
          }
      }
    }

    if (kl == 0 && ncols > 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int row = r0 + rg * MT + m;
        if (row >= C) break;
        T* yr = ye + (size_t)row * N + n0;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          if (j >= ncols) break;
          float v = acc[0][m][j];
          if (SWIGLU) {
            const float g = v;
            v = g * (1.f / (1.f + expf(-g))) * acc[NW - 1][m][j];
          }
          store_f(yr + j, v);
        }
      }
    }
  }
}

// Picks the row tiling for C and launches on `stream`. ta, tb: the layouts
// of x and w (0: as named above; 1: transposed, see the head of the file).
template <typename T, bool SWIGLU>
int launch(const void* x, const void* w, void* y, int E, int C, int K, int N,
           int ldw, int ta, int tb, cudaStream_t stream) {
  if ((ta != 0 && ta != 1) || (tb != 0 && tb != 1) || (SWIGLU && (ta || tb)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gx = (N + BN - 1) / BN;
  const size_t sxr = ta ? 1 : K, sxk = ta ? C : 1;
  const size_t swk = tb ? 1 : ldw, swn = tb ? K : 1;
  const bool vec_ok = tb == 0 && ldw % VEC == 0 && N % VEC == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  // One CTA per ROWS = MT x RG rows; the grid's z extent is at most 65535.
  if ((C + 127) / 128 > 65535) return static_cast<int>(cudaErrorInvalidValue);
#define GMMK_LAUNCH(MT, RG)                                              \
  gmm_kernel<T, MT, RG, SWIGLU>                                          \
      <<<dim3(gx, E, (C + MT * RG - 1) / (MT * RG)), THREADS, 0,         \
         stream>>>(xp, wp, yp, C, K, N, ldw, sxr, sxk, swk, swn, vec_ok)
  if (C <= 1) GMMK_LAUNCH(1, 1);
  else if (C <= 2) GMMK_LAUNCH(2, 1);
  else if (C <= 4) GMMK_LAUNCH(4, 1);
  else if (C <= 8) GMMK_LAUNCH(8, 1);
  else if (C <= 16) GMMK_LAUNCH(8, 2);
  else if (C <= 32) GMMK_LAUNCH(8, 4);
  else if (C <= 64) GMMK_LAUNCH(8, 8);
  else GMMK_LAUNCH(8, 16);
#undef GMMK_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmmk
